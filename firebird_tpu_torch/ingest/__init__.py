"""Ingest: the synthetic chip source and dense packing (numpy)."""

from firebird_tpu_torch.ingest.packer import ChipData, PackedChips, pack
from firebird_tpu_torch.ingest.sources import SyntheticSource

__all__ = ["ChipData", "PackedChips", "pack", "SyntheticSource"]
