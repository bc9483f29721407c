"""Ingest: chip sources, the registry of the Chipmunk service, and dense
packing (numpy)."""

from firebird_tpu_torch.ingest.packer import (ChipData, PackedChips, pack,
                                             pixel_timeseries)
from firebird_tpu_torch.ingest.sources import (ChipmunkSource, FileSource,
                                              SyntheticSource)

__all__ = ["ChipData", "PackedChips", "pack", "pixel_timeseries",
           "SyntheticSource", "FileSource", "ChipmunkSource"]
