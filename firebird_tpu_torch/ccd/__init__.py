"""The CCDC change detector in PyTorch, with hand-written CUDA kernels.

- :mod:`firebird_tpu_torch.ccd.kernel` — the batched event-horizon
  detector (prologue, INIT/MONITOR rounds, segment close, refit).
- :mod:`firebird_tpu_torch.ccd.cuda_ops` — the three CUDA kernels of the
  detector's hot path and their plain PyTorch versions.
- :mod:`firebird_tpu_torch.ccd.format` — egress decode and the store's
  table frames.
- :mod:`firebird_tpu_torch.ccd.reference` — the per-pixel numpy float64
  reference detector (``detect``), which the float64 route is held to.
- :mod:`firebird_tpu_torch.ccd.incremental` — the stream path's per-pixel
  tail state (``StreamState``) and its one-acquisition ``step``.
"""

from firebird_tpu_torch.ccd import params
from firebird_tpu_torch.ccd.reference import detect

__all__ = ["params", "detect"]
