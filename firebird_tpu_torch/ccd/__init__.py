"""The CCDC change detector in PyTorch, with hand-written CUDA kernels.

- :mod:`firebird_tpu_torch.ccd.kernel` — the batched event-horizon
  detector (prologue, INIT/MONITOR rounds, segment close, refit).
- :mod:`firebird_tpu_torch.ccd.cuda_ops` — the three CUDA kernels of the
  detector's hot path and their plain PyTorch versions.
- :mod:`firebird_tpu_torch.ccd.format` — egress decode and the store's
  table frames.
"""
