"""lcmap-ccdc change detection in PyTorch on an NVIDIA H100.

A second implementation of ``firebird_tpu``'s detector: plain PyTorch for
the tensor code and hand-written CUDA kernels (``csrc/``) where the JAX
package runs Pallas kernels.  It imports nothing of ``firebird_tpu`` and no
JAX.  Entry points take ``device=None``, which means CUDA; they raise when
no CUDA device is present unless the caller passes ``device="cpu"``.
"""

from firebird_tpu_torch.__about__ import __version__

__all__ = ["__version__"]
