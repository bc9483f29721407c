"""Active-lane compaction of the event loop's per-pixel state.

The counterparts of the JAX package's compaction helpers
(``firebird_tpu/ccd/kernel.py``, "Active-lane compaction"): a compaction
permutes every per-pixel tensor the loop carries so that the pixels still
working (phase != DONE) form a dense prefix of each chip's pixel axis,
original order kept within each class.  Every per-pixel computation of a
round is elementwise over the pixel axis or a reduction over time within
one pixel, so the permutation leaves the results unchanged; the loop
carries the running permutation and inverts it at exit.

The pixel axis of this package's tensors is 1 for the per-pixel vectors,
models and result buffers (``[C,P,...]``) and the last axis for the time
planes ``[C,T,P]`` and the resident spectra ``[C,B,T,P]``
(:func:`pixel_axis`).  Every function here returns contiguous tensors:
the kernels' wrappers refuse views.
"""

from __future__ import annotations

import numpy as np
import torch

from firebird_tpu_torch.ccd.round_state import PHASE_DONE

# The accounting unit of the occupancy capture: the lanes a round pays for
# are the COMPACT_LANE_BLOCK-wide blocks that hold an active lane
# (kernel.COMPACT_LANE_BLOCK).
COMPACT_LANE_BLOCK = 512

# Loop-state keys permuted along their pixel axis by a compaction
# (kernel._COMPACT_PIXEL_KEYS); the result buffers ``bufs``, the carried
# residents ``resp`` and the permutation ``perm`` move with them.
PIXEL_KEYS = ("phase", "cur_i", "cur_k", "alive", "included", "coefs", "rmse",
              "n_last_fit", "first_seg", "nseg")
# Per-pixel tensors whose pixel axis is the last one: the time planes
# [C,T,P] and the resident spectra [C,B,T,P].
_PIXEL_LAST = frozenset(("alive", "included", "Yt", "Yd"))


def pixel_axis(key: str) -> int:
    """The pixel axis of the loop tensor ``key``: -1 for the time planes
    and resident spectra, 1 for everything else."""
    return -1 if key in _PIXEL_LAST else 1


def dense_prefix_perm(active):
    """Stable dense-prefix permutation of each chip's lanes from ``active``
    [C,P] bool: gather indices g [C,P] int64 with out[c,i] = in[c,g[c,i]],
    active lanes first, original order kept within each class —
    kernel._dense_prefix_perm."""
    C, P = active.shape
    a = active.to(torch.int64)
    na = a.sum(1, keepdim=True)
    tgt = torch.where(active, a.cumsum(1) - 1, na + (1 - a).cumsum(1) - 1)
    iota = torch.arange(P, device=active.device).expand(C, P)
    return torch.empty_like(tgt).scatter_(1, tgt, iota)


def take_pixels(a, g, axis):
    """Per-chip lane gather along ``axis``: out[c,...,i,...] =
    a[c,...,g[c,i],...] for gather indices ``g`` [C,P'] —
    kernel._take_pixels."""
    axis = axis % a.ndim
    shape = [1] * a.ndim
    shape[0], shape[axis] = g.shape[0], g.shape[1]
    size = list(a.shape)
    size[axis] = g.shape[1]
    return torch.gather(a, axis, g.reshape(shape).expand(size)).contiguous()


def slice_pixels(a, n, axis):
    """The first ``n`` lanes of each chip along ``axis``, as a contiguous
    tensor (the stage-2 bucket's static slice)."""
    return a.narrow(axis % a.ndim, 0, n).contiguous()


def compact_state(st):
    """One compaction sweep: the loop state ``st`` with every per-pixel
    carry — the :data:`PIXEL_KEYS`, ``bufs``, the residents ``resp`` and
    the permutation ``perm`` — permuted so that each chip's working lanes
    form a dense prefix — kernel._compact_state."""
    g = dense_prefix_perm(st["phase"] != PHASE_DONE)
    out = {k: take_pixels(st[k], g, pixel_axis(k)) for k in PIXEL_KEYS}
    out["bufs"] = tuple(take_pixels(b, g, 1) for b in st["bufs"])
    out["resp"] = {k: take_pixels(v, g, pixel_axis(k))
                   for k, v in st["resp"].items()}
    out["perm"] = take_pixels(st["perm"], g, 1)
    return dict(st, **out)


def unpermute(a, perm, axis):
    """Invert a carried permutation at loop exit: out[c,...,perm[c,p],...]
    = a[c,...,p,...] along ``axis`` — kernel._unpermute."""
    C, P = perm.shape
    iota = torch.arange(P, device=perm.device).expand(C, P)
    inv = torch.empty_like(perm).scatter_(1, perm, iota)
    return take_pixels(a, inv, axis)


def block_widths(P: int) -> np.ndarray:
    """The widths of the COMPACT_LANE_BLOCK-wide blocks of ``P`` lanes
    (the last block may be ragged) — kernel._block_widths."""
    nb = -(-P // COMPACT_LANE_BLOCK)
    w = np.full(nb, COMPACT_LANE_BLOCK, np.int32)
    w[-1] = P - (nb - 1) * COMPACT_LANE_BLOCK
    return w


def paid_lanes(phase):
    """Per-chip lanes [C] int32 a round pays for under the per-block skip
    guards: the COMPACT_LANE_BLOCK-wide blocks that hold a lane with phase
    != DONE, weighted by their widths — kernel._paid_lanes.  This is the
    guards' accounting model: this package runs no per-block guards, so
    its kernels compute every lane of the current width."""
    C, P = phase.shape
    widths = block_widths(P)
    nb = widths.shape[0]
    act = torch.nn.functional.pad(phase != PHASE_DONE,
                                  (0, nb * COMPACT_LANE_BLOCK - P))
    blk = act.reshape(C, nb, COMPACT_LANE_BLOCK).any(-1)
    w = torch.from_numpy(widths).to(phase.device)
    return (blk * w).sum(-1, dtype=torch.int32)
