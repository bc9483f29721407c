"""Carrying detector state between the JAX package and this one.

CCDC learns no weights: what the two implementations share is the science
constants (``params``) and the event loop's state.  These functions move
that state across as numpy arrays, so the same mid-loop round state can be
fed to both packages.

The JAX package keeps one chip's state as ``[P, ...]`` arrays with
``[P, T]`` time planes, ``[B, T, P]`` resident spectra and flat
``[P, S*k]`` result buffers (``kernel._prologue``'s ``res`` and ``state``
dicts; batched under ``vmap`` they gain a leading chip axis).  This
package keeps ``[C, ...]`` tensors with ``[C, T, P]`` time planes and
``[C, P, S, ...]`` buffers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from firebird_tpu_torch.ccd import kernel

# Keys whose JAX layout is a [P, T] time plane ([C, T, P] here).
_PLANES = ("alive", "included", "alt_mask")
_INTS = ("phase", "cur_i", "cur_k", "n_last_fit", "nseg", "procedure")
_BOOLS = ("first_seg", "is_std", "is_alt") + _PLANES
_BUF_KEYS = ("meta", "rmse", "mag", "coef")


def _tensor(a, dtype, device):
    # A contiguous copy: the arrays may be read-only or transposed views of
    # another framework's buffers.
    return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)


def _from_one(key, a, device):
    a = np.asarray(a)
    if key in _PLANES:
        a = np.swapaxes(a, -1, -2)
    if key in _BOOLS:
        return _tensor(a, torch.bool, device)
    if key in _INTS:
        return _tensor(a, torch.int32, device)
    if key in ("Yt", "Yd"):
        return _tensor(a, torch.int16, device)
    return _tensor(a, torch.float32, device)


def _to_one(key, v):
    a = v.cpu().numpy()
    return np.swapaxes(a, -1, -2) if key in _PLANES else a


def round_state_from_numpy(res: dict, st: dict, device="cpu"):
    """JAX ``_prologue`` (res, state) as numpy -> this package's (res,
    state) tensors on ``device``.  Takes one chip (``res["X"]`` [T,8]) or a
    batch ([C,T,8]); the result always has the chip axis.  Keys absent
    from the input are absent from the output; the JAX-only ``Y``/``XX``
    views are dropped."""
    batched = np.asarray(res["X"]).ndim == 3
    add = (lambda a: np.asarray(a)) if batched else (lambda a: np.asarray(a)[None])
    res_t = {k: _from_one(k, add(v), device) for k, v in res.items()
             if k not in ("Y", "XX")}
    st_t = {k: _from_one(k, add(v), device) for k, v in st.items()
            if k != "bufs"}
    if "bufs" in st:
        st_t["bufs"] = bufs_from_flat(tuple(add(b) for b in st["bufs"]),
                                      st_t["coefs"].shape[2], device)
    return res_t, st_t


def round_state_to_numpy(res: dict, st: dict):
    """The inverse of :func:`round_state_from_numpy`: batched numpy dicts
    in the JAX layout (leading chip axis)."""
    res_n = {k: _to_one(k, v) for k, v in res.items()}
    st_n = {k: _to_one(k, v) for k, v in st.items() if k != "bufs"}
    if "bufs" in st:
        st_n["bufs"] = bufs_to_flat(st["bufs"])
    return res_n, st_n


def bufs_from_flat(bufs, B: int, device="cpu") -> tuple:
    """The JAX package's flat result buffers (meta [P,S*6], rmse and mag
    [P,S*B], coef [P,S*B*8]; or with a leading chip axis) -> this
    package's (meta [C,P,S,6], rmse [C,P,S,B], mag [C,P,S,B], coef
    [C,P,S,B,8]) float32 tensors."""
    meta, rmse, mag, coef = (np.asarray(b) for b in bufs)
    if meta.ndim == 2:
        meta, rmse, mag, coef = (b[None] for b in (meta, rmse, mag, coef))
    C, P = meta.shape[:2]
    S = meta.shape[-1] // 6
    K = coef.shape[-1] // (S * B)
    shapes = ((C, P, S, 6), (C, P, S, B), (C, P, S, B), (C, P, S, B, K))
    return tuple(_tensor(b.reshape(s), torch.float32, device)
                 for b, s in zip((meta, rmse, mag, coef), shapes))


def bufs_to_flat(bufs) -> tuple:
    """The inverse of :func:`bufs_from_flat`: flat [C,P,S*k] numpy
    arrays."""
    return tuple(b.cpu().numpy().reshape(b.shape[0], b.shape[1], -1)
                 for b in bufs)


def plane_from_numpy(a, dtype=torch.bool, device="cpu"):
    """A JAX time plane [P,T] (or [C,P,T]) -> a [C,T,P] tensor."""
    a = np.asarray(a)
    return _tensor(np.swapaxes(a if a.ndim == 3 else a[None], -1, -2),
                   dtype, device)


def plane_to_numpy(v) -> np.ndarray:
    """A [C,T,P] tensor -> the JAX layout [C,P,T]."""
    return np.swapaxes(v.cpu().numpy(), -1, -2)


def segments_from_numpy(seg, device="cpu") -> kernel.ChipSegments:
    """A ChipSegments of either package (fields as arrays) -> this
    package's ChipSegments of tensors on ``device``.  The layouts agree
    field by field; fields this package does not carry are dropped."""
    out = {}
    for f in dataclasses.fields(kernel.ChipSegments):
        v = getattr(seg, f.name, None)
        out[f.name] = None if v is None else torch.from_numpy(
            np.ascontiguousarray(np.asarray(v))).to(device)
    return kernel.ChipSegments(**out)


segments_to_numpy = kernel.segments_to_numpy


def stream_state_from_numpy(arrays, device="cpu"):
    """A stream state as numpy arrays (a dict, or an object with the
    fields as attributes: either package's StreamState) -> this package's
    ``incremental.StreamState`` of tensors on ``device``, dtypes kept."""
    from firebird_tpu_torch.ccd import incremental

    get = (arrays.__getitem__ if isinstance(arrays, dict)
           else lambda f: getattr(arrays, f))
    return incremental.StreamState(*(
        torch.tensor(np.array(get(f)), device=device)
        for f in incremental.STATE_FIELDS))


def stream_state_to_numpy(st) -> dict:
    """The inverse of :func:`stream_state_from_numpy`: {field: array}."""
    from firebird_tpu_torch.ccd import incremental

    return {f: getattr(st, f).cpu().numpy() for f in incremental.STATE_FIELDS}
