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
    # A copy: the arrays may be read-only views of another framework's
    # buffers.
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


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
        C, P = st_t["nseg"].shape
        B = st_t["coefs"].shape[2]
        K = st_t["coefs"].shape[3]
        meta, rmse, mag, coef = (add(b) for b in st["bufs"])
        S = meta.shape[-1] // 6
        shapes = ((C, P, S, 6), (C, P, S, B), (C, P, S, B), (C, P, S, B, K))
        st_t["bufs"] = tuple(_tensor(np.asarray(b).reshape(s), torch.float32,
                                     device)
                             for b, s in zip((meta, rmse, mag, coef), shapes))
    return res_t, st_t


def round_state_to_numpy(res: dict, st: dict):
    """The inverse of :func:`round_state_from_numpy`: batched numpy dicts
    in the JAX layout (leading chip axis)."""
    res_n = {k: _to_one(k, v) for k, v in res.items()}
    st_n = {k: _to_one(k, v) for k, v in st.items() if k != "bufs"}
    if "bufs" in st:
        st_n["bufs"] = tuple(b.cpu().numpy().reshape(b.shape[0], b.shape[1], -1)
                             for b in st["bufs"])
    return res_n, st_n


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
