"""Inputs of the eight guarded kernels for the guard's tests.

Shared by tests/test_torch_guards.py (the plain versions, on the CPU) and
tests/test_torch_cuda.py (the kernels, on the card); imports neither JAX nor
the JAX package.  A state holds every kernel's inputs for C chips of P
pixels, made from a seed with numpy: arbitrary values, not a consistent
loop state.  :func:`inert` gives the lanes outside a lane set the inputs a
compacted loop gives them; :func:`caller_active` is the set each caller
guards with (kernel.BatchLoop).
"""

import numpy as np
import torch

from firebird_tpu_torch.ccd import cuda_ops, harmonic, params
from firebird_tpu_torch.ccd.sensor import LANDSAT_ARD, chi2_thresholds

K = params.MAX_COEFS
GUARDED = ("lasso_fit", "lasso_cd", "tmask_bad", "monitor_chain_scored",
           "monitor_chain", "init_window", "fused_fit_close", "fused_round")
FUSED = ("fused_fit_close", "fused_round")
MON_KW = dict(zip(("change_thr", "outlier_thr"), chi2_thresholds(5)))


def state(seed, C=2, P=75, T=48, B=7, S=4, W=16, dev="cpu"):
    """Every guarded kernel's inputs for C chips of P pixels, T steps and B
    bands, from ``seed``; W is the Tmask screen's window."""
    rng = np.random.default_rng(seed)
    g = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    t = np.sort(rng.integers(729000, 731500, (C, T)), 1).astype(np.float64)
    X = np.stack([harmonic.design_matrix(tc, tc[0], K) for tc in t])
    Xt6 = np.stack([harmonic.design_matrix(tc, tc[0], params.TMASK_COEFS + 1)
                    for tc in t])
    Xt = np.concatenate([Xt6[..., :1], Xt6[..., 2:]], -1)
    Yt = g(rng.integers(0, 6000, (C, B, T, P)).astype(np.int16))
    alive = g(rng.random((C, T, P)) < 0.8)
    w = (alive & g(rng.random((C, T, P)) < 0.7)).float()
    coefmask = g(np.arange(K)[None, None, :]
                 < rng.choice([4, 6, 8], (C, P))[..., None])
    X = g(X.astype(np.float32))
    coefs, rmse = cuda_ops.lasso_fit_plain(Yt, w, X, coefmask)
    Y2 = rng.normal(1000, 200, (C, P, 2, W)).astype(np.float32)
    Y2[rng.random((C, P, 2, W)) < 0.05] += 900
    return dict(
        Yt=Yt, X=X, Xt=g(Xt.astype(np.float32)), t=g(t.astype(np.float32)),
        alive=alive, included=alive & g(rng.random((C, T, P)) < 0.4), w=w,
        coefmask=coefmask, coefs=coefs, rmse=rmse,
        vario=g(rng.uniform(20, 150, (C, P, B)).astype(np.float32)),
        cur_k=g(rng.integers(0, T // 2, (C, P)).astype(np.int32)),
        cur_i=g(rng.integers(0, T // 2, (C, P)).astype(np.int32)),
        n_last_fit=g(rng.integers(4, 40, (C, P)).astype(np.int32)),
        in_mon=g(rng.random((C, P)) < 0.6),
        in_init=g(rng.random((C, P)) < 0.6),
        init_ok=g(rng.random((C, P)) < 0.2),
        w_stab=alive & g(rng.random((C, T, P)) < 0.3),
        n_ok=g(rng.integers(6, 30, (C, P)).astype(np.int32)),
        do_fit=g(rng.random((C, P)) < 0.3),
        n_full=g(rng.integers(6, 30, (C, P)).astype(np.int32)),
        is_tail=g(rng.random((C, P)) < 0.2),
        is_brk=g(rng.random((C, P)) < 0.2),
        pos_ev=g(rng.integers(0, T, (C, P)).astype(np.int32)),
        n_exceed=g(rng.integers(0, 6, (C, P)).astype(np.int32)),
        mags=g(rng.normal(0, 300, (C, P, B)).astype(np.float32)),
        first_seg=g(rng.random((C, P)) < 0.5),
        nseg=g(rng.integers(0, S + 1, (C, P)).astype(np.int32)),
        bufs=tuple(g(rng.standard_normal((C, P, S) + k).astype(np.float32))
                   for k in ((6,), (B,), (B,), (B, K))),
        s=g(rng.gamma(2.0, 6.0, (C, T, P)).astype(np.float32)),
        Xtw=g(rng.normal(0, 1, (C, P, W, params.TMASK_COEFS))
              .astype(np.float32)),
        Y2=g(Y2), tm_n=g(rng.integers(0, W + 1, (C, P))),
        vario2=g(rng.uniform(20, 80, (C, P, 2)).astype(np.float32)),
        W=W), rng


def prefix(counts, P, dev="cpu"):
    """[C,P] bool: each chip's dense prefix of ``counts[c]`` lanes."""
    return (torch.arange(P, device=dev)[None, :]
            < torch.tensor(counts, device=dev)[:, None])


def inert(st, active):
    """The state as a compacted loop hands it to each kernel: the lanes
    outside ``active`` carry an empty window, no monitoring, no INIT, no
    fit and no close (what their callers give them)."""
    st = dict(st)
    st["w"] = st["w"] * active[:, None, :]
    st["w_stab"] = st["w_stab"] & active[:, None, :]
    for k in ("in_mon", "in_init", "init_ok", "do_fit", "is_tail", "is_brk"):
        st[k] = st[k] & active
    return st


def args(name, st, sensor=LANDSAT_ARD):
    """Kernel ``name``'s wrapper arguments and keywords on ``st``."""
    det = list(sensor.detection_bands)
    if name == "lasso_fit":
        return (st["Yt"], st["w"], st["X"], st["coefmask"]), {}
    if name == "lasso_cd":
        G, c, _ = cuda_ops.gram_plain(st["Yt"], st["w"], st["X"])
        diag = torch.diagonal(G, dim1=-2, dim2=-1).clamp_min(1e-12)
        return (G, c, diag.contiguous(), st["coefmask"]), {}
    if name == "tmask_bad":
        n = torch.where(st["in_init"], st["tm_n"], 0)
        w = (torch.arange(st["W"], device=n.device) < n[..., None]).float()
        return (st["Xtw"], st["Y2"], w, st["vario2"]), {}
    if name == "monitor_chain_scored":
        dden = torch.maximum(st["rmse"], st["vario"])[:, :, det].contiguous()
        return (st["Yt"][:, det].contiguous(),
                st["coefs"][:, :, det].contiguous(), dden, st["X"],
                st["alive"], st["included"], st["cur_k"], st["n_last_fit"],
                st["in_mon"]), MON_KW
    if name == "monitor_chain":
        return (st["s"], st["alive"], st["included"], st["cur_k"],
                st["n_last_fit"], st["in_mon"]), MON_KW
    if name == "init_window":
        return (st["alive"], st["cur_i"], st["in_init"], st["t"], st["X"],
                st["Xt"], st["Yt"], st["vario"]), dict(W=st["W"],
                                                        sensor=sensor)
    if name == "fused_fit_close":
        return (st["Yt"], st["X"], st["t"], st["w"], st["do_fit"],
                st["n_full"], st["included"], st["coefs"], st["rmse"],
                st["mags"], st["is_tail"], st["is_brk"], st["pos_ev"],
                st["n_exceed"], st["first_seg"], st["nseg"], st["bufs"]), {}
    assert name == "fused_round"
    return (st["Yt"], st["X"], st["t"], st["alive"], st["included"],
            st["cur_k"], st["n_last_fit"], st["in_mon"], st["coefs"],
            st["rmse"], st["vario"], st["init_ok"], st["w_stab"],
            st["n_ok"], st["first_seg"], st["nseg"], st["bufs"]), dict(
                MON_KW, sensor=sensor)


def caller_active(name, st):
    """The lane set kernel.BatchLoop guards ``name`` with, on ``st``."""
    if name in ("lasso_fit", "lasso_cd"):
        return st["w"].sum(1) > 0
    if name in ("monitor_chain_scored", "monitor_chain"):
        return st["in_mon"]
    if name in ("init_window", "tmask_bad"):
        return st["in_init"]
    if name == "fused_fit_close":
        return st["do_fit"] | st["is_tail"] | st["is_brk"]
    return st["in_mon"] | st["init_ok"]


def call(fns, name, a, kw, active=None, mixed=False):
    """``fns.<name>`` (cuda_ops.KERNELS or cuda_ops.PLAIN) on ``a``, the
    fused kernels' buffers cloned first (they are updated in place)."""
    if name in FUSED:
        a = a[:16] + (tuple(b.clone() for b in a[16]),)
    if mixed:
        kw = dict(kw, mixed=True)
    return getattr(fns, name)(*a, **kw, active=active)


def leaves(out):
    """An output's tensors with their paths: a dict's by key (the kernels'
    and the plain versions' dicts order their keys differently), a tuple's
    in order."""
    if torch.is_tensor(out):
        return [("", out)]
    if isinstance(out, dict):
        return sorted(out.items())
    return [(f"{i}{k}", v) for i, o in enumerate(out) for k, v in leaves(o)]


def assert_same(got, want, what, bits=True):
    """Every tensor of ``got`` equal to ``want``'s in dtype, shape and value;
    where ``bits``, bit for bit (+0 and -0 apart)."""
    g, w = leaves(got), leaves(want)
    assert [k for k, _ in g] == [k for k, _ in w], what
    for (k, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape, (what, k)
        if bits and a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), (what, k)


def lanes(v, mask):
    """The [C,P] lanes ``mask`` of an output ``v`` ([C,P,...] or a [C,T,P]
    plane, told apart by its shape against the mask's)."""
    if v.shape[:2] == mask.shape:
        return v[mask]
    return v.transpose(1, 2)[mask]
