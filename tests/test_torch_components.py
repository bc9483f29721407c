"""The port's component route against the JAX package, on the CPU.

- The plain versions of ``lasso_cd``, ``monitor_chain`` and ``tmask_bad``
  against the Pallas kernels in interpret mode, on inputs made from a seed
  with numpy (P=16, T=24, W=16).
- ``lasso_fit_plain``, now ``gram_plain`` + ``lasso_cd_plain`` +
  ``rmse_plain``, bit for bit against the one-piece form it had.
- ``detect_packed(pallas="lasso,monitor,tmask")`` against the JAX
  package's f32, compact-off ``detect_packed`` on the three tiny
  configurations of tests/test_torch_detect.py.
- ``kernel.pallas_components``: FIREBIRD_PALLAS resolved as the JAX
  package's ``use_pallas`` resolves it, and the values it refuses.
"""

import dataclasses
import functools
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firebird_tpu.ccd import harmonic, pallas_ops
from firebird_tpu.ccd import kernel as jk
from firebird_tpu_torch.ccd import convert, cuda_ops, params
from firebird_tpu_torch.ccd import kernel as tk
from firebird_tpu_torch.ccd.primitives import dot_cols, tree_sum
from firebird_tpu_torch.ccd.sensor import chi2_thresholds

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_detect import CONFIGS, _packed  # noqa: E402

COMPONENTS = "lasso,monitor,tmask"
B, T, K, P, W = 7, 24, 8, 16, 16
CHANGE_THR, OUTLIER_THR = chi2_thresholds(5)


@pytest.fixture(autouse=True)
def _clear_env(monkeypatch):
    # The JAX references trace their default XLA paths; the port's route
    # comes from each call's pallas= only.
    monkeypatch.delenv("FIREBIRD_PALLAS", raising=False)
    monkeypatch.delenv("FIREBIRD_FUSED_FIT", raising=False)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))[None]


def _fit_inputs(seed):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.integers(729000, 730500, T)).astype(np.float64)
    X = harmonic.design_matrix(t, t[0], K).astype(np.float32)
    Yt = rng.integers(0, 8000, (B, T, P)).astype(np.int16)
    w = (rng.random((T, P)) < 0.8).astype(np.float32)
    w[:, 3] = 0.0                                   # an empty window
    mask = np.arange(K)[None, :] < rng.choice([4, 6, 8], P)[:, None]
    return _t(Yt), _t(w), _t(X), _t(mask)


# ---------------------------------------------------------------------------
# lasso_cd
# ---------------------------------------------------------------------------

def test_lasso_cd_plain_matches_pallas():
    Yt, w, X, mask = _fit_inputs(21)
    G, c, _ = cuda_ops.gram_plain(Yt, w, X)
    diag = torch.diagonal(G, dim1=-2, dim2=-1).clamp_min(1e-12).contiguous()
    want = np.asarray(pallas_ops.lasso_cd(
        jnp.asarray(G[0].numpy()), jnp.asarray(c[0].numpy()),
        jnp.asarray(diag[0].numpy()), jnp.asarray(mask[0].numpy()),
        interpret=True))
    got = cuda_ops.lasso_cd(G, c, diag, mask)[0].numpy()
    assert np.abs(want).max() > 100
    # Relative to each band's coefficient vector: a soft-thresholded
    # near-zero coefficient carries error on its siblings' scale.
    scale = np.maximum(np.abs(want).max(-1, keepdims=True), 1.0)
    assert (np.abs(got - want) / scale).max() <= 1e-5
    off = np.broadcast_to(~mask[0].numpy()[:, None, :], got.shape)
    assert not got[3].any() and not got[off].any()


def _lasso_fit_one_piece(Yt, w, X, coefmask, with_rmse=True):
    """lasso_fit_plain as it stood before it was split: Gram, CD loop and
    RMSE in one function (the RMSE's sum over time in tree_sum's fixed
    order, which makes a pixel's RMSE independent of the batch width)."""
    C, B, T, P = Yt.shape
    n = w.sum(1).clamp_min(1.0)
    XX = (X[:, :, :, None] * X[:, :, None, :]).reshape(C, T, K * K)
    G = torch.einsum("ctp,ctk->cpk", w, XX) / n[..., None]
    c = torch.stack([torch.einsum("ctp,ctk->cpk", Yt[:, b].float() * w, X)
                     for b in range(B)], 2) / n[:, :, None, None]
    tiny = torch.tensor(1e-12, dtype=G.dtype, device=G.device)
    diag = [torch.maximum(G[..., j * K + j], tiny)[..., None] for j in range(K)]
    mask = [coefmask[..., j][..., None] for j in range(K)]
    Gjk = [[G[..., j * K + k][..., None] for k in range(K)] for j in range(K)]
    cj = [c[..., j] for j in range(K)]
    zero = torch.zeros_like(cj[0])
    b = [zero] * K
    for _ in range(params.LASSO_ITERS):
        for j in range(K):
            acc = Gjk[j][0] * b[0]
            for k in range(1, K):
                acc = acc + Gjk[j][k] * b[k]
            rho = cj[j] - acc + diag[j] * b[j]
            if j == 0:
                bj = rho / diag[0]
            else:
                bj = torch.sign(rho) * (rho.abs() - params.LASSO_ALPHA
                                        ).clamp_min(0.0) / diag[j]
            b[j] = torch.where(mask[j], bj, zero)
    beta = torch.stack(b, -1)
    if not with_rmse:
        return beta, torch.zeros(C, P, B, dtype=w.dtype, device=w.device)
    rmse = []
    for bb in range(B):
        pred = dot_cols(beta[:, None, :, bb, :], X[:, :, None, :])
        r = Yt[:, bb].float() - pred
        rmse.append(torch.sqrt((tree_sum(r * r * w) / n).clamp_min(0.0)))
    return beta, torch.stack(rmse, -1)


@pytest.mark.parametrize("with_rmse", [True, False])
def test_split_lasso_fit_plain_is_bit_identical(with_rmse):
    args = _fit_inputs(22)
    got = cuda_ops.lasso_fit_plain(*args, with_rmse=with_rmse)
    want = _lasso_fit_one_piece(*args, with_rmse=with_rmse)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# monitor_chain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [31, 33])
def test_monitor_chain_plain_matches_pallas(seed):
    rng = np.random.default_rng(seed)
    alive = rng.random((P, T)) < 0.85
    s = rng.gamma(2.0, 3.0, (P, T)).astype(np.float32)
    s[:4, T // 2:] += 40.0                          # breaks
    included = (rng.random((P, T)) < 0.4) & alive
    cur_k = rng.integers(0, T // 2, P).astype(np.int32)
    # Small last-fit counts refit early; large ones never do.
    nlf = np.where(rng.random(P) < 0.5, rng.integers(1, 12, P),
                   1000).astype(np.int32)
    in_mon = rng.random(P) < 0.8
    rank = np.cumsum(alive, -1) - 1
    want = pallas_ops.monitor_chain(
        jnp.asarray(s), jnp.asarray(alive), jnp.asarray(included),
        jnp.asarray(rank), jnp.asarray(cur_k), jnp.asarray(nlf),
        jnp.asarray(in_mon), change_thr=CHANGE_THR, outlier_thr=OUTLIER_THR,
        interpret=True)
    got = cuda_ops.monitor_chain(
        convert.plane_from_numpy(s, torch.float32),
        convert.plane_from_numpy(alive), convert.plane_from_numpy(included),
        _t(cur_k), _t(nlf), _t(in_mon), change_thr=CHANGE_THR,
        outlier_thr=OUTLIER_THR)
    assert all(np.asarray(want[k]).any()
               for k in ("is_tail", "is_brk", "is_refit"))
    assert set(got) == set(want)
    for k in want:
        g = (convert.plane_to_numpy(got[k]) if k in ("inc_q", "rem_q")
             else got[k].numpy())[0]
        np.testing.assert_array_equal(g, np.asarray(want[k]), err_msg=k)


# ---------------------------------------------------------------------------
# tmask_bad
# ---------------------------------------------------------------------------

def test_tmask_bad_plain_matches_pallas():
    rng = np.random.default_rng(33)
    Xtw = rng.normal(0, 1, (P, W, 5)).astype(np.float32)
    Xtw[:, :, 0] = 1.0
    Y2 = (400 + 80 * rng.normal(0, 1, (P, 2, W))).astype(np.float32)
    Y2[rng.random((P, 2, W)) < 0.06] += 900
    nwin = rng.integers(10, W + 1, P)
    nwin[2] = 0                                     # no window
    w = (np.arange(W)[None, :] < nwin[:, None]).astype(np.float32)
    Y2[5] = 444.0                      # constant series -> singular Gram
    vario2 = np.abs(rng.normal(40, 10, (P, 2))).astype(np.float32)
    want = np.asarray(pallas_ops.tmask_bad(
        jnp.asarray(Xtw), jnp.asarray(Y2), jnp.asarray(w),
        jnp.asarray(vario2), interpret=True))
    got = cuda_ops.tmask_bad(_t(Xtw), _t(Y2), _t(w), _t(vario2))[0].numpy()
    assert want.any() and not want[[2, 5]].any()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# The component route
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_ref(name):
    jp, _ = _packed(name)
    return jk.detect_packed(jp, dtype=jnp.float32, compact=False)


@functools.lru_cache(maxsize=None)
def _route(name, fused=0):
    _, tp = _packed(name)
    return tk.detect_packed(tp, device="cpu", pallas=COMPONENTS, fused=fused)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_component_route_decisions_match_jax(name):
    ref = _jax_ref(name)
    g = convert.segments_to_numpy(_route(name))
    for f in ("n_segments", "procedure", "mask", "seg_meta", "rounds",
              "round_counts"):
        np.testing.assert_array_equal(getattr(g, f),
                                      np.asarray(getattr(ref, f)), err_msg=f)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_component_route_floats_within_envelope(name):
    ref = _jax_ref(name)
    g = convert.segments_to_numpy(_route(name))
    np.testing.assert_allclose(g.seg_rmse, np.asarray(ref.seg_rmse),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(g.seg_mag, np.asarray(ref.seg_mag),
                               rtol=5e-3, atol=1e-2)
    np.testing.assert_array_equal(g.vario, np.asarray(ref.vario))
    c_r = np.asarray(ref.seg_coef)
    scale = np.maximum(np.abs(c_r).max(-1, keepdims=True), 1.0)
    assert (np.abs(g.seg_coef - c_r) / scale).max() <= 1e-4


def _spy_ops(calls):
    def spy(name):
        fn = getattr(cuda_ops.PLAIN, name)
        return lambda *a, **k: calls.append(name) or fn(*a, **k)

    return types.SimpleNamespace(**{n: spy(n) for n in vars(cuda_ops.PLAIN)})


@pytest.mark.parametrize("fused", [0, 1])
def test_component_route_calls_the_component_kernels(fused):
    """The component route calls lasso_cd (every fit, the prologue's
    included), monitor_chain and tmask_bad, and none of the kernels they
    stand for; FIREBIRD_FUSED_FIT=1 composes with it as in JAX (the close
    and refit go to fused_fit_close), to the same result."""
    calls = []
    _, tp = _packed("default")
    seg = tk.detect_packed(tp, device="cpu", ops=_spy_ops(calls),
                           pallas=COMPONENTS, fused=fused)
    want = {"lasso_cd", "monitor_chain", "tmask_bad"}
    want |= {"fused_fit_close"} if fused else set()
    assert set(calls) == want
    base = _route("default")
    for f in dataclasses.fields(seg):
        va, vb = getattr(seg, f.name), getattr(base, f.name)
        assert (va is None and vb is None) or torch.equal(va, vb), f.name


# ---------------------------------------------------------------------------
# FIREBIRD_PALLAS
# ---------------------------------------------------------------------------

_PICKS = (("fit", "lasso"), ("score", "monitor"), ("init", "tmask"))


@pytest.mark.parametrize("value", [
    None, "1", "fit,score,init", COMPONENTS, "fit,monitor,tmask",
    "lasso,score,tmask", "lasso,monitor,init,fit", "fit,score,init,lasso"])
def test_pallas_components_resolve_as_jax(monkeypatch, value):
    """Unset, the port reads FIREBIRD_PALLAS as "1" (the JAX package's
    unset is its XLA route, which the port does not have)."""
    monkeypatch.setenv("FIREBIRD_PALLAS", "1" if value is None else value)
    want = tuple(fused if jk.use_pallas(fused) else component
                 for fused, component in _PICKS)
    assert not jk.use_pallas("mega")
    if value is None:
        monkeypatch.delenv("FIREBIRD_PALLAS")
    ops = tk.pallas_components()
    assert not ops.mega and ops.components == want
    # The explicit argument reads the same as the environment.
    monkeypatch.setenv("FIREBIRD_PALLAS", "mega")
    assert tk.pallas_components(value or "1").components == want


@pytest.mark.parametrize("value", ["mega", "mega,fit,score", COMPONENTS
                                   + ",mega"])
def test_mega_supersedes_every_component(monkeypatch, value):
    monkeypatch.setenv("FIREBIRD_PALLAS", value)
    assert jk.use_pallas("mega")
    ops = tk.pallas_components()
    assert ops.mega and ops.components == ("mega",)
    assert ops.detect_mega is cuda_ops.KERNELS.detect_mega
    assert ops.lasso_fit is cuda_ops.KERNELS.lasso_fit
    assert tk.pallas_components(value, cuda_ops.PLAIN).detect_mega \
        is cuda_ops.detect_mega_plain


@pytest.mark.parametrize("value", ["0", "", "lasso,monitor", "fit,score",
                                   "score,init,tmask", "lasso,monitor,xyz"])
def test_pallas_values_without_a_kernel_are_refused(value):
    with pytest.raises(ValueError, match="FIREBIRD_PALLAS"):
        tk.pallas_components(value)
    _, tp = _packed("default")
    with pytest.raises(ValueError, match="FIREBIRD_PALLAS"):
        tk.detect_packed(tp, device="cpu", pallas=value)


@pytest.mark.parametrize("value", ["1", COMPONENTS, "mega"])
def test_a_resolved_route_is_resolved_once(monkeypatch, value):
    """detect_packed resolves the route once and hands it down: a resolved
    route comes back as it is, whatever FIREBIRD_PALLAS says by then, and
    refuses a second pallas= beside it."""
    route = tk.pallas_components(value)
    monkeypatch.setenv("FIREBIRD_PALLAS", "0")
    assert tk.pallas_components(None, route) is route
    with pytest.raises(ValueError, match="resolved route"):
        tk.pallas_components(value, route)
    seen = []
    monkeypatch.setattr(tk, "detect_staged",
                        lambda *a, ops, **k: seen.append(ops))
    _, tp = _packed("default")
    monkeypatch.setenv("FIREBIRD_PALLAS", value)
    tk.detect_packed(tp, device="cpu", check_capacity=False)
    assert seen[0].components == route.components
