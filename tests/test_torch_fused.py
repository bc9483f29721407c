"""The port's fused round routes against the JAX package, on the CPU.

- The plain versions of ``fused_fit_close`` and ``fused_round`` against
  the Pallas kernels in interpret mode, on inputs made from a seed with
  numpy at the shapes of tests/test_fuse.py (B=7, T=24, S=3, P=16), the
  JAX side in pixel blocks of 8 so its per-block gates are exercised; and
  the same on the 12-band Sentinel-2 layout.
- ``detect_packed(fused=1)`` byte-identical to ``fused=0``.
- ``detect_packed(fused="mon")`` against the JAX package's
  ``fused="mon"`` route.
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
from firebird_tpu.ccd.sensor import LANDSAT_ARD, SENTINEL2
from firebird_tpu_torch.ccd import convert, cuda_ops
from firebird_tpu_torch.ccd import kernel as tk
from firebird_tpu_torch.ccd.sensor import SENTINEL2 as T_S2
from firebird_tpu_torch.ccd.sensor import chi2_thresholds

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_detect import CONFIGS, _packed  # noqa: E402

B, T, K, S, P, BP = 7, 24, 8, 3, 16, 8
CHANGE_THR, OUTLIER_THR = chi2_thresholds(5)


@pytest.fixture(autouse=True)
def _clear_env(monkeypatch):
    # The JAX references trace their default XLA paths; the route comes
    # from each call's fused= only.
    monkeypatch.delenv("FIREBIRD_PALLAS", raising=False)
    monkeypatch.delenv("FIREBIRD_FUSED_FIT", raising=False)


def _t(a, dtype=None):
    a = torch.from_numpy(np.ascontiguousarray(a))[None]
    return a if dtype is None else a.to(dtype)


def _series(rng, nb=B):
    """Days, the harmonic design and int16 spectra [nb,T,P] made from a
    per-pixel model (returned) plus noise; pixels 1, 4 and 9 step up by
    800 from the middle of the series (a break)."""
    t = np.sort(rng.choice(np.arange(729000, 729800), T, replace=False))
    X = harmonic.design_matrix(t.astype(np.float64), float(t[0]),
                               K).astype(np.float32)
    beta = np.zeros((P, nb, K), np.float32)
    beta[..., 0] = rng.uniform(500, 3000, (P, nb))
    beta[..., 2:6] = rng.normal(0, 150, (P, nb, 4))
    Y = np.einsum("pbk,tk->btp", beta, X) + rng.normal(0, 20, (nb, T, P))
    Y[:, T // 2:, [1, 4, 9]] += 800
    return t.astype(np.float32), X, Y.astype(np.int16), beta


def _bufs(rng, nb=B):
    return tuple(rng.standard_normal((P, S * k)).astype(np.float32)
                 for k in (6, nb, nb, nb * K))


def _compare_bufs(got, want, mag_tol=None):
    for i, (g, w) in enumerate(zip(convert.bufs_to_flat(got), want)):
        if i == 2 and mag_tol:
            np.testing.assert_allclose(g[0], np.asarray(w), **mag_tol)
        else:
            np.testing.assert_array_equal(g[0], np.asarray(w),
                                          err_msg=f"buffer {i}")


def test_fused_fit_close_plain_matches_pallas():
    _check_fused_fit_close(np.random.default_rng(3), B)


def test_fused_fit_close_plain_matches_pallas_sentinel2():
    """The 12-band layout (fused_fit_close takes no band roles: every band
    is fitted and closed)."""
    _check_fused_fit_close(np.random.default_rng(13), T_S2.n_bands)


def _check_fused_fit_close(rng, nb):
    t, X, Yt, beta = _series(rng, nb)
    w_fit = (rng.random((P, T)) < 0.7).astype(np.float32)
    do_fit = rng.random(P) < 0.5
    n_full = rng.integers(12, 30, P).astype(np.int32)
    incm = rng.random((P, T)) < 0.5
    incm[5] = False                                 # no included obs
    coefs = (beta + rng.normal(0, 5, beta.shape)).astype(np.float32)
    rmse = rng.uniform(10, 40, (P, nb)).astype(np.float32)
    mags = rng.normal(0, 300, (P, nb)).astype(np.float32)
    kind = rng.integers(0, 3, P)                    # 0 none, 1 tail, 2 brk
    kind[[2, 5]] = 1
    kind[[1, 4]] = 2
    is_tail, is_brk = kind == 1, kind == 2
    pos_ev = rng.integers(0, T, P).astype(np.int32)
    n_exceed = rng.integers(0, 7, P).astype(np.int32)
    first_seg = rng.random(P) < 0.5
    nseg = rng.integers(0, S + 1, P).astype(np.int32)   # S: past capacity
    nseg[[1, 2]] = [0, S]
    bufs = _bufs(rng, nb)

    want = pallas_ops.fused_fit_close(
        jnp.asarray(Yt), jnp.asarray(X), jnp.asarray(t), jnp.asarray(w_fit),
        jnp.asarray(do_fit), jnp.asarray(n_full), jnp.asarray(incm),
        jnp.asarray(coefs), jnp.asarray(rmse), jnp.asarray(mags),
        jnp.asarray(is_tail), jnp.asarray(is_brk), jnp.asarray(pos_ev),
        jnp.asarray(n_exceed), jnp.asarray(first_seg), jnp.asarray(nseg),
        tuple(jnp.asarray(b) for b in bufs), S=S, block_p=BP, interpret=True)
    got = cuda_ops.fused_fit_close(
        _t(Yt), _t(X), _t(t), convert.plane_from_numpy(w_fit, torch.float32),
        _t(do_fit), _t(n_full), convert.plane_from_numpy(incm), _t(coefs),
        _t(rmse), _t(mags), _t(is_tail), _t(is_brk), _t(pos_ev),
        _t(n_exceed), _t(first_seg), _t(nseg),
        convert.bufs_from_flat(bufs, nb))
    _compare_bufs(got[0], want[0])
    np.testing.assert_array_equal(got[1][0].numpy(), np.asarray(want[1]))
    # The Gram sums run in another order than the Pallas dot; 50 CD sweeps
    # amplify the f32 ulps (the lasso_fit envelope).
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g[0].numpy(), np.asarray(w), rtol=1e-2,
                                   atol=1e-2)
    assert int(got[1].sum()) == int(nseg.sum() + (is_tail | is_brk).sum())


def _round_inputs(rng, nb=B):
    t, X, Yt, beta = _series(rng, nb)
    alive = rng.random((P, T)) < 0.9
    cur_k = rng.integers(4, 10, P).astype(np.int32)
    included = alive & (np.arange(T)[None, :] < cur_k[:, None])
    # Small last-fit counts refit early; large ones never do.
    n_last_fit = np.where(rng.random(P) < 0.4, included.sum(1),
                          1000).astype(np.int32)
    # Block 0 (pixels 0-7): six monitoring pixels, one initialized, one
    # idle.  Block 1 (8-15): monitoring pixels 9 and 12, one initialized,
    # the rest idle.
    in_mon = np.zeros(P, bool)
    in_mon[[0, 1, 2, 3, 4, 5, 9, 12]] = True
    init_ok = np.zeros(P, bool)
    init_ok[[6, 14]] = True
    w_stab = alive & (rng.random((P, T)) < 0.7) & init_ok[:, None]
    rmse = np.full((P, nb), 20.0, np.float32)
    vario = rng.uniform(15, 25, (P, nb)).astype(np.float32)
    return dict(
        Yt=Yt, X=X, t=t, alive=alive, included=included, cur_k=cur_k,
        n_last_fit=n_last_fit, in_mon=in_mon, coefs=beta, rmse=rmse,
        vario=vario, init_ok=init_ok, w_stab=w_stab,
        n_ok=w_stab.sum(1).astype(np.int32),
        first_seg=rng.random(P) < 0.5,
        nseg=rng.integers(0, S + 1, P).astype(np.int32),
        bufs=_bufs(rng, nb))


_PLANES = ("alive", "included", "w_stab")


def test_fused_round_plain_matches_pallas():
    _check_fused_round(np.random.default_rng(9), LANDSAT_ARD, None)


def test_fused_round_plain_matches_pallas_sentinel2():
    """The 12-band layout: scored on detection bands 2, 3, 7, 10, 11."""
    _check_fused_round(np.random.default_rng(9), SENTINEL2, T_S2)


def _check_fused_round(rng, j_sensor, t_sensor):
    """fused_round_plain against the Pallas kernel on ``j_sensor``'s
    layout (``t_sensor`` the port's copy; None: the wrapper's default)."""
    a = _round_inputs(rng, j_sensor.n_bands)
    want = pallas_ops.fused_round(
        *(jnp.asarray(a[k]) for k in (
            "Yt", "X", "t", "alive", "included", "cur_k", "n_last_fit",
            "in_mon", "coefs", "rmse", "vario", "init_ok", "w_stab", "n_ok",
            "first_seg", "nseg")),
        tuple(jnp.asarray(b) for b in a["bufs"]), S=S, sensor=j_sensor,
        change_thr=CHANGE_THR, outlier_thr=OUTLIER_THR, block_p=BP,
        interpret=True)
    args = [convert.plane_from_numpy(a[k]) if k in _PLANES else _t(a[k])
            for k in ("Yt", "X", "t", "alive", "included", "cur_k",
                      "n_last_fit", "in_mon", "coefs", "rmse", "vario",
                      "init_ok", "w_stab", "n_ok", "first_seg", "nseg")]
    kw = {} if t_sensor is None else dict(sensor=t_sensor)
    got = cuda_ops.fused_round(*args,
                               convert.bufs_from_flat(a["bufs"],
                                                      j_sensor.n_bands),
                               change_thr=CHANGE_THR,
                               outlier_thr=OUTLIER_THR, **kw)
    ev_w, ev_g = want[4], got[4]
    # The inputs reach every event and both gates of each pixel block.
    kinds = [np.asarray(ev_w[k]) for k in ("is_tail", "is_brk", "is_refit")]
    assert all(k.any() for k in kinds)
    assert not np.asarray(ev_w["do_fit"])[[7, 8, 10]].any()

    # seg_mag: the in-kernel median of differently rounded residuals.
    _compare_bufs(got[0], want[0], mag_tol=dict(rtol=5e-3, atol=1e-2))
    np.testing.assert_array_equal(got[1][0].numpy(), np.asarray(want[1]))
    for g, w in zip(got[2:4], want[2:4]):
        np.testing.assert_allclose(g[0].numpy(), np.asarray(w), rtol=1e-2,
                                   atol=1e-2)
    for k in ("is_tail", "is_brk", "is_refit", "do_fit"):
        np.testing.assert_array_equal(ev_g[k][0].numpy(), np.asarray(ev_w[k]),
                                      err_msg=k)
    for k in ("included_mon", "alive_mon"):
        np.testing.assert_array_equal(convert.plane_to_numpy(ev_g[k])[0],
                                      np.asarray(ev_w[k]), err_msg=k)
    # pos_ev and n_full carry meaning only for monitoring (and init-ok)
    # pixels; elsewhere the Pallas kernel's value depends on whether the
    # pixel's block had a monitoring pixel, the port's is 0.
    mon, fit = a["in_mon"], a["in_mon"] | a["init_ok"]
    np.testing.assert_array_equal(ev_g["pos_ev"][0].numpy()[mon],
                                  np.asarray(ev_w["pos_ev"])[mon])
    np.testing.assert_array_equal(ev_g["n_full"][0].numpy()[fit],
                                  np.asarray(ev_w["n_full"])[fit])
    assert not ev_g["pos_ev"][0][~torch.from_numpy(mon)].any()


@functools.lru_cache(maxsize=None)
def _route(name, fused):
    _, tp = _packed(name)
    return tk.detect_packed(tp, device="cpu", fused=fused)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_route_1_byte_identical_to_route_0(name):
    a, b = _route(name, 0), _route(name, 1)
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        assert (va is None and vb is None) or torch.equal(va, vb), f.name


def test_route_mon_matches_jax_mon():
    jp, tp = _packed("two_changes_gaps")
    ref = jk.detect_packed(jp, dtype=jnp.float32, compact=False, fused="mon")
    g = convert.segments_to_numpy(_route("two_changes_gaps", "mon"))
    for f in ("n_segments", "procedure", "mask", "seg_meta", "rounds",
              "round_counts"):
        np.testing.assert_array_equal(getattr(g, f),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    assert g.n_segments.max() >= 2
    np.testing.assert_allclose(g.seg_rmse, np.asarray(ref.seg_rmse),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(g.seg_mag, np.asarray(ref.seg_mag),
                               rtol=5e-3, atol=1e-2)
    np.testing.assert_array_equal(g.vario, np.asarray(ref.vario))
    c_r = np.asarray(ref.seg_coef)
    scale = np.maximum(np.abs(c_r).max(-1, keepdims=True), 1.0)
    assert (np.abs(g.seg_coef - c_r) / scale).max() <= 1e-4


def test_fused_mode_resolution(monkeypatch):
    """The port's fused_mode resolves FIREBIRD_FUSED_FIT and explicit
    values as the JAX package does."""
    for v in ("", "0", "1", "mon", "2", "yes"):
        monkeypatch.setenv("FIREBIRD_FUSED_FIT", v)
        assert tk.fused_mode() == jk.fused_mode(), v
    monkeypatch.delenv("FIREBIRD_FUSED_FIT")
    assert tk.fused_mode() == 0
    for v, want in ((0, 0), (False, 0), (1, 1), (True, 1), ("mon", "mon"),
                    (2, "mon")):
        assert tk.fused_mode(v) == want, v


def test_fused_env_selects_the_route(monkeypatch):
    """detect_packed(fused=None) reads FIREBIRD_FUSED_FIT: with "mon" the
    round loop calls fused_round and never the monitor on its own."""
    calls = []

    def spy(name):
        fn = getattr(cuda_ops.PLAIN, name)
        return lambda *a, **k: calls.append(name) or fn(*a, **k)

    ops = types.SimpleNamespace(**{n: spy(n) for n in vars(cuda_ops.PLAIN)})
    _, tp = _packed("default")
    monkeypatch.setenv("FIREBIRD_FUSED_FIT", "mon")
    seg = tk.detect_packed(tp, device="cpu", ops=ops)
    assert "fused_round" in calls and "monitor_chain_scored" not in calls
    assert "fused_fit_close" not in calls
    for f in ("n_segments", "seg_meta", "mask"):
        assert torch.equal(getattr(seg, f),
                           getattr(_route("default", "mon"), f)), f
