"""The port's mega route against the JAX package, on the CPU.

- The plain version of ``detect_mega`` (the lockstep loop over the plain
  INIT block and the plain fused round) against the Pallas kernel in
  interpret mode, from one start state made with numpy: one chip of 16
  pixels, T=64, with breaks, Tmask spikes, refits and tails.
- ``detect_packed(pallas="mega")`` against the JAX package's f32,
  compact-off ``detect_packed`` on the three tiny configurations of
  tests/test_torch_detect.py, and against the port's route "mon".
- The mega route's calls, its supersession of the fused routes and its
  window-cap limit.
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
from firebird_tpu.ccd.sensor import LANDSAT_ARD
from firebird_tpu_torch.ccd import convert, cuda_ops, primitives
from firebird_tpu_torch.ccd import kernel as tk
from firebird_tpu_torch.ccd.sensor import chi2_thresholds


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_detect import CONFIGS, _packed  # noqa: E402

CHANGE_THR, OUTLIER_THR = chi2_thresholds(5)
PHASES = (cuda_ops.PHASE_INIT, cuda_ops.PHASE_MONITOR, cuda_ops.PHASE_DONE)


@pytest.fixture(autouse=True)
def _clear_env(monkeypatch):
    monkeypatch.delenv("FIREBIRD_PALLAS", raising=False)
    monkeypatch.delenv("FIREBIRD_FUSED_FIT", raising=False)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))[None]


def _mega_inputs(seed=41, P=16, T=64, B=7, S=4):
    """One chip's start state: ~16-day revisits over ~2.8 years, a
    harmonic model per pixel plus noise, a step of 800 on pixels 0-7 from
    step 35 on, 3 % spikes; pixel 14 has too short a series for a
    window, pixel 15 starts DONE, pixel 13 holds one prologue row."""
    rng = np.random.default_rng(seed)
    t = (729000 + np.cumsum(rng.integers(10, 22, T))).astype(np.float64)
    X = harmonic.design_matrix(t, t[0], 8).astype(np.float32)
    X6 = harmonic.design_matrix(t, t[0], 6)
    Xt = np.concatenate([X6[:, :1], X6[:, 2:]], 1).astype(np.float32)
    beta = np.zeros((P, B, 8))
    beta[..., 0] = rng.uniform(500, 3000, (P, B))
    beta[..., 2:6] = rng.normal(0, 150, (P, B, 4))
    Y = np.einsum("pbk,tk->btp", beta, X) + rng.normal(0, 20, (B, T, P))
    Y[:, 35:, :8] += 800
    Y[:, rng.random((T, P)) < 0.03] += 2500
    Y = Y.astype(np.int16)
    alive = rng.random((P, T)) < 0.92
    alive[14, 20:] = False
    phase = np.where(alive.any(1), PHASES[0], PHASES[2]).astype(np.int32)
    phase[15] = PHASES[2]
    nseg = np.zeros(P, np.int32)
    nseg[13] = 1
    bufs = tuple(rng.standard_normal((P, S * k)).astype(np.float32)
                 for k in (6, B, B, B * 8))
    hi = np.searchsorted(t, t + 365.25, side="right")
    W = -8 * (-(int((hi - np.arange(T)).max()) + 1) // 8)   # window_cap
    vario = primitives.variogram(
        torch.from_numpy(Y.astype(np.float32))[None],
        convert.plane_from_numpy(alive),
        torch.from_numpy(t.astype(np.float32))[None])[0].numpy()
    return dict(Yt=Y, phase0=phase, cur_i0=alive.argmax(1).astype(np.int32),
                alive0=alive, nseg0=nseg, bufs=bufs,
                t=t.astype(np.float32), X=X, Xt=Xt, vario=vario, W=W, S=S)


@pytest.mark.slow  # the JAX interpret call alone takes ~80 s (its compile)
def test_detect_mega_plain_matches_pallas():
    a = _mega_inputs()
    want = pallas_ops.detect_mega(
        *(jnp.asarray(a[k])[None] for k in ("Yt", "phase0", "cur_i0",
                                            "alive0", "nseg0")),
        tuple(jnp.asarray(b)[None] for b in a["bufs"]),
        *(jnp.asarray(a[k])[None] for k in ("t", "X", "Xt", "vario")),
        W=a["W"], S=a["S"], sensor=LANDSAT_ARD, phases=PHASES,
        change_thr=CHANGE_THR, outlier_thr=OUTLIER_THR, block_p=16,
        interpret=True)
    events = dict(is_brk=0, is_refit=0, is_tail=0, init_tm=0)

    def on_round(st, init, ev):
        for k in events:
            events[k] += int((init if k == "init_tm" else ev)[k].sum())

    got = cuda_ops.detect_mega_plain(
        *(_t(a[k]) for k in ("Yt", "phase0", "cur_i0")),
        convert.plane_from_numpy(a["alive0"]), _t(a["nseg0"]),
        convert.bufs_from_flat(a["bufs"], 7),
        *(_t(a[k]) for k in ("t", "X", "Xt", "vario")), W=a["W"],
        change_thr=CHANGE_THR, outlier_thr=OUTLIER_THR, on_round=on_round)
    assert all(events.values()), events
    np.testing.assert_array_equal(got["nseg"].numpy(), np.asarray(want["nseg"]))
    np.testing.assert_array_equal(convert.plane_to_numpy(got["alive"]),
                                  np.asarray(want["alive"]))
    np.testing.assert_array_equal(got["rounds"].numpy(),
                                  np.asarray(want["rounds"]))
    np.testing.assert_array_equal(got["counts"].numpy(),
                                  np.asarray(want["counts"]))
    np.testing.assert_array_equal(got["meta"].numpy(), np.asarray(want["meta"]))
    # The fits sum their Grams in another order than the Pallas dots.
    np.testing.assert_allclose(got["rmse"].numpy(), np.asarray(want["rmse"]),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got["mag"].numpy(), np.asarray(want["mag"]),
                               rtol=5e-3, atol=1e-2)
    c_w = np.asarray(want["coef"])
    scale = np.maximum(np.abs(c_w).max(-1, keepdims=True), 1.0)
    assert (np.abs(got["coef"].numpy() - c_w) / scale).max() <= 1e-4


# ---------------------------------------------------------------------------
# The mega route
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_ref(name):
    jp, _ = _packed(name)
    return jk.detect_packed(jp, dtype=jnp.float32, compact=False)


@functools.lru_cache(maxsize=None)
def _route(name, pallas="mega", fused=0):
    _, tp = _packed(name)
    return tk.detect_packed(tp, device="cpu", pallas=pallas, fused=fused)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_mega_route_decisions_match_jax(name):
    ref = _jax_ref(name)
    got = _route(name)
    g = convert.segments_to_numpy(got)
    for f in ("n_segments", "procedure", "mask", "seg_meta"):
        np.testing.assert_array_equal(getattr(g, f),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    # Rounds are per chip on this route; the deepest chip ran the
    # lockstep loop's count.
    assert g.rounds.max() == np.asarray(ref.rounds).max()
    assert g.rounds.shape == g.round_counts.shape[:1] == (2,)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_mega_route_floats_within_envelope(name):
    ref = _jax_ref(name)
    g = convert.segments_to_numpy(_route(name))
    np.testing.assert_allclose(g.seg_rmse, np.asarray(ref.seg_rmse),
                               rtol=1e-4, atol=1e-3)
    # The JAX package's own mega contract (tests/test_pallas.py).
    np.testing.assert_allclose(g.seg_mag, np.asarray(ref.seg_mag),
                               rtol=5e-3, atol=1e-2)
    np.testing.assert_array_equal(g.vario, np.asarray(ref.vario))
    c_r = np.asarray(ref.seg_coef)
    scale = np.maximum(np.abs(c_r).max(-1, keepdims=True), 1.0)
    assert (np.abs(g.seg_coef - c_r) / scale).max() <= 1e-4


@pytest.mark.parametrize("name", list(CONFIGS))
def test_mega_route_equals_route_mon_but_rounds(name):
    """Both run the same round body; the mega route counts its rounds
    per chip."""
    mega, mon = _route(name), _route(name, pallas="1", fused="mon")
    for f in dataclasses.fields(mega):
        if f.name in ("occupancy", "compactions", "lanes_migrated"):
            # The round loop's capture, which the mega route has none of.
            assert getattr(mega, f.name) is None, f.name
        elif f.name not in ("rounds", "round_counts"):
            assert torch.equal(getattr(mega, f.name),
                               getattr(mon, f.name)), f.name
    assert int(mega.rounds.max()) == int(mon.rounds[0])
    assert (mega.round_counts <= mon.round_counts).all()


def _spy_ops(calls):
    def spy(name):
        fn = getattr(cuda_ops.PLAIN, name)
        return lambda *a, **k: calls.append(name) or fn(*a, **k)

    return types.SimpleNamespace(**{n: spy(n) for n in vars(cuda_ops.PLAIN)})


@pytest.mark.parametrize("fused", [None, 1, "mon"])
def test_mega_route_calls_one_detect_mega_and_supersedes_fused(
        monkeypatch, fused):
    """One detect_mega call a dispatch after the prologue's lasso_fit,
    whatever the round route asks (FIREBIRD_FUSED_FIT included)."""
    if fused is None:
        monkeypatch.setenv("FIREBIRD_FUSED_FIT", "mon")
    monkeypatch.setenv("FIREBIRD_PALLAS", "mega")
    calls = []
    _, tp = _packed("default")
    seg = tk.detect_packed(tp, device="cpu", ops=_spy_ops(calls), fused=fused)
    assert sorted(calls) == ["detect_mega", "lasso_fit"]
    for f in dataclasses.fields(seg):
        va, vb = getattr(seg, f.name), getattr(_route("default"), f.name)
        assert (va is None and vb is None) or torch.equal(va, vb), f.name


def test_window_cap_past_the_largest_instance_raises():
    assert [cuda_ops._w_instance(w, "detect_mega")
            for w in (12, 32, 33, 64, 65, 128)] == [32, 32, 64, 64, 128, 128]
    with pytest.raises(ValueError, match="detect_mega"):
        cuda_ops._w_instance(129, "detect_mega")
