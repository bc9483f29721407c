"""The port's mixed-precision fit (FIREBIRD_MIXED_PRECISION) against the JAX
package, on the CPU, where the wrappers run their plain versions.

- The bf16 split: ``cuda_ops.split_bf16`` against ``pallas_ops._split_bf16``
  bit for bit, and exact on int16 values.
- The fitting kernels' plain versions with ``mixed=True`` against the
  Pallas kernels with ``mixed=True`` in interpret mode (``lasso_fit``,
  ``fused_fit_close``, ``fused_round``, ``init_window``), at the shapes of
  the f32 tests, with their tolerance (rtol = atol = 1e-2).
- The knob and which fits it reaches.
The whole path and the threshold-fuzz chip are in
tests/test_torch_mixed_routes.py; the kernels' mixed instances are held to
these plain versions on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import dataclasses
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from firebird_tpu.ccd import harmonic, pallas_ops
from firebird_tpu.ccd import kernel as jk
from firebird_tpu.ccd.sensor import LANDSAT_ARD, SENTINEL2
from firebird_tpu_torch.ccd import cuda_ops, params
from firebird_tpu_torch.ccd import kernel as tk
from firebird_tpu_torch.ccd.sensor import SENTINEL2 as T_S2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_precision import _scaled_ulps  # noqa: E402
from test_torch_detect import _packed  # noqa: E402
from test_torch_fused import (_check_fused_fit_close,  # noqa: E402
                              _check_fused_round)
from test_torch_kernels import (_fit_inputs, _init_compare,  # noqa: E402
                                _init_inputs, _port_fit_args,
                                _port_init_args)

BUDGET = params.MIXED_ULP_BUDGET


@pytest.fixture(autouse=True)
def _clear_env(monkeypatch):
    for k in ("FIREBIRD_PALLAS", "FIREBIRD_FUSED_FIT",
              "FIREBIRD_MIXED_PRECISION"):
        monkeypatch.delenv(k, raising=False)


# ---------------------------------------------------------------------------
# The split
# ---------------------------------------------------------------------------

def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def test_split_bf16_matches_jax_bit_for_bit():
    """A real design's XX plane, negatives, and values at bf16 ties (half
    way between two bf16 neighbours, both parities: round to even)."""
    rng = np.random.default_rng(0)
    t = np.sort(rng.integers(724000, 730000, 200)).astype(np.float64)
    X = harmonic.design_matrix(t, float(t[0]), 8).astype(np.float32)
    XX = (X[:, :, None] * X[:, None, :]).reshape(200, 64)
    ties = np.array([1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8, -(1 + 2.0 ** -8),
                     -(1 + 3 * 2.0 ** -8), 257.0, 259.0, -32767.0,
                     2.0 ** -130, 3.0e38], np.float32)
    for x in (XX, -XX, rng.normal(0, 1e4, (64, 64)).astype(np.float32),
              ties):
        want = pallas_ops._split_bf16(jnp.asarray(x))
        got = cuda_ops.split_bf16(torch.from_numpy(x))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(
                _bits(g.numpy()), _bits(np.asarray(w.astype(jnp.float32))))


@settings(max_examples=300, deadline=None)
@given(st.lists(st.integers(-32768, 32767), min_size=1, max_size=64))
def test_split_bf16_is_exact_on_int16(values):
    y = torch.tensor(values, dtype=torch.float32)
    hi, lo = cuda_ops.split_bf16(y)
    assert torch.equal(hi + lo, y)


# ---------------------------------------------------------------------------
# The fitting kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

def _jax_fit(X, Yi, w, mask, mixed):
    return pallas_ops.lasso_fit(
        jnp.asarray(Yi.transpose(1, 2, 0)), jnp.asarray(w), jnp.asarray(X),
        jnp.asarray(mask), with_rmse=True, mixed=mixed, interpret=True)


def test_lasso_fit_mixed_plain_matches_pallas_mixed():
    X, Yi, w, mask = _fit_inputs()
    want_b, want_r = _jax_fit(X, Yi, w, mask, True)
    got_b, got_r = cuda_ops.lasso_fit(*_port_fit_args(X, Yi, w, mask),
                                      mixed=True)
    # The split dots' f32 sums run in another order than the Pallas dots;
    # 50 CD sweeps amplify the ulps (the f32 fit's envelope).
    np.testing.assert_allclose(got_b[0].numpy(), np.asarray(want_b),
                               rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got_r[0].numpy(), np.asarray(want_r),
                               rtol=1e-2, atol=1e-2)


def test_lasso_fit_mixed_within_budget_of_f32():
    """Mixed against the port's own f32 fit: within the scaled-ulp budget,
    and not identical (the mixed Gram ran); masked coefficients stay 0."""
    X, Yi, w, mask = _fit_inputs(seed=5)
    args = _port_fit_args(X, Yi, w, mask)
    c_m, r_m = cuda_ops.lasso_fit(*args, mixed=True)
    c_f, r_f = cuda_ops.lasso_fit(*args)
    assert float(_scaled_ulps(c_m, c_f, vector_axis=-1).max()) <= BUDGET
    assert float(_scaled_ulps(r_m, r_f).max()) <= BUDGET
    assert not torch.equal(c_m, c_f)
    off = ~args[3][:, :, None, :].expand_as(c_m)
    assert not c_m[off].any()


def test_gram_plain_mixed_terms():
    """gram_plain(mixed=True) is the sum of its split terms: the count is
    an integer and the correlations of y w split exactly."""
    X, Yi, w, mask = _fit_inputs(seed=6, P=9, T=40)
    Yt, wt, Xt, _ = _port_fit_args(X, Yi, w, mask)
    G, c, n = cuda_ops.gram_plain(Yt, wt, Xt, mixed=True)
    assert torch.equal(n, wt.sum(1).clamp_min(1.0))
    Gf, cf, _ = cuda_ops.gram_plain(Yt, wt, Xt)
    # ~2^-17 relative on the Gram (the XX lo·lo term is dropped); the
    # correlations lose only tl·yl.
    torch.testing.assert_close(G, Gf, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(c, cf, rtol=1e-4, atol=1e-2)
    assert not torch.equal(G, Gf)


# The 12-band cases run the same mixed branch on the other band layout
# (init_window's case below is 12-band too); ~20 s each, most of it the
# Pallas kernels' interpret-mode compile.
@pytest.mark.parametrize("nb", [7, pytest.param(12, marks=pytest.mark.slow)])
def test_fused_fit_close_mixed_plain_matches_pallas_mixed(nb):
    _check_fused_fit_close(np.random.default_rng(3 if nb == 7 else 13), nb,
                           mixed=True)


@pytest.mark.parametrize("nb", [7, pytest.param(12, marks=pytest.mark.slow)])
def test_fused_round_mixed_plain_matches_pallas_mixed(nb):
    j, t = (LANDSAT_ARD, None) if nb == 7 else (SENTINEL2, T_S2)
    _check_fused_round(np.random.default_rng(9), j, t, mixed=True)


def test_init_window_mixed_plain_matches_pallas_mixed_sentinel2():
    """The 12-band layout at the f32 test's non-slow shape (P=16, W=16), on
    harmonic series with noise (most windows pass the Tmask screen and
    take the mixed stability fit): the stability verdicts agree on every
    pixel."""
    t, X, Xt, Yi, vario, alive, cur_i, phase = _init_inputs(
        seed=23, P=16, B=12, T=64)
    rng = np.random.default_rng(23)
    beta = np.zeros((16, 12, 8), np.float32)
    beta[..., 0] = rng.uniform(500, 3000, (16, 12))
    beta[..., 2:6] = rng.normal(0, 150, (16, 12, 4))
    Yi = (np.einsum("pbk,tk->bpt", beta, X)
          + rng.normal(0, 20, (12, 16, 64))).astype(np.int16)
    Yi[:, :4, 40:] += 900                    # unstable windows
    inputs = t, X, Xt, Yi, vario, alive, cur_i, phase
    want = pallas_ops.init_window(
        jnp.asarray(alive), jnp.asarray(cur_i),
        jnp.asarray(phase == jk.PHASE_INIT), jnp.asarray(t, jnp.float32),
        jnp.asarray(X), jnp.asarray(Xt), jnp.asarray(Yi.transpose(0, 2, 1)),
        jnp.asarray(vario), W=16, sensor=SENTINEL2, mixed=True,
        interpret=True)
    got = cuda_ops.init_window(*_port_init_args(*inputs), W=16, sensor=T_S2,
                               mixed=True)
    assert np.asarray(want["init_ok"]).sum() >= 4
    _init_compare(got, want, 0.0)


# ---------------------------------------------------------------------------
# The knob and the fits it reaches
# ---------------------------------------------------------------------------

def _fields_differing(a, b):
    """The fields of two ChipSegments that differ (one None, the other not,
    counts as differing)."""
    out = []
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if (va is None) != (vb is None) or (va is not None
                                            and not torch.equal(va, vb)):
            out.append(f.name)
    return out


def test_mixed_knob_resolution(monkeypatch):
    for v in ("", "0", "1", "yes"):
        monkeypatch.setenv("FIREBIRD_MIXED_PRECISION", v)
        assert tk.use_mixed_precision() == jk.use_mixed_precision(), v
        assert tk.pallas_components().mixed == tk.use_mixed_precision()
        assert tk.pallas_components(mixed=False).mixed is False
        assert tk.pallas_components(mixed=True).mixed is True
    monkeypatch.delenv("FIREBIRD_MIXED_PRECISION")
    assert tk.use_mixed_precision() is False
    route = tk.pallas_components(mixed=True)
    assert tk.pallas_components(ops=route) is route
    assert tk.pallas_components(ops=route, mixed=True) is route
    with pytest.raises(ValueError, match="mixed"):
        tk.pallas_components(ops=route, mixed=False)


def _spy_ops(calls):
    def spy(name):
        fn = getattr(cuda_ops.PLAIN, name)

        def run(*a, **k):
            calls.append((name, k.get("mixed", False)))
            return fn(*a, **k)
        return run
    return types.SimpleNamespace(**{n: spy(n) for n in vars(cuda_ops.PLAIN)})


@pytest.mark.parametrize("pallas,fused,want", [
    ("1", 0, {"lasso_fit", "init_window"}),
    ("1", 1, {"lasso_fit", "init_window", "fused_fit_close"}),
    ("1", "mon", {"lasso_fit", "init_window", "fused_round"}),
    ("mega", 0, {"lasso_fit", "detect_mega"}),
    ("fit,monitor,tmask", 0, {"lasso_fit"}),
    ("lasso,monitor,init", 1, {"init_window", "fused_fit_close"}),
    ("lasso,monitor,tmask", 0, set()),
])
def test_mixed_reaches_the_fitting_kernels_only(pallas, fused, want,
                                                monkeypatch):
    """mixed=True binds to the fitting kernels the route calls; the
    component route's fit (a PyTorch Gram around lasso_cd) stays f32, as
    JAX's XLA Gram does, and then so does its result."""
    calls = []
    _, tp = _packed("default")
    seg = tk.detect_packed(tp, device="cpu", ops=_spy_ops(calls),
                           pallas=pallas, fused=fused, compact=False,
                           mixed=True)
    assert {n for n, m in calls if m} == want
    mixed_names = {n for n in cuda_ops.MIXED_SOURCES}
    assert not any(m for n, m in calls if n not in mixed_names)
    if not want:
        ref = tk.detect_packed(tp, device="cpu", pallas=pallas, fused=fused,
                               compact=False, mixed=False)
        assert _fields_differing(seg, ref) == []


def test_refused_mega_keeps_mixed(monkeypatch):
    """A mega request whose shape cuda_ops.mega_fits refuses runs the round
    loop, still with the mixed Gram (JAX's refused mega keeps mixed_on)."""
    calls = []
    monkeypatch.setattr(cuda_ops, "mega_fits", lambda T, W: False)
    _, tp = _packed("default")
    tk.detect_packed(tp, device="cpu", ops=_spy_ops(calls), pallas="mega",
                     compact=False, mixed=True)
    assert "detect_mega" not in {n for n, _ in calls}
    assert {n for n, m in calls if m} == {"lasso_fit", "init_window"}


def test_cli_mixed_flag(capsys):
    """python -m firebird_tpu_torch detect --mixed 1 reports the mixed
    route."""
    import json

    from firebird_tpu_torch.__main__ import main

    main(["detect", "--chips", "1", "--device", "cpu", "--sensor",
          "landsat-ard-tiny", "--start", "1995-01-01", "--end",
          "1997-01-01", "--mixed", "1"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["mixed"] is True and out["segments"] > 0


# ---------------------------------------------------------------------------
# A numpy model of csrc/mixed_gram.cuh's tensor-core layout
# ---------------------------------------------------------------------------
# The kernel's index arithmetic, transcribed lane by lane: each lane builds
# its mma fragments (rows gr = lane / 4 and gr + 8, steps 2tc, 2tc+1, 2tc+8,
# 2tc+9 of a 16-step chunk, B column gr), the model multiplies the tiles the
# PTX fragment layout assembles (exact products, one f32 rounding per
# chunk), and the lanes stage and read the results as dense_fit (the
# warp's four pixels) and mixed_init_gram (32 pixels, a lane each) do.
# Both layouts must give every pixel the same sums, and those sums must be
# gram_plain(mixed=True)'s up to the order of the f32 additions.

def _bf(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).float().numpy().astype(np.float64)


def _split(x):
    hi = _bf(x)
    return hi, _bf(np.float32(np.asarray(x, np.float32) - hi.astype(
        np.float32)))


def _mma(A, B, C):
    """f32(A B + C): the model's tensor core."""
    return (A @ B + C).astype(np.float32).astype(np.float64)


def _pass(rows, X, corr, i0=0, nt=1):
    """mixed_pass for the warp's 32 lanes; rows[lane] = (r0, r1), a row a
    dict (w [T] 0/1, y [T] or None, n) or None.  Returns acc[lane][term]
    [u][4]."""
    T = X.shape[0]
    terms = 3 if corr else 2
    acc = np.zeros((32, terms, nt, 4))
    on = [r for pair in rows for r in pair if r is not None]
    klo = min(int(np.flatnonzero(r["w"])[0]) // 16 for r in on
              if r["w"].any()) if any(r["w"].any() for r in on) else 0
    khi = max(int(np.flatnonzero(r["w"])[-1]) // 16 for r in on
              if r["w"].any()) if any(r["w"].any() for r in on) else -1
    for kc in range(klo, khi + 1):
        A = {k: np.zeros((16, 16)) for k in ("h", "l", "w")}
        Bm = {}
        for lane in range(32):
            gr, tc = lane >> 2, lane & 3
            ks = (2 * tc, 2 * tc + 1, 2 * tc + 8, 2 * tc + 9)
            for ri, r in enumerate(rows[lane]):
                for s in ks:
                    t = 16 * kc + s
                    if r is None or t >= T or not r["w"][t]:
                        continue
                    if corr:
                        h, lo = _split(r["y"][t])
                        A["h"][gr + 8 * ri, s], A["l"][gr + 8 * ri, s] = h, lo
                    else:
                        A["w"][gr + 8 * ri, s] = 1.0
            for u in range(nt):
                for s in ks:
                    t = 16 * kc + s
                    x = 0.0
                    if t < T:
                        x = (X[t, gr] if corr else
                             np.float32(X[t, i0 + u]) * np.float32(X[t, gr]))
                    h, lo = _split(x)
                    Bm.setdefault((u, "h"), np.zeros((16, 8)))[s, gr] = h
                    Bm.setdefault((u, "l"), np.zeros((16, 8)))[s, gr] = lo
        for u in range(nt):
            prods = ([(A["h"], Bm[u, "h"]), (A["l"], Bm[u, "h"]),
                      (A["h"], Bm[u, "l"])] if corr else
                     [(A["w"], Bm[u, "h"]), (A["w"], Bm[u, "l"])])
            for term, (a, b) in enumerate(prods):
                C = np.zeros((16, 8))
                for lane in range(32):
                    gr, tc = lane >> 2, lane & 3
                    C[gr, 2 * tc:2 * tc + 2] = acc[lane, term, u, :2]
                    C[gr + 8, 2 * tc:2 * tc + 2] = acc[lane, term, u, 2:]
                D = _mma(a, b, C)
                for lane in range(32):
                    gr, tc = lane >> 2, lane & 3
                    acc[lane, term, u, :2] = D[gr, 2 * tc:2 * tc + 2]
                    acc[lane, term, u, 2:] = D[gr + 8, 2 * tc:2 * tc + 2]
    return acc


def _f32(x):
    return np.float64(np.float32(x))


def _corr_value(a, e, n):
    return _f32(_f32(_f32(a[0, 0, e] + a[1, 0, e]) + a[2, 0, e]) / n)


def _gram_value(a, u, e, n):
    return _f32(_f32(a[0, u, e] + a[1, u, e]) / n)


def _dense_fit_model(pix, X, NB):
    """dense_fit's mixed branch for one warp: pix[p] (p < 4) a dict (w [T],
    y [NB, T]) or None (the group does not fit).  Returns {p: (c [NB, 8],
    G [8, 8])}."""
    n = {p: max(int(d["w"].sum()), 1) for p, d in enumerate(pix) if d}
    Gw = np.zeros(4 * 65)
    cb = {p: np.zeros((NB, 8)) for p in n}
    for mt in range((4 * NB + 15) // 16):
        rows = []
        for lane in range(32):
            gr = lane >> 2
            d = pix[gr & 3]
            pair = []
            for h in range(2):
                b = 4 * mt + 2 * h + (gr >> 2)
                pair.append(dict(w=d["w"], y=d["y"][b], n=n[gr & 3])
                            if d and b < NB else None)
            rows.append(pair)
        acc = _pass(rows, X, True)
        for lane in range(32):
            gr, tc = lane >> 2, lane & 3
            for e in range(4):
                r = rows[lane][e >> 1]
                Gw[(gr + 8 * (e >> 1)) * 8 + 2 * tc + (e & 1)] = _corr_value(
                    acc[lane], e, r["n"] if r else 1)
        for lane in range(32):
            gw, l = lane // 8, lane % 8
            for s in range(2):
                b = l + 8 * s
                if gw in n and b < NB and b // 4 == mt:
                    cb[gw][b] = Gw[(4 * (b % 4) + gw) * 8:][:8]
    G = {p: np.zeros(64) for p in n}
    for i0 in range(0, 8, 2):
        rows = [((dict(w=pix[lane >> 2]["w"], y=None, n=n[lane >> 2])
                  if (lane >> 2) < 4 and pix[lane >> 2] else None), None)
                for lane in range(32)]
        acc = _pass(rows, X, False, i0, 2)
        for lane in range(32):
            gr, tc = lane >> 2, lane & 3
            if rows[lane][0] is None:
                continue
            for u in range(2):
                for e in range(2):
                    G[gr][(i0 + u) * 8 + 2 * tc + e] = _gram_value(
                        acc[lane], u, e, n[gr])
    return {p: (cb[p], G[p].reshape(8, 8)) for p in n}


def _init_gram_model(pix, X):
    """mixed_init_gram for 32 pixels (pix[p] a dict (w [T] restricted to
    the window, y [5, T]) or None).  Returns {p: (c [5, 8], G [8, 8])}."""
    n = {p: max(int(d["w"].sum()), 1) for p, d in enumerate(pix) if d}
    stage = np.zeros(2048)
    for mt in range(10):
        d_, p0 = mt >> 1, 16 * (mt & 1)
        rows = []
        for lane in range(32):
            p = p0 + (lane >> 2)
            rows.append(tuple(
                dict(w=pix[q]["w"], y=pix[q]["y"][d_], n=n[q])
                if pix[q] else None for q in (p, p + 8)))
        acc = _pass(rows, X, True)
        for lane in range(32):
            p, tc = p0 + (lane >> 2), lane & 3
            for e in range(4):
                r = rows[lane][e >> 1]
                stage[(32 * d_ + p + 8 * (e >> 1)) * 8 + 2 * tc + (e & 1)] = \
                    _corr_value(acc[lane], e, r["n"] if r else 1)
    c = {p: np.array([stage[(32 * d_ + p) * 8:][:8] for d_ in range(5)])
         for p in n}
    for mt in range(2):
        rows = []
        for lane in range(32):
            p = 16 * mt + (lane >> 2)
            rows.append(tuple(dict(w=pix[q]["w"], y=None, n=n[q])
                              if pix[q] else None for q in (p, p + 8)))
        for i0 in range(0, 8, 2):
            acc = _pass(rows, X, False, i0, 2)
            for lane in range(32):
                p, tc = 16 * mt + (lane >> 2), lane & 3
                for u in range(2):
                    for e in range(4):
                        r = rows[lane][e >> 1]
                        stage[(p + 8 * (e >> 1)) * 64 + (i0 + u) * 8
                              + 2 * tc + (e & 1)] = _gram_value(
                                  acc[lane], u, e, r["n"] if r else 1)
    G = {p: np.triu(stage[p * 64:(p + 1) * 64].reshape(8, 8)) for p in n}
    return {p: (c[p], G[p] + np.triu(G[p], 1).T) for p in n}


def test_mixed_gram_tile_layout_model():
    """The model of the kernel's layouts gives gram_plain(mixed=True)'s Gram
    and correlations (up to f32 summation order), and the warp layout of
    dense_fit and the 32-pixel layout of detect_mega's INIT give every
    pixel the same sums, bit for bit, whatever its neighbours."""
    rng = np.random.default_rng(12)
    T, NB = 40, 5
    t = np.sort(rng.integers(729000, 730000, T)).astype(np.float64)
    X = harmonic.design_matrix(t, float(t[0]), 8).astype(np.float32)
    pix = []
    for p in range(32):
        lo, hi = sorted(rng.integers(0, T, 2))
        w = (rng.random(T) < 0.8) & (np.arange(T) >= lo) & (np.arange(T) <= hi)
        if p in (5, 17):
            pix.append(None)                       # does not fit
            continue
        pix.append(dict(w=w, y=rng.integers(-2000, 9000, (NB, T)).astype(
            np.float64)))
    whole = _init_gram_model(pix, X)
    for q0 in range(0, 32, 4):
        warp = _dense_fit_model(pix[q0:q0 + 4], X, NB)
        for p, (c, G) in warp.items():
            np.testing.assert_array_equal(c, whole[q0 + p][0])
            np.testing.assert_array_equal(G, whole[q0 + p][1])
    fitted = [p for p in range(32) if pix[p]]
    Yt = torch.from_numpy(np.stack([pix[p]["y"] for p in fitted], -1)[None]
                          .astype(np.int16))
    wt = torch.from_numpy(np.stack([pix[p]["w"] for p in fitted], -1)[None]
                          .astype(np.float32))
    G, c, _ = cuda_ops.gram_plain(Yt, wt, torch.from_numpy(X[None]),
                                  mixed=True)
    for j, p in enumerate(fitted):
        np.testing.assert_allclose(whole[p][0], c[0, j].numpy(), rtol=1e-5,
                                   atol=1e-2)
        np.testing.assert_allclose(whole[p][1], G[0, j].numpy(), rtol=1e-5,
                                   atol=1e-6)
