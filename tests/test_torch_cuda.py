"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch (the repository's conftest imports JAX; skip it there):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from firebird_tpu_torch.ccd import cuda_ops, harmonic, kernel, params
from firebird_tpu_torch.ccd.primitives import coefmask_for
from firebird_tpu_torch.ccd.sensor import (LANDSAT_ARD, LANDSAT_ARD_TINY,
                                           SENTINEL2)
from firebird_tpu_torch.ingest import SyntheticSource, pack

# The guard cases' inputs (tests/_torch_guard_cases.py, found on the path
# pytest gives this directory).
import _torch_guard_cases as cases


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


pytestmark = pytest.mark.cuda

CHANGE_THR, OUTLIER_THR = 11.07, 15.09
INIT_EXACT = ("init_nowin", "init_tm", "has_adv", "i_next_tm", "i_adv", "j",
              "n_ok", "w_stab", "alive_init")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _designs(rng, C, T, dev):
    t = np.sort(rng.integers(729000, 731500, (C, T)), 1).astype(np.float64)
    X = np.stack([harmonic.design_matrix(tc, tc[0], params.MAX_COEFS)
                  for tc in t]).astype(np.float32)
    Xt6 = np.stack([harmonic.design_matrix(tc, tc[0], params.TMASK_COEFS + 1)
                    for tc in t])
    Xt = np.concatenate([Xt6[..., :1], Xt6[..., 2:]], -1).astype(np.float32)
    return _t(t.astype(np.float32), dev), _t(X, dev), _t(Xt, dev)


def test_lasso_fit_matches_plain(dev):
    rng = np.random.default_rng(3)
    C, B, T, P = 2, 7, 60, 141
    _, X, _ = _designs(rng, C, T, dev)
    Yt = _t(rng.integers(0, 8000, (C, B, T, P)).astype(np.int16), dev)
    w = _t((rng.random((C, T, P)) < 0.8).astype(np.float32), dev)
    mask = _t(np.arange(8) < rng.choice([4, 6, 8], (C, P))[..., None], dev)
    before = cuda_ops.LAUNCHES["lasso_fit"]
    got = cuda_ops.lasso_fit(Yt, w, X, mask)
    assert cuda_ops.LAUNCHES["lasso_fit"] == before + 1
    want = cuda_ops.lasso_fit_plain(Yt, w, X, mask)
    for g, v in zip(got, want):
        torch.testing.assert_close(g, v, rtol=1e-2, atol=1e-2)
    b0, r0 = cuda_ops.lasso_fit(Yt, w, X, mask, with_rmse=False)
    assert torch.equal(b0, got[0]) and not r0.any()


@pytest.mark.parametrize("trial", range(3))
def test_monitor_chain_scored_matches_plain(dev, trial):
    rng = np.random.default_rng(11 + trial)
    C, nb, T, P = 2, 5, 96, 137
    _, X, _ = _designs(rng, C, T, dev)
    alive = rng.random((C, T, P)) < 0.8
    args = (_t(rng.integers(0, 8000, (C, nb, T, P)).astype(np.int16), dev),
            _t((rng.normal(0, 1, (C, P, nb, 8)) * 100).astype(np.float32), dev),
            _t((np.abs(rng.normal(150, 40, (C, P, nb))) + 1).astype(np.float32),
               dev),
            X, _t(alive, dev), _t((rng.random((C, T, P)) < 0.4) & alive, dev),
            _t(rng.integers(0, T, (C, P)).astype(np.int32), dev),
            _t(rng.integers(1, 40, (C, P)).astype(np.int32), dev),
            _t(rng.random((C, P)) < 0.7, dev))
    kw = dict(change_thr=CHANGE_THR, outlier_thr=OUTLIER_THR)
    got = cuda_ops.monitor_chain_scored(*args, **kw)
    # A pixel that does not monitor gets the zero outputs (kernel._mon_zeros)
    # from the kernel; the plain version's value there is read by no one.
    want = cuda_ops.monitoring_only(
        cuda_ops.monitor_chain_scored_plain(*args, **kw), args[-1])
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _monitor_case(rng, dev, sensor, T, P, p_mon):
    """monitor_chain_scored's inputs from a model of ``sensor``'s bands:
    the detection bands gathered from [C,B,T,P] spectra with a step of 800
    half way through every fifth pixel, as kernel._mon_block gathers them."""
    a = _round_args(rng, dev, B=sensor.n_bands, T=T, P=P)
    C = a["Yt"].shape[0]
    det = list(sensor.detection_bands)
    nlast = np.where(rng.random((C, P)) < 0.4,
                     a["included"].sum(1).cpu().numpy(), 1000)
    dden = _t(rng.uniform(15, 25, (C, P, 5)).astype(np.float32), dev)
    return (a["Yt"][:, det].contiguous(), a["coefs"][:, :, det].contiguous(),
            dden, a["X"], a["alive"], a["included"], a["cur_k"],
            _t(nlast.astype(np.int32), dev), _t(rng.random((C, P)) < p_mon,
                                                 dev))


@pytest.mark.parametrize("sensor,T,P,p_mon", [
    (LANDSAT_ARD, 96, 141, 0.7), (SENTINEL2, 96, 141, 0.7),
    (LANDSAT_ARD, 77, 50, 0.7), (SENTINEL2, 96, 141, 0.0),
    (LANDSAT_ARD, 96, 141, 1.0)])
def test_monitor_chain_scored_cases_match_plain(dev, sensor, T, P, p_mon):
    """The detection bands of both layouts; T off a multiple of 32 and P
    off a multiple of the 32-pixel tile; a launch with no monitoring pixel
    (every output zero) and one where all monitor."""
    args = _monitor_case(np.random.default_rng(31), dev, sensor, T, P, p_mon)
    kw = dict(change_thr=CHANGE_THR, outlier_thr=OUTLIER_THR)
    before = cuda_ops.LAUNCHES["monitor_chain_scored"]
    got = cuda_ops.monitor_chain_scored(*args, **kw)
    assert cuda_ops.LAUNCHES["monitor_chain_scored"] == before + 1
    want = cuda_ops.monitoring_only(
        cuda_ops.monitor_chain_scored_plain(*args, **kw), args[-1])
    for k in want:
        assert torch.equal(got[k], want[k]), k
    if p_mon == 0.0:
        assert not any(v.any() for v in got.values())
    elif p_mon == 1.0:
        assert all(want[k].any() for k in ("is_tail", "is_brk", "is_refit"))


@pytest.mark.parametrize("B,P", [(7, 141), (12, 141), (12, 50)])
def test_lasso_fit_bands_and_empty_windows(dev, B, P):
    """Both band-count instances, P off a multiple of the tile, and pixels
    with no weight (their fit is exactly zero, as the plain version's)."""
    rng = np.random.default_rng(40 + B)
    C, T = 2, 77
    _, X, _ = _designs(rng, C, T, dev)
    Yt = _t(rng.integers(0, 8000, (C, B, T, P)).astype(np.int16), dev)
    w = rng.random((C, T, P)) < 0.6
    w[:, :, ::7] = False
    w = _t(w.astype(np.float32), dev)
    mask = _t(np.arange(8) < rng.choice([4, 6, 8], (C, P))[..., None], dev)
    got = cuda_ops.lasso_fit(Yt, w, X, mask)
    want = cuda_ops.lasso_fit_plain(Yt, w, X, mask)
    for g, v in zip(got, want):
        torch.testing.assert_close(g, v, rtol=1e-2, atol=1e-2)
    assert not got[0][:, ::7].any() and not got[1][:, ::7].any()
    b0, r0 = cuda_ops.lasso_fit(Yt, w, X, mask, with_rmse=False)
    assert torch.equal(b0, got[0]) and not r0.any()


@pytest.mark.parametrize("B", [7, 12])
def test_lasso_fit_equals_fit_window(dev, B):
    """fused_fit_close's refit gives lasso_fit's coefficients and RMSE bit
    for bit on the same windows and masks (both run fb::dense_fit; route 1
    equals route 0 because of it)."""
    rng = np.random.default_rng(50 + B)
    a = _round_args(rng, dev, B=B, T=77)
    C, _, T, P = a["Yt"].shape
    w = _t((rng.random((C, T, P)) < 0.6).astype(np.float32), dev)
    n_full = _t(rng.integers(10, 40, (C, P)).astype(np.int32), dev)
    no = torch.zeros(C, P, dtype=torch.bool, device=dev)
    zi = torch.zeros(C, P, dtype=torch.int32, device=dev)
    rmse = torch.ones(C, P, B, device=dev)
    _, _, coefs, rmse_o = cuda_ops.fused_fit_close(
        a["Yt"], a["X"], a["t"], w, ~no, n_full, a["included"], a["coefs"],
        rmse, rmse, no, no, zi, zi, a["first_seg"], a["nseg"],
        _clone(a["bufs"]))
    want = cuda_ops.lasso_fit(a["Yt"], w, a["X"], coefmask_for(n_full))
    assert torch.equal(want[0], coefs)
    assert torch.equal(want[1], rmse_o)


def _init_args(rng, dev, C=2, B=7, T=96, P=137, outliers=0.0):
    t, X, Xt = _designs(rng, C, T, dev)
    Y = 1000 + 300 * np.cos(2 * np.pi * t.cpu().numpy() / 365.25)
    Y = Y[:, None, :, None] + rng.normal(0, 30, (C, B, T, P))
    Y[rng.random(Y.shape) < outliers] += 2000
    return (_t(rng.random((C, T, P)) < 0.7, dev),
            _t(rng.integers(0, T // 2, (C, P)).astype(np.int32), dev),
            _t(rng.random((C, P)) < 0.6, dev), t, X, Xt,
            _t(Y.astype(np.int16), dev),
            _t((np.abs(rng.normal(40, 10, (C, P, B))) + 1).astype(np.float32),
               dev))


@pytest.mark.parametrize("outliers", [0.0, 0.03])
@pytest.mark.parametrize("W", [24, 40])
def test_init_window_matches_plain(dev, outliers, W):
    args = _init_args(np.random.default_rng(17), dev, outliers=outliers)
    got = cuda_ops.init_window(*args, W=W)
    want = cuda_ops.init_window_plain(*args, W=W)
    assert set(got) == set(want)
    for k in INIT_EXACT:
        assert torch.equal(got[k], want[k]), k
    if outliers:
        assert got["init_tm"].any()
    assert got["init_ok"].any()
    # The stability verdict rests on a Gram summed in another order.
    for k in ("init_ok", "init_bad"):
        assert (got[k] != want[k]).float().mean().item() <= 0.02, k


def test_init_window_sentinel2_matches_plain(dev):
    """The 12-band instance with Sentinel-2's roles (detection bands 2, 3,
    7, 10, 11; Tmask bands 2, 10)."""
    args = _init_args(np.random.default_rng(18), dev, B=12, outliers=0.03)
    got = cuda_ops.init_window(*args, W=24, sensor=SENTINEL2)
    want = cuda_ops.init_window_plain(*args, W=24, sensor=SENTINEL2)
    for k in INIT_EXACT:
        assert torch.equal(got[k], want[k]), k
    assert got["init_tm"].any() and got["init_ok"].any()
    for k in ("init_ok", "init_bad"):
        assert (got[k] != want[k]).float().mean().item() <= 0.02, k


def _dense_init_args(rng, dev, B, T, P, span, W):
    """_init_args on ``span`` days of dates (a year holds more members the
    shorter the span) with about one outlier in two windows of ``W``, every
    pixel of chip 0's first tile not initializing and every pixel of its
    second tile initializing."""
    args = list(_init_args(rng, dev, B=B, T=T, P=P))
    t = np.sort(rng.uniform(0, span, (2, T)), 1) + 729000.0
    X = np.stack([harmonic.design_matrix(tc, tc[0], params.MAX_COEFS)
                  for tc in t]).astype(np.float32)
    Xt6 = np.stack([harmonic.design_matrix(tc, tc[0], params.TMASK_COEFS + 1)
                    for tc in t])
    Xt = np.concatenate([Xt6[..., :1], Xt6[..., 2:]], -1).astype(np.float32)
    Y = 1000 + 300 * np.cos(2 * np.pi * t / 365.25)
    Y = Y[:, None, :, None] + rng.normal(0, 30, (2, B, T, P))
    Y[rng.random(Y.shape) < 0.5 / W] += 2000
    args[3:7] = (_t(t.astype(np.float32), dev), _t(X, dev), _t(Xt, dev),
                 _t(Y.astype(np.int16), dev))
    args[2][0, :32] = False
    args[2][0, 32:64] = True
    return tuple(args)


@pytest.mark.parametrize("W,T,span", [(24, 96, 2500), (40, 160, 900),
                                      (100, 320, 900), (24, 64, 1100)])
@pytest.mark.parametrize("sensor", [LANDSAT_ARD, SENTINEL2])
def test_init_window_instances_and_tiles(dev, sensor, W, T, span):
    """The 32, 64 and 128 window instances (W = 24, 40, 100, windows longer
    than 32 members at the two wider ones), T = 64, both band layouts, P
    not a multiple of 32, a tile with no initializing pixel beside one
    where every pixel initializes."""
    rng = np.random.default_rng(W + T)
    args = _dense_init_args(rng, dev, sensor.n_bands, T, 77, span, W)
    got = cuda_ops.init_window(*args, W=W, sensor=sensor)
    want = cuda_ops.init_window_plain(*args, W=W, sensor=sensor)
    for k in INIT_EXACT:
        assert torch.equal(got[k], want[k]), k
    for k in ("init_ok", "init_bad"):
        assert (got[k] != want[k]).float().mean().item() <= 0.02, k
    for k in ("init_nowin", "init_tm", "init_ok", "init_bad"):
        assert not got[k][0, :32].any(), k
    assert got["init_ok"][0, 32:64].any() and got["init_tm"].any()
    if W > 32:
        assert int(got["n_ok"].max()) > 32


@pytest.mark.parametrize("W", [24, 40, 100])
def test_tmask_bad_empty_and_singular_windows(dev, W):
    """Each window instance with P not a multiple of 32: a pixel whose
    weights are all zero next to a singular window (identical design
    columns: the Cholesky's NaN flags nothing), windows with holes."""
    rng = np.random.default_rng(W)
    C, P = 2, 45
    Xtw = rng.normal(0, 1, (C, P, W, 5)).astype(np.float32)
    Xtw[..., 0] = 1.0
    Y2 = (400 + 80 * rng.normal(0, 1, (C, P, 2, W))).astype(np.float32)
    Y2[rng.random(Y2.shape) < 0.05] += 900
    w = (rng.random((C, P, W)) < 0.85).astype(np.float32)
    w[0, 5] = 0.0                      # no member
    Xtw[0, 6] = 1.0                    # singular
    w[1, 32:] = 0.0                    # chip 1's second tile: no member
    args = (_t(Xtw, dev), _t(Y2, dev), _t(w, dev),
            _t(np.abs(rng.normal(40, 10, (C, P, 2))).astype(np.float32), dev))
    got = cuda_ops.tmask_bad(*args)
    want = cuda_ops.tmask_bad_plain(*args)
    assert torch.equal(got, want)
    assert want.any() and not want[0, 5:7].any() and not want[1, 32:].any()
    if W > 32:
        assert want[..., 32:].any()


def test_wrappers_refuse_bad_tensors(dev):
    rng = np.random.default_rng(0)
    _, X, _ = _designs(rng, 1, 16, dev)
    Yt = torch.zeros(1, 7, 16, 8, dtype=torch.int16, device=dev)
    w = torch.zeros(1, 8, 16, device=dev).transpose(1, 2)
    mask = torch.ones(1, 8, 8, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_ops.lasso_fit(Yt, w, X, mask)
    with pytest.raises(TypeError):
        cuda_ops.lasso_fit(Yt.float(), w.contiguous(), X, mask)
    with pytest.raises(ValueError):
        cuda_ops.lasso_fit(Yt, w.contiguous().cpu(), X, mask)


def _tiny_packed():
    src = SyntheticSource(4, start="1995-01-01", end="1999-06-01",
                          sensor=LANDSAT_ARD_TINY, n_changes=2)
    return pack([src.chip(100, 200), src.chip(3100, 200)], bucket=32)


def test_detect_on_card_matches_cpu(dev):
    packed = _tiny_packed()
    cuda_ops.reset_launches()
    a = kernel.detect_packed(packed, fused=0)
    route0 = {"lasso_fit", "monitor_chain_scored", "init_window"}
    assert {k for k, n in cuda_ops.LAUNCHES.items() if n > 0} == route0
    b = kernel.detect_packed(packed, device="cpu")
    for f in ("n_segments", "procedure", "mask", "seg_meta", "rounds"):
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f
    torch.testing.assert_close(a.seg_rmse.cpu(), b.seg_rmse, rtol=1e-4,
                               atol=1e-3)


def _round_args(rng, dev, C=2, B=7, T=96, P=141, S=3):
    """Mid-loop round state: a per-pixel model, spectra from it plus noise
    (a step of 800 half way through every fifth pixel), cursors, included
    sets and segment buffers."""
    t, X, _ = _designs(rng, C, T, dev)
    beta = np.zeros((C, P, B, 8), np.float32)
    beta[..., 0] = rng.uniform(500, 3000, (C, P, B))
    beta[..., 2:6] = rng.normal(0, 150, (C, P, B, 4))
    Y = (np.einsum("cpbk,ctk->cbtp", beta, X.cpu().numpy())
         + rng.normal(0, 20, (C, B, T, P)))
    Y[:, :, T // 2:, ::5] += 800
    alive = rng.random((C, T, P)) < 0.9
    cur_k = rng.integers(4, 30, (C, P)).astype(np.int32)
    included = alive & (np.arange(T)[None, :, None] < cur_k[:, None, :])
    bufs = tuple(_t(rng.standard_normal((C, P, S) + k).astype(np.float32), dev)
                 for k in ((6,), (B,), (B,), (B, 8)))
    return dict(t=t, X=X, Yt=_t(Y.astype(np.int16), dev),
                alive=_t(alive, dev), included=_t(included, dev),
                cur_k=_t(cur_k, dev), coefs=_t(beta, dev), bufs=bufs,
                first_seg=_t(rng.random((C, P)) < 0.5, dev),
                nseg=_t(rng.integers(0, S + 1, (C, P)).astype(np.int32), dev))


def _clone(bufs):
    return tuple(b.clone() for b in bufs)


def test_fused_fit_close_matches_plain(dev):
    rng = np.random.default_rng(21)
    a = _round_args(rng, dev)
    C, B, T, P = a["Yt"].shape
    kind = rng.integers(0, 3, (C, P))
    args = (a["Yt"], a["X"], a["t"],
            _t((rng.random((C, T, P)) < 0.7).astype(np.float32), dev),
            _t(rng.random((C, P)) < 0.5, dev),
            _t(rng.integers(12, 30, (C, P)).astype(np.int32), dev),
            a["included"], a["coefs"],
            _t(rng.uniform(10, 40, (C, P, B)).astype(np.float32), dev),
            _t(rng.normal(0, 300, (C, P, B)).astype(np.float32), dev),
            _t(kind == 1, dev), _t(kind == 2, dev),
            _t(rng.integers(0, T, (C, P)).astype(np.int32), dev),
            _t(rng.integers(0, 7, (C, P)).astype(np.int32), dev),
            a["first_seg"], a["nseg"])
    before = cuda_ops.LAUNCHES["fused_fit_close"]
    got = cuda_ops.fused_fit_close(*args, _clone(a["bufs"]))
    assert cuda_ops.LAUNCHES["fused_fit_close"] == before + 1
    want = cuda_ops.fused_fit_close_plain(*args, _clone(a["bufs"]))
    for g, w in zip(got[0], want[0]):
        assert torch.equal(g, w)
    assert torch.equal(got[1], want[1])
    for g, w in zip(got[2:], want[2:]):
        torch.testing.assert_close(g, w, rtol=1e-2, atol=1e-2)


def test_fused_round_matches_plain(dev):
    rng = np.random.default_rng(22)
    a = _round_args(rng, dev)
    C, B, T, P = a["Yt"].shape
    in_mon = rng.random((C, P)) < 0.7
    init_ok = ~in_mon & (rng.random((C, P)) < 0.5)
    w_stab = (a["alive"].cpu().numpy() & (rng.random((C, T, P)) < 0.7)
              & init_ok[:, None, :])
    nlast = np.where(rng.random((C, P)) < 0.4,
                     a["included"].sum(1).cpu().numpy(), 1000)
    args = (a["Yt"], a["X"], a["t"], a["alive"], a["included"], a["cur_k"],
            _t(nlast.astype(np.int32), dev), _t(in_mon, dev), a["coefs"],
            torch.full((C, P, B), 20.0, device=dev),
            _t(rng.uniform(15, 25, (C, P, B)).astype(np.float32), dev),
            _t(init_ok, dev), _t(w_stab, dev),
            _t(w_stab.sum(1).astype(np.int32), dev), a["first_seg"],
            a["nseg"])
    kw = dict(change_thr=CHANGE_THR, outlier_thr=OUTLIER_THR)
    got = cuda_ops.fused_round(*args, _clone(a["bufs"]), **kw)
    want = cuda_ops.fused_round_plain(*args, _clone(a["bufs"]), **kw)
    assert all(want[4][k].any() for k in ("is_tail", "is_brk", "is_refit"))
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        if i == 2:      # seg_mag: the in-kernel PEEK-run median
            torch.testing.assert_close(g, w, rtol=5e-3, atol=1e-2)
        else:
            assert torch.equal(g, w), i
    assert torch.equal(got[1], want[1])
    for g, w in zip(got[2:4], want[2:4]):
        torch.testing.assert_close(g, w, rtol=1e-2, atol=1e-2)
    assert set(got[4]) == set(want[4])
    for k in want[4]:
        assert torch.equal(got[4][k], want[4][k]), k


def _fused_round_case(rng, dev, T, P, mode):
    """fused_round's inputs at T x P in one of the named modes: "mixed",
    "all_fit" (every pixel init-ok, none monitoring), "none_mon" (no pixel
    monitors) or "all_break" (every pixel monitors a step of 800)."""
    a = _round_args(rng, dev, T=T, P=P)
    C, B = a["Yt"].shape[:2]
    in_mon = rng.random((C, P)) < 0.7
    init_ok = ~in_mon & (rng.random((C, P)) < 0.5)
    nlast = np.where(rng.random((C, P)) < 0.4,
                     a["included"].sum(1).cpu().numpy(), 1000)
    if mode == "all_fit":
        in_mon, init_ok = np.zeros_like(in_mon), np.ones_like(init_ok)
    elif mode == "none_mon":
        in_mon = np.zeros_like(in_mon)
    elif mode == "all_break":
        in_mon, init_ok = np.ones_like(in_mon), np.zeros_like(init_ok)
        nlast = np.full_like(nlast, 10 * T)
        a["Yt"][:, :, T // 2:] += 800
    w_stab = (a["alive"].cpu().numpy() & (rng.random((C, T, P)) < 0.7)
              & init_ok[:, None, :])
    args = (a["Yt"], a["X"], a["t"], a["alive"], a["included"], a["cur_k"],
            _t(nlast.astype(np.int32), dev), _t(in_mon, dev), a["coefs"],
            torch.full((C, P, B), 20.0, device=dev),
            _t(rng.uniform(15, 25, (C, P, B)).astype(np.float32), dev),
            _t(init_ok, dev), _t(w_stab, dev),
            _t(w_stab.sum(1).astype(np.int32), dev), a["first_seg"],
            a["nseg"])
    return args, a["bufs"]


@pytest.mark.parametrize("mode,T,P", [("all_fit", 96, 141),
                                      ("none_mon", 96, 141),
                                      ("all_break", 96, 141),
                                      ("mixed", 64 + 13, 141),
                                      ("mixed", 96, 50)])
def test_fused_round_cases_match_plain(dev, mode, T, P):
    """The named cases, and T off a multiple of 32 and P off a multiple of
    the kernel's 32-pixel tile."""
    args, bufs = _fused_round_case(np.random.default_rng(23), dev, T, P, mode)
    kw = dict(change_thr=CHANGE_THR, outlier_thr=OUTLIER_THR)
    got = cuda_ops.fused_round(*args, _clone(bufs), **kw)
    want = cuda_ops.fused_round_plain(*args, _clone(bufs), **kw)
    if mode == "all_break":
        assert want[4]["is_brk"].all()
    if mode == "all_fit":
        assert want[4]["do_fit"].all()
    if mode == "none_mon":
        assert not (want[4]["is_tail"] | want[4]["is_brk"]).any()
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        if i == 2:
            torch.testing.assert_close(g, w, rtol=5e-3, atol=1e-2)
        else:
            assert torch.equal(g, w), i
    assert torch.equal(got[1], want[1])
    for g, w in zip(got[2:4], want[2:4]):
        torch.testing.assert_close(g, w, rtol=1e-2, atol=1e-2)
    for k in want[4]:
        assert torch.equal(got[4][k], want[4][k]), k


def test_fused_round_fit_equals_lasso_fit(dev):
    """The refit's coefficients and RMSE are lasso_fit's bit for bit on the
    same windows (route "mon" equals route 0 because of it)."""
    args, bufs = _fused_round_case(np.random.default_rng(24), dev, 96, 141,
                                   "mixed")
    kw = dict(change_thr=CHANGE_THR, outlier_thr=OUTLIER_THR)
    _, _, coefs, rmse, ev = cuda_ops.fused_round(*args, _clone(bufs), **kw)
    init_ok, w_stab = args[11], args[12]
    w = torch.where(init_ok[:, None, :], w_stab,
                    ev["included_mon"] & ev["is_refit"][:, None, :])
    fit = ev["do_fit"]
    assert fit.any()
    want = cuda_ops.lasso_fit(args[0], w.float().contiguous(), args[1],
                              coefmask_for(ev["n_full"]))
    assert torch.equal(coefs[fit], want[0][fit])
    assert torch.equal(rmse[fit], want[1][fit])
    assert torch.equal(coefs[~fit], args[8][~fit])


def _s2_round_case(rng, dev, T=96, P=141):
    """fused_round's inputs on the 12-band layout ("mixed" mode)."""
    a = _round_args(rng, dev, B=12, T=T, P=P)
    C = a["Yt"].shape[0]
    in_mon = rng.random((C, P)) < 0.7
    init_ok = ~in_mon & (rng.random((C, P)) < 0.5)
    nlast = np.where(rng.random((C, P)) < 0.4,
                     a["included"].sum(1).cpu().numpy(), 1000)
    w_stab = (a["alive"].cpu().numpy() & (rng.random((C, T, P)) < 0.7)
              & init_ok[:, None, :])
    args = (a["Yt"], a["X"], a["t"], a["alive"], a["included"], a["cur_k"],
            _t(nlast.astype(np.int32), dev), _t(in_mon, dev), a["coefs"],
            torch.full((C, P, 12), 20.0, device=dev),
            _t(rng.uniform(15, 25, (C, P, 12)).astype(np.float32), dev),
            _t(init_ok, dev), _t(w_stab, dev),
            _t(w_stab.sum(1).astype(np.int32), dev), a["first_seg"],
            a["nseg"])
    return args, a["bufs"]


def test_fused_round_sentinel2_matches_plain(dev):
    args, bufs = _s2_round_case(np.random.default_rng(25), dev)
    kw = dict(change_thr=CHANGE_THR, outlier_thr=OUTLIER_THR,
              sensor=SENTINEL2)
    got = cuda_ops.fused_round(*args, _clone(bufs), **kw)
    want = cuda_ops.fused_round_plain(*args, _clone(bufs), **kw)
    assert all(want[4][k].any() for k in ("is_tail", "is_brk", "is_refit"))
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        if i == 2:
            torch.testing.assert_close(g, w, rtol=5e-3, atol=1e-2)
        else:
            assert torch.equal(g, w), i
    assert torch.equal(got[1], want[1])
    for g, w in zip(got[2:4], want[2:4]):
        torch.testing.assert_close(g, w, rtol=1e-2, atol=1e-2)
    for k in want[4]:
        assert torch.equal(got[4][k], want[4][k]), k


def test_fused_round_fit_equals_lasso_fit_sentinel2(dev):
    """The 12-band refit is lasso_fit's 12-band instance bit for bit (lanes
    0-3 own two bands each)."""
    args, bufs = _s2_round_case(np.random.default_rng(26), dev)
    kw = dict(change_thr=CHANGE_THR, outlier_thr=OUTLIER_THR,
              sensor=SENTINEL2)
    _, _, coefs, rmse, ev = cuda_ops.fused_round(*args, _clone(bufs), **kw)
    init_ok, w_stab = args[11], args[12]
    w = torch.where(init_ok[:, None, :], w_stab,
                    ev["included_mon"] & ev["is_refit"][:, None, :])
    fit = ev["do_fit"]
    assert fit.any()
    want = cuda_ops.lasso_fit(args[0], w.float().contiguous(), args[1],
                              coefmask_for(ev["n_full"]))
    assert torch.equal(coefs[fit], want[0][fit])
    assert torch.equal(rmse[fit], want[1][fit])


def test_fused_fit_close_and_lasso_cd_12_bands(dev):
    """The 12-band instances of fused_fit_close and lasso_cd against their
    plain versions."""
    rng = np.random.default_rng(27)
    a = _round_args(rng, dev, B=12)
    C, B, T, P = a["Yt"].shape
    kind = rng.integers(0, 3, (C, P))
    w = _t((rng.random((C, T, P)) < 0.7).astype(np.float32), dev)
    args = (a["Yt"], a["X"], a["t"], w, _t(rng.random((C, P)) < 0.5, dev),
            _t(rng.integers(12, 30, (C, P)).astype(np.int32), dev),
            a["included"], a["coefs"],
            _t(rng.uniform(10, 40, (C, P, B)).astype(np.float32), dev),
            _t(rng.normal(0, 300, (C, P, B)).astype(np.float32), dev),
            _t(kind == 1, dev), _t(kind == 2, dev),
            _t(rng.integers(0, T, (C, P)).astype(np.int32), dev),
            _t(rng.integers(0, 7, (C, P)).astype(np.int32), dev),
            a["first_seg"], a["nseg"])
    got = cuda_ops.fused_fit_close(*args, _clone(a["bufs"]))
    want = cuda_ops.fused_fit_close_plain(*args, _clone(a["bufs"]))
    for g, v in zip(got[0], want[0]):
        assert torch.equal(g, v)
    assert torch.equal(got[1], want[1])
    for g, v in zip(got[2:], want[2:]):
        torch.testing.assert_close(g, v, rtol=1e-2, atol=1e-2)
    mask = coefmask_for(args[5])
    G, c, _ = cuda_ops.gram_plain(a["Yt"], w, a["X"])
    diag = torch.diagonal(G, dim1=-2, dim2=-1).clamp_min(1e-12).contiguous()
    torch.testing.assert_close(cuda_ops.lasso_cd(G, c, diag, mask),
                               cuda_ops.lasso_cd_plain(G, c, diag, mask),
                               rtol=1e-5, atol=1e-5)


def test_sentinel2_routes_on_card(dev):
    """A 64-pixel Sentinel-2 cut through routes 0, 1, "mon" and mega on
    the card: route 1 equals route 0, "mon" equals it but seg_mag, mega
    decides as "mon", and route 0 decides as the plain route on the CPU."""
    src = SyntheticSource(88, start="2019-01-01", end="2023-01-01",
                          cloud_frac=0.15, sensor=SENTINEL2)
    p = pack([src.chip(100, 200)], bucket=32)
    sel = np.arange(64) * (p.spectra.shape[2] // 64)
    packed = dataclasses.replace(
        p, spectra=np.ascontiguousarray(p.spectra[:, :, sel]),
        qas=np.ascontiguousarray(p.qas[:, sel]))
    base = kernel.detect_packed(packed, fused=0, compact=False)
    assert int(base.n_segments.max()) >= 2
    one = kernel.detect_packed(packed, fused=1, compact=False)
    mon = kernel.detect_packed(packed, fused="mon", compact=False)
    mega = kernel.detect_packed(packed, pallas="mega")
    for f in ("n_segments", "seg_meta", "seg_rmse", "seg_mag", "seg_coef",
              "mask", "procedure", "rounds", "vario", "round_counts"):
        assert torch.equal(getattr(one, f), getattr(base, f)), f
        if f != "seg_mag":
            assert torch.equal(getattr(mon, f), getattr(base, f)), f
    _decisions_equal(mega, mon)
    cpu = kernel.detect_packed(packed, device="cpu", compact=False)
    _decisions_equal(base, cpu)


def test_fused_round_geometry_on_card(dev):
    """The runtime's shared memory and occupancy agree with the host-side
    helper's at T=768."""
    g = cuda_ops.kernel_geometry(768)["fused_round"]
    assert g["smem_bytes"] == cuda_ops.fused_round_smem_bytes(768)
    assert g["blocks_per_sm"] >= cuda_ops.FUSED_ROUND_MIN_BLOCKS
    with pytest.raises(ValueError, match="shared memory"):
        cuda_ops.fused_round_geometry(4096)


def test_lasso_cd_matches_plain(dev):
    rng = np.random.default_rng(5)
    C, B, T, P = 2, 7, 60, 141
    _, X, _ = _designs(rng, C, T, dev)
    Yt = _t(rng.integers(0, 8000, (C, B, T, P)).astype(np.int16), dev)
    w = _t((rng.random((C, T, P)) < 0.8).astype(np.float32), dev)
    mask = _t(np.arange(8) < rng.choice([4, 6, 8], (C, P))[..., None], dev)
    G, c, _ = cuda_ops.gram_plain(Yt, w, X)
    diag = torch.diagonal(G, dim1=-2, dim2=-1).clamp_min(1e-12).contiguous()
    before = cuda_ops.LAUNCHES["lasso_cd"]
    got = cuda_ops.lasso_cd(G, c, diag, mask)
    assert cuda_ops.LAUNCHES["lasso_cd"] == before + 1
    want = cuda_ops.lasso_cd_plain(G, c, diag, mask)
    # Both run the same sweeps in the same order on the same Gram.
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_monitor_chain_matches_plain(dev):
    rng = np.random.default_rng(14)
    C, T, P = 2, 96, 137
    alive = rng.random((C, T, P)) < 0.8
    args = (_t(rng.gamma(2.0, 6.0, (C, T, P)).astype(np.float32), dev),
            _t(alive, dev), _t((rng.random((C, T, P)) < 0.4) & alive, dev),
            _t(rng.integers(0, T, (C, P)).astype(np.int32), dev),
            _t(rng.integers(1, 40, (C, P)).astype(np.int32), dev),
            _t(rng.random((C, P)) < 0.7, dev))
    kw = dict(change_thr=CHANGE_THR, outlier_thr=OUTLIER_THR)
    got = cuda_ops.monitor_chain(*args, **kw)
    # The kernel gives a pixel that does not monitor the zero outputs.
    want = cuda_ops.monitoring_only(cuda_ops.monitor_chain_plain(*args, **kw),
                                    args[5])
    assert set(got) == set(want)
    assert all(want[k].any() for k in ("is_tail", "is_brk", "is_refit"))
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("T", [64, 768, 100])
def test_monitor_chain_tiles(dev, T):
    """The tile kernel through monitoring_only at T a multiple of 32 and
    not, a tile with no monitoring pixel, scores that are NaN, +-inf or
    exactly at a threshold; one launch a call."""
    rng = np.random.default_rng(30 + T)
    C, P = 2, 137
    s = rng.gamma(2.0, 6.0, (C, T, P)).astype(np.float32)
    special = np.float32([np.nan, np.inf, -np.inf, CHANGE_THR, OUTLIER_THR])
    pick = rng.random(s.shape) < 0.05
    s[pick] = rng.choice(special, int(pick.sum()))
    alive = rng.random((C, T, P)) < 0.8
    in_mon = rng.random((C, P)) < 0.7
    in_mon[0, 32:64] = False
    args = (_t(s, dev), _t(alive, dev),
            _t((rng.random((C, T, P)) < 0.4) & alive, dev),
            _t(rng.integers(0, T, (C, P)).astype(np.int32), dev),
            _t(rng.integers(1, 40, (C, P)).astype(np.int32), dev),
            _t(in_mon, dev))
    kw = dict(change_thr=CHANGE_THR, outlier_thr=OUTLIER_THR)
    before = cuda_ops.LAUNCHES["monitor_chain"]
    got = cuda_ops.monitor_chain(*args, **kw)
    assert cuda_ops.LAUNCHES["monitor_chain"] == before + 1
    want = cuda_ops.monitoring_only(cuda_ops.monitor_chain_plain(*args, **kw),
                                    args[5])
    assert want["is_brk"].any()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert not got["m"][0, 32:64].any() and not got["inc_q"][0, :, 32:64].any()


@pytest.mark.parametrize("B", [7, 12])
def test_lasso_cd_tiles(dev, B):
    """The tile kernel equals the plain version at P not a multiple of 32,
    with a tile whose systems are all zero (no weight), a full tile and a
    pixel with only some bands zero; one launch a call; a misaligned Gram
    is refused."""
    rng = np.random.default_rng(40 + B)
    C, T, P = 2, 60, 141
    _, X, _ = _designs(rng, C, T, dev)
    Y = rng.integers(0, 8000, (C, B, T, P)).astype(np.int16)
    Y[0, : B // 2, :, 5] = 0
    w = (rng.random((C, T, P)) < 0.8).astype(np.float32)
    w[0, :, 32:64] = 0.0
    mask = _t(np.arange(8) < rng.choice([4, 6, 8], (C, P))[..., None], dev)
    G, c, _ = cuda_ops.gram_plain(_t(Y, dev), _t(w, dev), X)
    diag = torch.diagonal(G, dim1=-2, dim2=-1).clamp_min(1e-12).contiguous()
    assert not c[0, 32:64].any() and not c[0, 5, : B // 2].any()
    before = cuda_ops.LAUNCHES["lasso_cd"]
    got = cuda_ops.lasso_cd(G, c, diag, mask)
    assert cuda_ops.LAUNCHES["lasso_cd"] == before + 1
    want = cuda_ops.lasso_cd_plain(G, c, diag, mask)
    assert torch.equal(got, want)
    assert torch.equal(got[0, 32:64].view(torch.int32),
                       torch.zeros_like(got[0, 32:64]).view(torch.int32))
    # The kernel reads G, c and diag in 16-byte loads.
    shifted = torch.empty(G.numel() + 1, device=dev)[1:].view(G.shape)
    shifted.copy_(G)
    with pytest.raises(ValueError, match="16-byte"):
        cuda_ops.lasso_cd(shifted, c, diag, mask)


def test_component_kernels_geometry_on_card(dev):
    """lasso_cd's and monitor_chain's shared memory as the runtime reports
    it equals the host-side formulas; lasso_cd keeps its chains in
    registers (no local memory)."""
    geo = cuda_ops.kernel_geometry(768, 7)
    assert geo["monitor_chain"]["smem_bytes"] == \
        cuda_ops.monitor_chain_smem_bytes(768)
    assert geo["monitor_chain"]["blocks_per_sm"] >= 1
    for B in (7, 12):
        g = cuda_ops.kernel_geometry(768, B)["lasso_cd"]
        assert g["smem_bytes"] == cuda_ops.lasso_cd_smem_bytes()
        assert g["blocks_per_sm"] >= 1 and g["local_bytes"] == 0, g


@pytest.mark.parametrize("W", [24, 40])
def test_tmask_bad_matches_plain(dev, W):
    rng = np.random.default_rng(9)
    C, P = 2, 153
    Xtw = rng.normal(0, 1, (C, P, W, 5)).astype(np.float32)
    Xtw[..., 0] = 1.0
    Y2 = (400 + 80 * rng.normal(0, 1, (C, P, 2, W))).astype(np.float32)
    Y2[rng.random(Y2.shape) < 0.05] += 900
    nwin = rng.integers(0, W + 1, (C, P))
    w = (np.arange(W) < nwin[..., None]).astype(np.float32)
    Y2[0, 7] = 444.0                   # constant series -> singular Gram
    args = (_t(Xtw, dev), _t(Y2, dev), _t(w, dev),
            _t(np.abs(rng.normal(40, 10, (C, P, 2))).astype(np.float32), dev))
    got = cuda_ops.tmask_bad(*args)
    want = cuda_ops.tmask_bad_plain(*args)
    assert want.any() and not want[0, 7].any()
    assert torch.equal(got, want)


def _decisions_equal(a, b):
    for f in ("n_segments", "procedure", "mask", "seg_meta"):
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu()), f


def test_mega_route_on_card(dev):
    """One detect_mega launch per dispatch after the prologue's lasso_fit;
    every field equal to route "mon" (the same device code) but the
    per-chip rounds and round_counts, whose maximum over chips is route
    0's rounds; decisions equal to the mega route's plain version."""
    packed = _tiny_packed()
    base = kernel.detect_packed(packed, fused=0)
    mon = kernel.detect_packed(packed, fused="mon")
    cuda_ops.reset_launches()
    seg = kernel.detect_packed(packed, pallas="mega")
    assert {k: n for k, n in cuda_ops.LAUNCHES.items() if n > 0} == {
        "lasso_fit": 1, "detect_mega": 1}
    for f in ("n_segments", "seg_meta", "seg_rmse", "seg_mag", "seg_coef",
              "mask", "procedure", "vario"):
        assert torch.equal(getattr(seg, f), getattr(mon, f)), f
    assert int(seg.rounds.max()) == int(base.rounds[0])
    ref = kernel.detect_packed(packed, pallas="mega", ops=cuda_ops.PLAIN)
    _decisions_equal(seg, ref)
    assert torch.equal(seg.rounds, ref.rounds)
    assert torch.equal(seg.round_counts, ref.round_counts)
    torch.testing.assert_close(seg.seg_mag, ref.seg_mag, rtol=5e-3, atol=1e-2)


def _mega_state(rng, dev, B, T=64, P=97, long_pixel=None, done_tile=None):
    """A detect_mega start state: ~16-day revisits over ~2.8 years, a
    harmonic model per pixel plus noise, a step of 800 on every third pixel
    from step 35 on, 3 % spikes; every pixel with an alive step starts in
    INIT.  ``long_pixel``: a pixel on a steep trend (3 a day), whose
    stability test fails at every cursor, so that it walks its series one
    INIT a round, the other pixels of its tile DONE from the start;
    ``done_tile``: a tile whose pixels are all DONE from the start."""
    TILE = cuda_ops.TILE
    t = (729000 + np.cumsum(rng.integers(10, 22, T))).astype(np.float64)
    X = harmonic.design_matrix(t, t[0], 8).astype(np.float32)
    X6 = harmonic.design_matrix(t, t[0], 6)
    Xt = np.concatenate([X6[:, :1], X6[:, 2:]], 1).astype(np.float32)
    beta = np.zeros((P, B, 8))
    beta[..., 0] = rng.uniform(500, 3000, (P, B))
    beta[..., 2:6] = rng.normal(0, 150, (P, B, 4))
    Y = np.einsum("pbk,tk->btp", beta, X) + rng.normal(0, 20, (B, T, P))
    Y[:, 35:, ::3] += 800
    Y[:, rng.random((T, P)) < 0.03] += 2500
    alive = rng.random((P, T)) < 0.92
    phase = np.where(alive.any(1), cuda_ops.PHASE_INIT, cuda_ops.PHASE_DONE)
    if done_tile is not None:
        phase[done_tile * TILE:(done_tile + 1) * TILE] = cuda_ops.PHASE_DONE
    if long_pixel is not None:
        g = long_pixel // TILE
        phase[g * TILE:(g + 1) * TILE] = cuda_ops.PHASE_DONE
        phase[long_pixel] = cuda_ops.PHASE_INIT
        alive[long_pixel] = True
        Y[:, :, long_pixel] = (1000 + 3 * (t - t[0]))[None] + rng.normal(
            0, 20, (B, T))
    S = 4
    vario = np.abs(rng.normal(40, 10, (P, B))) + 1
    return (_t(Y.astype(np.int16)[None], dev),
            _t(phase.astype(np.int32)[None], dev),
            _t(alive.argmax(1).astype(np.int32)[None], dev),
            _t(alive.T[None].copy(), dev),
            _t(rng.integers(0, 2, (1, P)).astype(np.int32), dev),
            tuple(_t(rng.standard_normal((1, P, S) + k).astype(np.float32),
                     dev) for k in ((6,), (B,), (B,), (B, 8))),
            _t(t.astype(np.float32)[None], dev), _t(X[None], dev),
            _t(Xt[None], dev), _t(vario.astype(np.float32)[None], dev))


def _mega_vs_plain(args, W, sensor):
    kw = dict(W=W, change_thr=CHANGE_THR, outlier_thr=OUTLIER_THR,
              sensor=sensor)
    a, bufs, tail = args[:5], args[5], args[6:]
    before = cuda_ops.LAUNCHES["detect_mega"]
    got = cuda_ops.detect_mega(*a, _clone(bufs), *tail, **kw)
    assert cuda_ops.LAUNCHES["detect_mega"] == before + 1
    want = cuda_ops.detect_mega_plain(*a, _clone(bufs), *tail, **kw)
    for k in ("nseg", "alive", "meta", "rounds", "counts"):
        assert torch.equal(got[k], want[k]), k
    # The fits sum their Grams in another order than the plain einsum.
    for k in ("rmse", "coef"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(got["mag"], want["mag"], rtol=5e-3,
                               atol=1e-2)
    return got, want


@pytest.mark.parametrize("W", [24, 40, 100])
@pytest.mark.parametrize("sensor", [LANDSAT_ARD, SENTINEL2])
def test_detect_mega_matches_plain(dev, sensor, W):
    """Both band layouts at each window instance (W 24, 40 and 100 take
    the 32, 64 and 128 instances), on a ragged last tile."""
    args = _mega_state(np.random.default_rng(60 + W), dev, sensor.n_bands)
    got, _ = _mega_vs_plain(args, W, sensor)
    assert int(got["nseg"].max()) >= 2 and (got["counts"] > 0).all()


@pytest.mark.parametrize("P", [33, 31])
def test_detect_mega_edge_tiles(dev, P):
    """P one past and one short of the 32-pixel tile."""
    args = _mega_state(np.random.default_rng(70 + P), dev, 7, P=P)
    _mega_vs_plain(args, 24, LANDSAT_ARD)


def test_detect_mega_idle_tiles(dev):
    """A tile whose pixels are all DONE from the start, and a tile whose one
    working pixel runs far more rounds than any other (its INIT fails the
    stability test at every cursor) while its other pixels sit DONE: the
    chip's rounds are that pixel's."""
    args = _mega_state(np.random.default_rng(80), dev, 7, P=97,
                       long_pixel=40, done_tile=0)
    got, _ = _mega_vs_plain(args, 24, LANDSAT_ARD)
    alone = [a[..., 40:41].contiguous() if a.dim() >= 2 and a.shape[-1] == 97
             else a for a in args[:5]]
    bufs = tuple(b[:, 40:41].contiguous() for b in args[5])
    tail = args[6:9] + (args[9][:, 40:41].contiguous(),)
    one = cuda_ops.detect_mega(*alone, bufs, *tail, W=24,
                               change_thr=CHANGE_THR,
                               outlier_thr=OUTLIER_THR)
    assert int(one["rounds"][0]) == int(got["rounds"][0]) > 20
    assert int(got["nseg"][0, :32].sum()) == int(args[4][0, :32].sum())


@pytest.mark.parametrize("W", [24, 64, 128])
@pytest.mark.parametrize("sensor", ["landsat", "sentinel2"])
def test_mega_equals_mon_at_each_instance(dev, sensor, W):
    """The mega route equals route "mon" in every field but the per-chip
    rounds and round_counts, at each window instance, on the tiny Landsat
    chips and a 64-pixel Sentinel-2 cut."""
    if sensor == "landsat":
        packed = _tiny_packed()
    else:
        src = SyntheticSource(88, start="2019-01-01", end="2023-01-01",
                              cloud_frac=0.15, sensor=SENTINEL2)
        p = pack([src.chip(100, 200)], bucket=32)
        sel = np.arange(64) * (p.spectra.shape[2] // 64)
        packed = dataclasses.replace(
            p, spectra=np.ascontiguousarray(p.spectra[:, :, sel]),
            qas=np.ascontiguousarray(p.qas[:, sel]))
    staged = kernel.stage_packed(packed, dev)
    run = lambda **kw: kernel.detect_staged(
        *staged, W=W, sensor=packed.sensor, compact=False, **kw)
    cuda_ops.reset_launches()
    mega = run(pallas="mega")
    assert cuda_ops.LAUNCHES["detect_mega"] == 1
    assert cuda_ops.REFUSED["detect_mega"] == 0
    mon = run(pallas="1", fused="mon")
    for f in ("n_segments", "seg_meta", "seg_rmse", "seg_mag", "seg_coef",
              "mask", "procedure", "vario"):
        assert torch.equal(getattr(mega, f), getattr(mon, f)), f
    assert int(mega.rounds.max()) == int(mon.rounds[0])


@pytest.mark.parametrize("P", [33, 31])
@pytest.mark.parametrize("B", [7, 12])
def test_fused_fit_close_edge_tiles(dev, B, P):
    """P one past and one short of the tile, both band counts, and a tile
    with no closing and no fitting pixel (it copies its model and counts
    its segments only)."""
    rng = np.random.default_rng(90 + P + B)
    a = _round_args(rng, dev, B=B, P=P)
    C, _, T, _ = a["Yt"].shape
    kind = rng.integers(0, 3, (C, P))
    do_fit = rng.random((C, P)) < 0.5
    kind[1, :32] = 0
    do_fit[1, :32] = False                  # chip 1's first tile: idle
    args = (a["Yt"], a["X"], a["t"],
            _t((rng.random((C, T, P)) < 0.7).astype(np.float32), dev),
            _t(do_fit, dev),
            _t(rng.integers(12, 30, (C, P)).astype(np.int32), dev),
            a["included"], a["coefs"],
            _t(rng.uniform(10, 40, (C, P, B)).astype(np.float32), dev),
            _t(rng.normal(0, 300, (C, P, B)).astype(np.float32), dev),
            _t(kind == 1, dev), _t(kind == 2, dev),
            _t(rng.integers(0, T, (C, P)).astype(np.int32), dev),
            _t(rng.integers(0, 7, (C, P)).astype(np.int32), dev),
            a["first_seg"], a["nseg"])
    bufs = _clone(a["bufs"])
    got = cuda_ops.fused_fit_close(*args, bufs)
    want = cuda_ops.fused_fit_close_plain(*args, _clone(a["bufs"]))
    for g, v in zip(got[0], want[0]):
        assert torch.equal(g, v)
    assert torch.equal(got[1], want[1])
    for g, v in zip(got[2:], want[2:]):
        torch.testing.assert_close(g, v, rtol=1e-2, atol=1e-2)
    # The idle tile: the model as it was, the buffers untouched.
    assert torch.equal(got[2][1, :32], a["coefs"][1, :32])
    assert torch.equal(got[1][1, :32], a["nseg"][1, :32])
    for g, v in zip(bufs, a["bufs"]):
        assert torch.equal(g[1, :32], v[1, :32])


def test_tile_kernels_geometry_on_card(dev):
    """fused_fit_close's, every detect_mega, init_window and tmask_bad
    instance's shared memory as the host-side helpers compute it, and at
    least one block an SM at T=768 (init_window also at T_MAX); mega_fits's
    limit is the card's."""
    geo = cuda_ops.kernel_geometry(768)
    assert geo["fused_fit_close"]["smem_bytes"] == \
        cuda_ops.fused_fit_close_smem_bytes(768)
    for w, g in geo["detect_mega"].items():
        assert g["smem_bytes"] == cuda_ops.detect_mega_smem_bytes(768), w
        assert g["blocks_per_sm"] >= 1, w
    for w, g in geo["init_window"].items():
        assert g["smem_bytes"] == cuda_ops.init_window_smem_bytes(768, w), w
        assert g["blocks_per_sm"] >= 1, w
    for w, g in cuda_ops.init_window_geometry(cuda_ops.T_MAX).items():
        assert g["blocks_per_sm"] >= 1, w
    for w, g in geo["tmask_bad"].items():
        assert g["smem_bytes"] == cuda_ops.tmask_bad_smem_bytes(w)
        assert g["blocks_per_sm"] >= 1, w
    with pytest.raises(ValueError, match="detect_mega"):
        args = _mega_state(np.random.default_rng(1), dev, 7, P=8)
        cuda_ops.detect_mega(*args[:5], args[5], *args[6:], W=129,
                             change_thr=CHANGE_THR, outlier_thr=OUTLIER_THR)


def test_component_route_on_card(dev):
    """pallas="lasso,monitor,tmask" launches exactly the three component
    kernels and decides as route 0 and as its own plain version."""
    packed = _tiny_packed()
    base = kernel.detect_packed(packed, fused=0)
    cuda_ops.reset_launches()
    seg = kernel.detect_packed(packed, pallas="lasso,monitor,tmask")
    launched = {k for k, n in cuda_ops.LAUNCHES.items() if n > 0}
    assert launched == {"lasso_cd", "monitor_chain", "tmask_bad"}
    _decisions_equal(seg, base)
    ref = kernel.detect_packed(packed, pallas="lasso,monitor,tmask",
                               ops=cuda_ops.PLAIN)
    _decisions_equal(seg, ref)
    torch.testing.assert_close(seg.seg_rmse, ref.seg_rmse, rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("fused", [1, "mon"])
def test_fused_routes_on_card(dev, fused):
    """Route 1 is byte-identical to route 0 on the card; route "mon"
    equals it in every field but seg_mag, and launches no
    monitor_chain_scored."""
    packed = _tiny_packed()
    base = kernel.detect_packed(packed, fused=0)
    cuda_ops.reset_launches()
    seg = kernel.detect_packed(packed, fused=fused)
    launched = {k for k, n in cuda_ops.LAUNCHES.items() if n > 0}
    if fused == 1:
        assert launched == {"lasso_fit", "monitor_chain_scored",
                            "init_window", "fused_fit_close"}
    else:
        assert launched == {"lasso_fit", "init_window", "fused_round"}
    for f in ("n_segments", "seg_meta", "seg_rmse", "seg_mag", "seg_coef",
              "mask", "procedure", "rounds", "vario", "round_counts"):
        a, b = getattr(seg, f), getattr(base, f)
        if fused == "mon" and f == "seg_mag":
            torch.testing.assert_close(a, b, rtol=5e-3, atol=1e-2)
        else:
            assert torch.equal(a, b), f


# ---------------------------------------------------------------------------
# ring_remote_copy, compaction and the sharded path
# ---------------------------------------------------------------------------

def _ring_payload(rng, dev, i):
    """Mixed dtypes, byte counts off multiples of 16, a 0-d tensor, an
    empty one, and a view whose start is not 16-byte aligned."""
    base = _t(rng.integers(0, 255, (41,)).astype(np.uint8), dev)
    return [_t(rng.standard_normal((3, 5)).astype(np.float32), dev),
            _t(rng.integers(-9, 9, (7,)).astype(np.int16), dev),
            _t(rng.random((2, 3, 3)) < 0.5, dev),
            torch.tensor(i, dtype=torch.int64, device=dev),
            _t(rng.integers(0, 2**31, (1000, 37)).astype(np.int32), dev),
            torch.zeros(0, 4, device=dev), base[3:]]


@pytest.mark.parametrize("n", [2, 3])
def test_ring_remote_copy_matches_plain(dev, n):
    """Every shard on the one card: byte-equal to the plain copy and to
    the sources, one launch per source shard."""
    rng = np.random.default_rng(n)
    payloads = [_ring_payload(rng, dev, i) for i in range(n)]
    raw = lambda t: t.reshape(-1).view(torch.uint8)
    before = cuda_ops.LAUNCHES["ring_remote_copy"]
    got = cuda_ops.ring_remote_copy(payloads, 1)
    assert cuda_ops.LAUNCHES["ring_remote_copy"] == before + n
    want = cuda_ops.ring_remote_copy_plain(payloads, 1)
    torch.cuda.synchronize()
    for i in range(n):
        for a, b, src in zip(got[(i + 1) % n], want[(i + 1) % n],
                             payloads[i]):
            assert a.device == src.device and a.shape == src.shape
            assert torch.equal(raw(a), raw(b)) and torch.equal(raw(a),
                                                               raw(src))


@pytest.mark.parametrize("n_leaves", [1, 128])
def test_ring_remote_copy_leaf_counts(dev, n_leaves):
    """One leaf and the most a launch carries, odd sizes, two shards."""
    rng = np.random.default_rng(n_leaves)

    def payload():
        return [_t(rng.integers(0, 255, (int(rng.integers(0, 5000)),))
                   .astype(np.uint8), dev) for _ in range(n_leaves)]

    payloads = [payload(), payload()]
    got = cuda_ops.ring_remote_copy(payloads, 1)
    torch.cuda.synchronize()
    for i in range(2):
        for a, src in zip(got[(i + 1) % 2], payloads[i]):
            assert a.shape == src.shape and torch.equal(a, src)


def test_ring_remote_copy_unaligned_views(dev):
    """Sources that start off a 16-byte boundary (views into a larger
    tensor), of odd sizes, next to large aligned leaves of several spans."""
    rng = np.random.default_rng(31)
    big = _t(rng.integers(0, 255, (3 * cuda_ops.RING_SPAN + 77,))
             .astype(np.uint8), dev)
    payloads = [[big[1:], big[3:70003], big[16:16 + cuda_ops.RING_SPAN + 5],
                 _t(rng.standard_normal((257, 129)).astype(np.float32), dev),
                 big[7:8]] for _ in range(2)]
    raw = lambda t: t.reshape(-1).view(torch.uint8)
    got = cuda_ops.ring_remote_copy(payloads, -1)
    want = cuda_ops.ring_remote_copy_plain(payloads, -1)
    torch.cuda.synchronize()
    for j in range(2):
        for a, b, src in zip(got[j], want[j], payloads[(j + 1) % 2]):
            assert a.dtype == src.dtype and a.shape == src.shape
            assert torch.equal(raw(a), raw(b)) and torch.equal(raw(a),
                                                               raw(src))


def test_ring_remote_copy_across_two_cards(dev):
    """A peer write from cuda:0 into cuda:1 and back (needs two cards)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    rng = np.random.default_rng(9)
    devs = [torch.device("cuda", 0), torch.device("cuda", 1)]
    payloads = [_ring_payload(rng, d, i) for i, d in enumerate(devs)]
    got = cuda_ops.ring_remote_copy(payloads, 1)
    torch.cuda.synchronize(devs[0])
    torch.cuda.synchronize(devs[1])
    for i in range(2):
        for a, src in zip(got[(i + 1) % 2], payloads[i]):
            assert a.device == devs[(i + 1) % 2]
            assert torch.equal(a.cpu(), src.cpu())


def test_compact_on_card_equals_off(dev, monkeypatch):
    """Compaction and the bucketed tail leave every result field as it
    was, on route 0 and on route "mon"."""
    monkeypatch.setenv("FIREBIRD_COMPACT_MIN_LANES", "8")
    packed = _tiny_packed()
    for fused in (0, "mon"):
        off = kernel.detect_packed(packed, fused=fused, compact=False)
        on = kernel.detect_packed(packed, fused=fused, compact=True)
        assert int(on.compactions.sum()) > 0
        for f in ("n_segments", "seg_meta", "seg_rmse", "seg_mag",
                  "seg_coef", "mask", "procedure", "rounds", "vario",
                  "round_counts"):
            assert torch.equal(getattr(on, f), getattr(off, f)), (fused, f)


def test_sharded_ring_on_card(dev, monkeypatch):
    """Two shards on the one card: the ring migrates lanes through three
    ring_remote_copy hops (one launch per shard each) and leaves the
    store fields equal to the ring-off and the unsharded dispatch."""
    from firebird_tpu_torch.parallel import detect_sharded

    monkeypatch.setenv("FIREBIRD_COMPACT_MIN_LANES", "8")
    packed = _tiny_packed()
    qas = packed.qas.copy()
    qas[1, 10:] = 1                     # the second shard: one row of land
    packed = dataclasses.replace(packed, qas=qas)
    devices = ["cuda:0", "cuda:0"]
    cuda_ops.reset_launches()
    on = detect_sharded(packed, devices, compact=True, rebalance=True,
                        fused=0, check_capacity=False)
    assert cuda_ops.LAUNCHES["ring_remote_copy"] == 6
    assert int(on.lanes_migrated.sum()) > 0
    off = detect_sharded(packed, devices, compact=True, rebalance=False,
                         fused=0)
    whole = kernel.detect_packed(packed, compact=True, fused=0)
    for f in ("n_segments", "seg_meta", "seg_rmse", "seg_mag", "seg_coef",
              "mask", "procedure"):
        assert torch.equal(getattr(on, f), getattr(off, f)), f
        assert torch.equal(getattr(on, f), getattr(whole, f)), f


# ---------------------------------------------------------------------------
# The mixed-precision instances (FIREBIRD_MIXED_PRECISION)
# ---------------------------------------------------------------------------

EPS32 = 2.0 ** -23


def _scaled_ulps(got, want, vector=False):
    """params.MIXED_ULP_BUDGET's metric |got - want| / (eps32 * scale):
    scale max(|coefficient vector|, 1) (``vector``) or max(|value|, 1)."""
    want = want.double()
    scale = (want.abs().amax(-1, keepdim=True) if vector
             else want.abs()).clamp_min(1.0)
    return (got.double() - want).abs() / (EPS32 * scale)


def _within_budget(got, want):
    """(coefs, rmse) pairs of a mixed kernel and its plain mixed version:
    every value within the scaled-ulp budget."""
    assert float(_scaled_ulps(got[0], want[0], True).max()) <= \
        params.MIXED_ULP_BUDGET
    assert float(_scaled_ulps(got[1], want[1]).max()) <= \
        params.MIXED_ULP_BUDGET


@pytest.mark.parametrize("B,P", [(7, 141), (12, 50)])
def test_lasso_fit_mixed_matches_plain(dev, B, P):
    """The mixed instance launches under its own count, lands within the
    scaled-ulp budget of the plain mixed version (the tensor cores add a
    chunk's products in their own way), differs from the f32 fit, and
    gives a pixel with no weight an exactly zero fit."""
    rng = np.random.default_rng(140 + B)
    C, T = 2, 77
    a = _round_args(rng, dev, C=C, B=B, T=T, P=P)
    w = rng.random((C, T, P)) < 0.6
    w[:, :, ::7] = False
    w = _t(w.astype(np.float32), dev)
    mask = _t(np.arange(8) < rng.choice([4, 6, 8], (C, P))[..., None], dev)
    before = dict(cuda_ops.LAUNCHES)
    got = cuda_ops.lasso_fit(a["Yt"], w, a["X"], mask, mixed=True)
    assert cuda_ops.LAUNCHES["lasso_fit_mixed"] == \
        before["lasso_fit_mixed"] + 1
    assert cuda_ops.LAUNCHES["lasso_fit"] == before["lasso_fit"]
    want = cuda_ops.lasso_fit_plain(a["Yt"], w, a["X"], mask, mixed=True)
    _within_budget(got, want)
    f32 = cuda_ops.lasso_fit(a["Yt"], w, a["X"], mask)
    assert not torch.equal(got[0], f32[0])
    assert not got[0][:, ::7].any() and not got[1][:, ::7].any()
    b0, r0 = cuda_ops.lasso_fit(a["Yt"], w, a["X"], mask, with_rmse=False,
                                mixed=True)
    assert torch.equal(b0, got[0]) and not r0.any()


@pytest.mark.parametrize("B", [7, 12])
def test_mixed_fits_equal_lasso_fit_mixed(dev, B):
    """fused_fit_close's and fused_round's mixed refits give lasso_fit's
    mixed coefficients and RMSE bit for bit on the same windows (each
    pixel's tensor-core sums are its own, whichever pixels share its
    warp): route 1 and route "mon" equal route 0 in mixed too."""
    rng = np.random.default_rng(150 + B)
    a = _round_args(rng, dev, B=B, T=77)
    C, _, T, P = a["Yt"].shape
    w = _t((rng.random((C, T, P)) < 0.6).astype(np.float32), dev)
    n_full = _t(rng.integers(10, 40, (C, P)).astype(np.int32), dev)
    fit = _t(rng.random((C, P)) < 0.7, dev)
    no = torch.zeros(C, P, dtype=torch.bool, device=dev)
    zi = torch.zeros(C, P, dtype=torch.int32, device=dev)
    rmse = torch.ones(C, P, B, device=dev)
    _, _, coefs, rmse_o = cuda_ops.fused_fit_close(
        a["Yt"], a["X"], a["t"], w, fit, n_full, a["included"], a["coefs"],
        rmse, rmse, no, no, zi, zi, a["first_seg"], a["nseg"],
        _clone(a["bufs"]), mixed=True)
    want = cuda_ops.lasso_fit(a["Yt"], w * fit[:, None, :], a["X"],
                              coefmask_for(n_full), mixed=True)
    assert torch.equal(want[0][fit], coefs[fit])
    assert torch.equal(want[1][fit], rmse_o[fit])

    args, bufs = (_fused_round_case(np.random.default_rng(160), dev, 96, 141,
                                    "mixed") if B == 7 else
                  _s2_round_case(np.random.default_rng(161), dev))
    kw = dict(change_thr=CHANGE_THR, outlier_thr=OUTLIER_THR,
              sensor=LANDSAT_ARD if B == 7 else SENTINEL2)
    _, _, coefs, rmse, ev = cuda_ops.fused_round(*args, _clone(bufs),
                                                 mixed=True, **kw)
    w = torch.where(args[11][:, None, :], args[12],
                    ev["included_mon"] & ev["is_refit"][:, None, :])
    fit = ev["do_fit"]
    assert fit.any()
    want = cuda_ops.lasso_fit(args[0], w.float().contiguous(), args[1],
                              coefmask_for(ev["n_full"]), mixed=True)
    assert torch.equal(coefs[fit], want[0][fit])
    assert torch.equal(rmse[fit], want[1][fit])
    got = cuda_ops.fused_round(*args, _clone(bufs), mixed=True, **kw)
    plain = cuda_ops.fused_round_plain(*args, _clone(bufs), mixed=True, **kw)
    for k in ("is_tail", "is_brk", "is_refit", "do_fit"):
        assert torch.equal(got[4][k], plain[4][k]), k
    _within_budget((got[2][fit], got[3][fit]),
                   (plain[2][fit], plain[3][fit]))


@pytest.mark.parametrize("sensor", [LANDSAT_ARD, SENTINEL2])
def test_init_window_mixed_matches_plain(dev, sensor):
    args = _init_args(np.random.default_rng(170), dev, B=sensor.n_bands,
                      outliers=0.03)
    before = cuda_ops.LAUNCHES["init_window_mixed"]
    got = cuda_ops.init_window(*args, W=24, sensor=sensor, mixed=True)
    assert cuda_ops.LAUNCHES["init_window_mixed"] == before + 1
    want = cuda_ops.init_window_plain(*args, W=24, sensor=sensor, mixed=True)
    for k in INIT_EXACT:
        assert torch.equal(got[k], want[k]), k
    assert got["init_tm"].any() and got["init_ok"].any()
    for k in ("init_ok", "init_bad"):
        assert (got[k] != want[k]).float().mean().item() <= 0.02, k


@pytest.mark.parametrize("W", [24, 40])
@pytest.mark.parametrize("sensor", [LANDSAT_ARD, SENTINEL2])
def test_detect_mega_mixed_matches_plain(dev, sensor, W):
    args = _mega_state(np.random.default_rng(180 + W), dev, sensor.n_bands)
    kw = dict(W=W, change_thr=CHANGE_THR, outlier_thr=OUTLIER_THR,
              sensor=sensor, mixed=True)
    a, bufs, tail = args[:5], args[5], args[6:]
    before = cuda_ops.LAUNCHES["detect_mega_mixed"]
    got = cuda_ops.detect_mega(*a, _clone(bufs), *tail, **kw)
    assert cuda_ops.LAUNCHES["detect_mega_mixed"] == before + 1
    want = cuda_ops.detect_mega_plain(*a, _clone(bufs), *tail, **kw)
    for k in ("nseg", "alive", "meta", "rounds", "counts"):
        assert torch.equal(got[k], want[k]), k
    for k in ("rmse", "coef"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("W", [24, 64, 128])
@pytest.mark.parametrize("sensor", ["landsat", "sentinel2"])
def test_mixed_mega_equals_mon_at_each_instance(dev, sensor, W):
    """In mixed, the mega route (its INIT's stability Gram summed by warp
    0's 32 pixels at once) equals route "mon" (init_window's, four pixels a
    warp) in every field but the per-chip rounds, at each window
    instance."""
    if sensor == "landsat":
        packed = _tiny_packed()
    else:
        src = SyntheticSource(88, start="2019-01-01", end="2023-01-01",
                              cloud_frac=0.15, sensor=SENTINEL2)
        p = pack([src.chip(100, 200)], bucket=32)
        sel = np.arange(64) * (p.spectra.shape[2] // 64)
        packed = dataclasses.replace(
            p, spectra=np.ascontiguousarray(p.spectra[:, :, sel]),
            qas=np.ascontiguousarray(p.qas[:, sel]))
    staged = kernel.stage_packed(packed, dev)
    run = lambda **kw: kernel.detect_staged(
        *staged, W=W, sensor=packed.sensor, compact=False, mixed=True, **kw)
    cuda_ops.reset_launches()
    mega = run(pallas="mega")
    assert {k for k, n in cuda_ops.LAUNCHES.items() if n} == {
        "lasso_fit_mixed", "detect_mega_mixed"}
    mon = run(pallas="1", fused="mon")
    for f in ("n_segments", "seg_meta", "seg_rmse", "seg_mag", "seg_coef",
              "mask", "procedure", "vario"):
        assert torch.equal(getattr(mega, f), getattr(mon, f)), f
    assert int(mega.rounds.max()) == int(mon.rounds[0])


def test_mixed_routes_on_card(dev):
    """Mixed: each route launches the mixed instances of its fitting
    kernels and no f32 one; route 1 = route 0 byte for byte, "mon" = route
    0 but seg_mag; the component route is inert (its f32 result); the
    decisions equal the f32 route's and the plain mixed route's."""
    packed = _tiny_packed()
    f32 = kernel.detect_packed(packed, fused=0)
    segs = {}
    for fused, want in ((0, {"lasso_fit_mixed", "monitor_chain_scored",
                             "init_window_mixed"}),
                        (1, {"lasso_fit_mixed", "monitor_chain_scored",
                             "init_window_mixed", "fused_fit_close_mixed"}),
                        ("mon", {"lasso_fit_mixed", "init_window_mixed",
                                 "fused_round_mixed"})):
        cuda_ops.reset_launches()
        segs[fused] = kernel.detect_packed(packed, fused=fused, mixed=True)
        assert {k for k, n in cuda_ops.LAUNCHES.items() if n} == want
    for f in ("n_segments", "seg_meta", "seg_rmse", "seg_mag", "seg_coef",
              "mask", "procedure", "rounds", "vario", "round_counts"):
        assert torch.equal(getattr(segs[1], f), getattr(segs[0], f)), f
        a, b = getattr(segs["mon"], f), getattr(segs[0], f)
        if f == "seg_mag":
            torch.testing.assert_close(a, b, rtol=5e-3, atol=1e-2)
        else:
            assert torch.equal(a, b), f
    assert not torch.equal(segs[0].seg_coef, f32.seg_coef)
    _decisions_equal(segs[0], f32)
    ref = kernel.detect_packed(packed, fused=0, mixed=True,
                               ops=cuda_ops.PLAIN)
    _decisions_equal(segs[0], ref)
    comp = dict(pallas="lasso,monitor,tmask", fused=0)
    a = kernel.detect_packed(packed, mixed=True, **comp)
    b = kernel.detect_packed(packed, mixed=False, **comp)
    for f in ("n_segments", "seg_meta", "seg_rmse", "seg_coef", "mask"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_mixed_instances_run_on_tensor_cores(dev):
    """The five mixed instances' SASS holds HMMA (bf16 mma.sync) and the f32
    instances' holds none."""
    import shutil
    import subprocess

    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    libs = cuda_ops.build()
    for unit, path in libs.items():
        if cuda_ops.source_of(unit) not in cuda_ops.MIXED_SOURCES:
            continue
        sass = subprocess.run([exe, "-sass", str(path)], capture_output=True,
                              text=True, check=True).stdout
        n = sass.count("HMMA")
        assert (n > 0) == (unit != cuda_ops.source_of(unit)), (unit, n)


# ---------------------------------------------------------------------------
# The float64 route and the batch driver on the card
# ---------------------------------------------------------------------------

def _two_tiny_chips(seed, n_changes=1):
    src = SyntheticSource(seed, start="1995-01-01", end="1999-06-01",
                          sensor=LANDSAT_ARD_TINY, cloud_frac=0.15,
                          n_changes=n_changes)
    return pack([src.chip(100, 200), src.chip(3100, 200)], bucket=32)


@pytest.mark.parametrize("seed,n_changes", [(3, 1), (5, 2)])
def test_f64_on_card_launches_nothing_and_decides_as_cpu(dev, seed,
                                                         n_changes):
    p = _two_tiny_chips(seed, n_changes)
    cuda_ops.reset_launches()
    got = kernel.detect_packed(p, device=dev, dtype=torch.float64)
    assert not any(cuda_ops.LAUNCHES.values())
    want = kernel.detect_packed(p, device="cpu", dtype=torch.float64)
    g, w = kernel.segments_to_numpy(got), kernel.segments_to_numpy(want)
    for f in ("n_segments", "procedure", "mask", "seg_meta"):
        np.testing.assert_array_equal(getattr(g, f), getattr(w, f), f)
    for f in ("seg_rmse", "seg_mag", "seg_coef", "vario"):
        np.testing.assert_allclose(getattr(g, f), getattr(w, f), rtol=1e-9,
                                   atol=1e-9, err_msg=f)


def test_stage_batch_pinned_copy_equals_stage_packed(dev):
    from firebird_tpu_torch.driver import core

    p = _two_tiny_chips(3)
    staged = core.stage_batch(p, "float32", "off", device=dev)
    assert staged.ready is not None and all(h.is_pinned()
                                            for h in staged.pinned)
    staged.ready.synchronize()
    for a, b in zip(staged.args, kernel.stage_packed(p, dev)):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)
    seg, n = core.detect_batch(staged.packed, "float32", "off",
                               staged=staged, device=dev)
    ref = kernel.detect_packed(p, device=dev, check_capacity=False)
    assert n == 2
    for f in ("n_segments", "seg_meta", "seg_rmse", "seg_coef", "mask"):
        assert torch.equal(getattr(seg, f), getattr(ref, f)), f


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_driver_on_card_equals_cpu_decisions(dev, dtype):
    from firebird_tpu_torch.config import Config
    from firebird_tpu_torch.driver import core
    from firebird_tpu_torch.store import MemoryStore

    cfg = Config(store_backend="memory", chips_per_batch=2, dtype=dtype,
                 device_sharding="off", fetch_retries=0, pipeline_depth=2)
    src = SyntheticSource(9, start="1995-01-01", end="1999-06-01",
                          sensor=LANDSAT_ARD_TINY, cloud_frac=0.1)
    stores = {}
    for where in (dev, "cpu"):
        stores[str(where)] = MemoryStore(str(where))
        cuda_ops.reset_launches()
        done = core.changedetection(x=100, y=200,
                                    acquired="1995-01-01/1999-06-01",
                                    number=5, chunk_size=5, cfg=cfg,
                                    source=src, store=stores[str(where)],
                                    device=where)
        assert len(done) == 5
        launched = {k for k, v in cuda_ops.LAUNCHES.items() if v}
        if str(where) != "cpu" and dtype == "float32":
            assert launched == {"lasso_fit", "monitor_chain_scored",
                                "init_window"}
        else:
            assert not launched
    card, cpu = stores[str(dev)], stores["cpu"]
    for table in ("chip", "pixel"):
        assert sorted(map(str, zip(*card.read(table).values()))) == \
            sorted(map(str, zip(*cpu.read(table).values())))
    keys = ("cx", "cy", "px", "py", "sday", "eday", "bday", "chprob",
            "curqa")
    rows = lambda s: sorted(zip(*(s.read("segment")[k] for k in keys)))
    assert rows(card) == rows(cpu)


# ---------------------------------------------------------------------------
# The stream path
# ---------------------------------------------------------------------------

def _stream_state(rng, P, dtype):
    """A stream state of P pixels made from ``rng``, with scores near the
    change threshold for some pixels."""
    from firebird_tpu_torch.ccd import incremental

    B = params.NUM_BANDS
    coefs = rng.normal(size=(P, B, 8)) * np.array([50, 0.005, 20, 20, 10, 10,
                                                  5, 5])
    coefs[..., 0] += 1000
    f = lambda a: torch.tensor(np.asarray(a), dtype=dtype)
    n_ex = rng.integers(0, params.PEEK_SIZE, P)
    return incremental.StreamState(
        coefs=f(coefs), rmse=f(rng.uniform(150, 300, (P, B))),
        vario=f(rng.uniform(150, 300, (P, B))),
        nobs=torch.tensor(rng.integers(12, 80, P), dtype=torch.int32),
        n_exceed=torch.tensor(n_ex, dtype=torch.int32),
        end_day=f(np.full(P, 729000.0)),
        exceed_day0=f(np.where(n_ex > 0, 728990.0, 0.0)),
        break_day=f(np.where(rng.random(P) < 0.05, 728900.0, 0.0)),
        active=torch.tensor(rng.random(P) < 0.95))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stream_step_on_card_equals_cpu(dev, dtype):
    """The step at P=10 000 on the card equals the CPU bit for bit over 40
    acquisitions (absorbs, exceed runs, breaks, cloudy and fill rows)."""
    from firebird_tpu_torch.ccd import incremental

    rng = np.random.default_rng(17)
    P = 10_000
    cpu = _stream_state(rng, P, dtype)
    card = cpu.to(dev)
    for k in range(40):
        t = 729016.0 + 16 * k
        x = incremental.design_row(t, 727000.0)
        base = cpu.coefs.double().numpy() @ x.astype(np.float64)
        scale = rng.uniform(0.0, 2.0 if k % 7 else 6.0, (P, 1))
        y = (base + rng.normal(size=base.shape) * 150 * scale).astype(
            np.float32)
        qa = np.where(rng.random(P) < 0.1, 1 << params.QA_FILL_BIT,
                      1 << params.QA_CLEAR_BIT).astype(np.int32)
        cpu = incremental.step(cpu, torch.tensor(x), torch.tensor(y),
                               torch.tensor(qa), t)
        card = incremental.step(card, _t(x, dev), _t(y, dev), _t(qa, dev),
                                torch.tensor(t, device=dev))
    for f in incremental.STATE_FIELDS:
        a, b = getattr(card, f).cpu(), getattr(cpu, f)
        assert a.dtype == b.dtype, f
        assert torch.equal(a.view(torch.uint8) if a.dtype == torch.bool
                           else a, b.view(torch.uint8) if b.dtype == torch.bool
                           else b), f
    assert int(cpu.needs_batch.sum()) > 0 and int(cpu.n_exceed.sum()) > 0


def test_statestore_roundtrip_from_card_tensors(dev, tmp_path):
    """A checkpoint saved from tensors on the card loads back bit for bit,
    on the card and on the CPU, and serializes as from host tensors."""
    from firebird_tpu_torch import grid
    from firebird_tpu_torch.ccd import incremental
    from firebird_tpu_torch.streamops import statestore as ss

    rng = np.random.default_rng(4)
    host = _stream_state(rng, 10_000, torch.float32)
    side = dict(sday=rng.random(10_000) * 1000,
                curqa=rng.integers(0, 64, 10_000), anchor=np.float64(723000),
                horizon=np.float64(736000))
    cid = tuple(int(v) for v in grid.chips(grid.tile(x=542000,
                                                     y=1650000))[5])
    assert (ss.serialize_state(host.to(dev), side)
            == ss.serialize_state(host, side))
    store = ss.TileStateStore(str(tmp_path), device=dev)
    store.save(cid, host.to(dev), side)
    for st, _ in (store.load(cid),
                  ss.TileStateStore(str(tmp_path)).load(cid)):
        for f in incremental.STATE_FIELDS:
            assert torch.equal(getattr(st, f).cpu(), getattr(host, f)), f
    assert store.load(cid)[0].coefs.device.type == dev.type
    store.close()


# ---------------------------------------------------------------------------
# The per-tile skip guard (active=)
# ---------------------------------------------------------------------------

GUARD_FRACTIONS = (1.0, 0.3, 0.02, 0.0)
_FITTING = ("lasso_fit", "init_window", "fused_fit_close", "fused_round")
_TWELVE = ("lasso_fit", "lasso_cd", "monitor_chain_scored", "init_window",
           "fused_fit_close", "fused_round")
GUARD_CASES = ([(n, False, 7) for n in cases.GUARDED]
               + [(n, True, 7) for n in _FITTING]
               + [(n, False, 12) for n in _TWELVE]
               + [(n, True, 12) for n in _FITTING])
GUARD_IDS = [f"{n}-{b}{'-mixed' if m else ''}" for n, m, b in GUARD_CASES]


def _guard_case(name, B, dev, seed=51):
    sensor = SENTINEL2 if B == 12 else LANDSAT_ARD
    st, _ = cases.state(seed, C=2, P=141, T=96, B=B, S=4, W=16, dev=dev)
    return st, sensor


def _close_on_live(name, got, want, live):
    """The kernel against its plain version on the live tiles, as the
    unguarded tests hold them: the monitors through monitoring_only
    (exact), INIT's exact fields and at most 2 % of its verdicts, every
    other integer and boolean exact, the fitted floats within the fit
    envelope (rtol / atol 1e-2)."""
    if name in ("monitor_chain_scored", "monitor_chain"):
        return
    for (k, g), (_, w) in zip(cases.leaves(got), cases.leaves(want)):
        g, w = cases.lanes(g, live), cases.lanes(w, live)
        if k in ("init_ok", "init_bad"):
            assert int((g != w).sum()) <= 0.02 * g.numel(), k
        elif g.is_floating_point():
            torch.testing.assert_close(g, w, rtol=1e-2, atol=1e-2)
        else:
            assert torch.equal(g, w), (name, k)


@pytest.mark.parametrize("name,mixed,B", GUARD_CASES, ids=GUARD_IDS)
def test_guard_matches_plain_at_each_share(dev, name, mixed, B):
    """Each guarded kernel (f32, mixed, 7 and 12 bands) at 100, 30, 2 and
    0 % of each chip active (a dense prefix; P=141, the last tile ragged),
    on arbitrary inputs: the guarded launch equals the unguarded launch
    with cuda_ops.guard's fill over the dead tiles, bit for bit (at 100 %
    the unguarded output itself), and its guarded plain version bit for bit
    on the dead tiles and as the unguarded tests hold them on the live
    ones."""
    st, sensor = _guard_case(name, B, dev)
    a, kw = cases.args(name, st, sensor)
    flat = name in cuda_ops.FLAT_TILES
    unit = cuda_ops.unit_of(name, mixed)
    u = cases.call(cuda_ops.KERNELS, name, a, kw, None, mixed)
    for share in GUARD_FRACTIONS:
        active = cases.prefix([int(share * 141)] * 2, 141, dev)
        before = cuda_ops.LAUNCHES[unit]
        g = cases.call(cuda_ops.KERNELS, name, a, kw, active, mixed)
        assert cuda_ops.LAUNCHES[unit] == before + 1
        cases.assert_same(g, cuda_ops.guard(name, u, active, a),
                          f"{name} at {share}")
        p = cases.call(cuda_ops.PLAIN, name, a, kw, active, mixed)
        if name in ("monitor_chain_scored", "monitor_chain"):
            p = cuda_ops.monitoring_only(p, a[-1])
        live = cuda_ops.tile_live(active, flat=flat)
        dead = ~live
        for (k, x), (_, y) in zip(cases.leaves(g), cases.leaves(p)):
            x, y = cases.lanes(x, dead), cases.lanes(y, dead)
            if x.dtype == torch.float32:
                x, y = x.view(torch.int32), y.view(torch.int32)
            assert torch.equal(x, y), (name, share, k)
        _close_on_live(name, g, p, live)


@pytest.mark.parametrize("name,mixed,B", GUARD_CASES, ids=GUARD_IDS)
def test_guard_changes_nothing_on_inert_lanes(dev, name, mixed, B):
    """With the inactive lanes carrying the inputs a compacted loop gives
    them (30 % and 2 % of each chip a dense prefix) and the caller's lane
    set as the guard, the guarded launch equals the unguarded one on every
    lane as the loop reads it, bit for bit (INIT's cursor fields of
    initializing pixels: an inactive pixel computes them too)."""
    st0, sensor = _guard_case(name, B, dev, seed=52)
    for share in (0.3, 0.02):
        st = cases.inert(st0, cases.prefix([int(share * 141)] * 2, 141, dev))
        a, kw = cases.args(name, st, sensor)
        act = cases.caller_active(name, st)
        g = cases.call(cuda_ops.KERNELS, name, a, kw, act, mixed)
        u = cases.call(cuda_ops.KERNELS, name, a, kw, None, mixed)
        if name == "init_window":
            g, u = ({k: (torch.where(a[2], v, torch.zeros_like(v))
                         if k in ("i_next_tm", "i_adv", "j", "has_adv")
                         else v) for k, v in o.items()} for o in (g, u))
        elif name in ("monitor_chain_scored", "monitor_chain"):
            g, u = (cuda_ops.monitoring_only(o, a[-1]) for o in (g, u))
        cases.assert_same(g, u, f"{name} at {share}")
