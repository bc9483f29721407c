"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch (the repository's conftest imports JAX; skip it there):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from firebird_tpu_torch.ccd import cuda_ops, harmonic, kernel, params
from firebird_tpu_torch.ccd.sensor import LANDSAT_ARD_TINY
from firebird_tpu_torch.ingest import SyntheticSource, pack

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
    want = cuda_ops.monitor_chain_scored_plain(*args, **kw)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


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
    want = cuda_ops.monitor_chain_plain(*args, **kw)
    assert set(got) == set(want)
    assert all(want[k].any() for k in ("is_tail", "is_brk", "is_refit"))
    for k in want:
        assert torch.equal(got[k], want[k]), k


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
