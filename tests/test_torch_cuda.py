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


def test_detect_on_card_matches_cpu(dev):
    src = SyntheticSource(4, start="1995-01-01", end="1999-06-01",
                          sensor=LANDSAT_ARD_TINY, n_changes=2)
    packed = pack([src.chip(100, 200), src.chip(3100, 200)], bucket=32)
    cuda_ops.reset_launches()
    a = kernel.detect_packed(packed)
    assert all(n > 0 for n in cuda_ops.LAUNCHES.values())
    b = kernel.detect_packed(packed, device="cpu")
    for f in ("n_segments", "procedure", "mask", "seg_meta", "rounds"):
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f
    torch.testing.assert_close(a.seg_rmse.cpu(), b.seg_rmse, rtol=1e-4,
                               atol=1e-3)
