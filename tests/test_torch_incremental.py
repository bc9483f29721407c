"""The port's streaming step against the JAX package's, on the CPU.

tests/test_incremental.py's seeded fixture (SyntheticSource(seed=11,
1995-2000, cloud_frac=0.1), 64 pixels, the last K=6 acquisitions
streamed): ``StreamState.from_chip`` on the same batch result, then the
same acquisitions through ``incremental.step`` of both packages, in
float32 and float64.  Every field must be equal, exactly: the step copies
days and counts and leaves coefs, rmse and vario as they are.  Cases: the
stream against the batch tail, break confirmation, a cloudy observation,
the Sentinel-2 break, and states and rows made from a numpy seed so that
the scores fall within a few ulps of CHANGE_THRESHOLD.

JAX's step on the CPU scores a pixel in XLA's vectorized loop, or in the
loop's last vector block, which sums the band terms with fused adds (an
ulp apart now and then).  The port holds every pixel to the vectorized
loop's arithmetic: the JAX step runs on the batch and on the batch rolled
by half, and each pixel's JAX result is taken from the run where it sits
in the first half (:func:`jax_step`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firebird_tpu.ccd import incremental as jinc
from firebird_tpu.ccd import kernel as jk
from firebird_tpu.ccd import synthetic as jsyn
from firebird_tpu.ccd.sensor import SENTINEL2 as J_S2
from firebird_tpu.ingest import SyntheticSource as JSource
from firebird_tpu.ingest import pack as jpack
from firebird_tpu.ingest.packer import PackedChips as JPacked
from firebird_tpu_torch.ccd import convert, incremental, kernel, params
from firebird_tpu_torch.ccd.sensor import LANDSAT_ARD, SENTINEL2, chi2_thresholds


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FIELDS = incremental.STATE_FIELDS
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "float64": (np.float64, jnp.float64, torch.float64)}


def slice_pixels(p, n):
    return JPacked(cids=p.cids, dates=p.dates, spectra=p.spectra[:, :, :n, :],
                   qas=p.qas[:, :n, :], n_obs=p.n_obs, sensor=p.sensor)


def batch_one(packed, dtype):
    return jk.chip_slice(jk.detect_packed(packed, dtype=dtype), 0,
                         to_host=True)


def jax_state(st_np):
    return jinc.StreamState(*(jnp.asarray(st_np[f]) for f in FIELDS))


def to_np(st):
    return {f: np.asarray(getattr(st, f)) for f in FIELDS}


def jax_step(st_np, x_row, y, qa, t, sensor=jinc.LANDSAT_ARD):
    """The JAX step with every pixel scored in XLA's vectorized loop: the
    first half of the pixels from the batch as given, the second half from
    the batch rolled by half (module docstring)."""
    P = st_np["nobs"].shape[0]
    h = P // 2
    roll = lambda a: np.roll(np.asarray(a), -h, axis=0)
    first = to_np(jinc.step(jax_state(st_np), jnp.asarray(x_row),
                            jnp.asarray(y), jnp.asarray(qa), t,
                            sensor=sensor))
    rolled = {f: roll(v) for f, v in st_np.items()}
    second = to_np(jinc.step(jax_state(rolled), jnp.asarray(x_row),
                             jnp.asarray(roll(y)), jnp.asarray(roll(qa)), t,
                             sensor=sensor))
    out = {}
    for f in FIELDS:
        back = np.roll(second[f], h, axis=0)
        out[f] = np.concatenate([first[f][:h], back[h:]])
    return out


def port_step(st_np, x_row, y, qa, t, sensor=LANDSAT_ARD):
    st = convert.stream_state_from_numpy(st_np)
    got = incremental.step(st, torch.tensor(x_row), torch.tensor(y),
                           torch.tensor(qa), t, sensor=sensor)
    return convert.stream_state_to_numpy(got)


def assert_same(got, want):
    for f in FIELDS:
        assert got[f].dtype == want[f].dtype, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def both_steps(st, x_row, y, qa, t, jsensor=jinc.LANDSAT_ARD,
               tsensor=LANDSAT_ARD):
    """One step through both packages from the same state; asserts every
    field equal and returns the (shared) new state."""
    want = jax_step(st, x_row, y, qa, t, jsensor)
    got = port_step(st, x_row, y, qa, t, tsensor)
    assert_same(got, want)
    return got


@pytest.fixture(scope="module")
def seeded():
    src = JSource(seed=11, start="1995-01-01", end="2000-01-01",
                  cloud_frac=0.1, change_frac=0.0)
    full = slice_pixels(jpack([src.chip(100, 200)], bucket=32), 64)
    T = int(full.n_obs[0])
    K = 6
    cut = JPacked(cids=full.cids, dates=full.dates,
                  spectra=full.spectra.copy(), qas=full.qas.copy(),
                  n_obs=full.n_obs - K)
    cut.qas[:, :, T - K:] = jsyn.QA_CLOUD
    segs = {name: (batch_one(cut, d[1]), batch_one(full, d[1]))
            for name, d in DTYPES.items()}
    return full, T, K, segs


def seeded_state(segs, dtype):
    seg = segs[dtype][0]
    want = to_np(jinc.StreamState.from_chip(seg))
    got = convert.stream_state_to_numpy(
        incremental.StreamState.from_chip(seg, device="cpu"))
    assert_same(got, want)
    return got


@pytest.mark.parametrize("dtype", DTYPES)
def test_from_chip_equals_jax(seeded, dtype):
    _, _, _, segs = seeded
    st = seeded_state(segs, dtype)
    assert st["active"].all() and not (st["break_day"] > 0).any()
    assert st["coefs"].dtype == DTYPES[dtype][0]


def test_from_chip_takes_host_and_tensor_results(seeded):
    _, _, _, segs = seeded
    seg = segs["float32"][0]
    host = incremental.StreamState.from_chip(seg, device="cpu")
    dev = incremental.StreamState.from_chip(
        convert.segments_from_numpy(seg), device="cpu")
    assert_same(convert.stream_state_to_numpy(dev),
                convert.stream_state_to_numpy(host))
    with pytest.raises(ValueError, match="vario"):
        incremental.StreamState.from_chip(
            kernel.ChipSegments(**{**vars(convert.segments_from_numpy(seg)),
                                   "vario": None}), device="cpu")


@pytest.mark.parametrize("t_new", [728000.0, 730120.5, 736000.25])
def test_design_row_equals_jax(t_new):
    for dt in (np.float32, np.float64):
        got = incremental.design_row(t_new, 727000.0, dt)
        want = jinc.design_row(t_new, 727000.0, dt)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_stream_matches_jax_and_batch_tail(seeded, dtype):
    """Streaming the last K acquisitions: equal to the JAX step in every
    field after every acquisition, and equal to the batch end state on the
    comparable pixels (test_incremental.py's rule)."""
    full, T, K, segs = seeded
    npd = DTYPES[dtype][0]
    seg_cut, seg_full = segs[dtype]
    st = seeded_state(segs, dtype)
    anchor = float(full.dates[0][0])
    any_exceed = np.zeros(64, bool)
    for k in range(T - K, T):
        t_new = float(full.dates[0][k])
        st = both_steps(st, jinc.design_row(t_new, anchor, npd),
                        full.spectra[0, :, :, k].T.astype(npd),
                        full.qas[0, :, k].astype(np.int32), t_new)
        any_exceed |= st["n_exceed"] > 0
    last_cut = np.maximum(np.asarray(seg_cut.n_segments) - 1, 0)
    last_full = np.maximum(np.asarray(seg_full.n_segments) - 1, 0)
    ar = np.arange(64)
    cc = np.asarray(seg_cut.seg_coef)[ar, last_cut]
    cf = np.asarray(seg_full.seg_coef)[ar, last_full]
    ok = ((cc == cf).all(axis=(1, 2))
          & (np.asarray(seg_cut.n_segments) == np.asarray(seg_full.n_segments))
          & ~any_exceed)
    assert ok.sum() >= 32
    meta = np.asarray(seg_full.seg_meta)[ar, last_full]
    np.testing.assert_array_equal(st["end_day"][ok], meta[ok, 1])
    np.testing.assert_array_equal(st["nobs"][ok], meta[ok, 5].astype(int))
    np.testing.assert_array_equal(
        st["n_exceed"][ok],
        np.round(meta[ok, 3] * params.PEEK_SIZE).astype(int))


@pytest.mark.parametrize("dtype", DTYPES)
def test_break_confirmation_equals_jax(seeded, dtype):
    full, T, K, segs = seeded
    npd = DTYPES[dtype][0]
    st = seeded_state(segs, dtype)
    anchor = float(full.dates[0][0])
    days = [float(full.dates[0][T - K]) + 16 * i
            for i in range(params.PEEK_SIZE)]
    shifted = full.spectra[0, :, :, T - 1].T.astype(npd) + 2000.0
    clear = np.full(64, jsyn.QA_CLEAR, np.int32)
    for i, t_new in enumerate(days):
        st = both_steps(st, jinc.design_row(t_new, anchor, npd), shifted,
                        clear, t_new)
        assert (st["break_day"] > 0).all() == (i == params.PEEK_SIZE - 1)
    np.testing.assert_array_equal(st["break_day"], np.full(64, days[0], npd))
    nobs = st["nobs"].copy()
    t_new = days[-1] + 16
    st = both_steps(st, jinc.design_row(t_new, anchor, npd), shifted, clear,
                    t_new)
    np.testing.assert_array_equal(st["nobs"], nobs)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cloudy_obs_is_noop_as_jax(seeded, dtype):
    full, T, K, segs = seeded
    npd = DTYPES[dtype][0]
    st = seeded_state(segs, dtype)
    t_new = float(full.dates[0][T - K])
    got = both_steps(st, jinc.design_row(t_new, float(full.dates[0][0]), npd),
                     full.spectra[0, :, :, T - K].T.astype(npd),
                     np.full(64, jsyn.QA_CLOUD, np.int32), t_new)
    assert_same(got, st)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sentinel2_break_equals_jax(dtype):
    npd, jd, _ = DTYPES[dtype]
    src = JSource(seed=9, start="2019-01-01", end="2021-06-01",
                  cloud_frac=0.0, change_frac=0.0, sensor=J_S2)
    p = slice_pixels(jpack([src.chip(100, 200)], bucket=32), 32)
    seg = batch_one(p, jd)
    st = to_np(jinc.StreamState.from_chip(seg))
    assert_same(convert.stream_state_to_numpy(
        incremental.StreamState.from_chip(seg, device="cpu")), st)
    assert st["active"].any()
    anchor = float(p.dates[0][0])
    T = int(p.n_obs[0])
    last = p.spectra[0, :, :, T - 1].T.astype(npd)
    t0 = float(p.dates[0][T - 1])
    clear = np.full(32, jsyn.QA_CLEAR, np.int32)
    step = lambda st, t, y: both_steps(
        st, jinc.design_row(t, anchor, npd), y, clear, t, J_S2, SENTINEL2)
    st = step(st, t0 + 10, last)
    for i in range(params.PEEK_SIZE):
        st = step(st, t0 + 20 + 10 * i, last + 3000.0)
    assert (st["break_day"] > 0)[st["active"]].all()


def threshold_case(seed, P, npd):
    """A state and a row made from a numpy seed whose scores sit within a
    few ulps of CHANGE_THRESHOLD: residuals of norm sqrt(threshold) in
    float64, on rows near 1000 over denominators near 200, so that one ulp
    of a row moves the score by about one ulp; then each pixel's row nudged
    by its own count of ulps (-4 to 4) across the threshold."""
    rng = np.random.default_rng(seed)
    B, det = params.NUM_BANDS, list(LANDSAT_ARD.detection_bands)
    thr, _ = chi2_thresholds(len(det))
    coefs = rng.normal(size=(P, B, 8)) * np.array(
        [50, 0.005, 20, 20, 10, 10, 5, 5])
    coefs[..., 0] += 1000
    rmse = rng.uniform(150, 300, (P, B))
    vario = rng.uniform(150, 300, (P, B))
    st = {"coefs": coefs.astype(npd), "rmse": rmse.astype(npd),
          "vario": vario.astype(npd),
          "nobs": rng.integers(12, 80, P).astype(np.int32),
          "n_exceed": rng.integers(0, params.PEEK_SIZE, P).astype(np.int32),
          "end_day": np.full(P, 729000.0, npd),
          "exceed_day0": np.zeros(P, npd), "break_day": np.zeros(P, npd),
          "active": np.ones(P, bool)}
    st["exceed_day0"][st["n_exceed"] > 0] = 728990.0
    t_new = 729016.0
    x = jinc.design_row(t_new, 727000.0, npd)
    pred = st["coefs"].astype(np.float64) @ x.astype(np.float64)
    den = np.maximum(st["rmse"], st["vario"]).astype(np.float64)
    u = rng.normal(size=(P, len(det)))
    u *= np.sqrt(thr) / np.linalg.norm(u, axis=1, keepdims=True)
    y = pred.copy()
    y[:, det] += u * den[:, det]
    y = y.astype(npd)
    nudge = (np.arange(P) % 9 - 4).astype(npd)
    y[:, det] += nudge[:, None] * np.spacing(y[:, det]) * np.sign(u)
    return st, x, y, np.full(P, jsyn.QA_CLEAR, np.int32), t_new


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_threshold_scores_decide_as_jax(dtype, seed):
    npd = DTYPES[dtype][0]
    st, x, y, qa, t_new = threshold_case(seed, 64, npd)
    thr, _ = chi2_thresholds(5)
    got = both_steps(st, x, y, qa, t_new)
    # The case is not vacuous: both outcomes occur.
    exceeded = got["n_exceed"] > st["n_exceed"]
    assert 0 < exceeded.sum() < 64
    # A second acquisition from the stepped state, the run continuing.
    both_steps(got, x, y, qa, t_new + 16)


def test_score_is_the_jax_steps_arithmetic():
    """The port's prediction is a fused multiply-add chain, as XLA's einsum
    on the CPU computes it: over 4 096 seeded pixels the two steps' scores
    agree bit for bit where a plain multiply-then-add chain does not."""
    from firebird_tpu_torch.ccd.primitives import dot_cols, fma

    rng = np.random.default_rng(5)
    coefs = (rng.normal(size=(4096, 5, 8)) * 40).astype(np.float32)
    x = jinc.design_row(729100.0, 727000.0)
    want = np.asarray(jnp.einsum("pbc,c->pb", jnp.asarray(coefs),
                                 jnp.asarray(x)))
    c, xt = torch.tensor(coefs), torch.tensor(x)
    chain = c[..., 0] * xt[0]
    for k in range(1, 8):
        chain = fma(c[..., k], xt[k].expand_as(chain), chain)
    np.testing.assert_array_equal(chain.numpy(), want)
    plain = dot_cols(c, xt).numpy()
    assert (plain != want).any()
