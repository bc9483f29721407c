"""The port's detector as a whole against the JAX package, on the CPU.

Tiny (10x10-pixel) synthetic chips go through
``firebird_tpu.ccd.kernel.detect_packed`` (float32, compaction off) and
through ``firebird_tpu_torch.ccd.kernel.detect_packed(device="cpu")``.
Decision fields must be identical; the fitted floats stay inside the
envelope of the JAX package's own route-parity tests.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firebird_tpu.ccd import format as jformat
from firebird_tpu.ccd import kernel as jk
from firebird_tpu.ccd.sensor import LANDSAT_ARD_TINY
from firebird_tpu.ingest import SyntheticSource, pack
from firebird_tpu_torch.ccd import cuda_ops, convert
from firebird_tpu_torch.ccd import format as tformat
from firebird_tpu_torch.ccd import kernel as tk
from firebird_tpu_torch.ingest import SyntheticSource as TSource
from firebird_tpu_torch.ingest import pack as tpack
from firebird_tpu_torch.ccd.sensor import LANDSAT_ARD_TINY as T_TINY


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CONFIGS = {
    "default": dict(seed=3),
    "two_changes_gaps": dict(seed=5, n_changes=2, seasonal_gap_frac=0.5),
    "snow_insufficient": dict(seed=7),
}


def _mark_alt_procedures(p):
    """Turn rows of the first chip into permanent-snow (pixels 0-9),
    insufficient-clear (10-19) and no-data (20) pixels."""
    qas = p.qas.copy()
    qas[0, :10] = (qas[0, :10] & ~np.uint16(0b110)) | np.uint16(1 << 4)
    cloudy = qas[0, 10:20].copy()
    cloudy[:, ::3] = 1 << 5
    qas[0, 10:20] = np.where(cloudy == (1 << 5), cloudy, 0)
    qas[0, 20, :] = 1
    return dataclasses.replace(p, qas=qas)


def _packed(name):
    kw = dict(CONFIGS[name])
    src_kw = dict(start="1995-01-01", end="1999-06-01", cloud_frac=0.15,
                  seed=kw.pop("seed"), **kw)
    jsrc = SyntheticSource(sensor=LANDSAT_ARD_TINY, **src_kw)
    tsrc = TSource(sensor=T_TINY, **src_kw)
    ids = [(100, 200), (3100, 200)]
    jp = pack([jsrc.chip(*i) for i in ids], bucket=32)
    tp = tpack([tsrc.chip(*i) for i in ids], bucket=32)
    if name == "snow_insufficient":
        jp, tp = _mark_alt_procedures(jp), _mark_alt_procedures(tp)
    np.testing.assert_array_equal(jp.spectra, tp.spectra)
    np.testing.assert_array_equal(jp.qas, tp.qas)
    return jp, tp


@functools.lru_cache(maxsize=None)
def _run(name):
    """Both packages' results on one configuration, computed once per
    process (pytest may set a parametrized module fixture up more than
    once as it orders the tests)."""
    jp, tp = _packed(name)
    ref = jk.detect_packed(jp, dtype=jnp.float32, compact=False)
    got = tk.detect_packed(tp, device="cpu")
    return name, jp, tp, ref, got


@pytest.fixture(params=list(CONFIGS))
def runs(request):
    return _run(request.param)


def test_detect_decisions_match_jax(runs):
    name, _, _, ref, got = runs
    g = convert.segments_to_numpy(got)
    np.testing.assert_array_equal(g.n_segments, np.asarray(ref.n_segments))
    np.testing.assert_array_equal(g.procedure, np.asarray(ref.procedure))
    np.testing.assert_array_equal(g.mask, np.asarray(ref.mask))
    m_r, m_g = np.asarray(ref.seg_meta), g.seg_meta
    # sday, eday, bday, chprob, curqa, nobs
    np.testing.assert_array_equal(m_g, m_r)
    if name == "snow_insufficient":
        assert {0, 1, 2, 3} <= set(g.procedure[0].tolist())
    if name == "two_changes_gaps":
        assert g.n_segments.max() >= 2


def test_detect_floats_within_envelope(runs):
    _, _, _, ref, got = runs
    g = convert.segments_to_numpy(got)
    np.testing.assert_allclose(g.seg_rmse, np.asarray(ref.seg_rmse),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(g.seg_mag, np.asarray(ref.seg_mag),
                               rtol=5e-3, atol=1e-2)
    np.testing.assert_array_equal(g.vario, np.asarray(ref.vario))
    # Coefficients at rtol 1e-4 of their vector's scale: a soft-thresholded
    # near-zero coefficient carries absolute error on its siblings' scale
    # (params.MIXED_ULP_BUDGET's anchoring).
    c_r = np.asarray(ref.seg_coef)
    scale = np.maximum(np.abs(c_r).max(-1, keepdims=True), 1.0)
    assert (np.abs(g.seg_coef - c_r) / scale).max() <= 1e-4


def test_detect_rounds_match_jax(runs):
    _, _, _, ref, got = runs
    np.testing.assert_array_equal(got.rounds.numpy(), np.asarray(ref.rounds))
    np.testing.assert_array_equal(got.round_counts.numpy(),
                                  np.asarray(ref.round_counts))


def test_chip_frames_match_jax(runs):
    _, jp, tp, ref, got = runs
    for c in range(jp.n_chips):
        want = jformat.chip_frames(jp, c, jk.chip_slice(ref, c, to_host=True))
        have = tformat.chip_frames(tp, c, tk.chip_slice(got, c, to_host=True))
        assert set(have) == set(want)
        for table in want:
            assert set(have[table]) == set(want[table]), table
            for col, w in want[table].items():
                h = have[table][col]
                if col.endswith("int"):
                    # The published intercept extrapolates the trend to day
                    # 0 (~2000x the slope's error): compare the day-anchor
                    # intercept c0 = int + slope * anchor instead.
                    anchor = float(jp.dates[c][0])
                    slope = lambda tab: np.array(
                        [np.nan if v is None else v[0]
                         for v in tab[col[:-3] + "coef"]])
                    np.testing.assert_allclose(
                        h.astype(float) + slope(have[table]) * anchor,
                        w.astype(float) + slope(want[table]) * anchor,
                        rtol=5e-3, atol=1e-1, err_msg=col)
                elif col.endswith(("mag", "rmse")):
                    np.testing.assert_allclose(
                        h.astype(float), w.astype(float), rtol=5e-3,
                        atol=1e-1, err_msg=col)
                elif col.endswith("coef"):
                    for a, b in zip(h, w):
                        assert (a is None) == (b is None), col
                        if a is not None:
                            np.testing.assert_allclose(a, b, rtol=5e-3,
                                                       atol=1e-2)
                else:
                    for a, b in zip(h, w):
                        np.testing.assert_array_equal(np.asarray(a),
                                                      np.asarray(b),
                                                      err_msg=col)


def test_batch_frames_equal_chip_frames(runs):
    _, _, tp, _, got = runs
    frames = tformat.batch_frames(tp, got)
    for c, ((cx, cy), f) in enumerate(frames):
        one = tformat.chip_frames(tp, c, tk.chip_slice(got, c))
        assert (cx, cy) == tuple(int(v) for v in tp.cids[c])
        for table in one:
            for col, v in one[table].items():
                for a, b in zip(f[table][col], v):
                    np.testing.assert_array_equal(np.asarray(a),
                                                  np.asarray(b))


def test_egress_roundtrip_bit_exact(runs):
    _, _, tp, _, got = runs
    worst = int(got.n_segments.max())
    S = got.seg_meta.shape[2]
    s_eff = tk.egress_bucket(worst, S)
    tables = tk.pack_egress(got, s_eff)
    assert all(not torch.is_floating_point(v) for v in tables.values())
    T = tp.spectra.shape[-1]
    dec = tformat.decode_egress(tables, T)
    g = convert.segments_to_numpy(got)
    for f in ("n_segments", "procedure", "mask", "rounds", "round_counts"):
        np.testing.assert_array_equal(getattr(dec, f), getattr(g, f))
    for f in ("seg_meta", "seg_rmse", "seg_mag", "seg_coef"):
        np.testing.assert_array_equal(
            getattr(dec, f).view(np.int32),
            getattr(g, f)[:, :, :s_eff].view(np.int32), err_msg=f)
    np.testing.assert_array_equal(dec.vario.view(np.int32),
                                  g.vario.view(np.int32))
    np.testing.assert_array_equal(tables["mask"].numpy(),
                                  np.packbits(g.mask, axis=-1))


def test_segments_to_records_match_jax(runs):
    """The pyccd result dicts: the port's converter equals the JAX one on
    the same arrays, and its discrete fields equal those of the JAX
    package's own result."""
    _, jp, tp, ref, got = runs
    for c in range(tp.n_chips):
        g = tk.chip_slice(got, c, to_host=True)
        r = jk.chip_slice(ref, c, to_host=True)
        dates = np.asarray(tp.dates[c][: int(tp.n_obs[c])])
        for p in range(g.n_segments.shape[0]):
            have = tk.segments_to_records(g, dates, p, sensor=T_TINY)
            assert have == jk.segments_to_records(g, dates, p,
                                                  sensor=LANDSAT_ARD_TINY)
            want = jk.segments_to_records(r, dates, p, sensor=LANDSAT_ARD_TINY)
            assert have["procedure"] == want["procedure"]
            assert have["processing_mask"] == want["processing_mask"]
            keys = ("start_day", "end_day", "break_day", "observation_count",
                    "curve_qa", "change_probability")
            assert ([{k: m[k] for k in keys} for m in have["change_models"]]
                    == [{k: m[k] for k in keys} for m in want["change_models"]])


def test_capacity_retry_reaches_full_result():
    _, _, tp, _, full = _run("two_changes_gaps")
    assert int(full.n_segments.max()) >= 2
    small = tk.detect_packed(tp, device="cpu", max_segments=1)
    assert small.seg_meta.shape[2] >= int(full.n_segments.max())
    S = int(full.n_segments.max())
    for f in ("n_segments", "procedure", "mask"):
        assert torch.equal(getattr(small, f), getattr(full, f)), f
    for f in ("seg_meta", "seg_rmse", "seg_mag", "seg_coef"):
        assert torch.equal(getattr(small, f)[:, :, :S],
                           getattr(full, f)[:, :, :S]), f
    raw = tk.detect_packed(tp, device="cpu", max_segments=1,
                           check_capacity=False)
    assert raw.seg_meta.shape[2] == 1
    assert torch.equal(raw.n_segments, full.n_segments)


def test_plain_ops_route_equals_kernels_route_on_cpu():
    """On CPU tensors the wrappers run their plain versions, so the two
    routes of detect_packed are the same computation."""
    _, tp = _packed("default")
    a = tk.detect_packed(tp, device="cpu", ops=cuda_ops.KERNELS)
    b = tk.detect_packed(tp, device="cpu", ops=cuda_ops.PLAIN)
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        assert (va is None and vb is None) or torch.equal(va, vb), f.name
