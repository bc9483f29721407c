"""The port's float64 route, on the CPU.

- ``detect_packed(dtype=torch.float64)`` against the JAX package's
  ``detect_packed(dtype=jnp.float64)`` (its XLA route) on the tiny
  configurations of ``test_torch_detect.py``: every decision field
  identical, the floats within rtol 1e-9 and atol 1e-9.  Both compute in
  float64; they differ only in the order of long sums (the Gram einsums,
  the RMSE's pairwise sum), measured at 4e-11 absolute on the coefficients
  and 4e-12 on rmse and magnitude.
- The float64 route against the port's own ``reference.detect``, as
  ``test_ccd_kernel.py`` holds the JAX float64 route to its reference (the
  60-pixel slice, the four procedures, a spike), at its tolerances.
- The capacity re-dispatch in float64, and the route's bookkeeping: no
  kernel, no mixed precision, float64 results; an f32 run unchanged by the
  new argument.
"""

import dataclasses
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firebird_tpu.ccd import kernel as jk
from firebird_tpu.ingest import SyntheticSource as JSource
from firebird_tpu.ingest import pack as jpack
from firebird_tpu_torch.ccd import convert, cuda_ops, params
from firebird_tpu_torch.ccd import kernel as tk
from firebird_tpu_torch.ccd.reference import detect
from firebird_tpu_torch.ingest import SyntheticSource, pack, pixel_timeseries
from firebird_tpu_torch.ingest.packer import PackedChips
from test_ccd_kernel import overflow_packed
from test_torch_detect import CONFIGS, _packed

F64 = torch.float64
DECISIONS = ("n_segments", "procedure", "mask", "seg_meta")
FLOATS = ("seg_rmse", "seg_mag", "seg_coef", "vario")


@pytest.fixture(autouse=True)
def _clear_env(monkeypatch):
    for k in ("FIREBIRD_PALLAS", "FIREBIRD_FUSED_FIT",
              "FIREBIRD_MIXED_PRECISION"):
        monkeypatch.delenv(k, raising=False)


def to_port(p) -> PackedChips:
    """A JAX-package PackedChips as the port's (same arrays, the port's
    Landsat layout)."""
    return PackedChips(cids=p.cids, dates=p.dates, spectra=p.spectra,
                       qas=p.qas, n_obs=p.n_obs)


# ---------------------------------------------------------------------------
# Against the JAX package's float64 route
# ---------------------------------------------------------------------------

_RUNS = {}


def _run(name):
    if name not in _RUNS:
        jp, tp = _packed(name)
        ref = jk.detect_packed(jp, dtype=jnp.float64, compact=False)
        got = tk.detect_packed(tp, device="cpu", dtype=F64)
        _RUNS[name] = (ref, convert.segments_to_numpy(got))
    return _RUNS[name]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_f64_decisions_equal_jax_f64(name):
    ref, got = _run(name)
    for f in DECISIONS:
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    np.testing.assert_array_equal(got.rounds, np.asarray(ref.rounds))
    assert got.seg_meta.dtype == np.float64


@pytest.mark.parametrize("name", list(CONFIGS))
def test_f64_floats_within_1e9_of_jax_f64(name):
    ref, got = _run(name)
    for f in FLOATS:
        np.testing.assert_allclose(getattr(got, f),
                                   np.asarray(getattr(ref, f)),
                                   rtol=1e-9, atol=1e-9, err_msg=f)


# ---------------------------------------------------------------------------
# Against the port's own reference (test_ccd_kernel.py's checks)
# ---------------------------------------------------------------------------

def _slice(p, pix):
    return dataclasses.replace(p, spectra=p.spectra[:, :, pix, :],
                               qas=p.qas[:, pix, :])


_SLICE = {}


def _sixty():
    """test_ccd_kernel.py's 60-pixel slice of a full Landsat chip, through
    the float64 route."""
    if not _SLICE:
        src = SyntheticSource(seed=5, start="1995-01-01", end="2001-01-01",
                              cloud_frac=0.1)
        p = pack([src.chip(100, 200)], bucket=64)
        pix = np.random.default_rng(0).choice(10000, size=60, replace=False)
        small = _slice(p, pix)
        seg = tk.chip_slice(tk.detect_packed(small, device="cpu", dtype=F64),
                            0, to_host=True)
        _SLICE.update(small=small, seg=seg)
    return _SLICE["small"], _SLICE["seg"]


def test_sixty_pixel_slice_is_test_ccd_kernels():
    src = JSource(seed=5, start="1995-01-01", end="2001-01-01",
                  cloud_frac=0.1)
    jp = jpack([src.chip(100, 200)], bucket=64)
    small, _ = _sixty()
    pix = np.random.default_rng(0).choice(10000, size=60, replace=False)
    np.testing.assert_array_equal(small.spectra, jp.spectra[:, :, pix, :])
    np.testing.assert_array_equal(small.qas, jp.qas[:, pix, :])


def test_f64_structural_parity_with_reference():
    small, seg = _sixty()
    dates = small.dates[0][: int(small.n_obs[0])]
    n_two = 0
    for i in range(small.spectra.shape[2]):
        o = detect(**pixel_timeseries(small, 0, i))
        k = tk.segments_to_records(seg, dates, i)
        assert len(o["change_models"]) == len(k["change_models"]), i
        n_two += len(o["change_models"]) > 1
        for om, km in zip(o["change_models"], k["change_models"]):
            for f in ("start_day", "end_day", "break_day", "curve_qa",
                      "observation_count"):
                assert om[f] == km[f], (i, f)
            assert om["change_probability"] == pytest.approx(
                km["change_probability"], abs=1e-6), i
        assert o["processing_mask"] == k["processing_mask"], i
    assert n_two >= 3


def test_f64_numeric_parity_with_reference():
    small, seg = _sixty()
    dates = small.dates[0][: int(small.n_obs[0])]
    for i in range(0, small.spectra.shape[2], 7):
        o = detect(**pixel_timeseries(small, 0, i))
        k = tk.segments_to_records(seg, dates, i)
        for om, km in zip(o["change_models"], k["change_models"]):
            for band in params.BAND_NAMES:
                assert km[band]["rmse"] == pytest.approx(
                    om[band]["rmse"], rel=1e-6, abs=1e-6)
                assert km[band]["intercept"] == pytest.approx(
                    om[band]["intercept"], rel=1e-5, abs=1e-3)
                assert km[band]["magnitude"] == pytest.approx(
                    om[band]["magnitude"], rel=1e-6, abs=1e-6)
                for a, b in zip(om[band]["coefficients"],
                                km[band]["coefficients"]):
                    assert b == pytest.approx(a, rel=1e-5, abs=1e-6)


def _hand_packed(kind):
    """test_ccd_kernel.py's hand-built pixels: the four procedures (seed
    44) or a spike (seed 45), as a one-chip batch."""
    from firebird_tpu.ccd import synthetic as js

    t = js.acquisition_dates("1995-01-01", "2000-01-01", 16)
    T = t.shape[0]
    if kind == "procedures":
        Y = js.harmonic_series(t, np.random.default_rng(44))
        qa = [np.full(T, q, np.uint16) for q in
              (js.QA_CLEAR, js.QA_SNOW, js.QA_CLOUD, js.QA_FILL)]
        qa[1][: T // 10] = js.QA_CLEAR
        Ys = [Y, Y, Y, np.full((7, T), params.FILL_VALUE, np.float64)]
    else:
        Y = js.harmonic_series(t, np.random.default_rng(45))
        Y[:, T // 2] += 3000.0
        Ys, qa = [Y], [np.full(T, js.QA_CLEAR, np.uint16)]
    spectra = np.stack([np.asarray(y, np.int16) for y in Ys])
    return PackedChips(cids=np.zeros((1, 2), np.int64),
                       dates=t[None].astype(np.int32),
                       spectra=spectra.transpose(1, 0, 2)[None],
                       qas=np.stack(qa)[None],
                       n_obs=np.array([T], np.int32))


@pytest.mark.parametrize("kind", ["procedures", "spike"])
def test_f64_hand_built_pixels_match_reference(kind):
    p = _hand_packed(kind)
    seg = tk.chip_slice(tk.detect_packed(p, device="cpu", dtype=F64), 0,
                        to_host=True)
    expected = (["standard", "permanent-snow", "insufficient-clear",
                 "no-data"] if kind == "procedures" else ["standard"])
    for i, proc in enumerate(expected):
        o = detect(**pixel_timeseries(p, 0, i))
        k = tk.segments_to_records(seg, p.dates[0], i)
        assert k["procedure"] == proc == o["procedure"]
        assert len(k["change_models"]) == len(o["change_models"])
        for om, km in zip(o["change_models"], k["change_models"]):
            assert om["start_day"] == km["start_day"]
            assert om["curve_qa"] == km["curve_qa"]
        assert k["processing_mask"] == o["processing_mask"]
    if kind == "spike":
        T = p.dates.shape[1]
        assert tk.segments_to_records(seg, p.dates[0], 0)[
            "processing_mask"][T // 2] == 0


# ---------------------------------------------------------------------------
# Capacity re-dispatch and the route's bookkeeping
# ---------------------------------------------------------------------------

def test_f64_capacity_overflow_redispatches():
    p = to_port(overflow_packed())
    t = p.dates[0][: int(p.n_obs[0])]
    raw = tk.detect_packed(p, device="cpu", dtype=F64, check_capacity=False)
    assert int(raw.n_segments.max()) > tk.MAX_SEGMENTS
    one = tk.chip_slice(tk.detect_packed(p, device="cpu", dtype=F64), 0,
                        to_host=True)
    o = detect(**pixel_timeseries(p, 0, 0))
    n_oracle = len(o["change_models"])
    assert n_oracle > tk.MAX_SEGMENTS
    assert int(one.n_segments[0]) == n_oracle
    assert one.seg_meta.shape[1] >= n_oracle
    assert one.seg_meta.dtype == np.float64
    k = tk.segments_to_records(one, t, 0)
    for om, km in zip(o["change_models"], k["change_models"]):
        assert om["break_day"] == km["break_day"]
        assert om["start_day"] == km["start_day"]


@pytest.mark.parametrize("pallas", ["1", "lasso,monitor,tmask", "mega"])
def test_f64_route_runs_no_kernel(pallas):
    """A float64 route takes the plain versions whatever ``ops`` and the
    knobs name, records its dtype and turns mixed precision off."""
    route = tk.pallas_components(pallas, cuda_ops.KERNELS, mixed=True,
                                 dtype=F64)
    assert route.dtype == F64 and route.mixed is False
    plain = set(vars(cuda_ops.PLAIN).values())
    kernels = set(vars(cuda_ops.KERNELS).values())
    fns = [v for k, v in vars(route).items()
           if callable(v) and k != "fallback"]
    for fn in fns:
        base = getattr(fn, "func", fn)
        assert base not in kernels
        assert base in plain or base in (cuda_ops.lasso_fit_plain,
                                         cuda_ops.monitor_chain_scored_plain,
                                         cuda_ops.init_window_plain)
        cd = getattr(fn, "keywords", {})
        assert not set(cd.values()) & kernels
    with pytest.raises(ValueError, match="dtype"):
        tk.pallas_components(ops=route, dtype=torch.float32)
    assert tk.pallas_components(ops=route, dtype="float64") is route


def test_float_dtype_names_and_refusals():
    assert tk.float_dtype(None) == torch.float32
    assert tk.float_dtype("float64") == F64
    assert tk.float_dtype(torch.float32) == torch.float32
    for bad in ("bfloat16", torch.float16, "f8"):
        with pytest.raises(ValueError):
            tk.float_dtype(bad)


def test_f64_results_refuse_int_egress():
    _, tp = _packed("default")
    seg = tk.detect_packed(tp, device="cpu", dtype=F64)
    assert seg.seg_coef.dtype == F64 and seg.vario.dtype == F64
    with pytest.raises(TypeError, match="float32"):
        tk.pack_egress(seg, 2)


def _digest(seg) -> str:
    h = hashlib.sha256()
    for f in dataclasses.fields(seg):
        v = getattr(seg, f.name)
        if v is not None:
            h.update(v.contiguous().numpy().tobytes())
    return h.hexdigest()


def test_f32_result_unchanged_by_dtype_argument():
    """dtype=None, float32 and "float32" are one program: the same bytes."""
    _, tp = _packed("two_changes_gaps")
    base = _digest(tk.detect_packed(tp, device="cpu"))
    assert _digest(tk.detect_packed(tp, device="cpu",
                                    dtype=torch.float32)) == base
    assert _digest(tk.detect_packed(tp, device="cpu",
                                    dtype="float32")) == base
