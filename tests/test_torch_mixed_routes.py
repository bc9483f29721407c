"""The port's mixed-precision path as a whole, on the CPU.

- ``detect_packed(mixed=True)`` against the JAX package's
  ``detect_packed(mixed=True)`` on its ``FIREBIRD_PALLAS=fit`` route, where
  every fit (the INIT block's stability fit too) runs the Pallas fit with
  the mixed Gram: decisions identical, floats inside test_torch_detect's
  envelope.
- The threshold-fuzz chip of tests/test_precision.py (seed 11) through the
  port: mixed against f32 on routes 0, 1, "mon" and mega (decisions
  identical, coef / rmse within ``params.MIXED_ULP_BUDGET`` scaled ulps),
  and the route identities in mixed.
"""

import functools
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firebird_tpu.ccd import kernel as jk
from firebird_tpu_torch.ccd import convert, params
from firebird_tpu_torch.ccd import kernel as tk
from firebird_tpu_torch.ingest.packer import PackedChips


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_precision import (DECISION_META_COLS, _scaled_ulps,  # noqa: E402
                            _threshold_fuzz_pixels)
from test_torch_detect import CONFIGS, _packed  # noqa: E402
from test_torch_mixed import _fields_differing  # noqa: E402

BUDGET = params.MIXED_ULP_BUDGET
FLOATS = ("seg_rmse", "seg_coef")


@pytest.fixture(autouse=True)
def _clear_env(monkeypatch):
    for k in ("FIREBIRD_PALLAS", "FIREBIRD_FUSED_FIT",
              "FIREBIRD_MIXED_PRECISION"):
        monkeypatch.delenv(k, raising=False)


# ---------------------------------------------------------------------------
# The whole path against the JAX package's mixed path
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_mixed(name):
    import os

    jp, _ = _packed(name)
    old = os.environ.get("FIREBIRD_PALLAS")
    os.environ["FIREBIRD_PALLAS"] = "fit"
    try:
        return jk.detect_packed(jp, dtype=jnp.float32, compact=False,
                                mixed=True)
    finally:
        if old is None:
            os.environ.pop("FIREBIRD_PALLAS")
        else:
            os.environ["FIREBIRD_PALLAS"] = old


# JAX's "fit" route: the Pallas fit for every fit (the INIT block's too),
# the XLA monitor and INIT block.  The port's "fit,monitor,tmask" route
# has the same fits; its default route "1" runs the INIT block's
# stability fit inside init_window, on the same mixed Gram.
@pytest.mark.parametrize("pallas", ["fit,monitor,tmask", "1"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_detect_mixed_matches_jax_mixed(name, pallas):
    _, tp = _packed(name)
    ref = _jax_mixed(name)
    g = convert.segments_to_numpy(tk.detect_packed(
        tp, device="cpu", pallas=pallas, compact=False, mixed=True))
    for f in ("n_segments", "procedure", "mask", "seg_meta", "rounds",
              "round_counts"):
        np.testing.assert_array_equal(getattr(g, f),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    # test_torch_detect's envelope.
    np.testing.assert_allclose(g.seg_rmse, np.asarray(ref.seg_rmse),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(g.seg_mag, np.asarray(ref.seg_mag),
                               rtol=5e-3, atol=1e-2)
    np.testing.assert_array_equal(g.vario, np.asarray(ref.vario))
    c_r = np.asarray(ref.seg_coef)
    scale = np.maximum(np.abs(c_r).max(-1, keepdims=True), 1.0)
    assert (np.abs(g.seg_coef - c_r) / scale).max() <= 1e-4


# ---------------------------------------------------------------------------
# The threshold-fuzz chip: mixed against f32 through the port
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _fuzz_packed():
    t, px = _threshold_fuzz_pixels()
    Ys, qas = zip(*px)
    spectra = np.stack([np.asarray(Y, np.int16) for Y in Ys])
    return PackedChips(cids=np.zeros((1, 2), np.int64),
                       dates=t[None].astype(np.int32),
                       spectra=spectra.transpose(1, 0, 2)[None],
                       qas=np.stack(qas)[None],
                       n_obs=np.array([t.shape[0]], np.int32))


FUZZ_ROUTES = {"0": dict(fused=0), "1": dict(fused=1),
               "mon": dict(fused="mon"), "mega": dict(pallas="mega")}


@functools.lru_cache(maxsize=None)
def _fuzz(route, mixed):
    return tk.detect_packed(_fuzz_packed(), device="cpu", compact=False,
                            mixed=mixed, **FUZZ_ROUTES[route])


@pytest.mark.parametrize("route", list(FUZZ_ROUTES))
def test_fuzz_chip_mixed_decisions_identical_within_budget(route):
    mx, f32 = _fuzz(route, True), _fuzz(route, False)
    for f in ("n_segments", "mask", "procedure", "rounds"):
        assert torch.equal(getattr(mx, f), getattr(f32, f)), f
    np.testing.assert_array_equal(
        mx.seg_meta[..., DECISION_META_COLS].numpy(),
        f32.seg_meta[..., DECISION_META_COLS].numpy())
    assert float(_scaled_ulps(mx.seg_coef, f32.seg_coef,
                              vector_axis=-1).max()) <= BUDGET
    assert float(_scaled_ulps(mx.seg_rmse, f32.seg_rmse).max()) <= BUDGET
    # The mixed Gram ran.
    assert any(not torch.equal(getattr(mx, f), getattr(f32, f))
               for f in FLOATS)
    assert int(mx.n_segments.max()) >= 2


def test_fuzz_chip_mixed_route_identities():
    """Route 1 = route 0 byte for byte, "mon" = route 0 but seg_mag, mega =
    "mon" but rounds (per chip there), all in mixed."""
    r0, r1 = _fuzz("0", True), _fuzz("1", True)
    mon, mega = _fuzz("mon", True), _fuzz("mega", True)
    assert _fields_differing(r1, r0) == []
    assert set(_fields_differing(mon, r0)) <= {"seg_mag"}
    assert set(_fields_differing(mega, mon)) <= {"rounds", "round_counts",
                                                 "occupancy", "compactions"}
    assert int(mega.rounds.max()) == int(r0.rounds[0])


def test_chip_smoke_fuzz_chip_is_test_precisions():
    """chip_smoke.py's threshold-fuzz chip (made from the port's copy of
    the synthetic series) is tests/test_precision.py's, array for array."""
    import chip_smoke

    got, want = chip_smoke.fuzz_packed(), _fuzz_packed()
    for f in ("cids", "dates", "spectra", "qas", "n_obs"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
