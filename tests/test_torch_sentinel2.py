"""The port's detector on the 12-band Sentinel-2 layout against the JAX
package, on the CPU.

The chip of tests/test_pallas.py's Sentinel-2 case (seed 88, 15 % cloud,
``SENTINEL2``: detection bands 2, 3, 7, 10, 11, Tmask bands 2, 10, no
thermal band) over 2019-2023 (T = 96), cut to 64 pixels strided over the
300 x 300 chip so that the cut crosses its change patch, goes through
``firebird_tpu.ccd.kernel.detect_packed`` (float32, ``FIREBIRD_PALLAS``
unset) and through the port's routes 0, "mon", mega and the component
route with ``device="cpu"`` (the kernels' plain versions).  Decision fields
must be identical; the fitted floats stay inside tests/test_torch_detect.py's
envelope.  The CUDA kernels' 12-band instances are held to these plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import dataclasses
import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firebird_tpu.ccd import kernel as jk
from firebird_tpu.ccd.sensor import SENTINEL2 as J_S2
from firebird_tpu.ingest.packer import PackedChips
from firebird_tpu_torch.ccd import convert
from firebird_tpu_torch.ccd import kernel as tk
from firebird_tpu_torch.ccd.sensor import SENTINEL2
from firebird_tpu_torch.ingest import SyntheticSource as TSource
from firebird_tpu_torch.ingest import pack as tpack


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PIXELS = 64
ROUTES = {
    "0": dict(pallas="1", fused=0),
    "mon": dict(pallas="1", fused="mon"),
    "mega": dict(pallas="mega"),
    "components": dict(pallas="lasso,monitor,tmask", fused=0),
}


def _cut(p):
    sel = np.arange(PIXELS) * (p.spectra.shape[2] // PIXELS)
    return dataclasses.replace(
        p, spectra=np.ascontiguousarray(p.spectra[:, :, sel]),
        qas=np.ascontiguousarray(p.qas[:, sel]))


@functools.lru_cache(maxsize=None)
def _packed():
    """The port's packed cut, and the same arrays as the JAX package's
    PackedChips (the two synthetic sources are held equal on the tiny
    sensor by tests/test_torch_detect.py; a 300 x 300 chip takes seconds
    to make)."""
    tp = _cut(tpack([TSource(seed=88, start="2019-01-01", end="2023-01-01",
                             cloud_frac=0.15, sensor=SENTINEL2)
                     .chip(100, 200)], bucket=32))
    jp = PackedChips(cids=tp.cids, dates=tp.dates, spectra=tp.spectra,
                     qas=tp.qas, n_obs=tp.n_obs, sensor=J_S2)
    return jp, tp


@functools.lru_cache(maxsize=None)
def _ref():
    """The JAX package's float32 route on its default (XLA) path."""
    saved = os.environ.pop("FIREBIRD_PALLAS", None)
    try:
        return jk.detect_packed(_packed()[0], dtype=jnp.float32,
                                compact=False)
    finally:
        if saved is not None:
            os.environ["FIREBIRD_PALLAS"] = saved


@functools.lru_cache(maxsize=None)
def _port(route):
    return convert.segments_to_numpy(
        tk.detect_packed(_packed()[1], device="cpu", compact=False,
                         **ROUTES[route]))


def test_chip_is_sentinel2_and_breaks():
    jp, tp = _packed()
    assert tp.spectra.shape[:3] == (1, 12, PIXELS)
    assert tp.spectra.shape[-1] <= 128
    # Some pixels break, so the decisions below are not all one segment.
    assert int(np.asarray(_ref().n_segments).max()) >= 2


@pytest.mark.parametrize("route", list(ROUTES))
def test_sentinel2_decisions_match_jax(route):
    ref, g = _ref(), _port(route)
    np.testing.assert_array_equal(g.n_segments, np.asarray(ref.n_segments))
    assert g.n_segments.max() >= 2
    np.testing.assert_array_equal(g.procedure, np.asarray(ref.procedure))
    np.testing.assert_array_equal(g.mask, np.asarray(ref.mask))
    # sday, eday, bday, chprob, curqa, nobs
    np.testing.assert_array_equal(g.seg_meta, np.asarray(ref.seg_meta))


@pytest.mark.parametrize("route", list(ROUTES))
def test_sentinel2_floats_within_envelope(route):
    ref, g = _ref(), _port(route)
    np.testing.assert_allclose(g.seg_rmse, np.asarray(ref.seg_rmse),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(g.seg_mag, np.asarray(ref.seg_mag),
                               rtol=5e-3, atol=1e-2)
    np.testing.assert_array_equal(g.vario, np.asarray(ref.vario))
    c_r = np.asarray(ref.seg_coef)
    scale = np.maximum(np.abs(c_r).max(-1, keepdims=True), 1.0)
    assert (np.abs(g.seg_coef - c_r) / scale).max() <= 1e-4
