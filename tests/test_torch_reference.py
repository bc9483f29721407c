"""The port's numpy float64 reference against the JAX package's, on the CPU.

``firebird_tpu_torch.ccd.reference`` is the port's own copy of
``firebird_tpu.ccd.reference``: both run the same numpy float64
arithmetic, so every result dict must be equal, floats included.  The
pixels come from the tiny configurations of ``test_torch_detect.py``
(through each package's ``pixel_timeseries``) and from the hand-built
pixels of ``test_ccd_kernel.py`` (the four procedures, a spike).
"""

import numpy as np
import pytest
import torch

from firebird_tpu.ccd import params as jparams
from firebird_tpu.ccd import reference as jref
from firebird_tpu.ccd import synthetic as jsynth
from firebird_tpu.ingest import pixel_timeseries as j_pixel
from firebird_tpu_torch import ccd as tccd
from firebird_tpu_torch.ccd import reference as tref
from firebird_tpu_torch.ingest import pixel_timeseries as t_pixel
from test_torch_detect import CONFIGS, _packed


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# Every third pixel of both chips: 68 pixels a configuration.
PIXELS = range(0, 100, 3)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_reference_equals_jax_on_tiny_configs(name):
    jp, tp = _packed(name)
    n_models = 0
    for c in range(jp.n_chips):
        for i in PIXELS:
            jx, tx = j_pixel(jp, c, i), t_pixel(tp, c, i)
            assert set(jx) == set(tx)
            for k in jx:
                np.testing.assert_array_equal(tx[k], jx[k])
            want, got = jref.detect(**jx), tref.detect(**tx)
            assert got == want, (name, c, i)
            n_models += len(got["change_models"])
    assert n_models > 0


def test_package_exports_the_reference():
    assert tccd.detect is tref.detect


def _hand_built():
    """The pixels of test_ccd_kernel.py's procedures and spike tests, as
    detect() keyword arguments."""
    rng = np.random.default_rng(44)
    t = jsynth.acquisition_dates("1995-01-01", "2000-01-01", 16)
    T = t.shape[0]
    Y = jsynth.harmonic_series(t, rng)
    qa = {
        "standard": np.full(T, jsynth.QA_CLEAR, np.uint16),
        "snow": np.full(T, jsynth.QA_SNOW, np.uint16),
        "cloud": np.full(T, jsynth.QA_CLOUD, np.uint16),
        "fill": np.full(T, jsynth.QA_FILL, np.uint16),
    }
    qa["snow"][: T // 10] = jsynth.QA_CLEAR
    Yf = np.full((7, T), jparams.FILL_VALUE, np.float64)
    out = {}
    for name, Yp in (("standard", Y), ("snow", Y), ("cloud", Y),
                     ("fill", Yf)):
        d = {n: np.asarray(Yp[b], np.int16)
             for b, n in enumerate(jparams.BAND_NAMES_PLURAL)}
        out[name] = dict(d, dates=t.astype(np.int64), qas=qa[name])
    rng = np.random.default_rng(45)
    Ys = jsynth.harmonic_series(t, rng)
    Ys[:, T // 2] += 3000.0
    d = {n: np.asarray(Ys[b], np.int16)
         for b, n in enumerate(jparams.BAND_NAMES_PLURAL)}
    out["spike"] = dict(d, dates=t.astype(np.int64),
                        qas=np.full(T, jsynth.QA_CLEAR, np.uint16))
    return out


@pytest.mark.parametrize("pixel", ["standard", "snow", "cloud", "fill",
                                   "spike"])
def test_reference_equals_jax_on_hand_built_pixels(pixel):
    kw = _hand_built()[pixel]
    want, got = jref.detect(**kw), tref.detect(**kw)
    assert got == want
    expected = {"standard": "standard", "snow": "permanent-snow",
                "cloud": "insufficient-clear", "fill": "no-data",
                "spike": "standard"}[pixel]
    assert got["procedure"] == expected
