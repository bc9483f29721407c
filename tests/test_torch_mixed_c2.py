"""The nine Sentinel-2 pixels whose mixed route-0 decisions differ from
float32 on the card (ROADMAP C2), examined against the JAX package.

On the card, ``chip_smoke.py``'s Sentinel-2 chip
(``SyntheticSource(seed=11, 2019-2020, cloud_frac=0.15,
sensor=SENTINEL2)``, ``chip(100, 200)``, 90 000 pixels, T=64) decides as
f32 under ``mixed=True`` on all but the nine pixels of :data:`PIXELS`
(``mixed_vs_f32`` names them; NVIDIA H100 80GB HBM3, 700.00 W).  Pixels
are independent, so their columns alone go through JAX's
``detect_packed`` on its ``FIREBIRD_PALLAS=fit`` route, in float32 and
with ``mixed=True``, and through the port's plain route 0 on the CPU:

- JAX's mixed route flips the same nine pixels, to the values the card's
  mixed kernels gave (:data:`CARD`): the mixed Gram moves the stability
  window's start by one acquisition.  A reference-side envelope, not a
  fault of the port;
- the port's plain versions decide as JAX in both precisions;
- a few other pixels of the chip decide alike in both precisions.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from firebird_tpu.ccd import kernel as jk
from firebird_tpu.ccd.sensor import SENTINEL2 as J_S2
from firebird_tpu.ingest import SyntheticSource as JSource
from firebird_tpu.ingest import pack as jpack
from firebird_tpu.ingest.packer import PackedChips as JPacked
from firebird_tpu_torch.ccd import kernel as tk
from firebird_tpu_torch.ccd.sensor import SENTINEL2
from firebird_tpu_torch.ingest import SyntheticSource, pack
from firebird_tpu_torch.ingest.packer import PackedChips


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


S2 = dict(seed=11, start="2019-01-01", end="2021-01-01", cloud_frac=0.15)
PIXELS = (40245, 53864, 56775, 57975, 58374, 65196, 68860, 70850, 81064)
OTHERS = (100, 20000, 45000)
# The card's tail segment of each pixel (n_segments 1, procedure 0 in
# both precisions): (sday, eday, bday, chprob, curqa, nobs) in f32, then
# in mixed.
CARD = {
    40245: ((737140, 737780, 737780, 0.0, 24, 14),
            (737172, 737780, 737780, 0.0, 24, 12)),
    53864: ((737156, 737716, 737716, 1 / 3, 24, 17),
            (737172, 737716, 737716, 1 / 3, 24, 16)),
    56775: ((737140, 737716, 737716, 1 / 3, 24, 18),
            (737156, 737716, 737716, 1 / 3, 24, 17)),
    57975: ((737156, 737716, 737716, 1 / 3, 24, 16),
            (737172, 737716, 737716, 1 / 3, 24, 15)),
    58374: ((737204, 737780, 737780, 1 / 6, 24, 13),
            (737204, 737716, 737716, 1 / 3, 24, 12)),
    65196: ((737204, 737716, 737716, 1 / 3, 24, 14),
            (737220, 737716, 737716, 1 / 3, 24, 13)),
    68860: ((737140, 737716, 737716, 1 / 3, 24, 16),
            (737156, 737716, 737716, 1 / 3, 24, 15)),
    70850: ((737172, 737716, 737716, 1 / 3, 24, 15),
            (737188, 737716, 737716, 1 / 3, 24, 14)),
    81064: ((737172, 737716, 737716, 1 / 3, 24, 13),
            (737188, 737716, 737716, 1 / 3, 24, 12)),
}


def _columns(p, cls, idx):
    return cls(cids=p.cids, dates=p.dates,
               spectra=np.ascontiguousarray(p.spectra[:, :, idx, :]),
               qas=np.ascontiguousarray(p.qas[:, idx, :]), n_obs=p.n_obs,
               sensor=p.sensor)


def _tails(seg):
    """Each pixel's (n_segments, procedure, tail meta) as host values."""
    n = np.asarray(seg.n_segments)[0]
    meta = np.asarray(seg.seg_meta, np.float64)[0]
    proc = np.asarray(seg.procedure)[0]
    return [(int(n[i]), int(proc[i]), tuple(meta[i, max(int(n[i]) - 1, 0)]))
            for i in range(n.shape[0])]


@pytest.fixture(scope="module")
def decided(monkeypatch_module):
    idx = np.array(PIXELS + OTHERS)
    jp = _columns(jpack([JSource(sensor=J_S2, **S2).chip(100, 200)],
                        bucket=64), JPacked, idx)
    monkeypatch_module.setenv("FIREBIRD_PALLAS", "fit")
    jax = {m: _tails(jk.detect_packed(jp, dtype=jnp.float32, compact=False,
                                      mixed=m)) for m in (False, True)}
    monkeypatch_module.delenv("FIREBIRD_PALLAS")
    tp = _columns(pack([SyntheticSource(sensor=SENTINEL2, **S2)
                        .chip(100, 200)], bucket=64), PackedChips, idx)
    port = {m: _tails(tk.detect_packed(tp, device="cpu", pallas="1", fused=0,
                                       compact=False, mixed=m))
            for m in (False, True)}
    return jax, port


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _close(tail, card):
    got = np.array(tail, np.float64)
    return np.allclose(got, np.array(card, np.float64), rtol=0, atol=1e-6)


def test_jax_mixed_flips_the_card_pixels_the_same_way(decided):
    jax, _ = decided
    for k, p in enumerate(PIXELS):
        f32, mixed = CARD[p]
        assert jax[False][k][:2] == jax[True][k][:2] == (1, 0), p
        assert _close(jax[False][k][2], f32), (p, jax[False][k])
        assert _close(jax[True][k][2], mixed), (p, jax[True][k])
        assert jax[False][k] != jax[True][k], p


def test_port_plain_routes_decide_as_jax(decided):
    jax, port = decided
    for m in (False, True):
        for k in range(len(PIXELS) + len(OTHERS)):
            assert port[m][k] == jax[m][k], (m, k)


def test_other_pixels_decide_alike_in_both_precisions(decided):
    jax, port = decided
    for k in range(len(PIXELS), len(PIXELS) + len(OTHERS)):
        assert jax[False][k] == jax[True][k]
        assert port[False][k] == port[True][k]
