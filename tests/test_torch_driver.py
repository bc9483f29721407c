"""The port's batch driver end to end on the CPU, against the JAX package's.

The scenarios of ``tests/test_driver.py`` on ``firebird_tpu_torch.driver
.core`` (end to end, rerun idempotent, chunk-failure isolation, resume
skips stored chips, transient fetch retries, the drain's re-dispatch on a
capacity overflow, the quarantine drained first on resume), on tiny
(10x10-pixel) chips; then the port's ``changedetection`` against the JAX
package's on the same source and Config:

- in float64 the stored rows are equal field for field: the keys, dates,
  masks and every decision column exactly, the float columns within the
  float64 route's 1e-9 (``test_torch_f64.py``; intercepts compared in
  their day-anchor form ``int + slope * anchor``, as test_torch_detect.py
  does, because the published intercept extrapolates the slope to day 0);
- in float32 (the JAX package's CPU route of test_torch_detect.py) the
  decisions are identical and the floats inside test_torch_detect.py's
  envelope;
- the command line ``python -m firebird_tpu_torch changedetection ...
  --device cpu`` into a sqlite store.
"""

import dataclasses
import json

import numpy as np
import pytest

from firebird_tpu.ccd.sensor import LANDSAT_ARD_TINY as J_TINY
from firebird_tpu.config import Config as JConfig
from firebird_tpu.driver import core as jcore
from firebird_tpu.ingest import SyntheticSource as JSource
from firebird_tpu.store import MemoryStore as JMemoryStore
from firebird_tpu_torch import __main__ as tmain
from firebird_tpu_torch.ccd import kernel as tk
from firebird_tpu_torch.ccd.sensor import LANDSAT_ARD_TINY
from firebird_tpu_torch.config import Config
from firebird_tpu_torch.driver import core
from firebird_tpu_torch.driver import quarantine as qlib
from firebird_tpu_torch.ingest import SyntheticSource
from firebird_tpu_torch.ingest.packer import PackedChips
from firebird_tpu_torch.obs import Counters
from firebird_tpu_torch.store import AsyncWriter, MemoryStore, SqliteStore
from test_ccd_kernel import overflow_packed

ACQ = "1995-01-01/1999-06-01"
SRC = dict(seed=9, start="1995-01-01", end="1999-06-01", cloud_frac=0.1)
CFG = Config(store_backend="memory", source_backend="synthetic",
             chips_per_batch=1, dtype="float64", device_sharding="off",
             fetch_retries=0)


@pytest.fixture(autouse=True)
def _clear_env(monkeypatch):
    for k in ("FIREBIRD_PALLAS", "FIREBIRD_FUSED_FIT",
              "FIREBIRD_MIXED_PRECISION"):
        monkeypatch.delenv(k, raising=False)


def tiny(**kw):
    return SyntheticSource(sensor=LANDSAT_ARD_TINY, **dict(SRC, **kw))


def run(number=2, chunk_size=2, cfg=CFG, source=None, store=None, **kw):
    store = store if store is not None else MemoryStore("test")
    done = core.changedetection(x=100, y=200, acquired=ACQ, number=number,
                                chunk_size=chunk_size, cfg=cfg,
                                source=source or tiny(), store=store,
                                device="cpu", **kw)
    return done, store


_RUN = {}


def run_result():
    if not _RUN:
        _RUN["r"] = run()
    return _RUN["r"]


# ---------------------------------------------------------------------------
# tests/test_driver.py's scenarios
# ---------------------------------------------------------------------------

def test_changedetection_end_to_end():
    done, store = run_result()
    assert len(done) == 2
    chips = store.read("chip")
    assert len(chips["cx"]) == 2
    assert chips["dates"][0][0].startswith("1995-")
    assert store.count("pixel") == 200
    assert store.count("segment") >= 200
    seg = store.read("segment", {"cx": done[0][0], "cy": done[0][1]})
    real = [i for i, s in enumerate(seg["sday"]) if s != "0001-01-01"]
    assert len(real) >= 90
    i = real[0]
    assert seg["nicoef"][i] is not None and len(seg["nicoef"][i]) == 7
    assert seg["nirmse"][i] > 0


def test_rerun_is_idempotent():
    _, store = run_result()
    before = store.count("segment")
    run(number=1, chunk_size=1, store=store)
    assert store.count("segment") == before


def test_chunk_failure_isolation():
    good = tiny()
    calls = {"n": 0}

    class Flaky:
        def chip(self, cx, cy, acquired=None):
            calls["n"] += 1
            if calls["n"] == 1:
                raise IOError("chipmunk down")
            return good.chip(cx, cy, acquired)

    done, store = run(number=2, chunk_size=1, source=Flaky())
    assert len(done) == 1
    assert store.count("chip") == 1


def test_resume_skips_stored_chips():
    done, store = run_result()

    class Explodes:
        def chip(self, cx, cy, acquired=None):
            raise AssertionError("resume must not refetch stored chips")

    out, _ = run(source=Explodes(), store=store, resume=True)
    assert set(out) == set(done)


def test_transient_fetch_retries(monkeypatch):
    import time

    monkeypatch.setattr(time, "sleep", lambda s: None)
    good = tiny()
    calls = {"n": 0}

    class Transient:
        def chip(self, cx, cy, acquired=None):
            calls["n"] += 1
            if calls["n"] == 1:
                raise IOError("blip")
            return good.chip(cx, cy, acquired)

    done, store = run(number=1, chunk_size=1, source=Transient(),
                      cfg=dataclasses.replace(CFG, fetch_retries=2))
    assert len(done) == 1 and calls["n"] == 2
    assert store.count("chip") == 1


def test_drain_recomputes_on_capacity_overflow():
    j = overflow_packed()
    p = PackedChips(cids=j.cids, dates=j.dates, spectra=j.spectra,
                    qas=j.qas, n_obs=j.n_obs)
    seg = tk.detect_packed(p, device="cpu", dtype="float64",
                           check_capacity=False)
    worst = int(seg.n_segments.max())
    assert worst > tk.MAX_SEGMENTS
    store = MemoryStore("overflow")
    writer = AsyncWriter(store)
    try:
        core.drain_batch(seg, p, 1, writer=writer, counters=Counters(),
                         dtype="float64")
        writer.flush()
    finally:
        writer.close()
    rows = store.read("segment", {"px": 0, "py": 0})
    real = [s for s in rows["sday"] if s != "0001-01-01"]
    assert len(real) == worst


def test_quarantine_drains_first_on_resume(tmp_path):
    cfg = dataclasses.replace(CFG, store_backend="sqlite",
                              store_path=str(tmp_path / "fb.db"))
    good = tiny()
    fetched = []
    state = {"down": True}
    chips3 = None

    class Source:
        def chip(self, cx, cy, acquired=None):
            fetched.append((cx, cy))
            if state["down"] and (cx, cy) == chips3[2]:
                raise IOError("poisoned")
            return good.chip(cx, cy, acquired)

    from firebird_tpu_torch import grid

    chips3 = [tuple(int(v) for v in c)
              for c in grid.chips(grid.tile(100, 200))[:4]]
    store = SqliteStore(cfg.store_path, cfg.keyspace())
    done, _ = run(number=3, chunk_size=3, cfg=cfg, source=Source(),
                  store=store)
    assert set(done) == set(chips3[:2])
    q = qlib.Quarantine.load(qlib.quarantine_path(cfg))
    assert q.chip_ids() == {chips3[2]}
    state["down"] = False
    fetched.clear()
    done, _ = run(number=4, chunk_size=4, cfg=cfg, source=Source(),
                  store=store, resume=True)
    assert fetched == [chips3[2], chips3[3]]      # the dead letter first
    assert set(done) == set(chips3)
    assert len(qlib.Quarantine.load(qlib.quarantine_path(cfg))) == 0
    assert store.chip_ids("segment") == set(chips3)


def test_changedetection_without_a_device_argument_needs_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        core.changedetection(x=100, y=200, acquired=ACQ, number=1,
                             chunk_size=1, cfg=CFG, source=tiny(),
                             store=MemoryStore("x"))


# ---------------------------------------------------------------------------
# Against the JAX package's changedetection
# ---------------------------------------------------------------------------

def _jax_rows(dtype, number=4):
    cfg = JConfig(store_backend="memory", source_backend="synthetic",
                  chips_per_batch=2, dtype=dtype, device_sharding="off",
                  fetch_retries=0, compact=False)
    store = JMemoryStore("jax")
    jcore.changedetection(x=100, y=200, acquired=ACQ, number=number,
                          chunk_size=number, cfg=cfg,
                          source=JSource(sensor=J_TINY, **SRC), store=store)
    return store


def _port_rows(dtype, number=4):
    cfg = dataclasses.replace(CFG, chips_per_batch=2, dtype=dtype)
    _, store = run(number=number, chunk_size=number, cfg=cfg)
    return store


_PAIRS = {}


def _pair(dtype):
    if dtype not in _PAIRS:
        _PAIRS[dtype] = (_jax_rows(dtype), _port_rows(dtype))
    return _PAIRS[dtype]


def _table(store, table):
    """The rows of ``table`` keyed by its primary key."""
    from firebird_tpu_torch.store.schema import primary_key

    d = store.read(table)
    key = primary_key(table)
    n = len(d[key[0]])
    return {tuple(d[k][i] for k in key): {c: d[c][i] for c in d}
            for i in range(n)}


BANDS = ("bl", "gr", "re", "ni", "s1", "s2", "th")
DECISION_COLS = ("sday", "eday", "bday", "chprob", "curqa")


def _anchor(store, cx, cy):
    from firebird_tpu_torch.utils import dates as dt

    dates = _table(store, "chip")[(cx, cy)]["dates"]
    return float(dt.to_ordinal(dates[0]))


def _compare_segments(jax_store, port_store, rtol_coef, check_float):
    want, got = _table(jax_store, "segment"), _table(port_store, "segment")
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        for c in DECISION_COLS:
            assert g[c] == w[c], (key, c)
        if w["sday"] == "0001-01-01":
            assert g == w, key
            continue
        anchor = _anchor(jax_store, key[0], key[1])
        for b in BANDS:
            check_float(g[f"{b}rmse"], w[f"{b}rmse"], "rmse")
            check_float(g[f"{b}mag"], w[f"{b}mag"], "mag")
            gc, wc = np.asarray(g[f"{b}coef"]), np.asarray(w[f"{b}coef"])
            scale = max(np.abs(wc).max(), 1.0)
            assert np.abs(gc - wc).max() / scale <= rtol_coef, (key, b)
            check_float(g[f"{b}int"] + gc[0] * anchor,
                        w[f"{b}int"] + wc[0] * anchor, "int")


def test_f64_store_rows_equal_jax():
    jax_store, port_store = _pair("float64")
    for table in ("chip", "pixel"):
        assert _table(port_store, table) == _table(jax_store, table)

    def close(a, b, what):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9, err_msg=what)

    _compare_segments(jax_store, port_store, 1e-9, close)


def test_f32_store_decisions_equal_jax():
    jax_store, port_store = _pair("float32")
    for table in ("chip", "pixel"):
        assert _table(port_store, table) == _table(jax_store, table)
    env = {"rmse": (1e-4, 1e-3), "mag": (5e-3, 1e-2), "int": (5e-3, 1e-1)}

    def close(a, b, what):
        rtol, atol = env[what]
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=what)

    _compare_segments(jax_store, port_store, 1e-4, close)


def test_cli_changedetection(monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("FIREBIRD_SOURCE", "synthetic")
    monkeypatch.setenv("FIREBIRD_SYNTH_SENSOR", "landsat-ard-tiny")
    monkeypatch.setenv("FIREBIRD_STORE_BACKEND", "sqlite")
    monkeypatch.setenv("FIREBIRD_STORE_PATH", str(tmp_path / "fb.db"))
    monkeypatch.setenv("FIREBIRD_DTYPE", "float64")
    tmain.main(["changedetection", "-x", "100", "-y", "200", "-n", "2",
                "-a", ACQ, "-c", "2", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["chips_done"] == 2 and out["pixels"] == 200
    assert out["segments"] >= 200 and out["pixels_per_sec"] > 0
    assert set(out["seconds"]) >= {"fetch", "pack", "stage", "dispatch",
                                   "drain", "write", "total"}
    ks = Config.from_env().keyspace()
    assert (tmp_path / f"fb.{ks}.db").exists()
    store = SqliteStore(str(tmp_path / "fb.db"), ks)
    assert store.count("chip") == 2
    assert store.count("segment") >= 200
    # A second run with --resume fetches nothing and writes nothing.
    tmain.main(["changedetection", "-x", "100", "-y", "200", "-n", "2",
                "-a", ACQ, "-c", "2", "--device", "cpu", "--resume"])
    again = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert again["chips_done"] == 2 and again["chips_detected"] == 0


def test_auto_chips_per_batch_sizes_from_card_memory(monkeypatch):
    import torch

    acq = "1982-01-01/2017-12-31"
    cfg = Config(chips_per_batch=0)
    # Without a card: the static default, as the JAX package does for a
    # device that reports no memory.
    assert core.auto_chips_per_batch(cfg, acq, "cpu") == \
        Config.chips_per_batch
    free = {"bytes": 16e9}
    monkeypatch.setattr(core.kernel, "resolve_device",
                        lambda d=None: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda d=None: (free["bytes"], 80e9))
    n16 = core.auto_chips_per_batch(cfg, acq)
    t = core.estimate_obs(acq, cfg)
    per = tk.working_set_bytes(t) + 2 * tk.result_bytes(t)
    assert n16 == max(1, int(16e9 * 0.6 / per))
    free["bytes"] = 8e9
    n8 = core.auto_chips_per_batch(cfg, acq)
    assert n16 >= 2 * n8 >= 2
    free["bytes"] = 16e9
    short = core.auto_chips_per_batch(cfg, "1998-01-01/1999-12-31")
    assert short > n16
    f64 = core.auto_chips_per_batch(dataclasses.replace(cfg, dtype="float64"),
                                    acq)
    assert f64 < n16
    assert core.resolve_batching(Config(chips_per_batch=5),
                                 acq).chips_per_batch == 5
    assert core.resolve_batching(cfg, acq).chips_per_batch == n16
    assert tk.working_set_bytes(768, dtype_bytes=8) > tk.working_set_bytes(768)
    assert tk.result_bytes(768) < tk.working_set_bytes(768)


def test_pad_batch_noop_and_repeat():
    p = tiny().chip(100, 200)
    from firebird_tpu_torch.ingest import pack

    packed = pack([p], bucket=32)
    same, n = core._pad_batch(packed, 1)
    assert same is packed and n == 1
    padded, n = core._pad_batch(packed, core._pad_target(3, True, 2))
    assert n == 1 and padded.n_chips == 4
    np.testing.assert_array_equal(padded.spectra[3], packed.spectra[0])
    assert core._pad_target(3, False, 8) == 3
    assert core._pad_target(8, True, 8) == 8
