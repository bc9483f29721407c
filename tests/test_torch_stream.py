"""The port's stream driver end to end on the CPU, against the JAX package's.

A StepSource-like chip (100x100 pixels, every pixel stepped +800 on every
band from 1999-03-01, 1997-1999) through ``stream()`` of both packages:

- the three passes (bootstrap to 1998-12-31, the update to 1999-12-31, the
  same range again): the same summaries; the bootstrap's rows under
  PR-11's float32 contract (decisions identical, floats inside
  test_torch_driver.py's envelopes); the third pass a no-op;
- the cross runs: JAX bootstraps and both packages update from copies of
  JAX's checkpoint, then the port bootstraps and both update from copies
  of the port's.  From the same state, the update's checkpoint, published
  rows and alert records (less run ids and clocks) are identical, and so
  are the repair jobs;
- the port alone: quarantine and drain, void on an unrecoverable
  checkpoint, ``repair_chip``'s rows against ``detect_packed`` +
  ``batch_frames`` (on a 10x10 chip), the ``stream`` command line.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from firebird_tpu.config import Config as JConfig
from firebird_tpu.driver import stream as jstream
from firebird_tpu.ingest.packer import ChipData as JChipData
from firebird_tpu.serve.changefeed import ProductWrites as JProductWrites
from firebird_tpu.store import MemoryStore as JMemoryStore
from firebird_tpu.streamops import statestore as jss
from firebird_tpu_torch import __main__ as tmain
from firebird_tpu_torch import grid
from firebird_tpu_torch.alerts import AlertLog, repair_chip
from firebird_tpu_torch.ccd import format as tformat
from firebird_tpu_torch.ccd import incremental, kernel, synthetic
from firebird_tpu_torch.ccd.sensor import LANDSAT_ARD, LANDSAT_ARD_TINY
from firebird_tpu_torch.config import Config
from firebird_tpu_torch.driver import quarantine as qlib
from firebird_tpu_torch.driver import stream as tstream
from firebird_tpu_torch.fleet import FleetQueue
from firebird_tpu_torch.ingest import pack
from firebird_tpu_torch.ingest.packer import ChipData
from firebird_tpu_torch.store import MemoryStore
from firebird_tpu_torch.streamops import statestore as tss
from firebird_tpu_torch.utils import dates as dt
from test_torch_driver import _compare_segments, _table

BOOT = "1997-01-01/1998-12-31"
FULL = "1997-01-01/1999-12-31"
# the first chip of the tile at (100, 200), the one a number=1 run takes
CID = tuple(int(v) for v in grid.chips(grid.tile(x=100, y=200))[0])


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU detector on one thread: the suite runs several
    workers on the machine's cores, and at 10 000 pixels torch's own
    threads then contend (a bootstrap ran ~10x slower on 8 threads than
    on one there)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class StepSource:
    """tests/test_stream_driver.py's StepSource on a shorter archive: one
    100x100 chip whose every pixel steps +800 on all bands at
    CHANGE_DATE; ``chip`` cuts it to the asked range.  ``fail`` names
    chips whose fetch raises; ``jax=True`` serves the JAX package's
    ChipData."""

    CHANGE_DATE = "1999-03-01"

    def __init__(self, jax=False, fail=(), sensor=LANDSAT_ARD):
        rng = np.random.default_rng(7)
        self.t = synthetic.acquisition_dates("1997-01-01", "1999-12-31", 16)
        T, side = self.t.shape[0], sensor.chip_side
        base = synthetic.harmonic_series(self.t, rng)            # [7, T]
        spectra = base[:, :, None, None] + rng.normal(0.0, 10.0,
                                                      (7, T, side, side))
        spectra[:, self.t >= dt.to_ordinal(self.CHANGE_DATE)] += 800.0
        self.spectra = np.clip(spectra, -32768, 32767).astype(np.int16)
        self.qas = np.full((T, side, side), synthetic.QA_CLEAR, np.uint16)
        self.data = JChipData if jax else ChipData
        self.sensor = sensor
        self.fail = set(fail)

    def chip(self, x, y, acquired):
        if (int(x), int(y)) in self.fail:
            raise IOError(f"chip ({x},{y}) unavailable")
        lo, hi = (dt.to_ordinal(s) for s in acquired.split("/"))
        m = (self.t >= lo) & (self.t <= hi)
        kw = {} if self.sensor is LANDSAT_ARD else dict(sensor=self.sensor)
        return self.data(cx=int(x), cy=int(y), dates=self.t[m],
                         spectra=self.spectra[:, m], qas=self.qas[m], **kw)


def _cfg(root, backend="sqlite"):
    return dict(store_backend=backend, store_path=str(root / "s.db"),
                stream_dir=str(root / "state"), alert_db=str(root / "a.db"),
                fleet_db=str(root / "fleet.db"), source_backend="synthetic")


def port(root, acquired, store=None, number=1, source=None, **kw):
    cfg = Config(**_cfg(root, "memory" if store is not None else "sqlite"),
                 **kw)
    return tstream.stream(100, 200, acquired=acquired, number=number,
                          cfg=cfg, source=source or StepSource(),
                          store=store, device="cpu")


def jax(root, acquired, store=None):
    cfg = JConfig(**_cfg(root, "memory" if store is not None else "sqlite"))
    return jstream.stream(100, 200, acquired=acquired, number=1, cfg=cfg,
                          source=StepSource(jax=True), store=store)


def _alerts(root):
    log = AlertLog(str(root / "a.db"))
    recs = log.since(0, limit=10_000)
    log.close()
    # less what names the run: ids, clocks and the JAX package's trace id
    # (the port's tracer is not ported)
    return [{k: v for k, v in r.items()
             if k not in ("id", "run_id", "detected_at", "trace")}
            for r in sorted(recs, key=lambda r: (r["px"], r["py"]))]


def _jobs(root):
    q = FleetQueue(str(root / "fleet.db"))
    out = {c: q.job(j)["payload"] for c, j in q.open_jobs("repair").items()}
    q.close()
    return {c: {k: v for k, v in p.items() if k != "run_id"}
            for c, p in out.items()}


def _copy_root(src, dst):
    """A copy of a run's directory: its files as they are, and its packed
    checkpoints re-saved slot by slot (a tile file is sparse, 2 500 slots
    of which one is used here; a plain copy would write out the holes)."""
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("*.fbss"))
    a = tss.TileStateStore(str(src / "state"))
    b = tss.TileStateStore(str(dst / "state"))
    for c in a.chips():
        b.save_arrays(c, a.peek_arrays(c))
    a.close()
    b.close()


def _state(root):
    return tss.TileStateStore(str(root / "state")).peek_arrays(CID)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' three passes, and the cross runs' updates."""
    tmp = tmp_path_factory.mktemp("stream")
    out = {}
    for name, drive in (("jax", jax), ("port", port)):
        root = tmp / name
        boot = MemoryStore("b") if name == "port" else JMemoryStore("b")
        s1 = drive(root, BOOT, store=boot)
        twin = tmp / f"{name}_twin"
        _copy_root(root, twin)
        upd = {}
        for who, d in (("jax", jax), ("port", port)):
            r = root if who == name else twin
            store = MemoryStore("u") if who == "port" else JMemoryStore("u")
            s2 = d(r, FULL, store=store)
            s3 = d(r, FULL, store=store)
            upd[who] = dict(root=r, s2=s2, s3=s3, store=store)
        out[name] = dict(s1=s1, boot=boot, upd=upd)
    return out


def test_bootstrap_rows_decide_as_jax(runs):
    j, p = runs["jax"], runs["port"]
    for k in ("bootstrapped", "updated", "pixels_need_batch",
              "alerts_emitted"):
        assert p["s1"][k] == j["s1"][k], k
    assert p["s1"]["bootstrapped"] == 1
    for table in ("chip", "pixel"):
        assert _table(p["boot"], table) == _table(j["boot"], table)
    env = {"rmse": (1e-4, 1e-3), "mag": (5e-3, 1e-2), "int": (5e-3, 1e-1)}

    def close(a, b, what):
        rtol, atol = env[what]
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=what)

    _compare_segments(j["boot"], p["boot"], 1e-4, close)


@pytest.mark.parametrize("boot", ["jax", "port"])
def test_update_from_the_same_checkpoint_is_identical(runs, boot):
    upd = runs[boot]["upd"]
    j, p = upd["jax"], upd["port"]
    assert p["s2"] == j["s2"]
    assert p["s2"]["updated"] == 1 and p["s2"]["obs_applied"] >= 20
    # the step change broke every active pixel, one alert each
    assert p["s2"]["alerts_emitted"] == p["s2"]["pixels_need_batch"] >= 9000
    want, got = _state(j["root"]), _state(p["root"])
    for f in incremental.STATE_FIELDS + tss.SIDE_FIELDS:
        assert got[f].dtype == want[f].dtype, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert _table(p["store"], "segment") == _table(j["store"], "segment")
    assert _alerts(p["root"]) == _alerts(j["root"])
    years = {r["break_date"][:4] for r in _alerts(p["root"])}
    assert years == {"1999"}
    assert _jobs(p["root"]) == _jobs(j["root"]) != {}


@pytest.mark.parametrize("boot", ["jax", "port"])
def test_third_pass_is_a_noop(runs, boot):
    for who in ("jax", "port"):
        s2, s3 = (runs[boot]["upd"][who][k] for k in ("s2", "s3"))
        assert s3["updated"] == 0 and s3["obs_applied"] == 0
        assert s3["alerts_emitted"] == 0 and s3["alerts_deduped"] == 0
        assert s3["repair_jobs_enqueued"] == 0
        assert s3["pixels_need_batch"] == s2["pixels_need_batch"]
    assert runs[boot]["upd"]["port"]["s3"] == runs[boot]["upd"]["jax"]["s3"]


def test_repair_chip_rows_equal_detect_packed(tmp_path):
    """``repair_chip`` on a chip whose checkpoint is flagged (10x10 pixels:
    the repair runs any chip the detector takes): its rows are
    ``detect_packed`` + ``batch_frames`` over the full range, its fresh
    checkpoint flags nothing, and the feed records the chip (read by the
    JAX package's reader)."""
    src = StepSource(sensor=LANDSAT_ARD_TINY)
    cfg = Config(**_cfg(tmp_path))
    (tmp_path / "s.db").write_bytes(b"")
    packed = pack([src.chip(*CID, FULL)], bucket=cfg.obs_bucket,
                  max_obs=cfg.max_obs)
    seg = kernel.segments_to_numpy(kernel.detect_packed(packed, device="cpu"))
    flagged = incremental.StreamState.from_chip(kernel.chip_slice(seg, 0),
                                                device="cpu")
    flagged.break_day[:] = 729900.0
    store = tss.TileStateStore(str(tmp_path / "state"))
    store.save(CID, flagged, tstream.seed_side(packed, 0,
                                               kernel.chip_slice(seg, 0)))
    caught = MemoryStore("repair")
    rep = repair_chip(cfg, CID, FULL, source=src, store=caught, device="cpu")
    assert rep["still_flagged"] == 0 and rep["obs"] == int(packed.n_obs[0])
    assert not (store.peek_arrays(CID)["break_day"] > 0).any()
    store.close()
    want = MemoryStore("want")
    for _, frames in tformat.batch_frames(packed, seg):
        for table in ("chip", "pixel", "segment"):
            want.write(table, frames[table])
    for table in ("chip", "pixel", "segment"):
        assert _table(caught, table) == _table(want, table), table
    feed = JProductWrites(str(tmp_path / "changefeed.db"))
    assert [(r["cx"], r["cy"]) for r in feed.since(0)] == [CID]
    feed.close()


def test_quarantine_and_drain(tmp_path):
    cids = [tuple(int(v) for v in c)
            for c in grid.chips(grid.tile(x=100, y=200))[:2]]
    poisoned = cids[0]
    s1 = port(tmp_path, BOOT, number=2, chips_per_batch=1, fetch_retries=0,
              source=StepSource(fail={poisoned}))
    assert s1["bootstrapped"] == 1 and s1["quarantined"] == 1
    cfg = Config(**_cfg(tmp_path))
    doc = json.load(open(qlib.quarantine_path(cfg)))
    assert doc["chips"][f"{poisoned[0]},{poisoned[1]}"]["stage"] == "stream"
    assert tss.TileStateStore(str(tmp_path / "state")).chips() == [cids[1]]
    s2 = port(tmp_path, BOOT, number=2, chips_per_batch=1, fetch_retries=0)
    assert s2["bootstrapped"] == 1 and s2["quarantined"] == 0
    assert len(qlib.Quarantine.load(qlib.quarantine_path(cfg))) == 0
    assert tss.TileStateStore(str(tmp_path / "state")).chips() == sorted(cids)


def test_void_on_unrecoverable_checkpoint(runs, tmp_path):
    root = tmp_path / "v"
    _copy_root(runs["port"]["upd"]["port"]["root"], root)
    store = tss.TileStateStore(str(root / "state"))
    hv, idx = store.slot_of(CID)
    store._open(hv)
    cap, span = store._spans(*store._geom[hv])
    base = store._slot_offset(idx, span)
    with open(store.tile_path(hv), "r+b") as f:
        for bank in (0, 1):
            f.seek(base + 2 * tss.SLOT_HDR_SIZE + bank * cap)
            f.write(b"\xff" * cap)
    store.close()
    s = port(root, FULL, store=MemoryStore("x"))
    assert s["state_voided"] == 1 and s["updated"] == 0
    assert not tss.TileStateStore(str(root / "state")).exists(CID)
    # the next run re-bootstraps the chip
    assert port(root, FULL, store=MemoryStore("y"))["bootstrapped"] == 1
    # and the JAX package reads the fresh checkpoint
    st, side = jss.TileStateStore(str(root / "state")).load(CID)
    assert float(side["horizon"]) == float(StepSource().t[-1])


def test_stream_refuses_what_is_not_ported(tmp_path):
    for knob in (dict(compile_cache="/x"), dict(object_root="/x"),
                 dict(faults="ingest:p=0.1")):
        with pytest.raises(ValueError, match="not ported"):
            port(tmp_path, BOOT, **knob)


def test_stream_refuses_a_non_landsat_chip(tmp_path):
    from firebird_tpu_torch.ccd.sensor import SENTINEL2
    from firebird_tpu_torch.ingest import SyntheticSource

    src = SyntheticSource(sensor=SENTINEL2, start="2019-01-01",
                          end="2019-03-01")
    with pytest.raises(ValueError, match="Landsat"):
        port(tmp_path, "2019-01-01/2019-03-01", source=src)


def test_cli_stream(monkeypatch, tmp_path, capsys):
    """``python -m firebird_tpu_torch stream`` on the CPU: bootstrap, then a
    pass with nothing new, into sqlite next to the store."""
    for k, v in (("FIREBIRD_SOURCE", "synthetic"),
                 ("FIREBIRD_STORE_BACKEND", "sqlite"),
                 ("FIREBIRD_STORE_PATH", str(tmp_path / "fb.db"))):
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(tstream.dcore, "make_source",
                        lambda cfg, kind=None: StepSource())
    argv = ["stream", "-x", "100", "-y", "200", "-n", "1", "-a", BOOT,
            "--device", "cpu"]
    tmain.main(argv)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["bootstrapped"] == 1 and out["updated"] == 0
    assert set(out["seconds"]) >= {"fetch", "pack", "dispatch", "drain",
                                   "write", "load", "step", "publish",
                                   "save", "total"}
    assert (tmp_path / "fb.db.stream").is_dir()
    tmain.main(argv)
    again = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert again["bootstrapped"] == 0 and again["obs_applied"] == 0
