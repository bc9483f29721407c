"""The port's stream ingest against the JAX package's, on the CPU.

The acquisition watcher (``streamops/watcher.py``), the scene manifests
of the sources (``SyntheticSource.list_acquisitions``, ``FileSource``'s
``scenes.jsonl``), ``fetch`` and the ``watch`` command.  The watcher cases
of tests/test_streamops.py run on both packages with the same scripted
manifest, and the two watchers must enqueue the same jobs with the same
payloads (less each scene's random trace suffix) into the same queue
schema; ``watcher.db``, ``scenes.jsonl``, the chip archives and the queue
cross both ways (a replacement watcher of the other package refuses a
scene the first recorded, each package lists the other's manifest).
Last, the watcher-fed fleet path on the CPU: a scene landed on a
``FileSource`` archive becomes a ``detect`` bootstrap and a ``stream``
job, a port worker drains them under the object tier, and the alerts,
checkpoints and rows equal a serial ``stream`` leg's.
"""

import json
import os

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from firebird_tpu import cli as jcli
from firebird_tpu.config import Config as JConfig
from firebird_tpu.fleet.queue import FleetQueue as JQueue
from firebird_tpu.ingest import sources as jsources
from firebird_tpu.streamops import statestore as jss
from firebird_tpu.streamops import watcher as jwatcher
from firebird_tpu_torch import __main__ as tmain
from firebird_tpu_torch import grid
from firebird_tpu_torch.config import Config
from firebird_tpu_torch.fleet.queue import FleetQueue
from firebird_tpu_torch.ingest import sources as tsources
from firebird_tpu_torch.streamops import statestore as tss
from firebird_tpu_torch.streamops import watcher as twatcher
from firebird_tpu_torch.utils import dates as dt
from firebird_tpu_torch.utils.fn import take

TILE_XY = (100.0, 200.0)
PKGS = {"port": (Config, FleetQueue, tss, twatcher, tsources),
        "jax": (JConfig, JQueue, jss, jwatcher, jsources)}
CROSS = [("port", "jax"), ("jax", "port")]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mk_arrays(P=5, B=7, K=8, seed=0):
    from test_torch_statestore import _mk_arrays as mk

    return mk(P=P, B=B, K=K, seed=seed)


class ManifestSource:
    """A scripted acquisition manifest (the list_acquisitions seam)."""

    def __init__(self):
        self.scenes = []

    def land(self, scene_id, published, date, bbox=None):
        self.scenes.append({"scene_id": scene_id, "published": published,
                            "date": date, "bbox": bbox})

    def list_acquisitions(self, since=0.0):
        return [s for s in self.scenes if s["published"] > since]


class Rig:
    """One package's watcher over a sqlite home: the config, a scripted
    manifest, the fleet queue, the checkpoint store and the watcher."""

    def __init__(self, pkg, root, src=None, **kw):
        conf, queue, ss, wt, _ = PKGS[pkg]
        os.makedirs(root, exist_ok=True)
        self.pkg = pkg
        self.cfg = conf(store_backend="sqlite",
                        store_path=os.path.join(root, "s.db"),
                        stream_dir=os.path.join(root, "state"),
                        source_backend="synthetic")
        self.src = src or ManifestSource()
        self.queue = queue(os.path.join(root, "fleet.db"))
        self.store = ss.TileStateStore(self.cfg.stream_dir)
        self.w = wt.AcquisitionWatcher(
            self.cfg, *TILE_XY, number=2, source=self.src, queue=self.queue,
            statestore=self.store,
            acquired_start=kw.get("acquired_start", "1995-01-01"))

    def jobs(self) -> list:
        """Every job as (type, payload less the trace id, deps, state,
        attempts), with the trace id's scene part kept."""
        out, i = [], 1
        while (j := self.queue.job(i)) is not None:
            p = dict(j["payload"])
            trace = p.pop("trace")
            scene, _, suffix = trace.rpartition("/")
            assert scene == f"scene/{p['scene_id']}" and suffix
            out.append((j["job_type"], p, j["depends_on"], j["state"],
                        j["attempts"]))
            i += 1
        return out

    def close(self):
        self.w.close()
        self.store.close()
        self.queue.close()


@pytest.fixture()
def rigs(tmp_path):
    """The port's rig and JAX's, each in its own home, on one scripted
    manifest."""
    src = ManifestSource()
    r = {pkg: Rig(pkg, str(tmp_path / pkg), src) for pkg in PKGS}
    yield src, r
    for rig in r.values():
        rig.close()


def _same_jobs(r):
    port, jax = r["port"].jobs(), r["jax"].jobs()
    assert port == jax
    return port


# ---------------------------------------------------------------------------
# The watcher (tests/test_streamops.py's cases, on both packages)
# ---------------------------------------------------------------------------

def test_constants_and_schema_equal_jax(tmp_path):
    assert twatcher.WATCH_SCHEMA == jwatcher.WATCH_SCHEMA
    assert twatcher.LOOKBACK_SEC == jwatcher.LOOKBACK_SEC
    assert tsources.FileSource.SCENES_FILE == jsources.FileSource.SCENES_FILE
    import sqlite3

    schemas = {}
    for pkg, (_, _, _, wt, _) in PKGS.items():
        path = str(tmp_path / f"{pkg}.db")
        wt.SceneCursor(path).close()
        con = sqlite3.connect(path)
        schemas[pkg] = (sorted(con.execute(
            "SELECT name, sql FROM sqlite_master").fetchall()),
            con.execute("SELECT key, value FROM meta ORDER BY key"
                        ).fetchall())
        con.close()
    assert schemas["port"] == schemas["jax"]


def test_watch_db_path_as_jax(tmp_path):
    for kw in (dict(store_path=str(tmp_path / "s.db")),
               dict(store_path=str(tmp_path / "s.db"),
                    watch_db=str(tmp_path / "w.db"))):
        assert twatcher.watch_db_path(Config(**kw)) \
            == jwatcher.watch_db_path(JConfig(**kw))
    for mod, conf in ((twatcher, Config), (jwatcher, JConfig)):
        with pytest.raises(ValueError, match="FIREBIRD_WATCH_DB"):
            mod.watch_db_path(conf(store_backend="memory"))


def test_watcher_bootstraps_then_streams(rigs):
    src, r = rigs
    src.land("LC08_A", 1000.0, "1999-06-01")
    s = {pkg: rig.w.poll_once() for pkg, rig in r.items()}
    assert s["port"] == s["jax"]
    assert s["port"]["scenes_new"] == 1 and s["port"]["scenes_enqueued"] == 1
    # no checkpoints yet: per chip one bootstrap detect + one stream
    # dep'd behind it via the queue's cross-stage machinery
    assert s["port"]["jobs"] == 4
    jobs = _same_jobs(r)
    w, queue = r["port"].w, r["port"].queue
    detect = queue.open_jobs("detect")
    stream = queue.open_jobs("stream")
    assert set(detect) == set(stream) == set(w.cids)
    for cid in w.cids:
        job = queue.job(stream[cid])
        assert job["depends_on"] == [detect[cid]]
        assert job["payload"]["published"] == 1000.0
        # half-open acquired: the scene's own date is INSIDE the range
        assert job["payload"]["acquired"] == "1995-01-01/1999-06-02"
        assert job["payload"]["cids"] == [[cid[0], cid[1]]]
        assert queue.job(detect[cid])["payload"]["bootstrap"] is True
    assert [j[0] for j in jobs] == ["detect", "stream"] * 2
    # a stream job is not claimable until its bootstrap acks — for
    # either package's claimer on the port's queue
    lease = JQueue(queue.path).claim("w0")
    assert lease.job_type == "detect"
    assert w.tallies == r["jax"].w.tallies


@pytest.mark.parametrize("first, second", CROSS)
def test_watcher_scene_dedup_is_durable(tmp_path, first, second):
    """A replacement watcher of the other package, on the first one's
    ``watcher.db`` and queue, refuses the recorded scene."""
    rig = Rig(first, str(tmp_path / "home"))
    try:
        rig.src.land("LC08_A", 1000.0, "1999-06-01")
        rig.w.poll_once()
        before = rig.queue.counts()
        # the same manifest re-listed (lookback window) enqueues nothing
        assert rig.w.poll_once()["scenes_new"] == 0
        assert rig.queue.counts() == before
        conf, queue, ss, wt, _ = PKGS[second]
        q2 = queue(rig.queue.path)
        st2 = ss.TileStateStore(rig.cfg.stream_dir)
        cfg2 = conf(store_backend="sqlite", store_path=rig.cfg.store_path,
                    stream_dir=rig.cfg.stream_dir)
        w2 = wt.AcquisitionWatcher(
            cfg2, *TILE_XY, number=2, source=rig.src, queue=q2,
            statestore=st2, cursor=wt.SceneCursor(wt.watch_db_path(cfg2)))
        try:
            assert w2.poll_once()["scenes_new"] == 0
            assert q2.counts() == before
            assert w2.cursor.status()["scenes"] == 1
        finally:
            w2.cursor.close()
            st2.close()
            q2.close()
        assert rig.w.cursor.cursor() == 1000.0
    finally:
        rig.close()


@pytest.mark.parametrize("saver", ["port", "jax"])
def test_watcher_checkpointed_chip_streams_directly(rigs, saver):
    """Checkpoints either package saved: no bootstrap, one open stream
    job a chip, and the open jobs absorb the next scene."""
    src, r = rigs
    for rig in r.values():
        st = PKGS[saver][2].TileStateStore(rig.cfg.stream_dir)
        for cid in rig.w.cids:
            st.save_arrays(cid, _mk_arrays())
        st.close()
    src.land("LC08_B", 2000.0, "1999-07-03")
    for rig in r.values():
        s = rig.w.poll_once()
        assert s["jobs"] == 2                  # stream only, no bootstrap
        assert not rig.queue.open_jobs("detect")
    src.land("LC08_C", 3000.0, "1999-07-19")
    for rig in r.values():
        s2 = rig.w.poll_once()
        assert s2["scenes_new"] == 1 and s2["jobs"] == 0
        assert rig.w.cursor.cursor() == 3000.0
    _same_jobs(r)


def test_watcher_bbox_maps_to_chips(rigs):
    src, r = rigs
    for rig in r.values():
        for cid in rig.w.cids:
            rig.store.save_arrays(cid, _mk_arrays())
    cx, cy = r["port"].w.cids[1]
    src.land("LC08_D", 4000.0, "1999-08-04",
             bbox=[cx + 100, cy - 2900, cx + 200, cy - 100])
    for rig in r.values():
        rig.w.poll_once()
        assert set(rig.queue.open_jobs("stream")) == {(cx, cy)}
    for bbox in ([cx - 10, cy - 10, cx, cy], [cx + 3000, cy, cx + 9000, cy + 10],
                 [cx - 3000, cy - 3000, cx + 10, cy + 10], None):
        assert r["port"].w._affected_chips({"bbox": bbox}) \
            == r["jax"].w._affected_chips({"bbox": bbox})
    _same_jobs(r)


def test_watcher_lookback_boundary_not_skipped(rigs):
    """A scene published exactly AT the cursor is re-listed by the
    LOOKBACK overlap and kept exactly-once by the durable dedup."""
    src, r = rigs
    for rig in r.values():
        for cid in rig.w.cids:
            rig.store.save_arrays(cid, _mk_arrays())
    src.land("LC08_T1", 5000.0, "1999-09-01")
    for rig in r.values():
        rig.w.poll_once()
    src.land("LC08_T2", 5000.0, "1999-09-01")
    for rig in r.values():
        assert 5000.0 - twatcher.LOOKBACK_SEC < rig.w.cursor.cursor()
        assert rig.w.poll_once()["scenes_new"] == 1
    _same_jobs(r)


def test_watcher_revives_dead_bootstrap(rigs):
    """A bootstrap that dead-letters must not strand its chip: the next
    scene's poll requeues it with a fresh budget and the chain drains."""
    src, r = rigs
    src.land("LC08_A", 1000.0, "1999-06-01")
    for rig in r.values():
        cfg, w, queue, store = rig.cfg, rig.w, rig.queue, rig.store
        w.poll_once()
        detect = queue.open_jobs("detect")
        for _ in range(cfg.fleet_max_attempts * len(w.cids)):
            lease = queue.claim("w0")
            assert lease.job_type == "detect"
            queue.fail(lease, RuntimeError("source outage"))
        assert queue.counts()["dead"] == len(w.cids)
        assert queue.claim("w0") is None     # stream jobs blocked, wedged
    src.land("LC08_B", 2000.0, "1999-06-17")
    for rig in r.values():
        rig.w.poll_once()
        assert rig.queue.counts()["dead"] == 0
    port = r["port"].jobs()
    jax = r["jax"].jobs()
    # the same jobs, states and revived budgets (attempt counts reset)
    assert [(t, p, d, s) for t, p, d, s, _ in port] \
        == [(t, p, d, s) for t, p, d, s, _ in jax]
    queue, store = r["port"].queue, r["port"].store
    lease = queue.claim("w0")
    assert lease is not None and lease.job_type == "detect"
    store.save_arrays((lease.payload["cx"], lease.payload["cy"]),
                      _mk_arrays())
    queue.ack(lease)
    nxt = {queue.claim("w0").job_type, queue.claim("w0").job_type}
    assert "stream" in nxt


def test_coverage_sweep_re_enqueues_a_lagging_chip(rigs):
    """A chip whose checkpoint horizon lags the newest scene covering it
    (its open job absorbed the scene) is re-enqueued by the sweep once
    the open job is done, in both packages alike."""
    src, r = rigs
    for rig in r.values():
        for cid in rig.w.cids:
            rig.store.save_arrays(cid, _mk_arrays())   # horizon 456
    src.land("LC08_A", 1000.0, "1999-06-01")
    for rig in r.values():
        rig.w.poll_once()
        for _ in rig.w.cids:                           # the jobs "run"
            rig.queue.ack(rig.queue.claim("w0"))
        s = rig.w.poll_once()
        assert s["jobs"] == 2 and rig.w.tallies["jobs_sweep"] == 2
        # memoized: the same target is not swept again by this watcher
        for _ in rig.w.cids:
            rig.queue.ack(rig.queue.claim("w0"))
        assert rig.w.poll_once()["jobs"] == 0
    jobs = _same_jobs(r)
    assert sum(1 for j in jobs if j[1].get("sweep")) == 2


def test_watcher_status_as_jax(rigs):
    src, r = rigs
    src.land("LC08_A", 1000.0, "1999-06-01")
    st = {}
    for pkg, rig in r.items():
        rig.w.poll_once()
        st[pkg] = rig.w.status()
        st[pkg]["cursor"].pop("path")
        st[pkg]["cursor"]["last_scene"].pop("enqueued_at")
    assert st["port"] == st["jax"]
    assert st["port"]["queue"]["stream"]["pending"] == 2


def test_watcher_requires_manifest_source(tmp_path):
    class NoManifest:
        pass

    for conf, queue, _, wt, _ in PKGS.values():
        cfg = conf(store_backend="sqlite",
                   store_path=str(tmp_path / "s.db"),
                   stream_dir=str(tmp_path / "state"))
        q = queue(str(tmp_path / "fleet.db"))
        try:
            with pytest.raises(ValueError, match="list_acquisitions"):
                wt.AcquisitionWatcher(cfg, *TILE_XY, number=1,
                                      source=NoManifest(), queue=q)
        finally:
            q.close()


def test_watch_fault_scope_aborts_the_poll(tmp_path):
    """FIREBIRD_FAULTS' ``watch`` scope now wraps the port's poll: an
    injected failure aborts it before any scene is mapped, and ``run``
    logs and goes on, as JAX's does."""
    from firebird_tpu_torch import faults as tfaults

    rig = Rig("port", str(tmp_path))
    try:
        rig.src.land("LC08_A", 1000.0, "1999-06-01")
        rig.w.fault_injector = tfaults.FaultPlan.parse(
            "watch:after=0").injector("watch")
        with pytest.raises(tfaults.InjectedFault):
            rig.w.poll_once()
        assert rig.queue.counts()["pending"] == 0
        status = rig.w.run(once=True)        # the second poll is clean
        assert status["tallies"]["polls"] == 2
        assert rig.queue.counts()["pending"] == 4
    finally:
        rig.close()


# ---------------------------------------------------------------------------
# Manifest sources, fetch, the queue's deps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer, reader", CROSS)
def test_filesource_manifest_roundtrip(tmp_path, writer, reader):
    fs = PKGS[writer][4].FileSource(str(tmp_path))
    rd = PKGS[reader][4].FileSource(str(tmp_path))
    assert rd.list_acquisitions() == []
    a = fs.append_scene("S1", date="1999-06-01", published=10.0,
                        bbox=[0, 0, 3000, 3000])
    fs.append_scene("S2", date="1999-06-17", published=20.0)
    assert rd.list_acquisitions() == fs.list_acquisitions()
    assert rd.list_acquisitions()[0] == a
    assert [s["scene_id"] for s in rd.list_acquisitions()] == ["S1", "S2"]
    assert [s["scene_id"] for s in rd.list_acquisitions(since=10.0)] \
        == ["S2"]
    # a torn trailing append is skipped, not fatal
    with open(os.path.join(str(tmp_path), rd.SCENES_FILE), "a") as f:
        f.write('{"scene_id": "S3", "pub')
    assert len(rd.list_acquisitions()) == len(fs.list_acquisitions()) == 2


def test_filesource_manifest_lines_equal_jax(tmp_path):
    for pkg in PKGS:
        (tmp_path / pkg).mkdir()
        PKGS[pkg][4].FileSource(str(tmp_path / pkg)).append_scene(
            "S1", date="1999-06-01", published=10.0, bbox=[0, 0, 1, 2])
    assert (tmp_path / "port" / "scenes.jsonl").read_bytes() \
        == (tmp_path / "jax" / "scenes.jsonl").read_bytes()


@pytest.mark.parametrize("kw", [
    dict(seed=3, start="1999-01-01", end="1999-03-01", cadence_days=16),
    dict(seed=0, start="1985-01-01", end="1986-01-01")])
def test_synthetic_manifest_equals_jax(kw):
    src = tsources.SyntheticSource(**kw)
    a = src.list_acquisitions()
    assert a == jsources.SyntheticSource(**kw).list_acquisitions()
    assert a == src.list_acquisitions()
    assert all(s["published"] > 0 for s in a)
    assert src.list_acquisitions(since=a[0]["published"])[0]["scene_id"] \
        == a[1]["scene_id"]
    if kw["seed"] == 3:
        assert [s["date"] for s in a][:2] == ["1999-01-01", "1999-01-17"]


@pytest.mark.parametrize("writer, reader", CROSS)
def test_file_source_roundtrip(tmp_path, writer, reader):
    """A chip and its AUX layers one package's FileSource saves, the
    other's loads, array for array (tests/test_ingest.py's round trip)."""
    src = tsources.SyntheticSource(seed=2, start="1995-01-01",
                                   end="1996-06-01")
    c = src.chip(542000, 1650000)
    data = (tsources if writer == "port" else jsources)
    from firebird_tpu.ingest.packer import ChipData as JChipData
    from firebird_tpu_torch.ingest.packer import ChipData

    chip = (ChipData if writer == "port" else JChipData)(
        cx=c.cx, cy=c.cy, dates=c.dates, spectra=c.spectra, qas=c.qas)
    fs = data.FileSource(str(tmp_path))
    fs.save_chip(chip)
    fs.save_aux(c.cx, c.cy, src.aux(c.cx, c.cy))
    rd = PKGS[reader][4].FileSource(str(tmp_path))
    c2 = rd.chip(c.cx, c.cy)
    for k in ("dates", "spectra", "qas"):
        got, want = getattr(c2, k), getattr(c, k)
        assert got.dtype == want.dtype and np.array_equal(got, want), k
    aux = rd.aux(c.cx, c.cy)
    assert aux["dem"].shape == (100, 100)
    assert set(np.unique(aux["trends"])) <= set(range(1, 9))
    cut = rd.chip(c.cx, c.cy, "1995-06-01/1995-12-31")
    assert cut.dates.min() >= dt.to_ordinal("1995-06-01")


def test_fetch_mirrors_tile_to_file_source_as_jax(tmp_path):
    """The port's fetch writes the archive JAX's fetch writes from the
    same source: the same files, the same arrays, readable by either
    package's FileSource (tests/test_driver.py's fetch)."""
    from firebird_tpu.driver import core as jcore
    from firebird_tpu_torch.driver import core as tcore

    kw = dict(x=542000, y=1650000, number=3, aux=True,
              acquired="1995-01-01/1996-06-01")
    tsrc = tsources.SyntheticSource(seed=2, start="1995-01-01",
                                    end="1996-06-01")
    jsrc = jsources.SyntheticSource(seed=2, start="1995-01-01",
                                    end="1996-06-01")
    got = tcore.fetch(outdir=str(tmp_path / "port"),
                      cfg=Config(source_backend="synthetic",
                                 store_backend="memory"),
                      source=tsrc, aux_source=tsrc, **kw)
    want = jcore.fetch(outdir=str(tmp_path / "jax"),
                       cfg=JConfig(source_backend="synthetic",
                                   store_backend="memory"),
                       source=jsrc, aux_source=jsrc, **kw)
    assert got == want == (3, 3)
    files = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert len([f for f in files if f.startswith("chip_")]) == 3
    assert len([f for f in files if f.startswith("aux_")]) == 3
    cx, cy = (int(v) for v in grid.tile(542000, 1650000)["chips"][0])
    live = tsrc.chip(cx, cy, kw["acquired"])
    for rd in (jsources.FileSource(str(tmp_path / "port")),
               tsources.FileSource(str(tmp_path / "jax"))):
        mirrored = rd.chip(cx, cy, kw["acquired"])
        np.testing.assert_array_equal(live.spectra, mirrored.spectra)
        np.testing.assert_array_equal(live.qas, mirrored.qas)
        np.testing.assert_array_equal(live.dates, mirrored.dates)
        assert set(rd.aux(cx, cy)) == {"dem", "trends", "aspect", "posidex",
                                       "slope", "mpw"}


def test_fetch_quarantines_and_resumes(tmp_path):
    """A chip whose fetch keeps failing is dead-lettered to
    ``<outdir>/quarantine.json`` (JAX's format) and the fetch reports it;
    a rerun that can fetch it redeems the dead letter."""
    from firebird_tpu.driver.quarantine import Quarantine as JQuarantine
    from firebird_tpu_torch.driver import fetch as tfetch

    cids = [tuple(int(v) for v in c) for c in take(
        2, grid.chips(grid.tile(542000, 1650000)))]
    src = tsources.SyntheticSource(seed=2, start="1995-01-01",
                                   end="1995-06-01")
    cfg = Config(source_backend="synthetic", store_backend="memory",
                 fetch_retries=1, faults=f"ingest:chip={cids[1][0]}:"
                                         f"{cids[1][1]}")
    out = str(tmp_path / "a")
    assert tfetch.fetch(542000, 1650000, out, "1995-01-01/1995-06-01",
                        number=2, cfg=cfg, source=src) == (1, 2)
    q = JQuarantine.load(os.path.join(out, "quarantine.json"))
    assert len(q) == 1
    entry = next(iter(q.snapshot()["chips"].values()))
    assert (entry["cx"], entry["cy"]) == cids[1]
    assert entry["stage"] == "fetch" and entry["error"] == "InjectedFault"
    assert entry["history"][-1]["attempts"] == 2
    ok = Config(source_backend="synthetic", store_backend="memory")
    assert tfetch.fetch(542000, 1650000, out, "1995-01-01/1995-06-01",
                        number=2, cfg=ok, source=src) == (2, 2)
    assert len(JQuarantine.load(os.path.join(out, "quarantine.json"))) == 0


def test_fetch_cli_as_jax(tmp_path, monkeypatch, capsys):
    """``fetch`` prints what JAX's prints, exits as it does, and writes
    the files it writes."""
    for k, v in (("FIREBIRD_SOURCE", "synthetic"),
                 ("FIREBIRD_SYNTH_SENSOR", "landsat-ard-tiny"),
                 ("FIREBIRD_STORE_BACKEND", "memory")):
        monkeypatch.setenv(k, v)
    argv = ["fetch", "-x", "542000", "-y", "1650000", "-n", "2", "-a",
            "1995-01-01/1995-06-01", "--aux", "-o"]
    mine, theirs = str(tmp_path / "a"), str(tmp_path / "b")
    tmain.main(argv + [mine])
    out = capsys.readouterr().out
    res = CliRunner().invoke(jcli.entrypoint, argv + [theirs],
                             catch_exceptions=False)
    assert res.exit_code == 0
    assert out == f"2 chips written to {mine}\n"
    assert res.output == f"2 chips written to {theirs}\n"
    assert sorted(os.listdir(mine)) == sorted(os.listdir(theirs))


def test_watch_cli_once_as_jax(tmp_path, monkeypatch, capsys):
    """``watch --once`` over the synthetic manifest: the same summary as
    JAX's command and the same jobs in each home's queue."""
    homes = {}
    for pkg in PKGS:
        home = tmp_path / pkg
        home.mkdir()
        homes[pkg] = {"FIREBIRD_SOURCE": "synthetic",
                      "FIREBIRD_STORE_BACKEND": "sqlite",
                      "FIREBIRD_STORE_PATH": str(home / "fb.db"),
                      "FIREBIRD_TELEMETRY": "0"}
    argv = ["watch", "-x", "100", "-y", "200", "-n", "1", "--once",
            "--acquired-start", "1995-01-01"]
    for k, v in homes["port"].items():
        monkeypatch.setenv(k, v)
    tmain.main(argv)
    mine = json.loads(capsys.readouterr().out)
    res = CliRunner().invoke(jcli.entrypoint, argv, env=homes["jax"],
                             catch_exceptions=False)
    assert res.exit_code == 0, res.output
    theirs = json.loads(res.output)
    assert mine == theirs
    assert mine["scenes_new"] > 100 and mine["jobs"] == 2
    jobs = {}
    for pkg in PKGS:
        q = JQueue(str(tmp_path / pkg / "fleet.db"))
        jobs[pkg] = [(j["job_type"], {k: v for k, v in j["payload"].items()
                                      if k != "trace"}, j["depends_on"])
                     for j in (q.job(i) for i in (1, 2))]
        q.close()
    assert jobs["port"] == jobs["jax"]
    assert [t for t, _, _ in jobs["port"]] == ["detect", "stream"]


@pytest.mark.parametrize("enqueuer, claimer", CROSS)
def test_enqueue_unique_chip_depends_on(tmp_path, enqueuer, claimer):
    q = PKGS[enqueuer][1](str(tmp_path / "fleet.db"))
    c = PKGS[claimer][1](str(tmp_path / "fleet.db"))
    try:
        boot = q.enqueue_unique_chip("detect", {"cx": 1, "cy": 2,
                                                "bootstrap": True})
        sj = q.enqueue_unique_chip("stream", {"cx": 1, "cy": 2},
                                   depends_on=[boot])
        assert c.job(sj)["depends_on"] == [boot]
        lease = c.claim("w")
        assert lease.job_id == boot
        assert c.claim("w") is None
        c.ack(lease)
        lease2 = c.claim("w")
        assert lease2 is not None and lease2.job_id == sj
        with pytest.raises(ValueError, match="unknown job ids"):
            q.enqueue_unique_chip("stream", {"cx": 9, "cy": 9},
                                  depends_on=[999])
    finally:
        q.close()
        c.close()


def test_alert_freshness_slo_prefers_end_to_end():
    from firebird_tpu.obs import slo as jslo
    from firebird_tpu_torch.obs import slo

    h = lambda p95: {"count": 4, "p95": p95}                  # noqa: E731
    snaps = [{"histograms": {"acquisition_to_alert_seconds": h(12.0),
                             "alert_visible_seconds": h(1.0)}},
             {"histograms": {"alert_visible_seconds": h(1.0)}},
             {"histograms": {}}]
    for snap in snaps:
        mine = slo.evaluate_snapshot(snap, spec="alert_freshness=60")
        assert mine == jslo.evaluate_snapshot(snap, spec="alert_freshness=60")
    (obj,) = slo.evaluate_snapshot(snaps[0],
                                   spec="alert_freshness=60")["objectives"]
    assert obj["metric"] == "acquisition_to_alert_seconds"
    assert obj["value_sec"] == 12.0 and obj["ok"] is True


def test_default_acquired_covers_today():
    """Half-open windows: the default range ends tomorrow, so an
    observation acquired today is inside it — in both packages."""
    import datetime

    from firebird_tpu.utils import dates as jdt

    assert dt.default_acquired() == jdt.default_acquired()
    lo, hi = dt.acquired_range(dt.default_acquired())
    assert hi == datetime.date.today().toordinal() + 1


# ---------------------------------------------------------------------------
# The watcher-fed fleet stream path on the CPU, under the object tier
# ---------------------------------------------------------------------------

def _alerts(path):
    import sqlite3

    con = sqlite3.connect(path)
    try:
        rows = con.execute("SELECT px, py, break_day FROM alerts").fetchall()
    finally:
        con.close()
    return sorted(rows)


def _payload(state_dir, cid):
    st = tss.TileStateStore(state_dir)
    try:
        a = st.peek_arrays(cid)
    finally:
        st.close()
    P, B, K = a["coefs"].shape
    return b"".join(tss._canonical(n, a[n], d, s).tobytes()
                    for n, d, s in tss._layout(P, B, K))


def test_watcher_fed_fleet_stream_equals_the_serial_leg(tmp_path,
                                                        monkeypatch):
    """A chip fetched into a FileSource archive to 1998, a scene for its
    newest acquisition, then the 1999 acquisitions landed and a second
    scene: the watcher enqueues a bootstrap and a stream job, then a
    stream job; a port worker on the CPU drains them under the object
    tier.  The alerts (every pixel steps in 1999), the checkpoint's bytes
    and the chip, pixel and segment rows equal a serial ``stream`` leg
    with no watcher, fleet or object tier; the object tier holds the
    checkpoint and the rows.  Both legs leave the repair roll-up off (a
    repair job would reseed the checkpoint the comparison reads)."""
    from firebird_tpu_torch.alerts import alert_db_path
    from firebird_tpu_torch.driver import fetch as tfetch
    from firebird_tpu_torch.driver import stream as tstream
    from firebird_tpu_torch.fleet import FleetWorker, make_queue
    from firebird_tpu_torch.obs import metrics as obs_metrics
    from firebird_tpu_torch.store import SqliteStore
    from firebird_tpu_torch.store import objectstore as tobj
    from test_torch_driver import _table
    from test_torch_stream import BOOT, CID, FULL, StepSource

    step = StepSource()
    start = BOOT.split("/")[0]
    boot_last = dt.to_iso(int(step.t[step.t <= dt.to_ordinal(
        BOOT.split("/")[1])][-1]))
    full_last = dt.to_iso(int(step.t[-1]))
    archive = str(tmp_path / "archive")
    assert tfetch.fetch(*TILE_XY, archive, BOOT, number=1, cfg=Config(
        store_backend="memory"), source=step) == (1, 1)
    fs = tsources.FileSource(archive)
    fs.append_scene("S_BOOT", date=boot_last)

    root = str(tmp_path / "objects")
    monkeypatch.setenv("FIREBIRD_OBJECT_ROOT", root)
    home = tmp_path / "fleet"
    cfg = Config(store_backend="sqlite", store_path=str(home / "fb.db"),
                 source_backend="file", source_path=archive,
                 object_root=root, fleet_lease_sec=60, alert_repair=False)
    queue = make_queue(cfg)
    obs_metrics.reset_registry()
    w = twatcher.AcquisitionWatcher(cfg, *TILE_XY, number=1,
                                    acquired_start=start, queue=queue)
    assert w.poll_once()["jobs"] == 2
    worker = FleetWorker(cfg, queue, poll_sec=0.05, device="cpu")
    assert worker.run(until_drained=True)["acked"] == 2
    fs.save_chip(step.chip(*CID, FULL))
    fs.append_scene("S_FULL", date=full_last)
    assert w.poll_once()["jobs"] == 1
    summary = worker.run(until_drained=True)
    assert summary["acked"] == 3 and queue.counts() == {
        "pending": 0, "leased": 0, "done": 3, "dead": 0}
    w.close()
    queue.close()
    hist = obs_metrics.histogram("acquisition_to_alert_seconds")
    assert hist.snapshot()["count"] >= 1

    monkeypatch.delenv("FIREBIRD_OBJECT_ROOT")
    serial = tmp_path / "serial"
    scfg = Config(store_backend="sqlite", store_path=str(serial / "fb.db"),
                  source_backend="synthetic", alert_repair=False)
    for end in (boot_last, full_last):
        tstream.stream(*TILE_XY, acquired=f"{start}/"
                       f"{dt.to_iso(dt.to_ordinal(end) + 1)}", number=1,
                       cfg=scfg, source=step, device="cpu")

    fleet_alerts = _alerts(alert_db_path(cfg))
    assert fleet_alerts == _alerts(alert_db_path(scfg))
    assert len(fleet_alerts) == len(set(fleet_alerts)) > 0
    state = _payload(str(home / "fb.db.stream"), CID)
    assert state == _payload(str(serial / "fb.db.stream"), CID)
    fleet_rows = SqliteStore(cfg.store_path, cfg.keyspace())
    serial_rows = SqliteStore(scfg.store_path, scfg.keyspace())
    objects = tobj.open_object_root(root=root)
    mirror = tobj.ObjectBackedStore(
        objects, tobj.scope_for_path(cfg.store_path), cfg.keyspace())
    for table in ("chip", "pixel", "segment"):
        want = _table(serial_rows, table)
        assert _table(fleet_rows, table) == want, table
        assert _table(mirror, table) == want, table
    scope = tobj.scope_for_path(str(home / "fb.db.stream"))
    got, _ = objects.get(f"{scope}/state/chip_{CID[0]}_{CID[1]}")
    assert got == state
