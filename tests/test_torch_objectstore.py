"""The port's object tier against the JAX package's, on the CPU.

The port keeps its own copy of ``store/objectstore.py`` with the same
on-disk layout (chunks by sha256, manifests by generation, quoted keys),
so an object either package writes reads in the other.  Here, the
non-serving cases of tests/test_objectstore.py, each run on the port and
held to the JAX package on the same inputs, with objects crossing both
ways: the chunked conditional-put protocol, torn-upload generation
fallback, the orphan scrubber and census, ``cas_update``, the fault and
retry layering, a SIGKILL between the chunk uploads and the manifest
commit, the zombie's stale object fence, the object store backend and the
env-driven write-through mirror, and the object statestores (payloads
equal byte for byte).
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from firebird_tpu import faults as jfaults
from firebird_tpu.config import Config as JConfig
from firebird_tpu.obs import metrics as jmetrics
from firebird_tpu.store import objectstore as jobj
from firebird_tpu.streamops import statestore as jss
from firebird_tpu_torch import faults as tfaults
from firebird_tpu_torch import grid
from firebird_tpu_torch.config import Config
from firebird_tpu_torch.obs import metrics as obs_metrics
from firebird_tpu_torch.store import objectstore as tobj
from firebird_tpu_torch.store import open_store
from firebird_tpu_torch.streamops import statestore as tss

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"port": tobj, "jax": jobj}
CROSS = [("port", "jax"), ("jax", "port")]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_metrics():
    obs_metrics.reset_registry()
    jmetrics.reset_registry()
    yield


def seg_frame(cx=1, cy=2, px=3, py=4, sday="1999-01-01", chprob=1.0):
    f = {"cx": [cx], "cy": [cy], "px": [px], "py": [py],
         "sday": [sday], "eday": ["2000-01-01"], "bday": [sday],
         "chprob": [chprob], "curqa": [8], "rfrawp": [None]}
    for p in ("bl", "gr", "re", "ni", "s1", "s2", "th"):
        f[f"{p}mag"] = [1.5]
        f[f"{p}rmse"] = [0.5]
        f[f"{p}coef"] = [[0.1, 0.2, 0.3]]
        f[f"{p}int"] = [7.0]
    return f


def _tree(root) -> dict:
    """Every file under an object root (but the lock files), by relative
    path: the layout both packages must write alike."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            if n == ".lock":
                continue
            p = os.path.join(d, n)
            out[os.path.relpath(p, root)] = p
    return out


def _manifests(root) -> dict:
    """{relative path: manifest with its clock dropped}."""
    out = {}
    for rel, p in _tree(root).items():
        if rel.startswith("keys") and rel.endswith(".json"):
            m = json.load(open(p))
            m.pop("updated")
            out[rel] = m
    return out


# ---------------------------------------------------------------------------
# Protocol
# ---------------------------------------------------------------------------

def test_module_constants_equal_jax():
    assert tobj.KEEP_GENERATIONS == jobj.KEEP_GENERATIONS == 2
    assert tobj.DEFAULT_CHUNK_SIZE == jobj.DEFAULT_CHUNK_SIZE
    assert tobj._PART == jobj._PART
    assert tobj.scope_for_path("/a/b.db") == jobj.scope_for_path("/a/b.db")
    assert tobj.ObjectBackedStore.FENCE_REJECTS_KEY \
        == jobj.ObjectBackedStore.FENCE_REJECTS_KEY


@pytest.mark.parametrize("writer, reader", CROSS)
def test_chunked_roundtrip_and_meta(tmp_path, writer, reader):
    s = PKGS[writer].LocalObjectStore(str(tmp_path), chunk_size=64)
    body = bytes(range(256))                     # 4 distinct chunks
    m = s.put("a/b", body, meta={"rows": 3})
    assert m.generation == 1 and len(m.chunks) == 4 and m.size == 256
    r = PKGS[reader].LocalObjectStore(str(tmp_path), chunk_size=64)
    got, meta = r.get("a/b")
    assert got == body and meta.meta == {"rows": 3}
    h = r.head("a/b")
    assert h is not None and h.generation == 1 and h.meta == {"rows": 3}
    assert h.chunks == m.chunks and h.size == m.size


def test_layout_equals_jax_file_for_file(tmp_path):
    """The same puts give the same files: chunk names and bytes,
    manifest names and bodies (less the clock)."""
    roots = {}
    for name, mod in PKGS.items():
        root = str(tmp_path / name)
        s = mod.LocalObjectStore(root, chunk_size=48)
        s.put("a/b c", bytes(range(200)), meta={"rows": 2})
        s.put("a/b c", bytes(range(100)), if_generation=1)
        s.put("z/%2F", b"x")
        roots[name] = root
    tp, tj = _tree(roots["port"]), _tree(roots["jax"])
    assert sorted(tp) == sorted(tj)
    for rel in tp:
        if rel.startswith("chunks"):
            assert open(tp[rel], "rb").read() == open(tj[rel], "rb").read()
    assert _manifests(roots["port"]) == _manifests(roots["jax"])


def test_conditional_put_and_generation_pruning(tmp_path):
    s = tobj.LocalObjectStore(str(tmp_path))
    s.put("k", b"one")
    s.put("k", b"two", if_generation=1)
    with pytest.raises(tobj.PreconditionFailed) as ei:
        s.put("k", b"late", if_generation=1)
    assert ei.value.current == 2
    assert s.get("k")[0] == b"two"
    with pytest.raises(tobj.PreconditionFailed):
        s.put("k", b"new", if_generation=0)
    s.put("fresh", b"x", if_generation=0)
    # JAX's store continues the generations the port wrote
    j = jobj.LocalObjectStore(str(tmp_path))
    with pytest.raises(jobj.PreconditionFailed) as ej:
        j.put("k", b"late", if_generation=1)
    assert ej.value.current == 2
    assert j.put("k", b"three", if_generation=2).generation == 3
    for i in range(5):
        s.put("k", f"v{i}".encode())
    manifests = [n for n in os.listdir(s._kdir("k")) if n.endswith(".json")]
    assert len(manifests) == tobj.KEEP_GENERATIONS
    assert j.get("k")[0] == b"v4" and j.head("k").generation == 8
    assert obs_metrics.counter("objectstore_conflicts").value == 2


@pytest.mark.parametrize("writer, reader", CROSS)
def test_list_delete_and_key_quoting(tmp_path, writer, reader):
    s = PKGS[writer].LocalObjectStore(str(tmp_path))
    r = PKGS[reader].LocalObjectStore(str(tmp_path))
    keys = ["a/b c", "a/d%2F", "z/1"]
    for k in keys:
        s.put(k, k.encode())
    assert r.list("a/") == s.list("a/") == sorted(keys[:2])
    assert r.list() == sorted(keys)
    for k in keys:                               # quoting round-trips
        assert r.get(k)[0] == k.encode()
    r.delete("a/b c")
    assert s.head("a/b c") is None
    assert s.list("a/") == ["a/d%2F"]
    s.delete("a/b c")                            # idempotent


@pytest.mark.parametrize("writer, reader", CROSS)
def test_torn_chunk_falls_back_one_generation(tmp_path, writer, reader):
    s = PKGS[writer].LocalObjectStore(str(tmp_path), chunk_size=32)
    good = bytes(range(100))
    s.put("k", good)
    s.put("k", bytes(reversed(range(100))), _torn="chunk")
    r = PKGS[reader].LocalObjectStore(str(tmp_path), chunk_size=32)
    got, meta = r.get("k")
    assert got == good and meta.generation == 1
    metrics = obs_metrics if reader == "port" else jmetrics
    assert metrics.counter("objectstore_torn_recoveries").value == 1
    # head reports the torn newest committed generation — the
    # conditional-put expectation readers must NOT take from get()
    assert r.head("k").generation == 2


def test_torn_manifest_is_invisible_and_scrubbed(tmp_path):
    reports = {}
    for name, mod in PKGS.items():
        s = mod.LocalObjectStore(str(tmp_path / name), chunk_size=32)
        s.put("k", b"\x01" * 100, _torn="manifest")
        assert s.head("k") is None and s.list() == []
        c = s.census()
        assert c["orphan_chunks"] >= 1 and c["keys"] == 0
        young = s.scrub(grace_sec=3600)
        assert young["removed"] == 0 and young["kept_young"] >= 1
        dry = s.scrub(grace_sec=0.0, dry_run=True)
        assert dry["removed"] >= 1 and s.census()["orphan_chunks"] >= 1
        wet = s.scrub(grace_sec=0.0)
        assert wet["removed"] >= 1 and s.census()["orphan_chunks"] == 0
        c.pop("root")
        reports[name] = (c, young, dry, wet)
    assert reports["port"] == reports["jax"]
    assert obs_metrics.counter("objectstore_scrubbed_chunks").value \
        == jmetrics.counter("objectstore_scrubbed_chunks").value >= 1


@pytest.mark.parametrize("writer, scrubber", CROSS)
def test_scrub_keeps_referenced_chunks(tmp_path, writer, scrubber):
    s = PKGS[writer].LocalObjectStore(str(tmp_path), chunk_size=32)
    body = bytes(range(100))
    s.put("live", body)
    s.put("gone", b"\x02" * 100, _torn="manifest")
    rep = PKGS[scrubber].LocalObjectStore(str(tmp_path)).scrub(grace_sec=0.0)
    assert rep["removed"] == 2 and rep["referenced"] == 4   # 3 x 32 B alike
    assert s.get("live")[0] == body


def test_census_tolerates_junk(tmp_path):
    out = {}
    for name, mod in PKGS.items():
        root = tmp_path / name
        s = mod.LocalObjectStore(str(root))
        s.put("k", b"x")
        with open(os.path.join(s._kdir("k"), "g2.json"), "w") as f:
            f.write("{not json")
        os.makedirs(os.path.join(str(root), "keys", "stray"),
                    exist_ok=True)
        c = s.census()
        assert c["keys"] == 1 and c["junk"] >= 1
        assert s.get("k")[0] == b"x"             # junk newest falls back
        c.pop("root")
        out[name] = c
    assert out["port"] == out["jax"]
    # the port's census of JAX's root counts what JAX's counts
    c = tobj.LocalObjectStore(str(tmp_path / "jax")).census()
    c.pop("root")
    assert c == out["jax"]


@pytest.mark.parametrize("writer, reader", CROSS)
def test_cas_update_contends_past_torn_newest(tmp_path, writer, reader):
    w, r = PKGS[writer], PKGS[reader]
    s = w.LocalObjectStore(str(tmp_path))
    w.cas_update(s, "ctr", lambda old: b"1" if old is None else
                 str(int(old) + 1).encode())
    r.cas_update(r.LocalObjectStore(str(tmp_path)), "ctr",
                 lambda old: str(int(old) + 1).encode())
    assert s.get("ctr")[0] == b"2"
    # a torn newest must not livelock the RMW loop: head says gen 3,
    # get falls back to gen 2 — the expectation must come from head
    s.put("ctr", b"9", _torn="chunk")
    r.cas_update(r.LocalObjectStore(str(tmp_path)), "ctr",
                 lambda old: str(int(old) + 1).encode())
    assert s.get("ctr")[0] == b"3" and s.head("ctr").generation == 4


def test_retry_and_fault_layering(tmp_path, monkeypatch):
    """open_object_root wires Local -> Faulty -> Retrying: transient
    injected faults are retried away (the same retries as JAX's on the
    same plan); torn faults pass through NonRetryable with the damage
    preserved."""
    from firebird_tpu import retry as jretry
    from firebird_tpu_torch import retry as tretry

    monkeypatch.setattr(tretry.time, "sleep", lambda s: None)
    monkeypatch.setattr(jretry.time, "sleep", lambda s: None)
    env = dict(FIREBIRD_FAULTS="object:p=0.4,seed=3", FIREBIRD_RETRIES="8")
    listed = {}
    for name, (mod, conf) in dict(port=(tobj, Config),
                                  jax=(jobj, JConfig)).items():
        root = str(tmp_path / name)
        s = mod.open_object_root(cfg=conf.from_env(env=dict(
            os.environ, FIREBIRD_OBJECT_ROOT=root, **env)))
        assert isinstance(s, mod.RetryingObjectStore)
        for i in range(10):
            s.put(f"k{i}", b"v")
        listed[name] = sorted(s.list())
        assert all(s.get(f"k{i}")[0] == b"v" for i in range(10))
    assert listed["port"] == listed["jax"] == sorted(f"k{i}"
                                                     for i in range(10))
    assert obs_metrics.counter("objectstore_retries").value \
        == jmetrics.counter("objectstore_retries").value >= 1
    assert obs_metrics.counter("faults_injected_object").value \
        == jmetrics.counter("faults_injected_object").value >= 1

    root = str(tmp_path / "port")
    t = tobj.open_object_root(cfg=Config.from_env(env=dict(
        os.environ, FIREBIRD_OBJECT_ROOT=root,
        FIREBIRD_FAULTS="object:p=1,torn")))
    with pytest.raises(tfaults.TornUpload):
        t.put("k0", b"replacement")                # a truncated chunk
    with pytest.raises(tfaults.TornUpload):
        t.put("k1", b"replacement")                # a dropped manifest
    # the reader falls back past the torn chunk; the dropped manifest
    # never became visible — on either package's reader
    for mod in (tobj, jobj):
        r = mod.LocalObjectStore(root)
        assert r.get("k0")[0] == b"v" and r.head("k0").generation == 2
        assert r.get("k1")[0] == b"v" and r.head("k1").generation == 1
    assert obs_metrics.counter("objectstore_retries").value \
        == jmetrics.counter("objectstore_retries").value


@pytest.mark.parametrize("plan", [
    "object:p=0.5,torn", "object:p=0.3,seed=4", "object:after=2,brownout=3",
    "object:chip=1:2", "store:p=1,torn", "object:p=0.2,seed=1,conn"])
def test_faults_grammar_object_scope(plan):
    def parsed(mod):
        try:
            p = mod.FaultPlan.parse(plan)
        except ValueError as e:
            return ("refused", str(e))
        return p.injector("object") is not None

    assert parsed(tfaults) == parsed(jfaults)
    if "chip=" in plan or "store:" in plan:     # torn is object-only,
        assert parsed(tfaults)[0] == "refused"  # chip= never fires here


@pytest.mark.parametrize("plan", ["object:p=0.3,seed=11",
                                  "object:after=4,brownout=3,timeout",
                                  "object:p=0.5,seed=2,torn"])
def test_object_fault_schedule_equals_jax(tmp_path, plan):
    """One plan fails the same object operations in either package, and
    the torn kind leaves the same damage (alternating a truncated chunk
    and a dropped manifest)."""
    seen = {}
    for name, mod, faults in (("port", tobj, tfaults),
                              ("jax", jobj, jfaults)):
        root = str(tmp_path / name)
        s = faults.wrap_objectstore(mod.LocalObjectStore(root, 16),
                                    faults.FaultPlan.parse(plan))
        log = []
        for i in range(24):
            op = (lambda: s.put(f"k{i % 5}", bytes([i]) * 40)) if i % 3 \
                else (lambda: s.head(f"k{i % 5}"))
            try:
                op()
                log.append((i, None))
            except Exception as e:
                log.append((i, type(e).__name__))
        plain = mod.LocalObjectStore(root, 16)
        seen[name] = (log, {k: (plain.head(k) and plain.head(k).generation)
                            for k in (f"k{j}" for j in range(5))})
    assert seen["port"] == seen["jax"]
    assert any(e for _, e in seen["port"][0])


# ---------------------------------------------------------------------------
# Nasty window 1: SIGKILL between the last chunk upload and the commit
# ---------------------------------------------------------------------------

CHILD_SRC = """\
import os, sys
sys.path.insert(0, os.environ["FB_REPO"])
from firebird_tpu_torch.store.objectstore import LocalObjectStore
s = LocalObjectStore(os.environ["FIREBIRD_OBJECT_ROOT"], chunk_size=64)
s.put("w/key", b"".join(bytes([c]) * 64 for c in range(4)))
"""


def _landed(root) -> int:
    """Chunk files that LANDED: a writer's in-flight temporary
    (``<sha>.tmp.<pid>.<tid>``) is not one."""
    try:
        names = os.listdir(os.path.join(root, "chunks"))
    except OSError:
        return 0
    return sum(1 for n in names if ".tmp" not in n)


def test_sigkill_between_chunks_and_manifest(tmp_path):
    """The port's writer, in a child this (jax-free) test process
    starts, is held between its last chunk upload and the manifest
    commit (FIREBIRD_OBJECT_COMMIT_HOLD_SEC) and SIGKILLed there: no
    object is visible, the four landed chunks are orphans for either
    package's census and scrub, and a successor's put lands generation
    1.  The wait counts landed chunks only, so a chunk still being
    written is never taken for one."""
    root = str(tmp_path / "objects")
    env = dict(os.environ, FB_REPO=ROOT, FIREBIRD_OBJECT_ROOT=root,
               FIREBIRD_OBJECT_COMMIT_HOLD_SEC="60")
    child = subprocess.Popen([sys.executable, "-c", CHILD_SRC], env=env,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 60
        while _landed(root) < 4:
            assert child.poll() is None, \
                f"writer finished despite hold: {child.stdout.read()}"
            assert time.time() < deadline, "chunks never landed"
            time.sleep(0.02)
        child.send_signal(signal.SIGKILL)
        child.wait(timeout=30)
    finally:
        if child.poll() is None:
            child.kill()
        child.stdout.close()
    assert child.returncode == -signal.SIGKILL
    assert _landed(root) == 4
    j = jobj.LocalObjectStore(root, chunk_size=64)
    assert j.head("w/key") is None and j.census()["orphan_chunks"] == 4
    s = tobj.LocalObjectStore(root, chunk_size=64)
    assert s.head("w/key") is None                # no visible partial
    assert s.list() == []
    assert s.census()["orphan_chunks"] == 4
    assert s.scrub(grace_sec=0.0)["removed"] == 4
    m = s.put("w/key", b"clean")                 # successor recovers
    assert m.generation == 1 and j.get("w/key")[0] == b"clean"


# ---------------------------------------------------------------------------
# Nasty window 2: the zombie's stale-fence conditional put
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("zombie_pkg, successor_pkg", CROSS)
def test_stale_object_fence_rejected_durably(tmp_path, zombie_pkg,
                                             successor_pkg):
    root = str(tmp_path / "objects")

    def make(pkg):
        mod, conf = (tobj, Config) if pkg == "port" else (jobj, JConfig)
        return mod.ObjectBackedStore(mod.open_object_root(
            root=root, cfg=conf.from_env(env=dict(
                os.environ, FIREBIRD_OBJECT_ROOT=root))), "scope", "ks")

    zombie, successor = make(zombie_pkg), make(successor_pkg)
    zombie.bind_fence(3)
    successor.bind_fence(5)
    zombie.write("segment", seg_frame(chprob=0.1))   # pre-reclaim: lands
    successor.write("segment", seg_frame(chprob=0.9))
    with pytest.raises(PKGS[zombie_pkg].StaleObjectFence):
        zombie.write("segment", seg_frame(chprob=0.2))
    assert successor.read("segment")["chprob"] == [0.9]
    assert zombie.read("segment")["chprob"] == [0.9]
    assert successor.fence_rejects() == zombie.fence_rejects() == 1
    metrics = obs_metrics if zombie_pkg == "port" else jmetrics
    assert metrics.counter("object_fence_rejected_total").value == 1
    zombie.close()
    successor.close()
    assert make("port").fence_rejects() == make("jax").fence_rejects() == 1


def test_fenced_store_stamps_object_fence(tmp_path):
    """The port's FencedStore binds the lease fence onto an object store
    and onto a mirror, so the object layer rejects a zombie even where
    the queue's own fence check cannot run."""
    from firebird_tpu_torch.fleet.queue import FencedStore, FleetQueue

    q = FleetQueue(str(tmp_path / "q.db"), lease_sec=30)
    q.enqueue("detect", {"n": 1})
    lease = q.claim("w:1")
    root = str(tmp_path / "objects")
    inner = tobj.ObjectBackedStore(tobj.open_object_root(
        root=root, cfg=Config.from_env(env=dict(
            os.environ, FIREBIRD_OBJECT_ROOT=root))), "scope", "ks")
    FencedStore(inner, q, lease)
    assert inner._fence == lease.fence
    mirror = tobj.MirroredStore(open_store("memory", "", "ks"), inner)
    inner._fence = None
    FencedStore(mirror, q, lease)
    assert inner._fence == lease.fence
    inner.close()
    q.close()


def test_worker_abandons_a_job_its_object_fence_rejects(tmp_path):
    """A StaleObjectFence from the job's store is a lost lease, as a
    StaleFence is: the worker abandons the job (counted lost), it does
    not fail it."""
    from firebird_tpu_torch.fleet import FleetQueue, FleetWorker

    q = FleetQueue(str(tmp_path / "q.db"), lease_sec=30)
    jid = q.enqueue("detect", {"n": 1})

    def zombie(payload, lease):
        raise tobj.StaleObjectFence("fenced off")

    cfg = Config(store_backend="memory", fleet_db=str(tmp_path / "q.db"))
    w = FleetWorker(cfg, q, handlers={"detect": zombie}, device="cpu")
    summary = w.run(until_drained=False, max_jobs=1)
    assert summary["lost"] == 1 and summary.get("dead", 0) == 0
    assert q.job(jid)["state"] == "leased"
    assert obs_metrics.counter("fleet_jobs_lost").value == 1
    q.close()


# ---------------------------------------------------------------------------
# The store: the pure object backend and the write-through mirror
# ---------------------------------------------------------------------------

def fixture_rows(store):
    store.write("chip", {"cx": [10], "cy": [20],
                         "dates": [["1999-01-01", "1999-02-01"]]})
    store.write("pixel", {"cx": [10], "cy": [20], "px": [10], "py": [20],
                          "mask": [[1, 0]]})
    store.write("segment", seg_frame(cx=10, cy=20, chprob=0.25))
    store.write("segment", seg_frame(cx=10, cy=20, chprob=0.75))
    store.write("tile", {"tx": [1], "ty": [2], "name": ["rf"],
                         "model": ["BLOB"], "updated": ["2020-01-01"]})


def canon(store) -> dict:
    out = {}
    for t in ("chip", "pixel", "segment", "tile"):
        frame = store.read(t)
        cols = sorted(frame)
        n = len(frame[cols[0]]) if cols else 0
        out[t] = sorted(
            json.dumps([(c, frame[c][i]) for c in cols], sort_keys=True)
            for i in range(n))
    return out


@pytest.mark.parametrize("writer, reader", CROSS)
def test_object_backend_parity_with_sqlite(tmp_path, monkeypatch, writer,
                                           reader):
    from firebird_tpu.store import open_store as jopen_store

    opens = {"port": open_store, "jax": jopen_store}
    monkeypatch.delenv("FIREBIRD_OBJECT_ROOT", raising=False)
    sq = open_store("sqlite", str(tmp_path / "s.db"), "ks")
    fixture_rows(sq)
    want = canon(sq)
    counts = {t: sq.count(t) for t in want}
    sq.close()
    monkeypatch.setenv("FIREBIRD_OBJECT_ROOT", str(tmp_path / "objects"))
    ob = opens[writer]("object", str(tmp_path / "scope"), "ks")
    fixture_rows(ob)
    ob.close()
    rd = opens[reader]("object", str(tmp_path / "scope"), "ks",
                       read_only=True)
    assert canon(rd) == want
    assert {t: rd.count(t) for t in want} == counts  # head-only counts
    assert rd.chip_ids("segment") == {(10, 20)}
    assert rd.read("segment", {"cx": 10, "cy": 20})["chprob"] == [0.75]
    empty = rd.read("segment", {"cx": 99})
    assert all(v == [] for v in empty.values())
    with pytest.raises(RuntimeError, match="read-only"):
        rd.write("segment", seg_frame())
    rd.close()


def test_open_store_mirror_is_env_driven(tmp_path, monkeypatch):
    monkeypatch.setenv("FIREBIRD_OBJECT_ROOT", str(tmp_path / "objects"))
    path = str(tmp_path / "m.db")
    st = open_store("sqlite", path, "ks")
    assert isinstance(st, tobj.MirroredStore)
    fixture_rows(st)
    want = canon(st)                             # reads are local
    st.close()
    # the object side alone carries identical rows, for either package
    for mod in (tobj, jobj):
        ob = mod.ObjectBackedStore(
            mod.open_object_root(root=str(tmp_path / "objects")),
            mod.scope_for_path(path), "ks")
        assert canon(ob) == want
        ob.close()
    # read-only replicas skip the wrap (they never write)
    ro = open_store("sqlite", path, "ks", read_only=True)
    assert not isinstance(ro, tobj.MirroredStore)
    ro.close()
    for backend in ("memory", "parquet"):
        st = open_store(backend, str(tmp_path / f"m.{backend}"), "ks")
        assert isinstance(st, tobj.MirroredStore)
        st.close()
    monkeypatch.delenv("FIREBIRD_OBJECT_ROOT")
    st = open_store("sqlite", str(tmp_path / "m2.db"), "ks")
    assert not isinstance(st, tobj.MirroredStore)
    st.close()


def test_mirror_raises_when_the_object_put_fails(tmp_path, monkeypatch):
    """Object first: a mirrored write whose object put fails raises, and
    no local row lands (nothing logged and skipped)."""
    monkeypatch.setenv("FIREBIRD_OBJECT_ROOT", str(tmp_path / "objects"))
    st = open_store("sqlite", str(tmp_path / "m.db"), "ks")

    def broken(*a, **k):
        raise tobj.ObjectStoreError("object tier down")

    monkeypatch.setattr(st.object_mirror._obj, "put", broken)
    with pytest.raises(tobj.ObjectStoreError, match="down"):
        st.write("segment", seg_frame())
    assert st.count("segment") == 0
    st.close()


@pytest.mark.parametrize("env, ok", [
    ({"FIREBIRD_STORE_BACKEND": "object"}, False),
    ({"FIREBIRD_OBJECT_ROOT": "/tmp/o", "FIREBIRD_OBJECT_CHUNK_KB": "0"},
     False),
    ({"FIREBIRD_OBJECT_ROOT": "/tmp/o",
      "FIREBIRD_OBJECT_SCRUB_GRACE_SEC": "-1"}, False),
    ({"FIREBIRD_STORE_BACKEND": "object", "FIREBIRD_OBJECT_ROOT": "/tmp/o"},
     True)])
def test_config_validates_object_knobs(env, ok):
    def made(conf):
        try:
            c = conf.from_env(env=env)
        except ValueError as e:
            return ("refused", str(e))
        return (c.object_root, c.object_chunk_kb, c.object_scrub_grace_sec)

    assert made(Config) == made(JConfig)
    assert (made(Config)[0] != "refused") == ok
    if ok:
        assert made(Config) == ("/tmp/o", 256, 60.0)


def test_object_root_is_honoured_by_the_drivers(tmp_path, monkeypatch):
    """``object_root`` and the ``object`` backend are ported: neither the
    batch driver nor the stream refuses them."""
    from firebird_tpu_torch.config import NOT_PORTED, NOT_PORTED_BACKENDS
    from firebird_tpu_torch.driver import core

    assert "object_root" not in NOT_PORTED
    assert "object" not in NOT_PORTED_BACKENDS
    assert set(NOT_PORTED) == {"compile_cache"}
    assert NOT_PORTED_BACKENDS == {}
    core.refuse_not_ported(Config(store_backend="object",
                                  object_root=str(tmp_path / "o")))


# ---------------------------------------------------------------------------
# The statestore seam
# ---------------------------------------------------------------------------

def _chip():
    return tuple(int(v) for v in
                 next(iter(grid.chips(grid.tile(x=100.0, y=200.0)))))


def _arrays(P=4, B=2, K=3):
    out = {}
    for i, (name, dtype, shape) in enumerate(tss._layout(P, B, K)):
        n = max(int(np.prod(shape)), 1)
        out[name] = ((np.arange(n) + i) % 5).astype(dtype).reshape(shape)
    return out


@pytest.mark.parametrize("writer, reader", CROSS)
def test_object_statestore_parity(tmp_path, writer, reader):
    """Packed and object checkpoints of one state read back alike, in
    either package, and the object payload is the canonical
    ``serialize_state`` byte layout, equal byte for byte across the
    packages."""
    mods = {"port": tss, "jax": jss}
    cid = _chip()
    arrays = _arrays()
    roots = {n: open_object_root_of(n, tmp_path) for n in mods}
    packed = mods[writer].TileStateStore(str(tmp_path / "packed"))
    objst = mods[writer].ObjectStateStore(roots[writer], "sc")
    packed.save_arrays(cid, arrays)
    objst.save_arrays(cid, arrays)
    rd = mods[reader].ObjectStateStore(roots[reader], "sc")
    a, b = packed.peek_arrays(cid), rd.peek_arrays(cid)
    for k in arrays:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    assert rd.peek_horizon(cid) == packed.peek_horizon(cid)
    assert rd.exists(cid) and rd.chips() == [cid]
    payload, meta = roots[reader].get(f"sc/state/chip_{cid[0]}_{cid[1]}")
    want = b"".join(jss._canonical(n, arrays[n], d, s).tobytes()
                    for n, d, s in jss._layout(4, 2, 3))
    assert payload == want and meta.meta["geom"] == [4, 2, 3]
    rd.void(cid)
    assert not objst.exists(cid)
    packed.close()
    objst.close()


def open_object_root_of(name, tmp_path):
    mod = tobj if name == "port" else jobj
    return mod.open_object_root(root=str(tmp_path / "objects"))


def test_object_statestore_loads_tensors_and_saves_jaxs_bytes(tmp_path):
    """A state the port saves from tensors lands as the bytes JAX's
    ObjectStateStore writes from the same numpy state, and the port's
    load gives that state back as tensors."""
    import jax.numpy as jnp

    from firebird_tpu.ccd.incremental import StreamState as JState
    from firebird_tpu_torch.ccd import convert
    from test_torch_statestore import _mk_arrays

    a = _mk_arrays(seed=3)
    cid = _chip()
    side = {k: a[k] for k in tss.SIDE_FIELDS}
    port = tss.ObjectStateStore(tobj.open_object_root(
        root=str(tmp_path / "p")), "sc")
    port.save(cid, convert.stream_state_from_numpy(a), side)
    jaxs = jss.ObjectStateStore(jobj.open_object_root(
        root=str(tmp_path / "j")), "sc")
    jaxs.save(cid, JState(*(jnp.asarray(a[f]) for f in tss.STATE_FIELDS)),
              side)
    key = f"sc/state/chip_{cid[0]}_{cid[1]}"
    pb, pm = port._obj.get(key)
    jb, jm = jaxs._obj.get(key)
    assert pb == jb and pm.meta == jm.meta
    st, got_side = port.load(cid)
    assert torch.is_tensor(st.coefs) and st.coefs.device.type == "cpu"
    np.testing.assert_array_equal(st.coefs.numpy(), a["coefs"])
    assert float(got_side["horizon"]) == float(a["horizon"])


def test_open_statestore_mirrors_under_object_root(tmp_path):
    cfg = Config.from_env(env={
        "FIREBIRD_STORE_PATH": str(tmp_path / "s.db"),
        "FIREBIRD_STREAM_DIR": str(tmp_path / "stream"),
        "FIREBIRD_OBJECT_ROOT": str(tmp_path / "objects")})
    st = tss.open_statestore(cfg)
    assert isinstance(st, tss.MirroredStateStore)
    cid = _chip()
    st.save_arrays(cid, _arrays())
    assert st.exists(cid)                        # local read-authoritative
    assert st._mirror.exists(cid)                # mirrored
    assert st.status()["backend"] == "packed+object"
    assert st.status()["object_scope"] == tobj.scope_for_path(
        str(tmp_path / "stream"))
    st.close()
    # JAX's mirror of the same config reads the port's object
    jst = jss.open_statestore(JConfig.from_env(env={
        "FIREBIRD_STORE_PATH": str(tmp_path / "s.db"),
        "FIREBIRD_STREAM_DIR": str(tmp_path / "stream"),
        "FIREBIRD_OBJECT_ROOT": str(tmp_path / "objects")}))
    assert isinstance(jst, jss.MirroredStateStore)
    assert jst._mirror.chips() == [cid]
    jst.close()
    # npz/f64 is NOT mirrored (lossy payloads)
    cfg64 = Config.from_env(env={
        "FIREBIRD_STORE_PATH": str(tmp_path / "s.db"),
        "FIREBIRD_STREAM_DIR": str(tmp_path / "stream64"),
        "FIREBIRD_DTYPE": "float64",
        "FIREBIRD_OBJECT_ROOT": str(tmp_path / "objects")})
    st = tss.open_statestore(cfg64)
    assert not isinstance(st, tss.MirroredStateStore)
    st.close()
