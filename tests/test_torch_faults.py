"""The port's fault plans against the JAX package's (firebird_tpu_torch/
faults.py): the same plan strings parse or refuse alike, the same plan and
seed fail the same operation indices through every seam the port wraps
(ingest and aux sources, the store, the async writer, the fleet lease
heartbeat), with the same error classes and the same ``faults_injected``
counters; and the plan reaches the drivers and the fleet worker: a
poisoned chip is quarantined while its chunk (or detect job) completes,
and transient faults cost retries, never results.
"""

import json

import pytest
import torch

from firebird_tpu import faults as jfaults
from firebird_tpu.obs import metrics as jmetrics
from firebird_tpu_torch import faults as tfaults
from firebird_tpu_torch import grid
from firebird_tpu_torch.config import Config
from firebird_tpu_torch.driver import core
from firebird_tpu_torch.driver import quarantine as qlib
from firebird_tpu_torch.fleet import FleetQueue, FleetWorker
from firebird_tpu_torch.obs import metrics as obs_metrics
from firebird_tpu_torch.store import MemoryStore, SqliteStore
from firebird_tpu_torch.utils.fn import take


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_registries():
    obs_metrics.reset_registry()
    jmetrics.reset_registry()
    yield
    obs_metrics.reset_registry()
    jmetrics.reset_registry()


ACQ = "1995-01-01/1998-01-01"
CFG = dict(source_backend="synthetic", synth_sensor="landsat-ard-tiny",
           chips_per_batch=1, dtype="float64", device_sharding="off",
           fetch_retries=0)
CIDS = [tuple(int(v) for v in c)
        for c in take(2, grid.chips(grid.tile(x=100, y=200)))]


# ---------------------------------------------------------------------------
# The grammar: what JAX's parser accepts and refuses, the port does alike
# ---------------------------------------------------------------------------

PLANS = [
    "", "  ; ", "ingest:p=0.05,timeout,seed=7;store:after=40,brownout=3",
    "aux:p=1.0", "writer:after=0,conn", "lease:p=1", "serve:after=2",
    "watch:p=0.5,seed=3", "object:p=0.2,torn", "ingest:chip=1:2,chip=3:4",
    "ingest:p=0.1,brownout=4,seed=9;aux:chip=5:6;store:p=0.3;writer:p=0.2;"
    "lease:after=1",
    # refused
    "nonsense", "bogus:p=0.5", "ingest:p=2.0", "ingest:wat=1",
    "ingest:p=abc", "ingest:frobnicate", "ingest:seed=7",
    "ingest:p=0.5;ingest:p=0.1", "store:chip=1:2", "lease:chip=1:2",
    "object:chip=1:2", "ingest:p=1,torn", "store:after=-1",
    "writer:after=1,brownout=0", "ingest:", "ingest:chip=1",
]


def _parsed(mod, text):
    try:
        plan = mod.FaultPlan.parse(text)
    except ValueError as e:
        return ("refused", str(e))
    if plan is None:
        return None
    return sorted(
        (t, inj.spec.p, inj.spec.after, inj.spec.brownout, inj.spec.seed,
         inj.spec.kind, sorted(inj.spec.chips))
        for t, inj in plan._injectors.items())


@pytest.mark.parametrize("text", PLANS)
def test_plan_parse_equals_jax(text):
    assert _parsed(tfaults, text) == _parsed(jfaults, text)


def test_config_validates_the_fault_plan():
    with pytest.raises(ValueError):
        Config(faults="ingest:p=2.0")
    cfg = Config.from_env(env={"FIREBIRD_FAULTS": "ingest:p=0.5"})
    assert cfg.faults == "ingest:p=0.5"
    assert tfaults.FaultPlan.from_config(cfg).injector("ingest").spec.p == 0.5
    assert tfaults.FaultPlan.from_config(Config()) is None


# ---------------------------------------------------------------------------
# The schedule: the same plan and seed fail the same operations
# ---------------------------------------------------------------------------

class _Inner:
    """A source, store and writer in one: counts what reaches it."""

    def __init__(self):
        self.calls = 0
        self.seed = 9

    def chip(self, cx, cy, acquired=None):
        self.calls += 1
        return (cx, cy)

    aux = chip

    def write(self, table, frame, key=None):
        self.calls += 1
        return 1


CHIPS = [(1, 2), (3, 4), (5, 6)]


def _fired(mod, text, scope, n=60):
    """Drive ``n`` operations through ``mod``'s seam for ``scope``;
    returns [(op index, error class name)] of the failures and the
    operations that reached the wrapped object."""
    plan = mod.FaultPlan.parse(text)
    inner = _Inner()
    if scope in ("ingest", "aux"):
        src = mod.wrap_source(inner, plan)
        op = (lambda i: src.chip(*CHIPS[i % 3], "a")) if scope == "ingest" \
            else (lambda i: src.aux(*CHIPS[i % 3], "a"))
    elif scope == "store":
        st = mod.wrap_store(inner, plan)
        op = lambda i: st.write("chip", {"i": i})          # noqa: E731
    elif scope == "writer":
        w = mod.wrap_writer(inner, plan)
        op = lambda i: w.write("chip", {"i": i})           # noqa: E731
    else:
        inj = plan.injector("lease")
        op = lambda i: inj.fire()                          # noqa: E731
    failed = []
    for i in range(n):
        try:
            op(i)
        except Exception as e:
            failed.append((i, type(e).__mro__[1].__name__))
    return failed, inner.calls


@pytest.mark.parametrize("kind", ["ioerror", "timeout", "conn"])
@pytest.mark.parametrize("scope", ["ingest", "aux", "store", "writer",
                                   "lease"])
def test_schedule_equals_jax(scope, kind):
    plans = [f"{scope}:p=0.3,seed=11,{kind}",
             f"{scope}:after=4,brownout=3,{kind}",
             f"{scope}:p=0.1,brownout=3,seed=5,{kind}"]
    if scope in ("ingest", "aux"):
        plans.append(f"{scope}:chip=3:4,chip=5:6,{kind}")
    for text in plans:
        got, want = _fired(tfaults, text, scope), _fired(jfaults, text, scope)
        assert got == want, text
        assert got[0], text                     # the plan did inject
    total = obs_metrics.counter("faults_injected").value
    assert total == jmetrics.counter("faults_injected").value > 0
    assert obs_metrics.counter(f"faults_injected_{scope}").value == total


def test_wrap_identity_off_the_hot_path():
    src, store, writer = object(), object(), object()
    assert tfaults.wrap_source(src, None) is src
    assert tfaults.wrap_store(store, None) is store
    assert tfaults.wrap_writer(writer, None) is writer
    plan = tfaults.FaultPlan.parse("store:after=1")
    assert tfaults.wrap_source(src, plan) is src
    assert tfaults.wrap_writer(writer, plan) is writer
    assert isinstance(tfaults.wrap_store(store, plan), tfaults.FaultyStore)
    # an aux-only plan still proxies the source, for its aux calls
    aux_only = tfaults.wrap_source(_Inner(), tfaults.FaultPlan.parse(
        "aux:p=1.0"))
    assert aux_only.chip(1, 2) == (1, 2) and aux_only.seed == 9
    with pytest.raises(tfaults.InjectedFault):
        aux_only.aux(1, 2)


# ---------------------------------------------------------------------------
# The plan in the drivers and the fleet worker
# ---------------------------------------------------------------------------

def _poison(cid):
    return f"ingest:chip={cid[0]}:{cid[1]}"


def test_poisoned_chip_no_longer_fails_its_chunk(tmp_path):
    """One permanently failing chip in a 2-chip chunk leaves the other
    landed, the poisoned one in quarantine.json (the JAX package's
    format), and a resume after the poison clears completes the tile."""
    cfg = Config(store_backend="sqlite", store_path=str(tmp_path / "fb.db"),
                 faults=_poison(CIDS[0]), **CFG)
    done = core.changedetection(x=100, y=200, acquired=ACQ, number=2,
                                chunk_size=2, cfg=cfg, device="cpu")
    assert list(done) == [CIDS[1]]
    store = SqliteStore(cfg.store_path, cfg.keyspace())
    assert store.count("chip") == 1
    doc = json.load(open(qlib.quarantine_path(cfg)))
    key = f"{CIDS[0][0]},{CIDS[0][1]}"
    assert doc["chips"][key]["error"] == "InjectedFault"
    healed = Config(store_backend="sqlite", store_path=cfg.store_path, **CFG)
    out = core.changedetection(x=100, y=200, acquired=ACQ, number=2,
                               chunk_size=2, cfg=healed, resume=True,
                               device="cpu")
    assert set(out) == set(CIDS)
    assert store.count("chip") == 2
    assert len(qlib.Quarantine.load(qlib.quarantine_path(cfg))) == 0
    store.close()


def test_transient_injected_faults_cost_retries_not_results(monkeypatch):
    """An ingest brownout and a store blip below the retry ceiling are
    absorbed: every chip lands and the counters show what was absorbed."""
    from firebird_tpu_torch import retry as retrylib

    monkeypatch.setattr(retrylib.time, "sleep", lambda s: None)
    cfg = Config(store_backend="memory",
                 faults="ingest:after=0,brownout=2;store:after=1",
                 **dict(CFG, fetch_retries=3))
    store = MemoryStore("faults")
    done = core.changedetection(x=100, y=200, acquired=ACQ, number=2,
                                chunk_size=2, cfg=cfg, store=store,
                                device="cpu")
    assert len(done) == 2 and store.count("chip") == 2
    assert obs_metrics.counter("faults_injected_ingest").value == 2
    assert obs_metrics.counter("faults_injected_store").value == 1
    assert obs_metrics.counter("fetch_retries").value == 2


def test_detect_job_acks_minus_dead_letters(tmp_path):
    """A detect job whose chip exhausts its fetch retries acks (the job
    ran; the per-chip quarantine is the record) and the dead letter
    survives the job's redeem sweep."""
    cfg = Config(store_backend="sqlite", store_path=str(tmp_path / "fb.db"),
                 faults=_poison(CIDS[0]), **CFG)
    queue = FleetQueue(str(tmp_path / "fleet.db"))
    queue.enqueue("detect", {"x": 100, "y": 200, "acquired": ACQ,
                             "cids": [list(c) for c in CIDS]})
    w = FleetWorker(cfg, queue, worker_id="t:1", sleep=lambda s: None,
                    device="cpu")
    summary = w.run(until_drained=True)
    assert summary["acked"] == 1 and summary["queue"]["done"] == 1
    q = qlib.Quarantine.load(qlib.quarantine_path(cfg))
    assert q.chip_ids() == {CIDS[0]}
    store = SqliteStore(cfg.store_path, cfg.keyspace())
    assert store.chip_ids("segment") == {CIDS[1]}
    store.close()
    queue.close()
