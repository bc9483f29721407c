"""One process per card on the CPU: the port's multi-process run, its
process-local mesh, and the kernel build under two processes.

Two ``python -m firebird_tpu_torch changedetection --device cpu`` children
with torchrun's variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK,
LOCAL_RANK) bring up a gloo group, take one chip each of a tile's first
two, and write into one sqlite store: the union of their rows must equal
a one-process port run on the same chips, the two report shards must
carry one run id, and process 0's fleet report must hold the shards'
sums (the JAX package's tests/test_multihost.py contract).  The chips are
whole chips of the tiny synthetic sensor (10x10 pixels): a 100x100 chip
takes tens of seconds on one CPU thread.  Each child runs torch on
one thread.
"""

import json
import os
import sqlite3
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest
import torch
from conftest import free_port

from firebird_tpu import grid
from firebird_tpu.obs import report as jreport
from firebird_tpu_torch.config import Config
from firebird_tpu_torch.driver import core as tcore
from firebird_tpu_torch.obs import report as treport

ROOT = Path(__file__).resolve().parents[1]
POINT = (542000, 1650000)
ACQUIRED = "1995-01-01/1998-01-01"
TINY = "landsat-ard-tiny"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _child_env(**kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    env.update({k: str(v) for k, v in kw.items()})
    return env


def _run(cmds, envs, logs, timeout=240):
    """Start every child at once; wait; return their combined outputs (one
    log file each, never pipes: a child blocked on a full pipe would stall
    its peer in the group's bring-up)."""
    procs, files = [], []
    try:
        for cmd, env, log in zip(cmds, envs, logs):
            files.append(open(log, "w+"))
            procs.append(subprocess.Popen(cmd, env=env, stdout=files[-1],
                                          stderr=subprocess.STDOUT,
                                          text=True, cwd=str(ROOT)))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        outs = []
        for f in files:
            f.seek(0)
            outs.append(f.read())
            f.close()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def _rows(db, table):
    con = sqlite3.connect(db)
    cur = con.execute(f"SELECT * FROM {table}")
    cols = [d[0] for d in cur.description]
    rows = sorted(tuple(r) for r in cur.fetchall())
    con.close()
    return cols, rows


# ---------------------------------------------------------------------------
# Two processes through the command line
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_process_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mp")
    port = free_port()
    cmd = [sys.executable, "-m", "firebird_tpu_torch", "changedetection",
           "-x", str(POINT[0]), "-y", str(POINT[1]), "-a", ACQUIRED,
           "-n", "2", "-c", "2", "--device", "cpu", "--trace", "1"]
    base = dict(FIREBIRD_SOURCE="synthetic", FIREBIRD_SYNTH_SENSOR=TINY,
                FIREBIRD_STORE_BACKEND="sqlite",
                FIREBIRD_STORE_PATH=tmp / "mp.db",
                FIREBIRD_CHIPS_PER_BATCH=1, MASTER_ADDR="127.0.0.1",
                MASTER_PORT=port, WORLD_SIZE=2)
    outs = _run([cmd, cmd],
                [_child_env(**base, RANK=i, LOCAL_RANK=i) for i in (0, 1)],
                [tmp / f"proc{i}.log" for i in (0, 1)])
    # the one-process port run on the same chips, in this process
    ref = tmp / "ref"
    ref.mkdir()
    cfg = Config(store_backend="sqlite", store_path=str(ref / "one.db"),
                 source_backend="synthetic", synth_sensor=TINY,
                 chips_per_batch=1)
    done = tcore.changedetection(*POINT, acquired=ACQUIRED, number=2,
                                 chunk_size=2, cfg=cfg, device="cpu")
    assert len(done) == 2
    return tmp, outs, ref


def test_each_process_takes_its_strided_share(two_process_run):
    tmp, outs, _ = two_process_run
    for i, out in enumerate(outs):
        assert f"process {i}/2 takes 1 of 2 chips" in out, out[-2000:]
        line = json.loads(out.strip().splitlines()[-1])
        assert line["process_index"] == i and line["process_count"] == 2
        assert line["chips_done"] == 1 and line["pixels"] == 100
        assert line["artifacts"]["report_shard"].endswith(
            f"obs_report.host{i}.json")
        assert line["artifacts"]["trace"].endswith(f"trace.host{i}.json")
    assert "report" in json.loads(outs[0].strip().splitlines()[-1])[
        "artifacts"]


@pytest.mark.parametrize("table", ["chip", "pixel", "segment"])
def test_union_of_rows_equals_a_one_process_run(two_process_run, table):
    tmp, _, ref = two_process_run
    [db] = tmp.glob("mp.*.db")
    [one] = ref.glob("one.*.db")
    cols, got = _rows(str(db), table)
    cols_ref, want = _rows(str(one), table)
    assert cols == cols_ref
    assert got == want and len(got) > 0
    expect = {tuple(int(v) for v in c)
              for c in grid.chips(grid.tile(*POINT))[:2]}
    assert {(r[cols.index("cx")], r[cols.index("cy")]) for r in got} \
        == expect


def test_shards_carry_one_run_id_and_the_fleet_report_sums_them(
        two_process_run):
    tmp, outs, _ = two_process_run
    shards = [json.load(open(tmp / f"obs_report.host{i}.json"))
              for i in (0, 1)]
    fleet = json.load(open(tmp / "obs_report.json"))
    ids = {sh["run"]["run_id"] for sh in shards}
    ids |= {json.loads(o.strip().splitlines()[-1])["run_id"] for o in outs}
    assert len(ids) == 1
    for i, sh in enumerate(shards):
        jreport.validate_report(sh)
        assert sh["run"]["process_id"] == i
        assert sh["run_counters"]["chips"] == 1
        assert sh["metrics"]["gauges"]["mesh_processes"] == 2
    jreport.validate_report(fleet)
    assert fleet["fleet"]["hosts"] == 2
    assert fleet["fleet"]["expected_hosts"] == 2
    assert "missing" not in fleet["fleet"]
    assert fleet["run_counters"]["chips"] == 2
    assert fleet["run_counters"]["pixels"] == 200
    for name, v in fleet["metrics"]["counters"].items():
        assert v == sum(sh["metrics"]["counters"].get(name, 0)
                        for sh in shards), name
    for name, h in fleet["metrics"]["histograms"].items():
        assert h["count"] == sum(
            sh["metrics"]["histograms"].get(name, {"count": 0})["count"]
            for sh in shards), name
    # the JAX package's tooling reads the port's fleet report
    assert jreport.load_fleet_report(str(tmp))["fleet"]["hosts"] == 2


def test_each_process_trace_passes_the_driver_contract(two_process_run):
    tmp, _, _ = two_process_run
    for i in (0, 1):
        trace = json.load(open(tmp / f"trace.host{i}.json"))
        shard = json.load(open(tmp / f"obs_report.host{i}.json"))
        treport.validate_driver_artifacts(trace, shard)
        jreport.validate_driver_artifacts(trace, shard)


# ---------------------------------------------------------------------------
# The process-local mesh (the counterpart of tests/_mp_mesh_child.py)
# ---------------------------------------------------------------------------

def test_mesh_two_processes_each_on_its_own_chips(tmp_path):
    coord = f"127.0.0.1:{free_port()}"
    child = str(ROOT / "tests" / "_torch_mp_mesh_child.py")
    outs = _run([[sys.executable, child, str(i), coord] for i in (0, 1)],
                [_child_env()] * 2, [tmp_path / f"mesh{i}.log"
                                     for i in (0, 1)])
    for i, out in enumerate(outs):
        assert f"CHILD_OK {i}" in out, out[-2000:]
    # the two cadences gave the processes different window caps
    caps = {out.split("wcap_local=")[1].split()[0] for out in outs}
    assert len(caps) == 2, outs


# ---------------------------------------------------------------------------
# The kernel build under two processes
# ---------------------------------------------------------------------------

# A stand-in for nvcc: logs its call, then writes its output slowly (a
# second in all), so that two builds of one unit would overlap.
FAKE_NVCC = textwrap.dedent("""\
    import os, sys, time
    out = sys.argv[sys.argv.index("-o") + 1]
    with open(os.environ["FB_NVCC_LOG"], "a") as f:
        f.write(f"{os.getpid()} {out}\\n")
    with open(out, "wb") as f:
        for i in range(50):
            f.write(bytes([i]) * 4096)
            f.flush()
            time.sleep(0.02)
    print("ptxas info    : Used 64 registers")
    """)

BUILD_CHILD = textwrap.dedent("""\
    import hashlib, os, sys, time
    from pathlib import Path
    from firebird_tpu_torch.ccd import cuda_ops
    build, nvcc, me = Path(sys.argv[1]), sys.argv[2], sys.argv[3]
    cuda_ops.BUILD_DIR = build
    cuda_ops._nvcc = lambda: nvcc
    # both processes reach _compile together
    (build.parent / f"ready.{me}").touch()
    while len(list(build.parent.glob("ready.*"))) < 2:
        time.sleep(0.005)
    out = cuda_ops._compile("lasso_fit")
    print("LIB", out, hashlib.sha256(out.read_bytes()).hexdigest())
    """)


def test_two_processes_build_a_unit_once(tmp_path):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\n" + FAKE_NVCC)
    nvcc.chmod(0o755)
    build = tmp_path / "build"
    log = tmp_path / "nvcc.log"
    env = _child_env(FB_NVCC_LOG=log)
    outs = _run([[sys.executable, "-c", BUILD_CHILD, str(build), str(nvcc),
                  str(i)] for i in (0, 1)], [env, env],
                [tmp_path / f"build{i}.log" for i in (0, 1)])
    libs = [o.split("LIB ")[1].split() for o in outs]
    # one build ran, and both processes got its complete library
    assert len(log.read_text().splitlines()) == 1
    assert libs[0] == libs[1]
    path = Path(libs[0][0])
    expect = b"".join(bytes([i]) * 4096 for i in range(50))
    assert path.read_bytes() == expect
    assert "Used 64 registers" in (build / "lasso_fit.ptxas.txt").read_text()
    assert not [p for p in build.iterdir() if ".tmp" in p.name]


def test_a_multi_process_run_without_a_card_raises(monkeypatch):
    """A process of a multi-process run takes its card, and without one
    raises unless the caller names the CPU; the ring is refused by name
    across processes."""
    from firebird_tpu_torch.parallel import dist

    monkeypatch.setattr(dist, "_state", dict(world=2, rank=1, local_rank=1))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcore.run_device()
    assert tcore.run_device("cpu").type == "cpu"
    assert tcore.host_shard(list(range(5))) == [1, 3]
    monkeypatch.setenv("FIREBIRD_REBALANCE", "1")
    with pytest.raises(NotImplementedError, match="FIREBIRD_REBALANCE"):
        tcore.changedetection(0, 0, cfg=Config(store_backend="memory"),
                              device="cpu")
