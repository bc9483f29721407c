"""The port's global mesh across two processes on the CPU, against the
one-process ring and the JAX package.

Two children (tests/_torch_mp_ring_child.py, fresh interpreters, one torch
thread each) join a gloo group, build ``parallel.make_mesh`` and run
``parallel.detect_sharded`` over it three times: the forced-ragged pair of
tests/test_torch_sharded.py with one CPU shard a process and the ring on
(its hops cross between the processes by gloo send/receive); the
counterpart of tests/_mp_mesh_child.py with two CPU shards a process,
different cadences (the window-cap agreement) and max_segments=1 (the
capacity retry's agreement), the ring on; and a dispatch whose stage-2
carries differ between the processes, which must raise by name in both.
Store fields are held exactly to the port's one-process two-shard ring,
decisions exactly and rmse/mag within test_torch_sharded.py's tolerances
(rtol 1e-4, atol 1e-3; rtol 5e-3, atol 1e-2) to JAX's ring, and
``lanes_migrated`` exactly to JAX's.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from conftest import free_port

from firebird_tpu_torch.ccd import cuda_ops
from firebird_tpu_torch.parallel import mesh as tmesh
from tests import test_torch_sharded as sharded

ROOT = Path(__file__).resolve().parents[1]
STORE = ("n_segments", "seg_meta", "seg_rmse", "seg_mag", "seg_coef", "mask",
         "procedure")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ring_env():
    mp = pytest.MonkeyPatch()
    for k, v in sharded.ENV.items():
        mp.setenv(k, v)
    mp.delenv("FIREBIRD_REBALANCE", raising=False)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def children(tmp_path_factory, ring_env):
    """Both children's outputs and their results directory."""
    out = tmp_path_factory.mktemp("global_mesh")
    np.savez(out / "ragged.npz", **sharded._ragged_arrays())
    coord = f"127.0.0.1:{free_port()}"
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               **sharded.ENV)
    env.pop("FIREBIRD_REBALANCE", None)
    child = str(ROOT / "tests" / "_torch_mp_ring_child.py")
    procs, logs = [], []
    try:
        for i in (0, 1):
            logs.append(open(out / f"child{i}.log", "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, child, str(i), coord, str(out)], env=env,
                stdout=logs[-1], stderr=subprocess.STDOUT, cwd=str(ROOT)))
        deadline = time.monotonic() + 240
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        texts = []
        for f in logs:
            f.seek(0)
            texts.append(f.read())
            f.close()
    for i, (p, text) in enumerate(zip(procs, texts)):
        assert p.returncode == 0 and f"CHILD_OK {i}" in text, text[-3000:]
    return out, texts


def _load(out, case, pid):
    return dict(np.load(out / f"{case}.{pid}.npz"))


def test_ragged_pair_across_processes_equals_the_one_process_ring(children):
    out, _ = children
    one = sharded._port(True)
    for pid in (0, 1):
        got = _load(out, "ragged", pid)
        for f in STORE:
            np.testing.assert_array_equal(
                got[f], getattr(one, f).numpy()[pid:pid + 1], err_msg=f)
        np.testing.assert_array_equal(got["lanes_migrated"],
                                      one.lanes_migrated.numpy()[pid:pid + 1])


def test_ragged_pair_across_processes_equals_jax(children):
    out, _ = children
    ref = sharded._jax_ring_on()
    for pid in (0, 1):
        got = _load(out, "ragged", pid)
        for f in ("n_segments", "procedure", "mask", "seg_meta"):
            np.testing.assert_array_equal(
                got[f], np.asarray(getattr(ref, f))[pid:pid + 1], err_msg=f)
        np.testing.assert_allclose(
            got["seg_rmse"], np.asarray(ref.seg_rmse)[pid:pid + 1],
            rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(
            got["seg_mag"], np.asarray(ref.seg_mag)[pid:pid + 1],
            rtol=5e-3, atol=1e-2)


def test_lanes_migrated_across_processes_equal_jax(children):
    out, _ = children
    ref = np.asarray(sharded._jax_ring_on().lanes_migrated)
    got = np.concatenate([_load(out, "ragged", p)["lanes_migrated"]
                          for p in (0, 1)])
    np.testing.assert_array_equal(got, ref)
    assert got.sum() > 0


def test_cadences_and_retry_agree_and_equal_detect_packed(children):
    out, _ = children
    caps = set()
    for pid in (0, 1):
        got = _load(out, "cadence", pid)
        caps.add(int(got["wcap_local"]))
        for f in ("n_segments", "seg_meta", "seg_coef", "seg_rmse", "mask"):
            a, b = got[f], got[f"ref_{f}"]
            if a.ndim >= 3 and f != "mask":
                S = min(a.shape[2], b.shape[2])
                a, b = a[:, :, :S], b[:, :, :S]
            np.testing.assert_array_equal(a, b, err_msg=f)
        # the capacity retry fired (it started at 1)
        assert got["seg_meta"].shape[2] >= 2, got["seg_meta"].shape
        assert got["lanes_migrated"].shape == (2,)
    # the two cadences gave the processes different window caps
    assert len(caps) == 2, caps


def test_a_payload_signature_that_differs_raises_in_both(children):
    _, texts = children
    for pid, text in enumerate(texts):
        line = next(ln for ln in text.splitlines()
                    if ln.startswith(f"MISMATCH_RAISED {pid}"))
        assert "payload signature" in line and "differs" in line, line


class _Mesh:
    """A two-process mesh seen from one process, its store a dict."""

    def __init__(self, me, store):
        self.process, self.owners = me, (0, 1)
        self.local, self.store, self.seq = range(me, me + 1), store, 0

    def __len__(self):
        return 2

    def next_seq(self):
        self.seq += 1
        return self.seq

    def post(self, key, value):
        self.store[key] = value

    def take(self, key, what):
        return self.store.pop(key)


def test_a_sender_refuses_a_receiver_planned_for_another_payload(
        monkeypatch):
    """A sender whose payload's signature differs from the one its
    receiver planned for writes nothing, posts the error for the receiver
    and raises by name."""
    monkeypatch.setattr(torch.distributed, "irecv", lambda *a, **k: None)
    store = {}
    ours = [torch.zeros(4, dtype=torch.int32)]
    store["fb/ring/1/1>0/ready"] = dict(sig=cuda_ops.ring_signature(
        [torch.zeros(5, dtype=torch.int32)]))
    with pytest.raises(ValueError, match="payload signature differs"):
        cuda_ops._hop_across([ours], +1, _Mesh(1, store), kernel=False)
    assert "differs" in store["fb/ring/1/1>0/done"]["error"]


def test_a_device_list_never_spans_processes():
    assert not tmesh.spans_processes(["cpu", "cpu"])
    one = tmesh.make_mesh(["cpu", "cpu"])
    assert not tmesh.spans_processes(one) and len(one) == 2
    assert list(one.local) == [0, 1]


def test_a_card_hop_keeps_no_buffer_and_closes_its_mappings_after_the_copy(
        monkeypatch):
    """The card's hop seen from process 1 of two, its IPC halves faked on
    the CPU: the receive buffer is the hop's own (the views returned hold
    it, and nothing else once they are gone), and every mapping the hop
    opened is released only after its "copy done" was waited on."""
    import gc
    import weakref

    log, bufs = [], []

    class Done:
        def synchronize(self):
            log.append("synchronized")

    def receive(pair, leaves, dev, msg):
        plan = cuda_ops.ring_plan(leaves)
        buf = torch.full((plan.total,), 7, dtype=torch.uint8)
        bufs.append(weakref.ref(buf))
        return buf, plan

    def send(pair, leaves, src, ready, msg):
        log.append(("sent", pair))
        return object(), Done()

    class Stream:
        def wait_event(self, ev):
            log.append("waited")

    monkeypatch.setattr(cuda_ops, "_ipc_receive", receive)
    monkeypatch.setattr(cuda_ops, "_ipc_send", send)
    monkeypatch.setattr(cuda_ops, "_peer_event", lambda h, d: h)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: Stream())
    ours = [torch.zeros(4, dtype=torch.int32)]
    store = {"fb/ring/1/1>0/ready": dict(sig=cuda_ops.ring_signature(ours)),
             "fb/ring/1/0>1/done": dict(done=b"handle")}
    got = cuda_ops._hop_across([ours], +1, _Mesh(1, store), kernel=True)
    assert log == [("sent", (1, 0)), "waited", "synchronized"]
    assert got[0][0].dtype == torch.int32 and "fb/ring/1/1>0/done" in store
    del got
    gc.collect()
    assert [r() for r in bufs] == [None]
