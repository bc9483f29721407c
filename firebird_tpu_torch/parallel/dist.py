"""One process per card: bring-up of a multi-process run.

The port's counterpart of the JAX package's ``parallel/dist.py``.  A run
of N processes is launched by torchrun (``torchrun --nproc-per-node N -m
firebird_tpu_torch changedetection ...``), which gives each process
MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK;
:func:`init_distributed` reads them (or its arguments), brings up a
``torch.distributed.TCPStore`` on the coordinator's address (torch's
``tcp://`` rendezvous) and a **gloo** process group on that store, and
records the topology.

CCDC is embarrassingly parallel over chips: each process runs the whole
pipeline on its strided share of the tile's chips
(``driver.core.host_shard``) on its own card (:func:`local_device`), and
what the processes exchange is a host scalar or a string — the run id
through the store's key-value API (``driver.core.fleet_run_id``), the
report shards on disk.  A global mesh (``parallel.mesh.make_mesh``) also
agrees on a few host scalars through the store, and its rebalancing ring
moves the stage-2 carry between processes: on the card by CUDA IPC into
the receiver's buffer (``ccd.cuda_ops.ring_remote_copy``), on the CPU by
gloo send/receive.  So the group is gloo, never NCCL: NCCL refuses two
ranks on one card.
"""

from __future__ import annotations

import datetime
import os

import torch

from firebird_tpu_torch.obs import logger

log = logger("change-detection")

# The bring-up's state (store, world, rank, local_rank); empty for a
# single-process run.
_state: dict = {}


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return default if v in (None, "") else int(v)


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Bring up the process group from the arguments or torchrun's
    environment (``coordinator`` is ``host:port``; default
    MASTER_ADDR:MASTER_PORT; ``num_processes`` WORLD_SIZE;
    ``process_id`` RANK).

    Returns True when a multi-process run was brought up, False for a
    single-process one (no coordinator, or one process) — callers need no
    branching.  Idempotent: a second call returns the first's answer.
    """
    if _state:
        return _state["world"] > 1
    if coordinator is None and os.environ.get("MASTER_ADDR"):
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
    world = num_processes or _env_int("WORLD_SIZE", 1)
    if not coordinator or world <= 1:
        return False
    rank = process_id if process_id is not None else _env_int("RANK", 0)
    local_rank = _env_int("LOCAL_RANK", rank)
    host, _, port = coordinator.rpartition(":")
    import torch.distributed as tdist

    timeout = datetime.timedelta(seconds=300)
    # torch's own tcp:// rendezvous: the TCPStore's server runs in process
    # 0, or in torchrun's agent when the agent hosts it
    # (TORCHELASTIC_USE_AGENT_STORE); the group and the run-id exchange
    # both use it.
    url = f"tcp://{host or '127.0.0.1'}:{port}?rank={rank}&world_size={world}"
    store, rank, world = next(tdist.rendezvous(url, timeout=timeout))
    if not tdist.is_initialized():
        tdist.init_process_group("gloo", store=store, rank=rank,
                                 world_size=world, timeout=timeout)
    _state.update(store=store, world=world, rank=rank,
                  local_rank=local_rank)
    if torch.cuda.is_available():
        torch.cuda.set_device(local_device())
    log.info("torch.distributed up: %d processes (gloo), process %d",
             world, rank)
    # Topology gauges feed /metrics and the merged fleet report
    # (identical in every process: merge policy "max", obs/metrics.py);
    # mark_mesh_up is the /readyz mesh half of an already-registered run.
    from firebird_tpu_torch.obs import metrics as obs_metrics
    from firebird_tpu_torch.obs import server as obs_server

    obs_metrics.gauge("mesh_processes",
                      help="torch.distributed process count").set(world)
    obs_metrics.gauge("mesh_global_devices",
                      help="cards the processes run on").set(
                          global_device_count())
    obs_server.mark_mesh_up()
    return True


def is_initialized() -> bool:
    return bool(_state)


def process_count() -> int:
    return _state.get("world", 1)


def process_index() -> int:
    return _state.get("rank", 0)


def local_device() -> torch.device:
    """This process's card: ``cuda:{LOCAL_RANK % device_count}`` (two
    processes on a one-card host share ``cuda:0``).  Raises without a
    card: a run on the CPU names its device itself."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' (--device cpu) to run on the CPU")
    return torch.device(
        "cuda", _state.get("local_rank", 0) % torch.cuda.device_count())


def global_device_count() -> int:
    """The cards the processes of a one-host launch run on: one each,
    processes beyond the host's cards sharing them."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return min(process_count(), n) if n else 0


def store():
    """The bring-up's key-value store (multi-process runs only): the
    global mesh's agreements and the ring's messages travel through it."""
    if "store" not in _state:
        raise RuntimeError("torch.distributed is not brought up: call "
                           "parallel.init_distributed first")
    return _state["store"]


def kv_set(key: str, value: str) -> None:
    """Set ``key`` in the bring-up's store (multi-process runs only)."""
    _state["store"].set(key, value)


def kv_get(key: str, timeout_ms: int) -> str:
    """Wait up to ``timeout_ms`` for ``key`` in the store, then read it."""
    store = _state["store"]
    store.wait([key], datetime.timedelta(milliseconds=timeout_ms))
    return store.get(key).decode()


def shutdown() -> None:
    """Take the group down (tests; a launch's processes just exit)."""
    import torch.distributed as tdist

    if tdist.is_initialized():
        tdist.destroy_process_group()
    _state.clear()


__all__ = ["init_distributed", "is_initialized", "process_count",
           "process_index", "local_device", "global_device_count",
           "store", "kv_set", "kv_get", "shutdown"]
