"""The chip batch sharded over a list of devices, and the rebalancing ring.

The counterpart of ``firebird_tpu/parallel/mesh.py``'s ``detect_sharded``
and its straggler-rebalancing ring (FIREBIRD_REBALANCE).  A "mesh" here is
a list of devices, one per shard; a device may repeat, so two shards on
``cuda:0`` lay the ring out on one card and ``["cpu", "cpu"]`` on the CPU.
Shard ``i`` takes chips ``[i*C/n, (i+1)*C/n)``.  One host thread drives
every shard, as JAX's single-controller ``shard_map`` does, running the
shards' phases in turn: each shard's stage-1 loop, then (with the ring on)
the exchange at the stage-2 boundary, each shard's tail, the exchange
back, and each shard's result.

Across processes (one process per card, ``parallel.dist``).  A device
list is process-local: the driver's per-process dispatch
(``driver.core.host_shard``) runs over its own chips and never
synchronizes, as the JAX package's host-local meshes must not.  A global
mesh (:func:`make_mesh` after ``init_distributed``) lists every process's
shards in ring order, as JAX's global mesh does; :func:`detect_sharded`
over it takes the process's local chip slice (JAX's
``make_array_from_process_local_data``) and returns that slice's
ChipSegments on the process's device.  Only then do the processes agree,
through the run's store, each wait bounded by the mesh's timeout: on the
dispatch's shape and route, on the window cap (``_wcap_global_max``, a
MAX), on the capacity retry (``read_worst``, a MAX), and, with the ring
on, on the stage-2 carry's signature (shapes and dtypes).  A mismatch
raises by name in every process.  The ring's hop to a shard of another
process is ``cuda_ops.ring_remote_copy`` into the receiver's buffer
mapped by CUDA IPC (gloo send/receive on the CPU), where JAX uses
``lax.ppermute`` or the Pallas remote DMA.

The ring (``mesh.py``'s block comment): compaction leaves each shard with
its own residue of working lanes, so without migration every shard waits
for the slowest one's tail.  At the bucketed-tail boundary the survivors
sit in a dense prefix of each chip.  A shard whose working lanes exceed
its right neighbour's by more than ``threshold`` of its stage-2 lanes
sheds half the gap: its whole stage-2 carry moves one hop rightward, the
neighbour runs its tail over its own chips and the guest chips (only the
donated lanes active there, the donor's copies parked DONE), and the
guests' results move back and merge into the donor's rows by position
(the tail pins lane order).  The results are those of the ring-off
dispatch.  Each hop is one :func:`cuda_ops.ring_remote_copy` call, one
kernel launch per source shard: the count probe, the migration out and
the migration back.
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import itertools
import pickle
from typing import Callable

import numpy as np
import torch

from firebird_tpu_torch.ccd import cuda_ops, kernel, params
from firebird_tpu_torch.ccd.compact import pixel_axis
from firebird_tpu_torch.ccd.round_state import PHASE_DONE
from firebird_tpu_torch.ccd.sensor import LANDSAT_ARD


def _flatten(tree):
    """The tensors of a nest of dicts, tuples and lists, in a fixed order,
    and the function that rebuilds the nest from an iterator over such
    tensors."""
    if torch.is_tensor(tree):
        return [tree], next
    if isinstance(tree, dict):
        parts = [(k, _flatten(v)) for k, v in tree.items()]
        return ([x for _, (xs, _) in parts for x in xs],
                lambda it: {k: build(it) for k, (_, build) in parts})
    if isinstance(tree, (tuple, list)):
        parts = [_flatten(v) for v in tree]
        return ([x for xs, _ in parts for x in xs],
                lambda it: type(tree)(build(it) for _, build in parts))
    raise TypeError(f"not a tensor, dict, tuple or list: {type(tree)}")


def _map(fn, *trees):
    """``fn`` over the tensors of nests of one structure."""
    leaves = [_flatten(t) for t in trees]
    return leaves[0][1](iter([fn(*xs) for xs in zip(*(l for l, _ in leaves))]))


@dataclasses.dataclass(frozen=True)
class RebalanceSpec:
    """The rebalancing ring of one dispatch: ``n`` shards, the donation
    ``threshold`` (the gap of working lanes to the right neighbour, as a
    share of a shard's stage-2 lanes, beyond which a shard sheds half the
    gap), and the ``hop`` that moves payloads
    (:func:`cuda_ops.ring_remote_copy` unless given; the route's, so that
    ``ops=cuda_ops.PLAIN`` moves them with the plain copy)."""

    n: int = 1
    threshold: float = 0.25
    hop: Callable | None = None

    def _move(self, trees, shift):
        # Every shard's nest has one structure (across processes the
        # signature agreement holds it), so each receiver rebuilds what
        # arrived with its own.
        flat = [_flatten(t) for t in trees]
        moved = (self.hop or cuda_ops.ring_remote_copy)(
            [leaves for leaves, _ in flat], shift)
        return [build(iter(m)) for (_, build), m in zip(flat, moved)]

    def to_right(self, trees):
        """One hop rightward: shard i's nest lands on shard i+1; returns,
        per shard, what arrived from its left neighbour."""
        return self._move(trees, +1)

    def to_left(self, trees):
        """One hop leftward (the return path, and the count probe): returns,
        per shard, its right neighbour's nest."""
        return self._move(trees, -1)


def rebalance_spec(devices, rebalance=None) -> RebalanceSpec | None:
    """The dispatch's ring over ``devices`` (a device list, or a
    :class:`Mesh`: every process's shards), or None when it is off
    (``rebalance``; None reads FIREBIRD_REBALANCE, default off) or there is
    one shard."""
    if not kernel.rebalance_mode(rebalance) or len(devices) < 2:
        return None
    return RebalanceSpec(n=len(devices),
                         threshold=kernel.rebalance_threshold())


def rebalance_tail_out(st2s, shareds, spec: RebalanceSpec, bucket: int):
    """The migration half of the ring at the stage-2 boundary.

    ``st2s`` holds each shard's stage-2 carry (``BatchLoop.stage1``'s),
    ``shareds`` each shard's designs.  Each shard compares its working
    lanes with its right neighbour's (the count probe) and, past the
    threshold, donates half the gap, taken from the end of its chips'
    dense prefixes.  Then every carry moves one hop rightward.  Returns,
    per shard, ``(cats, shcats, donated, lanes_migrated)``: own + guest
    chips concatenated on the chip axis (the guest lanes active only where
    their donor shed them, the donor's own copies parked DONE), their
    designs likewise, the donated lanes [C, bucket] (kept for the merge
    back) and the lanes each chip donated [C] int32 —
    mesh.rebalance_tail_out."""
    C = st2s[0]["phase"].shape[0]
    n_alive_c = [(st["phase"] != PHASE_DONE).sum(-1, dtype=torch.int32)
                 for st in st2s]
    na = [n.sum(dtype=torch.int32).reshape(1) for n in n_alive_c]
    na_right = [d["na"] for d in spec.to_left([{"na": x} for x in na])]
    thresh = max(int(spec.threshold * C * bucket), 1)
    donated = []
    for n_c, n, n_r in zip(n_alive_c, na, na_right):
        gap = n - n_r
        give = torch.where(gap > thresh, gap // 2, torch.zeros_like(gap))
        # Global lane index over the shard's dense prefixes: the donated
        # set is the last ``give`` working lanes, from the last chips.
        off = n_c.cumsum(0, dtype=torch.int32) - n_c
        lane = torch.arange(bucket, dtype=torch.int32, device=n_c.device)
        g_idx = off[:, None] + lane[None, :]
        donated.append((lane[None, :] < n_c[:, None]) & (g_idx >= n - give))
    guests = spec.to_right([(st, sh, d)
                            for st, sh, d in zip(st2s, shareds, donated)])
    cat = lambda a, b: torch.cat([a, b], 0)
    cats, shcats = [], []
    for st, sh, don, (g_st, g_sh, g_don) in zip(st2s, shareds, donated,
                                               guests):
        own = dict(st, phase=torch.where(don, PHASE_DONE, st["phase"]))
        guest = dict(g_st, phase=torch.where(g_don, g_st["phase"],
                                             PHASE_DONE))
        cats.append(_map(cat, own, guest))
        shcats.append(_map(cat, sh, g_sh))
    return cats, shcats, donated, [d.sum(-1, dtype=torch.int32)
                                   for d in donated]


def rebalance_tail_back(stcats, donated, spec: RebalanceSpec, C: int):
    """The migration back: each shard's guest chips' outputs (``nseg``,
    ``alive``, ``bufs``) move one hop leftward to their owner, which
    merges them into the rows it donated — by position, since the tail
    pinned the lane order.  Returns each shard's stage-2 carry of its own
    chips — mesh.rebalance_tail_back."""
    rets = spec.to_left([
        {"nseg": st["nseg"][C:], "alive": st["alive"][C:],
         "bufs": tuple(b[C:] for b in st["bufs"])} for st in stcats])

    def pick(don, own, ret, key):
        shape = [1] * own.ndim
        shape[0], shape[pixel_axis(key)] = don.shape
        return torch.where(don.reshape(shape), ret, own)

    out = []
    for st, ret, don in zip(stcats, rets, donated):
        own = _map(lambda a: a[:C], st)
        out.append(dict(
            own, nseg=pick(don, own["nseg"], ret["nseg"], "nseg"),
            alive=pick(don, own["alive"], ret["alive"], "alive"),
            bufs=tuple(pick(don, o, r, "bufs")
                       for o, r in zip(own["bufs"], ret["bufs"]))))
    return out


# ---------------------------------------------------------------------------
# The global mesh: every process's shards, and agreement across processes
# ---------------------------------------------------------------------------

# The number of the next cross-process exchange.  Every process of a run
# makes the same exchanges in the same order (meshes, agreements, ring
# hops), so the numbers agree and name the store's keys.
_SEQ = itertools.count()
# How long any exchange waits for another process before it raises.
MESH_TIMEOUT_S = 300.0


class MeshMismatch(ValueError):
    """The processes of a global mesh disagree on something every one of
    them must hold alike (the dispatch, the ring's payload)."""


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A 1-D data mesh over every process's shards, in ring order (process
    0's shards, then process 1's, ...): ``devices[k]`` is shard ``k``'s
    device as its process names it, ``owners[k]`` that process; this
    process is ``process``.  :func:`make_mesh` builds it; every exchange
    through it waits at most ``timeout_s``."""

    devices: tuple
    owners: tuple
    process: int
    timeout_s: float = MESH_TIMEOUT_S

    def __len__(self) -> int:
        return len(self.devices)

    @property
    def local(self) -> range:
        """This process's shards: a contiguous run of ring positions."""
        mine = [k for k, o in enumerate(self.owners) if o == self.process]
        return range(mine[0], mine[-1] + 1)

    @property
    def local_devices(self) -> list:
        return [torch.device(self.devices[k]) for k in self.local]

    # ---- the store's messages (multi-process runs) ----

    def next_seq(self) -> int:
        return next(_SEQ)

    def post(self, key: str, value) -> None:
        from firebird_tpu_torch.parallel import dist

        dist.store().set(key, pickle.dumps(value))

    def take(self, key: str, what: str):
        """Wait for ``key`` (at most ``timeout_s``), read it and delete it;
        raises TimeoutError naming ``what``."""
        from firebird_tpu_torch.parallel import dist

        store = dist.store()
        try:
            store.wait([key], datetime.timedelta(seconds=self.timeout_s))
        except Exception as e:
            raise TimeoutError(f"global mesh: {what}: no answer within "
                               f"{self.timeout_s:g} s ({key})") from e
        value = pickle.loads(store.get(key))
        store.delete_key(key)
        return value

    def gather(self, what: str, value) -> list:
        """Every process's ``value`` for one exchange, in process order."""
        from firebird_tpu_torch.parallel import dist

        seq, store = self.next_seq(), dist.store()
        store.set(f"fb/mesh/{seq}/{self.process}", pickle.dumps(value))
        procs = sorted(set(self.owners))
        keys = [f"fb/mesh/{seq}/{p}" for p in procs]
        try:
            store.wait(keys, datetime.timedelta(seconds=self.timeout_s))
        except Exception as e:
            raise TimeoutError(f"global mesh: {what}: not every process "
                               f"answered within {self.timeout_s:g} s") from e
        return [pickle.loads(store.get(k)) for k in keys]

    def global_max(self, what: str, v: int) -> int:
        """The MAX of a host integer over the processes."""
        return max(int(x) for x in self.gather(what, int(v)))

    def agree(self, what: str, value) -> None:
        """Raise :class:`MeshMismatch`, in every process, unless every
        process holds the same ``value`` (a string or a plain nest)."""
        got = self.gather(what, value)
        if any(g != got[0] for g in got):
            raise MeshMismatch(f"global mesh: {what} differs across "
                               f"processes: "
                               + "; ".join(f"process {p}: {g}" for p, g in
                                           zip(sorted(set(self.owners)),
                                               got)))


def make_mesh(devices=None, timeout_s: float = MESH_TIMEOUT_S) -> Mesh:
    """The data mesh over every process's shards: this process's
    ``devices`` (default :func:`shard_devices`' — in a multi-process run,
    this process's card) and, after ``parallel.init_distributed``, every
    other process's, exchanged through the run's store, in process order.
    Every process of the run calls it together.  Sets the
    ``mesh_devices`` gauge."""
    from firebird_tpu_torch.obs import metrics as obs_metrics
    from firebird_tpu_torch.parallel import dist

    local = [str(d) for d in shard_devices(devices)]
    me = dist.process_index()
    if dist.process_count() > 1:
        mesh = Mesh((), tuple(range(dist.process_count())), me, timeout_s)
        lists = mesh.gather("the devices of every process", local)
    else:
        lists = [local]
    mesh = Mesh(tuple(d for ds in lists for d in ds),
                tuple(p for p, ds in enumerate(lists) for _ in ds), me,
                timeout_s)
    # Topology gauge for /metrics and the fleet report (merge "max": the
    # same on every process of a global mesh).
    obs_metrics.gauge("mesh_devices",
                      help="devices in the active data mesh").set(len(mesh))
    return mesh


def spans_processes(mesh) -> bool:
    """True when ``mesh`` holds shards of other processes: the one
    predicate deciding whether a dispatch takes its local chip slice and
    agrees across processes.  A device list never does."""
    return isinstance(mesh, Mesh) and len(set(mesh.owners)) > 1


def shard_devices(devices=None) -> list:
    """The shards' devices: ``devices`` as given (repeats allowed), or
    every visible CUDA device once — in a multi-process run, this
    process's own card only (``parallel.dist.local_device``).  Raises
    without a CUDA device unless the caller names the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass devices="
                               "['cpu', ...] to shard on the CPU")
        from firebird_tpu_torch.parallel import dist

        if dist.process_count() > 1:
            return [dist.local_device()]
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    out = []
    for d in devices:
        d = kernel.resolve_device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    if not out:
        raise ValueError("detect_sharded needs at least one device")
    return out


def _concat(segs, migrated, dev):
    """The shards' ChipSegments concatenated on the chip axis on ``dev``."""
    out = {}
    for f in dataclasses.fields(kernel.ChipSegments):
        vals = (migrated if f.name == "lanes_migrated"
                else [getattr(s, f.name) for s in segs])
        out[f.name] = (None if vals is None or vals[0] is None
                       else torch.cat([v.to(dev) for v in vals], 0))
    return kernel.ChipSegments(**out)


def _dispatch(staged, devs, spec, mesh=None, **kw):
    """One dispatch of every shard: stage 1 each, the tails (through the
    ring when ``spec`` is given), the results.  Over a global ``mesh``
    with the ring on, the processes first agree on the stage-2 carry's
    signature (none where the shards skip the bucketed tail)."""
    with torch.no_grad():
        loops = [kernel.staged_loop(*args, **kw) for args in staged]
        st2s = [loop.stage1() for loop in loops]
        migrated = None
        if mesh is not None and spec is not None:
            mesh.agree("the ring's payload signature (the stage-2 carry)",
                       "none" if st2s[0] is None else
                       cuda_ops.ring_signature(
                           _flatten((st2s[0], loops[0].shared))[0]))
        if st2s[0] is not None:          # every shard has the same width
            if spec is not None:
                cats, shcats, donated, migrated = rebalance_tail_out(
                    st2s, [loop.shared for loop in loops], spec,
                    loops[0].bucket)
                tails = [loop.tail(c, shared=sh, pinned=True)
                         for loop, c, sh in zip(loops, cats, shcats)]
                st2s = rebalance_tail_back(tails, donated, spec, loops[0].C)
            else:
                st2s = [loop.tail(s) for loop, s in zip(loops, st2s)]
        segs = [loop.result(s) for loop, s in zip(loops, st2s)]
    if spec is not None and migrated is None:
        migrated = [torch.zeros(loop.C, dtype=torch.int32, device=d)
                    for loop, d in zip(loops, devs)]
    return _concat(segs, migrated, devs[0])


def detect_sharded(packed, devices=None, *, compact=None, fused=None,
                   pallas=None, rebalance=None, check_capacity: bool = True,
                   max_segments: int = kernel.MAX_SEGMENTS,
                   variogram_mode: str = params.VARIOGRAM_DEFAULT,
                   ops=None, mixed=None, dtype=None) -> kernel.ChipSegments:
    """Run the detector over a PackedChips batch with its chip axis
    sharded over ``devices`` (default: every visible CUDA device once) ->
    ChipSegments [C, P, ...] on the first shard's device.

    ``devices`` may be a :class:`Mesh` (:func:`make_mesh`).  One that spans
    processes takes ``packed`` as this process's local chip slice, runs it
    on this process's shards with every other process's (the ring's hops
    crossing between processes), and returns that slice's ChipSegments on
    this process's first device; the processes agree on the dispatch, the
    window cap and the capacity retry.  One that does not is its local
    device list.

    The chip count must divide evenly over the (local) shards.  ``compact``,
    ``fused``, ``pallas``, ``ops``, ``mixed``, ``dtype``, ``max_segments``,
    ``check_capacity`` and ``variogram_mode`` are
    :func:`kernel.detect_packed`'s; the
    capacity retry re-runs every shard.  ``rebalance`` turns the ring on
    or off (None reads FIREBIRD_REBALANCE, default off; the threshold is
    FIREBIRD_REBALANCE_THRESHOLD's); it acts only where the shards take
    the bucketed tail.  ``rounds`` and ``round_counts`` are each shard's,
    on its chips; ``compactions`` sits on each shard's first chip;
    ``lanes_migrated`` is None with the ring off."""
    mesh = devices if spans_processes(devices) else None
    if isinstance(devices, Mesh):
        devices = devices.local_devices
    devs = shard_devices(devices)
    n, C = len(devs), packed.n_chips
    if C % n:
        raise ValueError(f"chip batch ({C}) must divide evenly over {n} "
                         f"shards — pad the batch")
    route = kernel.pallas_components(pallas, ops, mixed, dtype)
    spec = rebalance_spec(devs if mesh is None else mesh, rebalance)
    if spec is not None:
        spec = dataclasses.replace(
            spec, hop=route.ring_remote_copy if mesh is None else
            functools.partial(route.ring_remote_copy, mesh=mesh))
    per = C // n
    staged = [tuple(torch.from_numpy(np.ascontiguousarray(a[i * per:
                                                            (i + 1) * per]))
                    .to(d) for a in kernel.wire_args(packed))
              for i, d in enumerate(devs)]
    kw = dict(W=kernel.window_cap(packed),
              sensor=getattr(packed, "sensor", LANDSAT_ARD),
              variogram_mode=variogram_mode, ops=route,
              fused=kernel.fused_mode(fused),
              compact=kernel.compact_mode(compact))
    read_worst = lambda seg: int(seg.n_segments.max())
    if mesh is not None:
        # Every process runs one program of hops and retries: agree on
        # its shape first, then on the window cap, and on every retry.
        mesh.agree("the sharded dispatch", repr((
            tuple(packed.spectra.shape[1:]), per, kw["sensor"].name,
            str(route.dtype), route.components, route.mixed,
            route.ring_remote_copy.__name__, kw["fused"],
            kw["compact"], variogram_mode, spec is not None,
            check_capacity)))
        kw["W"] = mesh.global_max("the window cap", kw["W"])
        read_worst = lambda seg: mesh.global_max(
            "the capacity retry's deepest pixel", int(seg.n_segments.max()))
    dispatch = lambda S: kernel.record_first_call(
        ("sharded", tuple(packed.spectra.shape), tuple(map(str, devs)),
         str(route.dtype), kw["W"], kw["sensor"].name, S, kw["compact"],
         kw["fused"], route.mixed, spec is not None, mesh is not None),
        lambda: _dispatch(staged, devs, spec, mesh, max_segments=S, **kw))
    if not check_capacity:
        return dispatch(max(max_segments, 1))
    return kernel.capacity_retry(dispatch, read_worst, max_segments,
                                 kernel.capacity_bound(packed))
