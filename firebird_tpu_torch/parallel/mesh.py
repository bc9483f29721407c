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
        flat = [_flatten(t) for t in trees]
        moved = (self.hop or cuda_ops.ring_remote_copy)(
            [leaves for leaves, _ in flat], shift)
        return [flat[(j - shift) % self.n][1](iter(moved[j]))
                for j in range(self.n)]

    def to_right(self, trees):
        """One hop rightward: shard i's nest lands on shard i+1; returns,
        per shard, what arrived from its left neighbour."""
        return self._move(trees, +1)

    def to_left(self, trees):
        """One hop leftward (the return path, and the count probe): returns,
        per shard, its right neighbour's nest."""
        return self._move(trees, -1)


def rebalance_spec(devices, rebalance=None) -> RebalanceSpec | None:
    """The dispatch's ring, or None when it is off (``rebalance``; None
    reads FIREBIRD_REBALANCE, default off) or there is one shard."""
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


def shard_devices(devices=None) -> list:
    """The shards' devices: ``devices`` as given (repeats allowed), or
    every visible CUDA device once.  Raises without a CUDA device unless
    the caller names the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass devices="
                               "['cpu', ...] to shard on the CPU")
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


def _dispatch(staged, devs, spec, **kw):
    """One dispatch of every shard: stage 1 each, the tails (through the
    ring when ``spec`` is given), the results."""
    with torch.no_grad():
        loops = [kernel.staged_loop(*args, **kw) for args in staged]
        st2s = [loop.stage1() for loop in loops]
        migrated = None
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
                   ops=None, mixed=None) -> kernel.ChipSegments:
    """Run the detector over a PackedChips batch with its chip axis
    sharded over ``devices`` (default: every visible CUDA device once) ->
    ChipSegments [C, P, ...] on the first shard's device.

    The chip count must divide evenly over the shards.  ``compact``,
    ``fused``, ``pallas``, ``ops``, ``mixed``, ``max_segments``,
    ``check_capacity`` and ``variogram_mode`` are
    :func:`kernel.detect_packed`'s; the
    capacity retry re-runs every shard.  ``rebalance`` turns the ring on
    or off (None reads FIREBIRD_REBALANCE, default off; the threshold is
    FIREBIRD_REBALANCE_THRESHOLD's); it acts only where the shards take
    the bucketed tail.  ``rounds`` and ``round_counts`` are each shard's,
    on its chips; ``compactions`` sits on each shard's first chip;
    ``lanes_migrated`` is None with the ring off."""
    devs = shard_devices(devices)
    n, C = len(devs), packed.n_chips
    if C % n:
        raise ValueError(f"chip batch ({C}) must divide evenly over {n} "
                         f"shards — pad the batch")
    route = kernel.pallas_components(pallas, ops, mixed)
    spec = rebalance_spec(devs, rebalance)
    if spec is not None:
        spec = dataclasses.replace(spec, hop=route.ring_remote_copy)
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
    dispatch = lambda S: _dispatch(staged, devs, spec, max_segments=S, **kw)
    if not check_capacity:
        return dispatch(max(max_segments, 1))
    return kernel.capacity_retry(dispatch,
                                 lambda seg: int(seg.n_segments.max()),
                                 max_segments, kernel.capacity_bound(packed))
