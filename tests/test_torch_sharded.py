"""The port's sharded dispatch and rebalancing ring against the JAX package.

The forced-ragged workload of ``tests/test_fuse.py``'s ring test (two
48-lane chips: sixteen long-lived standard pixels, half with a break, on
one chip, two on the other, the rest fill) goes through
``firebird_tpu_torch.parallel.detect_sharded(devices=["cpu", "cpu"])``
with the ring on and off, and through the JAX package's
``detect_sharded`` on a simulated 2-device mesh with the ring on
(FIREBIRD_COMPACT_MIN_LANES=8 so the 48 lanes take the bucketed tail,
threshold 0.1).  The ring moves lanes between shards and back, so the
store fields must equal the ring-off dispatch and the unsharded one, the
migrated lanes the JAX package's, and the decisions the JAX package's.
The plain version of ``ring_remote_copy`` is checked on its own.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firebird_tpu.ccd import params as jparams
from firebird_tpu.ccd import synthetic
from firebird_tpu.ingest.packer import PackedChips as JPackedChips
from firebird_tpu_torch.ccd import cuda_ops
from firebird_tpu_torch.ccd import kernel as tk
from firebird_tpu_torch.ingest.packer import PackedChips as TPackedChips
from firebird_tpu_torch.parallel import mesh as tmesh
from tests.test_compact import _grid

STORE = ("n_segments", "seg_meta", "seg_rmse", "seg_mag", "seg_coef", "mask",
         "procedure")
CPU2 = ["cpu", "cpu"]
ENV = {"FIREBIRD_COMPACT_MIN_LANES": "8",
       "FIREBIRD_REBALANCE_THRESHOLD": "0.1"}


@pytest.fixture(autouse=True, scope="module")
def _ring_env():
    mp = pytest.MonkeyPatch()
    for k, v in ENV.items():
        mp.setenv(k, v)
    mp.delenv("FIREBIRD_REBALANCE", raising=False)
    yield
    mp.undo()


def _ragged_arrays():
    """tests/test_fuse.py's forced-ragged pair of chips."""
    rng = np.random.default_rng(5)
    t = _grid()
    T, P = t.shape[0], 48

    def chip(n_std, brk):
        px = []
        for i in range(n_std):
            Y = synthetic.harmonic_series(t, rng)
            if brk and i % 2 == 0:
                Y[:, T // 2:] += 800.0
            px.append((Y, np.full(T, synthetic.QA_CLEAR, np.uint16)))
        while len(px) < P:
            px.append((np.full((7, T), jparams.FILL_VALUE, np.float64),
                       np.full(T, synthetic.QA_FILL, np.uint16)))
        return px

    Ys, Qs = [], []
    for px in (chip(16, True), chip(2, False)):
        Y, q = zip(*px)
        Ys.append(np.stack([np.asarray(y, np.int16)
                            for y in Y]).transpose(1, 0, 2))
        Qs.append(np.stack(q))
    return dict(cids=np.stack([np.zeros(2, np.int64), np.ones(2, np.int64)]),
                dates=np.stack([t, t]).astype(np.int32),
                spectra=np.stack(Ys), qas=np.stack(Qs),
                n_obs=np.array([T, T], np.int32))


@functools.lru_cache(maxsize=None)
def _jax_ring_on():
    from firebird_tpu.parallel import make_mesh
    from firebird_tpu.parallel.mesh import detect_sharded

    mp = pytest.MonkeyPatch()
    mp.setenv("FIREBIRD_PALLAS", "0")
    mp.setenv("FIREBIRD_REBALANCE", "1")
    try:
        return detect_sharded(JPackedChips(**_ragged_arrays()),
                              make_mesh(n_devices=2), dtype=jnp.float32,
                              compact=True)
    finally:
        mp.undo()


@functools.lru_cache(maxsize=None)
def _port(rebalance, **kw):
    return tmesh.detect_sharded(TPackedChips(**_ragged_arrays()), CPU2,
                                compact=True, rebalance=rebalance, **kw)


@pytest.fixture(scope="module")
def ring(_ring_env):
    return _jax_ring_on(), _port(True), _port(False)


def test_ring_on_equals_ring_off(ring):
    _, on, off = ring
    for f in STORE:
        assert torch.equal(getattr(on, f), getattr(off, f)), f
    assert off.lanes_migrated is None
    assert on.lanes_migrated.shape == (2,) and int(on.lanes_migrated.sum()) > 0


def test_lanes_migrated_match_jax(ring):
    ref, on, _ = ring
    np.testing.assert_array_equal(on.lanes_migrated.numpy(),
                                  np.asarray(ref.lanes_migrated))


def test_sharded_decisions_match_jax(ring):
    ref, on, _ = ring
    for f in ("n_segments", "procedure", "mask", "seg_meta", "rounds",
              "round_counts", "compactions", "occupancy"):
        np.testing.assert_array_equal(getattr(on, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    np.testing.assert_allclose(on.seg_rmse.numpy(), np.asarray(ref.seg_rmse),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(on.seg_mag.numpy(), np.asarray(ref.seg_mag),
                               rtol=5e-3, atol=1e-2)


def test_sharded_equals_unsharded(ring):
    _, on, _ = ring
    whole = tk.detect_packed(TPackedChips(**_ragged_arrays()), device="cpu",
                             compact=True)
    for f in STORE:
        assert torch.equal(getattr(on, f), getattr(whole, f)), f
    # one loop's compaction count on each shard's first chip
    assert on.compactions.shape == (2,)


def test_ring_hops_through_the_route(ring):
    """Three hops a dispatch (count probe, out, back), each one call of
    the route's ring_remote_copy; none with the ring off."""
    calls = []

    def spy(name):
        fn = getattr(cuda_ops.PLAIN, name)
        return lambda *a, **k: calls.append(name) or fn(*a, **k)

    ops = type(cuda_ops.PLAIN)(**{n: spy(n) for n in vars(cuda_ops.PLAIN)})
    p = TPackedChips(**_ragged_arrays())
    on = tmesh.detect_sharded(p, CPU2, compact=True, rebalance=True, ops=ops,
                              check_capacity=False)
    assert calls.count("ring_remote_copy") == 3
    for f in STORE:
        assert torch.equal(getattr(on, f), getattr(ring[1], f)), f
    calls.clear()
    tmesh.detect_sharded(p, CPU2, compact=True, rebalance=False, ops=ops,
                         check_capacity=False)
    assert "ring_remote_copy" not in calls


@pytest.mark.parametrize("fused", [1, "mon"])
def test_ring_on_equals_ring_off_fused_routes(fused):
    on, off = _port(True, fused=fused), _port(False, fused=fused)
    assert int(on.lanes_migrated.sum()) > 0
    for f in STORE:
        assert torch.equal(getattr(on, f), getattr(off, f)), f


def test_ring_without_bucketed_tail_migrates_nothing(monkeypatch):
    monkeypatch.setenv("FIREBIRD_COMPACT_MIN_LANES", "1024")
    p = TPackedChips(**_ragged_arrays())
    on = tmesh.detect_sharded(p, CPU2, compact=True, rebalance=True)
    assert on.lanes_migrated.tolist() == [0, 0]


def test_uneven_chip_split_raises():
    with pytest.raises(ValueError, match="divide evenly"):
        tmesh.detect_sharded(TPackedChips(**_ragged_arrays()),
                             ["cpu"] * 3)


def test_shard_devices_default_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.shard_devices()
    assert tmesh.shard_devices(CPU2) == [torch.device("cpu")] * 2


def test_rebalance_spec_resolution(monkeypatch):
    monkeypatch.delenv("FIREBIRD_REBALANCE", raising=False)
    assert tmesh.rebalance_spec(CPU2) is None
    monkeypatch.setenv("FIREBIRD_REBALANCE", "1")
    monkeypatch.setenv("FIREBIRD_REBALANCE_THRESHOLD", "0.5")
    spec = tmesh.rebalance_spec(CPU2)
    assert spec.n == 2 and spec.threshold == 0.5
    assert tmesh.rebalance_spec(["cpu"]) is None
    assert tmesh.rebalance_spec(CPU2, rebalance=False) is None
    monkeypatch.delenv("FIREBIRD_REBALANCE_THRESHOLD")
    assert tmesh.rebalance_spec(CPU2, rebalance=True).threshold == 0.25


# ---------------------------------------------------------------------------
# ring_remote_copy's plain version
# ---------------------------------------------------------------------------

def _payload(rng, i):
    """Mixed dtypes, byte counts off multiples of 16, a 0-d tensor."""
    return [torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)),
            torch.from_numpy(rng.integers(-9, 9, (7,)).astype(np.int16)),
            torch.from_numpy(rng.random((2, 3, 3)) < 0.5),
            torch.tensor(i, dtype=torch.int64),
            torch.from_numpy(rng.integers(0, 255, (13,)).astype(np.uint8)),
            torch.zeros(0, 4)]


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("shift", [1, -1])
def test_ring_remote_copy_plain_rotates(n, shift):
    rng = np.random.default_rng(n)
    payloads = [_payload(rng, i) for i in range(n)]
    for fn in (cuda_ops.ring_remote_copy_plain, cuda_ops.ring_remote_copy):
        out = fn(payloads, shift)
        for i in range(n):
            got = out[(i + shift) % n]
            assert len(got) == len(payloads[i])
            for a, b in zip(got, payloads[i]):
                assert a.dtype == b.dtype and a.shape == b.shape
                assert torch.equal(a, b)
                assert a.numel() == 0 or a.data_ptr() != b.data_ptr()


def test_ring_remote_copy_refuses_bad_payloads():
    x = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_ops.ring_remote_copy([[x.t()], [x]], 1)
    with pytest.raises(ValueError, match="no tensors"):
        cuda_ops.ring_remote_copy([[x], []], 1)


def test_ring_spec_moves_nests():
    spec = tmesh.RebalanceSpec(n=3)
    trees = [{"a": torch.full((2,), i), "b": (torch.tensor(i),
                                             torch.zeros(1, i + 1))}
             for i in range(3)]
    right = spec.to_right(trees)
    left = spec.to_left(trees)
    for j in range(3):
        assert int(right[j]["a"][0]) == (j - 1) % 3
        assert right[j]["b"][1].shape == (1, (j - 1) % 3 + 1)
        assert int(left[j]["b"][0]) == (j + 1) % 3


def test_capacity_retry_reruns_every_shard():
    p = TPackedChips(**_ragged_arrays())
    full = _port(True)
    small = tmesh.detect_sharded(p, CPU2, compact=True, rebalance=True,
                                 max_segments=1)
    S = int(full.n_segments.max())
    assert S >= 2 and small.seg_meta.shape[2] >= S
    assert torch.equal(small.n_segments, full.n_segments)
    assert torch.equal(small.seg_meta[:, :, :S], full.seg_meta[:, :, :S])
    assert dataclasses.fields(small) == dataclasses.fields(full)


@pytest.mark.parametrize("argv, shards, compact", [
    (["--shards", "2", "--compact", "1"], 2, True),
    (["--compact", "0"], 1, False)], ids=["sharded", "compact_off"])
def test_cli_shards_and_compact_flags(capsys, monkeypatch, argv, shards,
                                      compact):
    import json

    from firebird_tpu_torch.__main__ import main

    monkeypatch.setenv("FIREBIRD_REBALANCE", "1")
    main(["detect", "--chips", "2", "--start", "1995-01-01", "--end",
          "1996-06-01", "--sensor", "landsat-ard-tiny", "--device", "cpu",
          *argv])
    out = json.loads(capsys.readouterr().out)
    assert out["shards"] == shards and out["compact"] is compact
    assert out["pixels"] == 200 and out["rounds"] > 0
    # 100-pixel chips take no bucketed tail, so the ring moves nothing
    assert out["lanes_migrated"] == (0 if shards == 2 else None)
