"""The rebalancing ring's span planner (``cuda_ops.ring_plan``) and the
receive views carved from one flat buffer (``cuda_ops.ring_views``), on
the CPU.  The ``ring_remote_copy`` kernel walks the plan's spans; these
tests hold the plan to its contract where no card is present."""

import numpy as np
import pytest
import torch

from firebird_tpu_torch.ccd import cuda_ops


def _payload(rng):
    """Mixed dtypes and shapes: odd byte counts, a 0-d tensor, empty
    tensors, and leaves larger than one span."""
    return [torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)),
            torch.from_numpy(rng.integers(-9, 9, (7,)).astype(np.int16)),
            torch.from_numpy(rng.random((2, 3, 3)) < 0.5),
            torch.tensor(3, dtype=torch.int64),
            torch.zeros(0, 4),
            torch.from_numpy(rng.integers(0, 255, (cuda_ops.RING_SPAN * 2 + 13,))
                             .astype(np.uint8)),
            torch.zeros(0, dtype=torch.int16),
            torch.from_numpy(rng.integers(0, 2**31, (300, 37))
                             .astype(np.int32))]


def _plan(leaves):
    cuda_ops._RING_PLANS.clear()
    return cuda_ops.ring_plan(leaves)


def test_plan_covers_every_byte_once():
    leaves = _payload(np.random.default_rng(0))
    plan = _plan(leaves)
    covered = np.zeros(plan.total, np.int32)
    for dst, off, n, k in plan.spans:
        assert 0 < n <= cuda_ops.RING_SPAN
        covered[dst:dst + n] += 1
    for k, t in enumerate(leaves):
        nb = t.numel() * t.element_size()
        assert plan.nbytes[k] == nb
        lo = plan.offsets[k]
        assert (covered[lo:lo + nb] == 1).all(), k
    # Padding between leaves is never written.
    assert covered.sum() == sum(plan.nbytes)


def test_spans_lie_inside_one_leaf():
    leaves = _payload(np.random.default_rng(1))
    plan = _plan(leaves)
    for dst, off, n, k in plan.spans:
        assert 0 <= off and off + n <= plan.nbytes[k]
        assert dst == plan.offsets[k] + off
        assert off % cuda_ops.RING_SPAN == 0      # 16-byte aligned starts
    # The spans of a leaf are equal but its last.
    big = [s for s in plan.spans if s[3] == 5]
    assert [s[2] for s in big] == [cuda_ops.RING_SPAN] * 2 + [13]


def test_offsets_are_aligned():
    plan = _plan(_payload(np.random.default_rng(2)))
    assert all(o % cuda_ops.RING_ALIGN == 0 for o in plan.offsets)
    assert plan.total % cuda_ops.RING_ALIGN == 0
    assert list(plan.offsets) == sorted(plan.offsets)


def test_zero_size_and_odd_size_leaves():
    leaves = [torch.zeros(0), torch.zeros(0, 3, dtype=torch.int16),
              torch.zeros(5, dtype=torch.uint8)]
    plan = _plan(leaves)
    assert plan.nbytes == (0, 0, 5)
    assert [tuple(s) for s in plan.spans] == [(0, 0, 5, 2)]
    assert plan.total == cuda_ops.RING_ALIGN
    empty = _plan([torch.zeros(0)])
    assert len(empty.spans) == 0 and empty.total == cuda_ops.RING_ALIGN


def test_views_have_the_leaves_shapes_and_dtypes():
    leaves = _payload(np.random.default_rng(3))
    plan = _plan(leaves)
    buf = torch.zeros(plan.total, dtype=torch.uint8)
    views = cuda_ops.ring_views(buf, plan)
    for v, t, off in zip(views, leaves, plan.offsets):
        assert v.shape == t.shape and v.dtype == t.dtype
        assert v.is_contiguous()
        assert v.untyped_storage().data_ptr() == buf.untyped_storage().data_ptr()
        assert v.storage_offset() * v.element_size() == off
    # A copy by the plan's spans through the views reproduces the leaves.
    raw = [t.reshape(-1).view(torch.uint8) for t in leaves]
    for dst, off, n, k in plan.spans:
        buf[dst:dst + n] = raw[k][off:off + n]
    for v, t in zip(views, leaves):
        assert torch.equal(v, t)


def test_plan_reused_for_a_repeated_signature():
    rng = np.random.default_rng(4)
    plan = _plan(_payload(rng))
    again = _payload(rng)                 # new tensors, the same signature
    assert cuda_ops.ring_plan(again) is plan
    other = _payload(rng)[:-1]
    assert cuda_ops.ring_plan(other) is not plan
    assert len(cuda_ops._RING_PLANS) == 2


@pytest.mark.parametrize("n_leaves", [1, 128])
def test_plan_of_one_and_many_leaves(n_leaves):
    rng = np.random.default_rng(n_leaves)
    leaves = [torch.from_numpy(rng.integers(0, 99, (int(rng.integers(0, 70)),))
                               .astype(np.int32)) for _ in range(n_leaves)]
    plan = _plan(leaves)
    assert len(plan.offsets) == n_leaves
    assert sum(plan.nbytes) == sum(t.numel() * 4 for t in leaves)
    assert len(plan.spans) == sum(1 for t in leaves if t.numel())
