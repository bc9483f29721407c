"""The port's active-lane compaction against itself and the JAX package.

The pixel mixes of ``tests/test_compact.py`` (32 lanes of one chip: long-
lived standard pixels among fill lanes, a single working pixel, every
pixel done before round one, the fuzz generator's adversarial pixels) go
through ``firebird_tpu_torch.ccd.kernel.detect_packed(device="cpu")`` with
compaction on and off, and through the JAX package's
``detect_packed(compact=True)`` at float32.  FIREBIRD_COMPACT_MIN_LANES=8
lets the 32-lane chip take the bucketed tail (bucket 8), as in
``tests/test_compact.py``; with 8 standard pixels the working count sits
exactly on the bucket boundary.

Compaction on and off must agree bit for bit; against the JAX package the
decisions, rounds, occupancy and compaction counts must be identical and
the fitted floats stay inside the envelope of ``tests/test_torch_detect.py``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firebird_tpu.ccd import kernel as jk
from firebird_tpu.ccd import params as jparams
from firebird_tpu.ingest.packer import PackedChips as JPackedChips
from firebird_tpu_torch.ccd import compact, cuda_ops
from firebird_tpu_torch.ccd import kernel as tk
from firebird_tpu_torch.ingest.packer import PackedChips as TPackedChips
from tests.test_compact import (P_TEST, _fill_pixel, _grid, _mixed_pixels,
                                _std_pixel)

IDENTICAL = ("n_segments", "seg_meta", "seg_rmse", "seg_mag", "seg_coef",
             "mask", "procedure", "rounds", "round_counts", "vario")


@pytest.fixture(autouse=True, scope="module")
def _small_cascade_env():
    """Let the 32-lane chip take the bucketed tail (both packages read the
    knob at dispatch or trace time)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("FIREBIRD_COMPACT_MIN_LANES", "8")
    yield
    mp.undo()


def _case_pixels(name):
    t = _grid()
    if name == "mixed":                   # the bucket-boundary case
        return _mixed_pixels(n_std=8)
    if name == "single_alive":
        rng = np.random.default_rng(3)
        pixels = [_fill_pixel(t) for _ in range(P_TEST)]
        pixels[17] = _std_pixel(rng, t, brk=True)
        return t, pixels
    if name == "all_done":                # every pixel done before round one
        return t, [_fill_pixel(t) for _ in range(P_TEST)]
    from tests.test_fuzz_parity import SPECIALS, _fuzz_pixel

    rng = np.random.default_rng(606)
    return t, [_fuzz_pixel(t, rng, special=SPECIALS.get(i))
               for i in range(P_TEST)]


CASES = ("mixed", "single_alive", "all_done", "fuzz")


def _packs(name):
    t, pixels = _case_pixels(name)
    Ys, qas = zip(*pixels)
    spectra = np.stack([np.asarray(Y, np.int16) for Y in Ys])
    arrays = dict(cids=np.zeros((1, 2), np.int64),
                  dates=t[None].astype(np.int32),
                  spectra=spectra.transpose(1, 0, 2)[None],
                  qas=np.stack(qas)[None],
                  n_obs=np.array([t.shape[0]], np.int32))
    return JPackedChips(**arrays), TPackedChips(**arrays)


@functools.lru_cache(maxsize=None)
def _run(name):
    """The JAX package's compacted result and the port's with compaction
    on and off, once per process."""
    jp, tp = _packs(name)
    ref = jk.detect_packed(jp, dtype=jnp.float32, compact=True)
    on = tk.detect_packed(tp, device="cpu", compact=True)
    off = tk.detect_packed(tp, device="cpu", compact=False)
    return ref, on, off


@pytest.fixture(scope="module", params=CASES)
def runs(request, _small_cascade_env):
    return (request.param,) + _run(request.param)


def test_compact_on_equals_off(runs):
    name, _, on, off = runs
    for f in IDENTICAL:
        assert torch.equal(getattr(on, f), getattr(off, f)), (name, f)
    assert off.lanes_migrated is None and on.lanes_migrated is None
    assert int(off.compactions.sum()) == 0
    # compaction off pays the full width every round
    r = int(off.rounds[0])
    assert (off.occupancy[0, :r, 1] == P_TEST).all()


def test_compact_decisions_match_jax(runs):
    name, ref, on, _ = runs
    np.testing.assert_array_equal(on.n_segments.numpy(),
                                  np.asarray(ref.n_segments))
    np.testing.assert_array_equal(on.procedure.numpy(),
                                  np.asarray(ref.procedure))
    np.testing.assert_array_equal(on.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(on.seg_meta.numpy(),
                                  np.asarray(ref.seg_meta))
    np.testing.assert_array_equal(on.rounds.numpy(), np.asarray(ref.rounds))
    np.testing.assert_array_equal(on.round_counts.numpy(),
                                  np.asarray(ref.round_counts))
    if name == "mixed":
        assert int(on.compactions[0]) > 0
    if name == "all_done":
        assert int(on.rounds[0]) == 0 and int(on.compactions[0]) == 0


def test_compact_occupancy_and_compactions_match_jax(runs):
    _, ref, on, _ = runs
    np.testing.assert_array_equal(on.occupancy.numpy(),
                                  np.asarray(ref.occupancy))
    np.testing.assert_array_equal(on.compactions.numpy(),
                                  np.asarray(ref.compactions))


def test_compact_floats_within_envelope(runs):
    _, ref, on, _ = runs
    np.testing.assert_allclose(on.seg_rmse.numpy(), np.asarray(ref.seg_rmse),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(on.seg_mag.numpy(), np.asarray(ref.seg_mag),
                               rtol=5e-3, atol=1e-2)
    c_r = np.asarray(ref.seg_coef)
    scale = np.maximum(np.abs(c_r).max(-1, keepdims=True), 1.0)
    assert (np.abs(on.seg_coef.numpy() - c_r) / scale).max() <= 1e-4


@pytest.mark.parametrize("route", [dict(fused=1), dict(fused="mon"),
                                   dict(pallas="lasso,monitor,tmask")],
                         ids=["fused1", "mon", "components"])
def test_compact_on_equals_off_on_every_route(route):
    """Compaction applies to routes 1, "mon" and the component route too,
    to the same result."""
    _, tp = _packs("mixed")
    on = tk.detect_packed(tp, device="cpu", compact=True, **route)
    off = tk.detect_packed(tp, device="cpu", compact=False, **route)
    assert int(on.compactions[0]) > 0
    for f in IDENTICAL:
        assert torch.equal(getattr(on, f), getattr(off, f)), f


def test_mega_route_never_compacts():
    _, tp = _packs("single_alive")
    seg = tk.detect_packed(tp, device="cpu", pallas="mega", compact=True)
    assert seg.occupancy is None and seg.compactions is None
    base = _run("single_alive")[2]
    for f in ("n_segments", "seg_meta", "mask", "procedure"):
        assert torch.equal(getattr(seg, f), getattr(base, f)), f


def test_uncarried_resident_fails_loudly(monkeypatch):
    """A round that reads a per-pixel resident the loop does not carry
    raises instead of reading the unpermuted original."""
    monkeypatch.setattr(tk, "resident_keys", lambda fused: ("Yt", "Yd"))
    _, tp = _packs("mixed")
    with pytest.raises(KeyError, match="vario"):
        tk.detect_packed(tp, device="cpu", compact=True)


def test_resident_keys_follow_the_route():
    assert set(tk.resident_keys(0)) == {"vario", "Yt", "Yd"}
    assert set(tk.resident_keys(1)) == {"vario", "Yt", "Yd"}
    assert set(tk.resident_keys("mon")) == {"vario", "Yt"}


# ---------------------------------------------------------------------------
# The helpers against the JAX package's
# ---------------------------------------------------------------------------

def test_dense_prefix_perm_matches_jax():
    rng = np.random.default_rng(0)
    alive = rng.random((3, 37)) < 0.4
    got = compact.dense_prefix_perm(torch.from_numpy(alive))
    for c in range(3):
        want = np.asarray(jk._dense_prefix_perm(jnp.asarray(alive[c])))
        np.testing.assert_array_equal(got[c].numpy(), want)


def test_take_pixels_and_unpermute_roundtrip():
    rng = np.random.default_rng(1)
    C, T, P = 2, 5, 19
    perm = torch.stack([torch.from_numpy(rng.permutation(P))
                        for _ in range(C)])
    plane = torch.from_numpy(rng.standard_normal((C, T, P)).astype(np.float32))
    vec = torch.from_numpy(rng.integers(0, 9, (C, P, 3)).astype(np.int32))
    for a, ax in ((plane, -1), (vec, 1)):
        moved = compact.take_pixels(a, perm, ax)
        assert moved.is_contiguous()
        for c in range(C):
            want = a[c].index_select(ax - 1 if ax > 0 else -1, perm[c])
            assert torch.equal(moved[c], want)
        assert torch.equal(compact.unpermute(moved, perm, ax), a)


def test_paid_lanes_matches_jax():
    rng = np.random.default_rng(2)
    for P in (32, 1000, 1536):
        phase = rng.choice([0, 1, 2], (3, P), p=[0.05, 0.05, 0.9])
        phase[1] = 2                            # a chip with nothing working
        got = compact.paid_lanes(torch.from_numpy(phase.astype(np.int32)))
        want = jk._paid_lanes(jnp.asarray(phase), jk._block_widths(P))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(compact.block_widths(P),
                                      jk._block_widths(P))


@pytest.mark.parametrize("P", [8, 32, 100, 1000, 10_000])
@pytest.mark.parametrize("floor", [0.0, 0.125, 0.3, 1.0])
def test_tail_bucket_matches_jax(P, floor):
    want = 1 << max(int(max(P * floor, 1) - 1).bit_length(), 3) \
        if floor > 0 else P
    assert tk.tail_bucket(P, floor) == want
    if (P, floor) == (10_000, 0.125):
        assert want == 2048


@pytest.mark.parametrize("env", [
    {}, {"FIREBIRD_COMPACT": "0", "FIREBIRD_COMPACT_EVERY": "0",
         "FIREBIRD_COMPACT_MIN_LANES": "-3", "FIREBIRD_COMPACT_FLOOR": "2.5"},
    {"FIREBIRD_COMPACT": "", "FIREBIRD_COMPACT_EVERY": "7",
     "FIREBIRD_COMPACT_MIN_LANES": "64", "FIREBIRD_COMPACT_FLOOR": "-1"}],
    ids=["defaults", "clamped_high", "clamped_low"])
def test_knobs_match_jax(monkeypatch, env):
    for k in ("FIREBIRD_COMPACT", "FIREBIRD_COMPACT_EVERY",
              "FIREBIRD_COMPACT_MIN_LANES", "FIREBIRD_COMPACT_FLOOR"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert tk.compact_mode() == jparams.compact_default()
    assert tk.compact_every() == jparams.compact_every()
    assert tk.compact_min_lanes() == jparams.compact_min_lanes()
    assert tk.compact_floor() == jparams.compact_floor()
    assert tk.compact_mode(True) and not tk.compact_mode(0)


def test_plain_ops_route_compacts_like_the_kernels_route():
    """On CPU tensors the wrappers run their plain versions: the compacted
    loop gives the same result through either namespace."""
    _, tp = _packs("mixed")
    a = tk.detect_packed(tp, device="cpu", compact=True, ops=cuda_ops.KERNELS)
    b = _run("mixed")[1]
    for f in IDENTICAL + ("occupancy", "compactions"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_tree_sum_is_independent_of_the_width():
    """The RMSE's sum over time gives a pixel the same value at any batch
    width (torch's own sum over a non-innermost axis does not, on the
    CPU, at narrow widths)."""
    from firebird_tpu_torch.ccd.primitives import tree_sum

    rng = np.random.default_rng(4)
    for T in (1, 2, 7, 115, 768):
        x = torch.from_numpy(rng.standard_normal((2, T, 32))
                             .astype(np.float32)) * 1000
        whole = tree_sum(x)
        assert whole.shape == (2, 32)
        assert torch.equal(whole[:, :8], tree_sum(x[:, :, :8].contiguous()))
        torch.testing.assert_close(whole, x.double().sum(1).float(),
                                   rtol=1e-5, atol=1e-2)
