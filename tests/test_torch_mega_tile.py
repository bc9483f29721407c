"""The tile design of ``detect_mega`` and its refusal, rehearsed on the CPU.

- The port's ``mega_fits`` and the round loop a refused mega takes: with
  JAX's ``pallas_ops.mega_fits`` and the port's ``cuda_ops.mega_fits``
  both refusing the tiny chip, a "mega" request runs the same compacted
  loop in both packages and the port makes no ``detect_mega`` call; the
  port's refused request is its fallback route in every field, with the
  fused round its flag asks for.
- A model of the kernel's round scheduling (``csrc/detect_mega.cu``):
  blocks of 32 pixels of one chip, each running rounds until its last
  pixel is DONE, the chip's ``rounds`` the most any of its blocks ran and
  its ``round_counts`` the rounds in which some block ran INIT, a fit or a
  close.  It is held to the JAX ``detect_mega`` in interpret mode (one
  Pallas block covers the cut chip, so its block counts are the chip's) on
  the tiny chip cut to P=40, not a multiple of 32, and to the port's
  lockstep plain version.
- The shared-memory sizing of the redesigned ``detect_mega`` and
  ``fused_fit_close`` against the formulas in their sources.
"""

import dataclasses
import functools
import re
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firebird_tpu.ccd import kernel as jk
from firebird_tpu.ccd import pallas_ops
from firebird_tpu.ccd.sensor import LANDSAT_ARD
from firebird_tpu_torch.ccd import convert, cuda_ops
from firebird_tpu_torch.ccd import kernel as tk
from firebird_tpu_torch.ccd.sensor import chi2_thresholds

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_detect import _packed  # noqa: E402

CHANGE_THR, OUTLIER_THR = chi2_thresholds(5)
PHASES = (cuda_ops.PHASE_INIT, cuda_ops.PHASE_MONITOR, cuda_ops.PHASE_DONE)
TILE = cuda_ops.TILE
CSRC = Path(cuda_ops.__file__).resolve().parents[1] / "csrc"


@pytest.fixture(autouse=True)
def _clear_env(monkeypatch):
    for k in ("FIREBIRD_PALLAS", "FIREBIRD_FUSED_FIT", "FIREBIRD_COMPACT"):
        monkeypatch.delenv(k, raising=False)


# ---------------------------------------------------------------------------
# mega_fits and the refused mega route
# ---------------------------------------------------------------------------

def test_mega_fits_accepts_the_main_path_shapes():
    """The 8-chip Landsat batch (T=768, W=24) and the Sentinel-2 chip
    (T=64) fit; past the largest window instance, past 227 KB of shared
    memory a block, or past T_MAX the shape is refused."""
    assert cuda_ops.mega_fits(768, 24)
    assert cuda_ops.mega_fits(64, 64)
    assert cuda_ops.mega_fits(768, 128)
    assert not cuda_ops.mega_fits(768, 129)
    T = 64
    while cuda_ops.detect_mega_smem_bytes(T + 1) <= cuda_ops.SMEM_BLOCK_MAX:
        T += 1
    assert cuda_ops.mega_fits(T, 24) and not cuda_ops.mega_fits(T + 1, 24)
    assert 1800 < T < cuda_ops.T_MAX
    assert not cuda_ops.mega_fits(cuda_ops.T_MAX + 1, 24)


def test_mega_route_carries_its_fallback():
    """A refused "mega" runs the round loop with the components the list
    names beside it, and route "1"'s kernel for each it leaves out."""
    r = tk.pallas_components("mega")
    assert r.mega and r.fallback.components == ("fit", "score", "init")
    assert not r.fallback.mega
    r = tk.pallas_components("mega,lasso,monitor")
    assert r.fallback.components == ("lasso", "monitor", "init")
    assert r.fallback.fused_round is cuda_ops.KERNELS.fused_round
    with pytest.raises(ValueError, match="INIT block"):
        tk.pallas_components("lasso,monitor")


def _spy_ops(calls):
    def spy(name):
        fn = getattr(cuda_ops.PLAIN, name)
        return lambda *a, **k: calls.append(name) or fn(*a, **k)

    return types.SimpleNamespace(**{n: spy(n) for n in vars(cuda_ops.PLAIN)})


def _jax_refused():
    """JAX's f32, compacted detect_packed with FIREBIRD_PALLAS=mega and its
    mega_fits refusing the tiny chip (the environment is set for this
    call alone; the jit caches are cleared around it, so that no program
    traced under another route is reused)."""
    jp, _ = _packed("default")
    mp = pytest.MonkeyPatch()
    asked = []
    try:
        mp.setenv("FIREBIRD_PALLAS", "mega")
        mp.setattr(pallas_ops, "mega_fits",
                   lambda *a: asked.append(a) or False)
        jax.clear_caches()
        seg = jk.detect_packed(jp, dtype=jnp.float32, compact=True,
                               fused=0)
        jax.block_until_ready(seg.n_segments)
    finally:
        mp.undo()
        jax.clear_caches()
    assert asked, "JAX never asked mega_fits"
    return seg


def test_refused_mega_takes_the_jax_loop(monkeypatch):
    """Compaction on, as its flag says on both sides: the same compacted
    loop, decision for decision, round for round."""
    monkeypatch.setenv("FIREBIRD_COMPACT_MIN_LANES", "8")
    monkeypatch.setattr(cuda_ops, "mega_fits", lambda T, W: False)
    ref = _jax_refused()
    _, tp = _packed("default")
    calls = []
    cuda_ops.reset_launches()
    got = tk.detect_packed(tp, device="cpu", pallas="mega", fused=0,
                           compact=True, ops=_spy_ops(calls))
    assert "detect_mega" not in calls and "monitor_chain_scored" in calls
    assert cuda_ops.REFUSED["detect_mega"] >= 1
    g = convert.segments_to_numpy(got)
    for f in ("n_segments", "procedure", "mask", "seg_meta", "rounds",
              "round_counts", "occupancy", "compactions"):
        np.testing.assert_array_equal(getattr(g, f),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    assert int(g.compactions.sum()) > 0


def test_refused_mega_equals_its_loop_route():
    """The port's refused mega is its fallback route in every field."""
    _, tp = _packed("two_changes_gaps")
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(cuda_ops, "mega_fits", lambda T, W: False)
        got = tk.detect_packed(tp, device="cpu", pallas="mega", fused=1,
                               compact=False)
    finally:
        mp.undo()
    want = tk.detect_packed(tp, device="cpu", pallas="1", fused=1,
                            compact=False)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert (a is None and b is None) or torch.equal(a, b), f.name


def test_window_cap_past_the_largest_instance_is_refused():
    """The predicate refuses W=129; the wrapper itself still raises."""
    assert not cuda_ops.mega_fits(64, 129)
    with pytest.raises(ValueError, match="detect_mega"):
        cuda_ops._w_instance(129, "detect_mega")


# ---------------------------------------------------------------------------
# The tile's round scheduling
# ---------------------------------------------------------------------------

P0, P_CUT = 10, 40


@functools.lru_cache(maxsize=None)
def _start_state():
    """The tiny chip's prologue state (chip 0 of the "default"
    configuration, P_CUT of its pixels from P0: some break twice), as the
    mega route starts."""
    _, tp = _packed("default")
    args = tk.stage_packed(tp, torch.device("cpu"))
    loop = tk.staged_loop(*args, W=tk.window_cap(tp), pallas="mega",
                          ops=cuda_ops.PLAIN, fused=0, compact=False)
    res, st = loop.res, loop.st
    cut = lambda v, ax: v[:1].narrow(ax, P0, P_CUT).contiguous()
    a = dict(Yt=cut(res["Yt"], 3), phase0=cut(st["phase"], 1),
             cur_i0=cut(st["cur_i"], 1), alive0=cut(st["alive"], 2),
             nseg0=cut(st["nseg"], 1),
             bufs=tuple(cut(b, 1) for b in st["bufs"]),
             t=res["t"][:1].contiguous(), X=res["X"][:1].contiguous(),
             Xt=res["Xt"][:1].contiguous(), vario=cut(res["vario"], 1))
    return a, loop.W


def _plain(a, W, sl=slice(None), on_round=None):
    pix = lambda v, ax: v.narrow(ax, sl.start, sl.stop - sl.start) \
        if sl.start is not None else v
    return cuda_ops.detect_mega_plain(
        pix(a["Yt"], 3), pix(a["phase0"], 1), pix(a["cur_i0"], 1),
        pix(a["alive0"], 2), pix(a["nseg0"], 1),
        tuple(pix(b, 1).clone() for b in a["bufs"]), a["t"], a["X"],
        a["Xt"], pix(a["vario"], 1), W=W, change_thr=CHANGE_THR,
        outlier_thr=OUTLIER_THR, on_round=on_round)


def tile_schedule(a, W):
    """The kernel's scheduling: each block of TILE pixels runs its own
    rounds (the plain round body on its pixels) until they are all DONE;
    per chip, ``rounds`` is the most a block ran and ``flags[c, g, r]`` is
    set when some block of the chip ran INIT (g=0), a fit (1) or a close
    (2) in its round r; ``counts`` sums the flags over r."""
    C, _, T, P = a["Yt"].shape
    flags = np.zeros((C, 3, 2 * T + 8), bool)
    rounds = np.zeros(C, np.int64)
    outs, block_rounds = [], []
    for t0 in range(0, P, TILE):
        r = [0]

        def on_round(st, init, ev):
            flags[:, 0, r[0]] |= (st["phase"] == cuda_ops.PHASE_INIT).any(
                1).numpy()
            flags[:, 1, r[0]] |= ev["do_fit"].any(1).numpy()
            flags[:, 2, r[0]] |= (ev["is_tail"] | ev["is_brk"]).any(1).numpy()
            r[0] += 1

        out = _plain(a, W, slice(t0, min(P, t0 + TILE)), on_round)
        rounds = np.maximum(rounds, out["rounds"].numpy())
        outs.append(out)
        block_rounds.append(r[0])
    cat = {k: torch.cat([o[k] for o in outs], 2 if k == "alive" else 1)
           for k in ("nseg", "alive", "meta", "rmse", "mag", "coef")}
    return dict(cat, rounds=rounds, counts=flags.sum(-1),
                block_rounds=block_rounds)


@functools.lru_cache(maxsize=None)
def _pallas_mega():
    a, W = _start_state()
    j = lambda v: jnp.asarray(v.numpy())
    return pallas_ops.detect_mega(
        j(a["Yt"]), j(a["phase0"]), j(a["cur_i0"]),
        jnp.asarray(convert.plane_to_numpy(a["alive0"])), j(a["nseg0"]),
        tuple(jnp.asarray(b) for b in convert.bufs_to_flat(a["bufs"])),
        j(a["t"]), j(a["X"]), j(a["Xt"]), j(a["vario"]), W=W,
        S=a["bufs"][0].shape[2], sensor=LANDSAT_ARD, phases=PHASES,
        change_thr=CHANGE_THR, outlier_thr=OUTLIER_THR, block_p=P_CUT,
        interpret=True)


def test_tile_schedule_matches_pallas_detect_mega():
    a, W = _start_state()
    model = tile_schedule(a, W)
    # Two blocks, the second ragged, ending at different rounds.
    assert len(model["block_rounds"]) == 2 and P_CUT % TILE
    assert len(set(model["block_rounds"])) == 2, model["block_rounds"]
    want = _pallas_mega()
    np.testing.assert_array_equal(model["rounds"], np.asarray(want["rounds"]))
    np.testing.assert_array_equal(model["counts"], np.asarray(want["counts"]))
    np.testing.assert_array_equal(model["nseg"].numpy(),
                                  np.asarray(want["nseg"]))
    np.testing.assert_array_equal(convert.plane_to_numpy(model["alive"]),
                                  np.asarray(want["alive"]))
    np.testing.assert_array_equal(model["meta"].numpy(),
                                  np.asarray(want["meta"]))
    assert int(model["nseg"].max()) >= 2 and model["counts"].min() > 0
    # The fits sum their Grams in another order than the Pallas dots.
    np.testing.assert_allclose(model["rmse"].numpy(),
                               np.asarray(want["rmse"]), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(model["mag"].numpy(), np.asarray(want["mag"]),
                               rtol=5e-3, atol=1e-2)


def test_tile_schedule_equals_the_lockstep_loop():
    """Pixels are independent: the blocks' rounds are the lockstep loop's,
    every field equal."""
    a, W = _start_state()
    model = tile_schedule(a, W)
    want = _plain(a, W)
    for k in ("nseg", "alive", "meta", "rmse", "mag", "coef"):
        assert torch.equal(model[k], want[k]), k
    np.testing.assert_array_equal(model["rounds"], want["rounds"].numpy())
    np.testing.assert_array_equal(model["counts"], want["counts"].numpy())


# ---------------------------------------------------------------------------
# Shared memory of the redesigned kernels
# ---------------------------------------------------------------------------

def _cu_smem_words(name):
    """The body of ``smem_words`` in ``csrc/<name>.cu``."""
    text = (CSRC / f"{name}.cu").read_text()
    m = re.search(r"size_t smem_words\(int T\) \{(.*?)\n\}", text, re.S)
    return " ".join(m.group(1).split())


def test_detect_mega_smem_bytes():
    # X, t and Xt (14T floats), 32 Grams of 65 floats, five masks of
    # ceil(T/32) words for 32 pixels, five ints a pixel and four more, and
    # three ints a pixel of round state.
    assert cuda_ops.detect_mega_smem_bytes(768) == 4 * (
        14 * 768 + 32 * 65 + 5 * 24 * 32 + 5 * 32 + 4 + 3 * 32) == 67728
    assert cuda_ops.detect_mega_smem_bytes(33) == 4 * (
        14 * 33 + 32 * 65 + 5 * 2 * 32 + 5 * 32 + 4 + 3 * 32)
    body = _cu_smem_words("detect_mega")
    assert "(fb::K + 1 + fb::NT) * T" in body and "tile_round_words" in body
    assert "NSTATE * TILE" in body
    assert "constexpr int NSTATE = 3;" in (CSRC / "detect_mega.cu").read_text()
    tile = (CSRC / "tile_round.cuh").read_text()
    assert "constexpr int TILE_NMASK = 5;" in tile
    assert "constexpr int TILE_NINFO = 5;" in tile
    # Three blocks an SM fit at the main path's T=768.
    assert 3 * (cuda_ops.detect_mega_smem_bytes(768)
                + cuda_ops.SMEM_RESERVED) <= cuda_ops.SMEM_SM


def test_fused_fit_close_smem_bytes():
    # X and t (9T floats), 32 Grams of 65 floats, the weight and included
    # masks of ceil(T/32) words for 32 pixels, three ints a pixel and four
    # more.
    assert cuda_ops.fused_fit_close_smem_bytes(768) == 4 * (
        9 * 768 + 32 * 65 + 2 * 24 * 32 + 3 * 32 + 4) == 42512
    assert cuda_ops.fused_fit_close_smem_bytes(33) == 4 * (
        9 * 33 + 32 * 65 + 2 * 2 * 32 + 3 * 32 + 4)
    body = _cu_smem_words("fused_fit_close")
    assert "(size_t)9 * T + TILE * fb::GSTRIDE + (size_t)2 * W * TILE" in body
    assert "3 * TILE + 4" in body
    fn = cuda_ops.fused_fit_close_smem_bytes
    assert fn(64) < fn(65) < fn(768)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_ops._check_smem("fused_fit_close", fn(8192))
