"""The port's per-tile skip guard (``active=``) against the JAX package's
per-block guard, on the CPU.

The JAX package's five guard tests (``tests/test_pallas.py``) each get a
counterpart here: the same inputs, made from a seed with numpy, through the
JAX kernel with ``active=`` (Pallas in interpret mode; INIT through its XLA
block, whose interpret Pallas trace takes over 20 s on the CPU) and
through the port's wrapper on CPU tensors, which runs the guarded plain
version.  Then the plain versions' guard itself: guarded equals unguarded
on every lane where the inactive lanes carry the inputs the callers give
them (the dense prefix that compaction leaves), and on any input the
guarded output is the unguarded one with the fill laid over the tiles
without an active lane (``cuda_ops.guard``), at a ragged width over two
chips.  Last, ``TILE`` against ``csrc/tile.cuh``, a spy on the route's
functions showing ``BatchLoop`` passes the JAX package's lane sets under
compaction and None without it, and compaction on against off where the
guards skip whole tiles.  The kernels themselves are held to these plain
versions on the card by ``tests/test_torch_cuda.py`` and chip_smoke.py.
"""

import functools
import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firebird_tpu.ccd import harmonic, kernel, pallas_ops, params
from firebird_tpu.ccd.sensor import LANDSAT_ARD, chi2_thresholds
from firebird_tpu_torch.ccd import cuda_ops
from firebird_tpu_torch.ccd import kernel as tk
from firebird_tpu_torch.ingest.packer import PackedChips as TPackedChips

# The guard cases' inputs (tests/_torch_guard_cases.py, found on the path
# pytest gives this directory).
import _torch_guard_cases as cases
from tests.test_compact import _fill_pixel, _grid, _std_pixel
from tests.test_pallas import _systems
from tests.test_torch_kernels import (_init_compare, _init_inputs,
                                      _port_init_args, _t)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clear_pallas_env(monkeypatch):
    # The JAX references must trace their default XLA paths.
    monkeypatch.delenv("FIREBIRD_PALLAS", raising=False)


K = params.MAX_COEFS


def _dead_tiles(active):
    """[C,P] bool: the lanes of tiles (TILE pixels of one chip) with no
    active lane."""
    return ~cuda_ops.tile_live(active)


# ---------------------------------------------------------------------------
# The JAX package's guard tests, ported
# ---------------------------------------------------------------------------

def _fit_case(rng, active, T=40, B=7):
    """lasso_fit inputs whose inactive lanes have empty windows, as
    tests/test_pallas.py's guard cases make them; ``active`` [C,P]."""
    C, P = active.shape
    t = np.sort(rng.integers(729000, 730500, T)).astype(np.float64)
    X = harmonic.design_matrix(t, t[0], K).astype(np.float32)
    Yt = rng.integers(0, 5000, (C, B, T, P)).astype(np.int16)
    w = ((rng.random((C, P, T)) < 0.8) & active[..., None]).astype(np.float32)
    mask = np.ones((C, P, K), bool)
    return X, Yt, w, mask


def _port_fit(X, Yt, w, mask, active=None):
    C, T = Yt.shape[0], Yt.shape[2]
    return cuda_ops.lasso_fit(
        _t(Yt), _t(w.transpose(0, 2, 1)),
        _t(np.broadcast_to(X, (C, T, K))), _t(mask),
        active=None if active is None else _t(active))


def test_fit_guard_skips_dead_tiles_as_jax_skips_dead_blocks(monkeypatch):
    """lasso_fit with a dense-prefix active mask (test_pallas.py's
    test_fit_guard_skips_dead_blocks_bit_identical): the port's guarded fit
    equals its unguarded fit on every lane and JAX's guarded fit on the
    active lanes (the fit envelope of test_torch_kernels.py), and writes
    zeros on its dead tiles as JAX's skipped block does."""
    monkeypatch.setattr(pallas_ops, "fit_block_p", lambda *a: 128)
    rng = np.random.default_rng(8)
    BP = pallas_ops.fit_block_p(40, 7, 2)
    P = 2 * BP
    active = np.zeros((1, P), bool)
    active[0, : BP // 2] = True
    X, Yt, w, mask = _fit_case(rng, active)
    want = pallas_ops.lasso_fit(jnp.asarray(Yt[0]), jnp.asarray(w[0]),
                                jnp.asarray(X), jnp.asarray(mask[0]),
                                active=jnp.asarray(active[0]),
                                interpret=True)
    assert (np.asarray(want[0])[BP:] == 0).all()
    ref = _port_fit(X, Yt, w, mask)
    got = _port_fit(X, Yt, w, mask, active)
    dead = _dead_tiles(_t(active))
    assert int(dead.sum()) == P - BP // 2          # tiles 2.. are dead
    for g, r, j in zip(got, ref, want):
        assert torch.equal(g, r)
        assert not g[dead].any()
        np.testing.assert_allclose(g[0, : BP // 2].numpy(),
                                   np.asarray(j)[: BP // 2],
                                   rtol=1e-2, atol=1e-2)


def test_guarded_fit_with_a_dead_chip_equals_per_chip_calls(monkeypatch):
    """test_pallas.py's test_guarded_fit_inside_shard_map on the port's
    layout (a chip axis where JAX has shards): a [C=2,P] guarded call whose
    second chip has no active lane equals the per-chip guarded calls bit
    for bit, writes zeros over the whole second chip, and equals JAX's
    per-chip guarded fit on the first chip's active lanes."""
    monkeypatch.setattr(pallas_ops, "fit_block_p", lambda *a: 128)
    rng = np.random.default_rng(10)
    BP = pallas_ops.fit_block_p(40, 7, 2)
    P = 2 * BP
    active = np.zeros((2, P), bool)
    active[0, : BP // 2] = True
    X, Yt, w, mask = _fit_case(rng, active)
    got = _port_fit(X, Yt, w, mask, active)
    for c in range(2):
        one = _port_fit(X, Yt[c:c + 1], w[c:c + 1], mask[c:c + 1],
                        active[c:c + 1])
        for g, o in zip(got, one):
            assert torch.equal(g[c:c + 1], o)
    assert not got[0][1].any() and not got[1][1].any()
    want = pallas_ops.lasso_fit(jnp.asarray(Yt[0]), jnp.asarray(w[0]),
                                jnp.asarray(X), jnp.asarray(mask[0]),
                                active=jnp.asarray(active[0]),
                                interpret=True)
    for g, j in zip(got, want):
        np.testing.assert_allclose(g[0, : BP // 2].numpy(),
                                   np.asarray(j)[: BP // 2],
                                   rtol=1e-2, atol=1e-2)


def test_monitor_scored_guard_matches_jax_on_active_lanes():
    """monitor_chain_scored under a dense-prefix in_mon guard
    (test_pallas.py's test_monitor_scored_guard_matches_on_active_lanes):
    the port equals JAX's guarded kernel on every in_mon lane, bit for bit,
    zeros its dead tiles as JAX zeros its dead block, and equals its own
    unguarded call as every consumer reads it (cuda_ops.monitoring_only)."""
    rng = np.random.default_rng(9)
    T, nb = 48, 5
    BP = pallas_ops.scored_block_p(T, nb, 2)
    P = 2 * BP
    t = np.sort(rng.integers(729000, 730500, T)).astype(np.float64)
    X = harmonic.design_matrix(t, t[0], K).astype(np.float32)
    Yd = rng.integers(0, 5000, (nb, T, P)).astype(np.int16)
    coefs = rng.normal(0, 1, (P, nb, K)).astype(np.float32)
    dden = rng.uniform(50, 200, (P, nb)).astype(np.float32)
    alive = rng.random((P, T)) < 0.8
    included = rng.random((P, T)) < 0.3
    cur_k = rng.integers(0, T // 2, P).astype(np.int32)
    nlast = rng.integers(12, 40, P).astype(np.int32)
    in_mon = np.arange(P) < BP // 3
    ct, ot = chi2_thresholds(nb)
    kw = dict(change_thr=float(ct), outlier_thr=float(ot))
    want = pallas_ops.monitor_chain_scored(
        jnp.asarray(Yd), jnp.asarray(coefs), jnp.asarray(dden),
        jnp.asarray(X), jnp.asarray(alive), jnp.asarray(included),
        jnp.asarray(cur_k), jnp.asarray(nlast), jnp.asarray(in_mon),
        active=jnp.asarray(in_mon), interpret=True, **kw)
    args = (_t(Yd[None]), _t(coefs[None]), _t(dden[None]), _t(X[None]),
            _t(alive.T[None]), _t(included.T[None]), _t(cur_k[None]),
            _t(nlast[None]), _t(in_mon[None]))
    got = cuda_ops.monitor_chain_scored(*args, active=args[-1], **kw)
    ref = cuda_ops.monitor_chain_scored(*args, **kw)
    dead = _dead_tiles(args[-1])[0]
    for k in want:
        g = got[k][0].numpy()
        if k in ("inc_q", "rem_q"):
            g, d = g.T, dead.numpy()
            assert not g[d].any(), k
        else:
            assert not g[dead.numpy()].any(), k
        np.testing.assert_array_equal(g[in_mon], np.asarray(want[k])[in_mon],
                                      err_msg=k)
        assert (np.asarray(want[k])[BP:] == 0).all(), k
    seen = cuda_ops.monitoring_only(got, args[-1])
    for k, v in cuda_ops.monitoring_only(ref, args[-1]).items():
        assert torch.equal(seen[k], v), k


def test_init_window_guard_passes_alive_through():
    """init_window under the in_init guard (test_pallas.py's
    test_init_window_guard_passes_alive_through).  One interpret trace of
    the Pallas init_window takes over 20 s on the CPU, so the reference is
    JAX's XLA INIT block (kernel._init_block with guards on) on the active
    lanes; on the dead tiles the port writes kernel._init_zeros' fill (the
    flags and indices zero, w_stab empty) and passes alive through."""
    inputs = _init_inputs(seed=10, P=2 * 128, T=32)
    t, X, Xt, Yi, vario, alive, cur_i, phase = inputs
    P = phase.shape[0]
    phase = np.where(np.arange(P) < 64, kernel.PHASE_INIT,
                     kernel.PHASE_DONE).astype(np.int32)
    T = t.shape[0]
    Xj = jnp.asarray(X)
    res = dict(X=Xj, Xt=jnp.asarray(Xt), t=jnp.asarray(t, jnp.float32),
               Y=jnp.asarray(Yi.transpose(1, 0, 2), jnp.float32),
               Yt=jnp.asarray(Yi.transpose(0, 2, 1)),
               XX=(Xj[:, :, None] * Xj[:, None, :]).reshape(T, -1),
               vario=jnp.asarray(vario))
    st = dict(alive=jnp.asarray(alive), cur_i=jnp.asarray(cur_i),
              phase=jnp.asarray(phase))
    fit = functools.partial(kernel._fit_chip, fit_pallas=False, on_tpu=False)
    want = jax.jit(functools.partial(
        kernel._init_block, sensor=LANDSAT_ARD, W=8, fdtype=jnp.float32,
        fit=fit, f32_ok=True, guards=True))(res, st)
    args = _port_init_args(t, X, Xt, Yi, vario, alive, cur_i, phase)
    got = cuda_ops.init_window(*args, W=8, active=args[2])
    use = phase == kernel.PHASE_INIT
    sub = {k: v[..., use] if k in ("w_stab", "alive_init") else v[:, use]
           for k, v in got.items()}
    _init_compare(sub, {k: np.asarray(v)[use] for k, v in want.items()},
                  0.02)
    dead = _dead_tiles(args[2])[0]
    assert int(dead.sum()) == P - 64
    zeros = jax.tree_util.tree_map(np.asarray, kernel._init_zeros(dict(
        included=jnp.zeros((1, P, T), bool), alive=jnp.asarray(alive)[None],
        cur_i=jnp.asarray(cur_i)[None])))
    for k, v in got.items():
        g = v[0].numpy()
        z = zeros[k][0]
        if k in ("w_stab", "alive_init"):
            g = g.T
        np.testing.assert_array_equal(g[dead.numpy()], z[dead.numpy()],
                                      err_msg=k)
    assert torch.equal(got["alive_init"][0][:, dead], args[0][0][:, dead])


def test_lasso_cd_and_tmask_guards():
    """test_pallas.py's test_lasso_cd_and_tmask_guards: all-dead calls
    fill exact zeros / all-false; guarded calls agree with the unguarded
    ones and with JAX's on the active lanes."""
    G, c, d, m = (torch.from_numpy(np.array(a))[None]
                  for a in _systems(P=24, dtype=jnp.float32))
    dead = torch.zeros(1, 24, dtype=torch.bool)
    z = cuda_ops.lasso_cd(G, torch.zeros_like(c), d, m, active=dead)
    assert not z.any()
    assert not cuda_ops.lasso_cd(G, c, d, m, active=dead).any()
    act = torch.arange(24)[None] < 9
    ref = cuda_ops.lasso_cd(G, c, d, m)
    got = cuda_ops.lasso_cd(G, c, d, m, active=act)
    assert torch.equal(got, ref)              # one tile, and it is live
    want = np.asarray(pallas_ops.lasso_cd(
        *(jnp.asarray(a[0].numpy()) for a in (G, c, d, m)),
        active=jnp.asarray(act[0].numpy()), interpret=True))
    scale = np.maximum(np.abs(want[:9]).max(-1, keepdims=True), 1.0)
    assert (np.abs(got[0, :9].numpy() - want[:9]) / scale).max() <= 1e-5

    rng = np.random.default_rng(12)
    P, W, nt = 20, 16, params.TMASK_COEFS
    Xtw = rng.normal(0, 1, (P, W, nt)).astype(np.float32)
    Y2 = rng.normal(1000, 200, (P, 2, W)).astype(np.float32)
    w = (rng.random((P, W)) < 0.8).astype(np.float32)
    v2 = rng.uniform(20, 80, (P, 2)).astype(np.float32)
    want = np.asarray(pallas_ops.tmask_bad(
        jnp.asarray(Xtw), jnp.asarray(Y2), jnp.asarray(w), jnp.asarray(v2),
        active=jnp.ones(P, bool), interpret=True))
    a = tuple(_t(x[None]) for x in (Xtw, Y2, w, v2))
    ref = cuda_ops.tmask_bad(*a)
    got = cuda_ops.tmask_bad(*a, active=torch.ones(1, P, dtype=torch.bool))
    assert torch.equal(got, ref)
    np.testing.assert_array_equal(got[0].numpy(), want)
    z = cuda_ops.tmask_bad(*a, active=torch.zeros(1, P, dtype=torch.bool))
    assert not z.any()


# ---------------------------------------------------------------------------
# The plain versions' guard, at a ragged width over two chips
# ---------------------------------------------------------------------------

C2, P2 = 2, 75
PREFIX = (40, 10)            # each chip's dense prefix of active lanes


CASES = [(n, False) for n in cases.GUARDED] + [
    (n, True) for n in ("lasso_fit", "init_window", "fused_fit_close",
                        "fused_round")]
IDS = [n + ("-mixed" if m else "") for n, m in CASES]


def _reader_view(name, out, st_args):
    """What the loop reads of an output: the monitors' fields of monitoring
    pixels (cuda_ops.monitoring_only; the kernel zeroes the others, the
    plain version keeps the Pallas values there), INIT's cursor fields
    (i_next_tm, i_adv, j, has_adv: an inactive pixel computes them too) of
    initializing pixels."""
    if name in ("monitor_chain_scored", "monitor_chain"):
        return cuda_ops.monitoring_only(out, st_args[-1])
    if name == "init_window":
        in_init = st_args[2]
        return {k: (torch.where(in_init, v, torch.zeros_like(v))
                    if k in ("i_next_tm", "i_adv", "j", "has_adv") else v)
                for k, v in out.items()}
    return out


@pytest.mark.parametrize("name,mixed", CASES, ids=IDS)
def test_guarded_plain_equals_unguarded_on_inert_lanes(name, mixed):
    """With the dense prefix of a compacted loop (chip 0 40 of 75 lanes,
    chip 1 10) and the inert inputs the callers give the other lanes, the
    guarded plain version equals the unguarded one on every lane as the
    loop reads it, and the guard skipped whole tiles."""
    st, _ = cases.state(31)
    st = cases.inert(st, cases.prefix(PREFIX, P2))
    args, kw = cases.args(name, st)
    act = cases.caller_active(name, st)
    dead = ~cuda_ops.tile_live(act, flat=name in cuda_ops.FLAT_TILES)
    assert dead.any() and not dead.all()
    got = cases.call(cuda_ops.KERNELS, name, args, kw, act, mixed)
    want = cases.call(cuda_ops.KERNELS, name, args, kw, None, mixed)
    if name in ("monitor_chain_scored", "monitor_chain", "init_window"):
        got, want = (_reader_view(name, o, args) for o in (got, want))
    # Bit for bit but the sign of a zero: the plain fit of an empty window
    # may sum to -0 where the fill writes +0 (the kernels write +0 there).
    cases.assert_same(got, want, name, bits=False)


@pytest.mark.parametrize("name,mixed", CASES, ids=IDS)
def test_guard_fill_holds_on_any_input(name, mixed):
    """On arbitrary inputs and a scattered active set (some tiles of each
    chip dead, the last one ragged), the guarded plain version is the
    unguarded output with cuda_ops.guard's fill on the dead tiles, bit for
    bit: zeros (the fits, the monitors, tmask_bad), zeros with alive passed
    through (init_window), the buffers, segment counts and model passed
    through with zero events (the fused kernels)."""
    st, rng = cases.state(41)
    args, kw = cases.args(name, st)
    active = torch.from_numpy(rng.random((C2, P2)) < 0.03)
    active[0, 5] = True                  # tile 0 of chip 0 live
    flat = name in cuda_ops.FLAT_TILES
    live = cuda_ops.tile_live(active, flat=flat)
    assert live.any() and not live.all()
    got = cases.call(cuda_ops.KERNELS, name, args, kw, active, mixed)
    want = cuda_ops.guard(name, cases.call(cuda_ops.KERNELS, name, args, kw,
                                           None, mixed), active, args)
    cases.assert_same(got, want, name)
    dead = ~live
    if name in ("fused_fit_close", "fused_round"):
        for b, b0 in zip(got[0], args[16]):
            assert torch.equal(b[dead], b0[dead])
        assert torch.equal(got[1][dead], args[15][dead])
    elif name == "init_window":
        assert torch.equal(got["alive_init"].transpose(1, 2)[dead],
                           args[0].transpose(1, 2)[dead])
    else:
        assert not any(cases.lanes(v, dead).any()
                       for _, v in cases.leaves(got))
    none = torch.zeros(C2, P2, dtype=torch.bool)
    nothing = cases.call(cuda_ops.KERNELS, name, args, kw, none, mixed)
    cases.assert_same(nothing, cuda_ops.guard(name, got, none, args),
                      name + " all dead")


def test_tile_live_tiles():
    """Tiles of TILE pixels of one chip, the last ragged; flat tiles run
    over the flattened chips."""
    a = torch.zeros(2, 75, dtype=torch.bool)
    a[0, 70] = True                      # chip 0's ragged last tile
    a[1, 0] = True
    live = cuda_ops.tile_live(a)
    assert live[0].tolist() == [False] * 64 + [True] * 11
    assert live[1].tolist() == [True] * 32 + [False] * 43
    flat = cuda_ops.tile_live(a, flat=True).reshape(-1)
    # Flat tile [64, 96) holds lane 70 of chip 0 and lane 0 of chip 1 (75).
    assert flat.tolist() == [False] * 64 + [True] * 32 + [False] * 54


def test_tile_mirrors_tile_cuh():
    """cuda_ops.TILE is csrc/tile.cuh's fb::TILE (line 19), and the tile
    kernels' block is its TILE_THREADS."""
    src = (Path(cuda_ops.CSRC) / "tile.cuh").read_text().splitlines()
    m = re.fullmatch(r"constexpr int TILE = (\d+);.*", src[18])
    assert m and int(m.group(1)) == cuda_ops.TILE
    threads = next(re.search(r"TILE_THREADS = (\d+);", ln).group(1)
                   for ln in src if "constexpr int TILE_THREADS" in ln)
    assert int(threads) == cuda_ops.FUSED_ROUND_THREADS


# ---------------------------------------------------------------------------
# The guard's call sites in the compacted loop
# ---------------------------------------------------------------------------

def _packed(n_std=(30, 3), seed=7, P=100):
    """Two chips of P lanes: standard pixels (half with breaks) scattered
    among fill lanes, and a few snow-covered ones (the prologue's one-shot
    fit), chip 1 mostly fill."""
    rng = np.random.default_rng(seed)
    t = _grid()
    chips = []
    for n in n_std:
        px = [_std_pixel(rng, t, brk=i % 2 == 0) for i in range(n)]
        for _ in range(3):
            Y, qa = _std_pixel(rng, t)
            qa = np.where(rng.random(qa.shape) < 0.9, 1 << params.QA_SNOW_BIT,
                          qa).astype(np.uint16)
            px.append((Y, qa))
        px += [_fill_pixel(t) for _ in range(P - len(px))]
        chips.append([px[i] for i in rng.permutation(P)])
    spectra = np.stack([np.stack([np.asarray(Y, np.int16) for Y, _ in px])
                        for px in chips]).transpose(0, 2, 1, 3)
    qas = np.stack([np.stack([qa for _, qa in px]) for px in chips])
    return TPackedChips(cids=np.zeros((2, 2), np.int64),
                        dates=np.stack([t, t]).astype(np.int32),
                        spectra=spectra, qas=qas,
                        n_obs=np.array([t.shape[0]] * 2, np.int32))


ROUTES = {"0": dict(fused=0), "1": dict(fused=1), "mon": dict(fused="mon"),
          "components": dict(pallas="lasso,monitor,tmask")}


def _expected_active(name, args):
    """The JAX package's lane set for a call of the route's ``name`` on its
    arguments ``args``: init_window in_init; the monitor in_mon;
    fused_round in_mon | init_ok; fused_fit_close do_fit | close; the fits
    (the prologue's alt_fit, route 0's do_fit) the pixels with a window,
    which those sets are exactly."""
    if name == "init_window":
        return args[2]
    if name == "monitor_chain_scored":
        return args[8]
    if name == "fused_round":
        return args[7] | args[11]
    if name == "fused_fit_close":
        return args[4] | args[10] | args[11]
    assert name == "lasso_fit"
    return args[1].sum(1) > 0


def _spied_route(route, calls, inner):
    """The route's functions, each recording its name, arguments and
    ``active``; ``inner`` records the component kernels' ``active`` under
    the component route."""
    base = {n: getattr(cuda_ops.KERNELS, n) for n in vars(cuda_ops.KERNELS)}

    def rec(name, fn, log):
        def spy(*a, **kw):
            log.append((name, a, kw.get("active")))
            return fn(*a, **kw)
        return spy

    spy_base = types.SimpleNamespace(
        **{n: rec(n, f, inner) for n, f in base.items()})
    ops = tk.pallas_components(route.get("pallas", "1"), spy_base,
                               mixed=False)
    for n in ("lasso_fit", "monitor_chain_scored", "init_window",
              "fused_fit_close", "fused_round"):
        setattr(ops, n, rec(n, getattr(ops, n), calls))
    return ops


@pytest.mark.parametrize("compact", [True, False], ids=["compact", "off"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_batch_loop_passes_jaxs_guard_sets(route, compact, monkeypatch):
    """Under compaction every call of a guarded kernel gets the JAX
    package's lane set (kernel._detect_batch_impl's guards=compact_on: the
    prologue's fit alt_fit, INIT in_init, the monitor in_mon, route 0's
    refit do_fit, fused_fit_close do_fit | close, fused_round in_mon |
    init_ok; on the component route each component kernel the set of the
    block that calls it), through the stage-2 tail too; without it, None."""
    monkeypatch.setenv("FIREBIRD_COMPACT_MIN_LANES", "8")
    calls, inner = [], []
    kw = dict(ROUTES[route])
    kw.pop("pallas", None)
    ops = _spied_route(ROUTES[route], calls, inner)
    seg = tk.detect_packed(_packed(), device="cpu", ops=ops, compact=compact,
                           **kw)
    names = {n for n, _, _ in calls}
    assert "init_window" in names and "lasso_fit" in names
    if not compact:
        assert all(a is None for _, _, a in calls + inner)
        return
    assert int(seg.compactions.sum()) > 0
    widths = set()
    for name, args, active in calls:
        assert active is not None, name
        assert torch.equal(active, _expected_active(name, args)), name
        widths.add(active.shape[1])
    assert len(widths) > 1                # the bucketed tail ran guarded
    if route == "components":
        # lasso_cd under every fit, monitor_chain under the monitor,
        # tmask_bad under INIT, each with its block's set.
        outer = [a for n, _, a in calls
                 if n in ("lasso_fit", "init_window", "monitor_chain_scored")]
        assert {n for n, _, _ in inner} == {"lasso_cd", "monitor_chain",
                                            "tmask_bad"}
        assert all(any(a is o for o in outer) for _, _, a in inner)


@pytest.mark.parametrize("route", list(ROUTES))
def test_compact_on_equals_off_where_guards_skip_tiles(route, monkeypatch):
    """Two chips of 100 lanes (four tiles, the last ragged; chip 1 mostly
    fill): with compaction the guards skip whole tiles, and every result
    field equals compaction off, byte for byte."""
    monkeypatch.setenv("FIREBIRD_COMPACT_MIN_LANES", "8")
    packed = _packed()
    calls, inner = [], []
    ops = _spied_route(ROUTES[route], calls, inner)
    kw = dict(ROUTES[route])
    kw.pop("pallas", None)
    on = tk.detect_packed(packed, device="cpu", ops=ops, compact=True, **kw)
    off = tk.detect_packed(packed, device="cpu", compact=False,
                           **ROUTES[route])
    assert any(not cuda_ops.tile_live(a).all() for _, _, a in calls)
    for f in ("n_segments", "seg_meta", "seg_rmse", "seg_mag", "seg_coef",
              "mask", "procedure", "rounds", "round_counts", "vario"):
        assert torch.equal(getattr(on, f), getattr(off, f)), f
