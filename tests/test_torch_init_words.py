"""init_window's and tmask_bad's tile algorithms, rehearsed on the CPU.

``csrc/init_window.cu`` finds every pixel's initialization window on its
alive column held as 32-step words (the first set bit at or after the
cursor, the first member from rank MEOW_SIZE - 1 on whose day passes
INIT_DAYS, the members by rank), and ``csrc/tmask_warp.cuh`` runs the Tmask
screen of a window on one warp: each of a band's 20 weighted sums owned by
one lane and summed slot by slot, the medians exact order statistics by
rank (ties broken by slot).  :func:`window_search`, :func:`rank_median`
and :func:`tmask_warp_model` below are numpy models of that code, line for
line; they are held to the plain versions (``cuda_ops.init_window_gather``,
``primitives.masked_median``, ``primitives.tmask_bad``) on random states,
on named edge cases and on the windows of real chips (``landsat-ard-tiny``
and the 64-pixel Sentinel-2 cut of tests/test_torch_sentinel2.py).  The
kernels' shared-memory formulas are checked here too.  Nothing here needs
a card.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from firebird_tpu_torch.ccd import cuda_ops, kernel, params
from firebird_tpu_torch.ccd.primitives import (first_at_or_after,
                                               masked_median, tmask_bad)
from firebird_tpu_torch.ccd.sensor import LANDSAT_ARD_TINY, SENTINEL2
from firebird_tpu_torch.ingest import SyntheticSource, pack

FULL = 0xFFFFFFFF
MEOW = params.MEOW_SIZE
F32 = np.float32


# ---------------------------------------------------------------------------
# The window search on words (init_window.cu, phases 1 and 2)
# ---------------------------------------------------------------------------

def popc(v):
    return bin(v).count("1")


def ffs(v):
    """1 + the index of the lowest set bit, 0 for none (CUDA __ffs)."""
    return (v & -v).bit_length()


def below(w, lim):
    k = lim - 32 * w
    return 0 if k <= 0 else (FULL if k >= 32 else (1 << k) - 1)


def words(col):
    """A boolean column [T] as ceil(T/32) words."""
    T = len(col)
    return [sum(1 << j for j in range(32)
                if 32 * w + j < T and col[32 * w + j])
            for w in range(-(-T // 32))]


def first_from(m, t):
    """The first set bit at or after step t, -1 when none."""
    t = max(t, 0)
    for w in range(t >> 5, len(m)):
        v = m[w] & ~below(w, t) & FULL
        if v:
            return 32 * w + ffs(v) - 1
    return -1


def step_of_rank(m, r):
    """tile.cuh's step_of_rank: the step of the set bit of rank r."""
    for w, v in enumerate(m):
        pc = popc(v)
        if r < pc:
            for _ in range(r):
                v &= v - 1
            return 32 * w + ffs(v) - 1
        r -= pc
    return 32 * len(m)


def member_step(m, i, s):
    """The step of window member s, counted from step i."""
    w0 = i >> 5
    skip = popc(m[w0] & below(w0, i))
    return 32 * w0 + step_of_rank(m[w0:], s + skip)


def window_search(col, ci, t, W):
    """One pixel's window as init_window.cu finds it on the words of its
    alive column ``col`` [T] from cursor ``ci`` (days ``t`` [T] float32,
    window cap ``W``): i, j, the member count through j, the steps of the
    first min(cnt, W) members, and the next alive step after i."""
    m = words(col)
    fi = first_from(m, ci)
    has_i = fi >= 0
    i = fi if has_i else 0
    t_i = F32(t[i])
    cnt, j, has_w_raw = 0, 0, False
    for w in range(i >> 5, len(m)):
        v = m[w] & ~below(w, i) & FULL
        pc = popc(v)
        if cnt + pc < MEOW:
            cnt += pc
            continue
        while v:
            tt = 32 * w + ffs(v) - 1
            v &= v - 1
            cnt += 1
            if cnt >= MEOW and F32(t[tt]) - t_i >= F32(params.INIT_DAYS):
                j, has_w_raw = tt, True
                break
        if has_w_raw:
            break
    has_w = has_i and has_w_raw
    fa = first_from(m, i + 1)
    pos = [member_step(m, i, s) for s in range(min(cnt, W))] if has_w else []
    return dict(i=i, j=j, has_w=has_w, cnt=cnt, pos=pos, has_adv=fa >= 0,
                i_adv=max(fa, 0))


def next_after_screen(col, i, bad_steps):
    """i_next_tm: the first set bit at or after i once the flagged members'
    bits are cleared (T when none)."""
    m = words(col)
    for t in bad_steps:
        m[t >> 5] &= ~(1 << (t & 31))
    fn = first_from(m, i)
    return fn if fn >= 0 else len(col)


def _days(rng, T, span):
    return np.sort(rng.uniform(0, span, T)).astype(np.float32) + F32(730000)


def _check_search(alive, cur_i, t, W, rng):
    """The word search of every pixel against init_window_gather (and the
    plain cursor advances), every initializing."""
    C, T, P = alive.shape
    X = torch.zeros(C, T, 8)
    Xt = torch.zeros(C, T, 5)
    Yt = torch.zeros(C, 1, T, P, dtype=torch.int16)
    a, ci, tt = torch.from_numpy(alive), torch.from_numpy(cur_i), \
        torch.from_numpy(t)
    every = torch.ones(C, P, dtype=torch.bool)
    win = cuda_ops.init_window_gather(a, ci, every, tt, X, Xt, Yt, W=W)
    has_adv, i_adv = first_at_or_after(a, win["i"] + 1)
    bad = torch.from_numpy(rng.random((C, T, P)) < 0.3) & win["w_init"]
    ex, i_next = first_at_or_after(a & ~bad, win["i"])
    i_next = torch.where(ex, i_next, torch.full_like(i_next, T))
    seen = dict(window=0, capped=0)
    for c in range(C):
        for p in range(P):
            got = window_search(alive[c, :, p], int(cur_i[c, p]), t[c], W)
            assert got["i"] == int(win["i"][c, p]), (c, p)
            assert got["j"] == int(win["j"][c, p]), (c, p)
            assert got["has_w"] == bool(win["has_w"][c, p]), (c, p)
            assert got["has_adv"] == bool(has_adv[c, p])
            assert got["i_adv"] == int(i_adv[c, p])
            if got["has_w"]:
                seen["window"] += 1
                seen["capped"] += got["cnt"] > W
                assert got["cnt"] == int(win["n_win"][c, p])
                n = len(got["pos"])
                assert got["pos"] == win["pos"][c, p, :n].tolist()
                steps = torch.nonzero(bad[c, :, p])[:, 0].tolist()
                assert next_after_screen(alive[c, :, p], got["i"], steps) == \
                    int(i_next[c, p])
    return seen


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**31 - 1),
       T=st.sampled_from([33, 45, 64, 70, 96, 130]),
       p_alive=st.sampled_from([0.2, 0.5, 0.9]),
       W=st.sampled_from([12, 24, 40]))
def test_window_search_matches_gather(seed, T, p_alive, W):
    rng = np.random.default_rng(seed)
    C, P = 2, 9
    alive = rng.random((C, T, P)) < p_alive
    t = np.stack([_days(rng, T, 6 * T) for _ in range(C)])
    cur_i = rng.integers(0, T + 1, (C, P)).astype(np.int32)
    _check_search(alive, cur_i, t, W, rng)


def test_window_search_edges():
    """T not a multiple of 32 and T = 64; a cursor past the last alive
    step; a window of exactly MEOW_SIZE members; more alive members in
    [i, j] than W; no window at all (too few members, too short a span)."""
    rng = np.random.default_rng(5)
    for T in (45, 64, 77):
        C, P = 1, 8
        t = (F32(730000) + np.arange(T, dtype=np.float32) * F32(40))[None]
        alive = np.zeros((C, T, P), bool)
        cur_i = np.zeros((C, P), np.int32)
        alive[0, :, 0] = True                          # exactly MEOW members:
        # every step alive at 40-day spacing: member 12 is 440 days on.
        alive[0, :T // 2, 1] = True
        cur_i[0, 1] = T - 1                            # past the last alive
        alive[0, ::7, 2] = True                        # sparse: long span
        alive[0, :, 3] = True
        cur_i[0, 3] = T - 5                            # too few members left
        alive[0, 3:9, 4] = True                        # 6 members only
        alive[0, 1::2, 5] = True
        cur_i[0, 5] = 30                               # cursor in word 0
        alive[0, -1, 6] = True                         # one alive, the last
        seen = _check_search(alive, cur_i, t, 12, rng)
        assert seen["window"] >= 1
        got = window_search(alive[0, :, 0], 0, t[0], 24)
        assert got["cnt"] == MEOW and got["j"] == MEOW - 1
        for p in (1, 3, 4, 6):
            assert not window_search(alive[0, :, p], int(cur_i[0, p]), t[0],
                                     24)["has_w"], p
    # Dense dates: a year holds more alive members than W.
    T = 200
    t = (F32(730000) + np.arange(T, dtype=np.float32) * F32(3))[None]
    alive = rng.random((1, T, 6)) < 0.8
    seen = _check_search(alive, np.zeros((1, 6), np.int32), t, 40, rng)
    assert seen["capped"] == seen["window"] > 0


# ---------------------------------------------------------------------------
# The median by rank (tmask_warp.cuh's warp_median)
# ---------------------------------------------------------------------------

def order_key(x):
    """tmask_warp.cuh's order_key: an integer key of a float (not NaN)
    with a < b exactly when key(a) < key(b), -0 and +0 one key."""
    b = int(np.asarray(x, np.float32).view(np.uint32))
    b = 0 if b == 0x80000000 else b
    return (~b & FULL) if b >> 31 else b | 0x80000000


def rank_median(vals, memb):
    """The members' median of ``vals`` (float32 by slot) as warp_median2
    takes it: NaN for any NaN member, 0 for none, else the values of ranks
    (m-1)/2 and m/2 averaged as 0.5 * (lo + hi), a member's rank counting
    the slots u whose key is below its own key + (u before it), a
    non-member's key past every key."""
    v = np.asarray(vals, np.float32)
    memb = np.asarray(memb, bool)
    idx = np.flatnonzero(memb)
    m = len(idx)
    with np.errstate(invalid="ignore"):
        if np.isnan(v[idx]).any():
            return F32(np.nan)
    if m == 0:
        return F32(0)
    keys = [order_key(x) if mk else FULL for x, mk in zip(v, memb)]
    lo, hi = (m - 1) // 2, m // 2
    sel = {}
    for s in idx:
        rank = sum(1 for u in range(len(v)) if keys[u] < keys[s] + (u < s))
        if rank == lo:
            sel[0] = v[s]
        if rank == hi:
            sel[1] = v[s]
    return F32(0.5) * (sel[0] + sel[1])


def vee_select(v, k, med):
    """tmask_warp.cuh's vee_select: the k-th smallest of |v - med| over a
    sorted float32 row v, as the least over its windows of k + 1 values of
    the larger distance at the window's ends."""
    v = np.asarray(v, np.float32)
    d = np.abs(v - F32(med))
    return min(max(d[a], d[a + k]) for a in range(len(v) - k))


def stable_median(vals, memb):
    """fb::median's insertion sort, as a stable sort of the members."""
    v = np.asarray(vals, np.float32)[np.asarray(memb, bool)]
    if np.isnan(v).any():
        return F32(np.nan)
    if len(v) == 0:
        return F32(0)
    s = np.sort(v, kind="stable")
    n = len(s)
    return F32(0.5) * (s[(n - 1) // 2] + s[n // 2])


def _same_bits(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    if np.isnan(a) and np.isnan(b):
        return True
    return a.view(np.int32) == b.view(np.int32)


def _check_median(vals, memb):
    got = rank_median(vals, memb)
    assert _same_bits(got, stable_median(vals, memb)), (vals, memb)
    want = masked_median(torch.tensor(np.asarray(vals, np.float32)),
                         torch.tensor(np.asarray(memb, bool))).item()
    # torch.sort leaves the order of equal keys (-0 beside +0) open: a zero
    # median may carry either sign there, so zeros compare by value.
    if np.isnan(got):
        assert np.isnan(want)
    elif got == 0:
        assert want == 0
    else:
        assert _same_bits(got, want), (vals, memb, got, want)


@settings(max_examples=60, deadline=None)
@given(vals=st.lists(st.sampled_from([-2.5, -1.0, -0.0, 0.0, 0.5, 1.0, 3.0,
                                      1e-7, 7.25, -7.25]),
                     min_size=1, max_size=40),
       data=st.data())
def test_rank_median_matches_masked_median(vals, data):
    memb = data.draw(st.lists(st.booleans(), min_size=len(vals),
                              max_size=len(vals)))
    _check_median(vals, memb)


def test_rank_median_edges():
    """Ties, +-0, n = 0, n = 1, even and odd n, a NaN member (NaN out) and
    a NaN outside the members (ignored)."""
    _check_median([3.0, 1.0, 2.0], [False, False, False])          # n = 0
    _check_median([3.0, 1.0, 2.0], [False, True, False])           # n = 1
    _check_median([4.0, 1.0, 3.0, 2.0], [True] * 4)                # even
    _check_median([4.0, 1.0, 3.0, 2.0, 9.0], [True] * 5)           # odd
    _check_median([2.0, 2.0, 1.0, 2.0, 5.0, 2.0], [True] * 6)      # ties
    _check_median([-0.0, 0.0, -0.0, 0.0], [True] * 4)
    _check_median([-0.0, -0.0, 0.0], [True] * 3)
    assert rank_median([-0.0, -0.0, 0.0], [True] * 3).view(np.int32) == \
        F32(-0.0).view(np.int32)                     # the stable pick: -0
    _check_median([1.0, np.nan, 2.0], [True, True, True])
    assert np.isnan(rank_median([1.0, np.nan, 2.0], [True] * 3))
    _check_median([1.0, np.nan, 2.0], [True, False, True])
    assert rank_median([1.0, np.nan, 2.0], [True, False, True]) == 1.5
    rng = np.random.default_rng(3)
    for n in (31, 32, 33, 64, 100, 128):                # the wide instances
        v = rng.integers(-20, 20, n).astype(np.float32)
        _check_median(v, rng.random(n) < 0.7)


# ---------------------------------------------------------------------------
# The Tmask screen on a warp (tmask_warp.cuh's tmask_warp)
# ---------------------------------------------------------------------------

def chol_solve5(G, c):
    """init_window.cuh's chol_solve5 over pixels: G [N,5,5] (lower half),
    c [N,5] float32 -> x [N,5], NaN where a pivot is not > 0."""
    n = c.shape[1]
    L = np.zeros_like(G)
    ok = np.ones(G.shape[0], bool)
    for i in range(n):
        for j in range(i + 1):
            s = G[:, i, j].copy()
            for q in range(j):
                s = s - L[:, i, q] * L[:, j, q]
            if i == j:
                ok &= s > 0
                L[:, i, j] = np.sqrt(np.maximum(s, F32(1e-30)))
            else:
                L[:, i, j] = s / L[:, j, j]
    y = np.zeros_like(c)
    for i in range(n):
        s = c[:, i].copy()
        for q in range(i):
            s = s - L[:, i, q] * y[:, q]
        y[:, i] = s / L[:, i, i]
    x = np.zeros_like(c)
    for i in reversed(range(n)):
        s = y[:, i].copy()
        for q in range(i + 1, n):
            s = s - L[:, q, i] * x[:, q]
        x[:, i] = s / L[:, i, i]
    return np.where(ok[:, None], x, F32(np.nan))


@settings(max_examples=60, deadline=None)
@given(vals=st.lists(st.sampled_from([-np.inf, -2.5, -1.0, -0.0, 0.0, 0.5,
                                      1.0, 3.0, 1e-7, 7.25, np.inf]),
                     min_size=1, max_size=40),
       med=st.sampled_from([-1.0, -0.0, 0.0, 0.25, 1.0, 3.0, 1e30]))
def test_vee_select_is_the_order_statistic(vals, med):
    """The MAD's selection on the sorted residuals equals the order
    statistics of |r - med| (the two middle ones of a member count)."""
    v = np.sort(np.asarray(vals, np.float32), kind="stable")
    with np.errstate(invalid="ignore"):
        d = np.sort(np.abs(v - F32(med)))
        if np.isnan(d).any():
            return                      # inf - inf: the screen takes NaN
        for k in {(len(v) - 1) // 2, len(v) // 2}:
            assert _same_bits(vee_select(v, k, med), d[k]), (v, k, med)


def rank_median_rows(v, memb):
    """rank_median of each row, vectorized: v, memb [N,W]."""
    N, W = v.shape
    u = np.arange(W)
    with np.errstate(invalid="ignore"):
        lt = (v[:, :, None] < v[:, None, :]) | (
            (v[:, :, None] == v[:, None, :]) & (u[:, None] < u[None, :]))
        rank = (lt & memb[:, :, None]).sum(1)                   # [N, W]
        m = memb.sum(1)
        pick = lambda r: np.where(memb & (rank == r[:, None]), v, 0).sum(
            1, dtype=np.float32)
        lo, hi = pick((m - 1) // 2), pick(m // 2)
        med = F32(0.5) * (lo + hi)
        nan = (np.isnan(v) & memb).any(1)
    med = np.where(m == 0, F32(0), med)
    return np.where(nan, F32(np.nan), med).astype(np.float32)


def mad_of(r, med):
    """warp_mad2 of one window's members ``r``: NaN for a NaN distance, 0
    for no member, else the two middle distances by :func:`vee_select` on
    the sorted members, averaged."""
    if np.isnan(np.abs(r - med)).any():
        return F32(np.nan)
    if len(r) == 0:
        return F32(0)
    s, m = np.sort(r), len(r)
    return F32(0.5) * (vee_select(s, (m - 1) // 2, med)
                       + vee_select(s, m // 2, med))


def tmask_warp_model(Xtw, Y2, w, vario2):
    """The warp's screen over N windows: Xtw [N,W,5], Y2 [N,2,W], w [N,W],
    vario2 [N,2] float32 -> flags [N,W].  Per band: the first solve at the
    slot weights, TMASK_IRLS_ITERS reweightings (residuals and Huber
    weights one slot a lane, medians by rank), each of the 20 sums taken
    slot by slot over the members (a lane's loop), then the flags.  The MAD
    is selected from the sorted residuals (:func:`vee_select`)."""
    N, W, nt = Xtw.shape
    memb = w > 0
    pairs = [(a, b) for a in range(nt) for b in range(a + 1)]
    bad = np.zeros((N, W), bool)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        for q in range(2):
            y = Y2[:, q]
            beta = None
            for it in range(params.TMASK_IRLS_ITERS + 1):
                if it == 0:
                    wt = w.copy()
                else:
                    pred = beta[:, 0:1] * Xtw[..., 0]
                    for c in range(1, nt):
                        pred = pred + beta[:, c:c + 1] * Xtw[..., c]
                    r = np.where(memb, y - pred, F32(0))
                    med = rank_median_rows(r, memb)
                    mad = np.array([mad_of(rr[mm], md)
                                    for rr, mm, md in zip(r, memb, med)],
                                   np.float32)
                    sigma = np.maximum(mad / F32(0.6745), F32(1e-6))
                    a = np.abs(r) / (F32(params.HUBER_K) * sigma[:, None])
                    h = np.where(a <= 1, F32(1),
                                 F32(1) / np.maximum(a, F32(1e-12)))
                    wt = (w * h).astype(np.float32)
                sums = []
                for a, b in pairs:                      # lanes 0-14
                    acc = np.zeros(N, np.float32)
                    for s in range(W):
                        acc = np.where(memb[:, s], acc + wt[:, s] * (
                            Xtw[:, s, a] * Xtw[:, s, b]), acc)
                    sums.append(acc)
                for a in range(nt):                     # lanes 15-19
                    acc = np.zeros(N, np.float32)
                    for s in range(W):
                        yw = y[:, s] * wt[:, s]
                        acc = np.where(memb[:, s], acc + yw * Xtw[:, s, a],
                                       acc)
                    sums.append(acc)
                G = np.zeros((N, nt, nt), np.float32)
                for k, (a, b) in enumerate(pairs):
                    G[:, a, b] = sums[k]
                for a in range(nt):
                    G[:, a, a] = G[:, a, a] + F32(1e-9)
                beta = chol_solve5(G, np.stack(sums[len(pairs):], 1))
            pred = beta[:, 0:1] * Xtw[..., 0]
            for c in range(1, nt):
                pred = pred + beta[:, c:c + 1] * Xtw[..., c]
            thr = F32(params.TMASK_CONST) * vario2[:, q]
            bad |= memb & (np.abs(y - pred) > thr[:, None])
    return bad


@functools.lru_cache(maxsize=None)
def _chip_windows(name):
    """The Tmask screen's inputs on a chip's first INIT round: the
    prologue's state (plain versions on the CPU), its initializing pixels'
    windows gathered as the component route gathers them."""
    if name == "landsat-ard-tiny":
        src = SyntheticSource(4, start="1995-01-01", end="1999-06-01",
                              sensor=LANDSAT_ARD_TINY, n_changes=2)
        packed = pack([src.chip(100, 200), src.chip(3100, 200)], bucket=32)
    else:
        src = SyntheticSource(88, start="2019-01-01", end="2023-01-01",
                              cloud_frac=0.15, sensor=SENTINEL2)
        p = pack([src.chip(100, 200)], bucket=32)
        sel = np.arange(64) * (p.spectra.shape[2] // 64)
        packed = dataclasses.replace(
            p, spectra=np.ascontiguousarray(p.spectra[:, :, sel]),
            qas=np.ascontiguousarray(p.qas[:, sel]))
    days, n_obs, spectra, qa = kernel.stage_packed(packed, "cpu")
    X, Xt, t, valid = kernel.device_designs(days, n_obs)
    Yt = spectra.transpose(2, 3).contiguous()
    qa_t = qa.transpose(1, 2).contiguous().to(torch.int32)
    res, st_ = kernel._prologue(X, Xt, t, valid, Yt, qa_t,
                                sensor=packed.sensor, S=kernel.MAX_SEGMENTS,
                                variogram_mode=params.VARIOGRAM_DEFAULT,
                                ops=cuda_ops.PLAIN)
    W = kernel.window_cap(packed)
    win = cuda_ops.init_window_gather(
        st_["alive"], st_["cur_i"], st_["phase"] == kernel.PHASE_INIT, t, X,
        Xt, Yt, W=W)
    Xtw, Y2, w, v2 = cuda_ops.tmask_args(win, res["vario"], packed.sensor)
    flat = lambda a: a.reshape(-1, *a.shape[2:]).numpy().astype(np.float32)
    return flat(Xtw), flat(Y2), flat(w), flat(v2)


def _check_screen(Xtw, Y2, w, v2):
    want = tmask_bad(*(torch.from_numpy(a) for a in (Xtw, Y2, w, v2))).numpy()
    got = tmask_warp_model(Xtw, Y2, w, v2)
    assert np.array_equal(got, want)
    return want


@pytest.mark.parametrize("chip", ["landsat-ard-tiny", "sentinel2"])
def test_tmask_warp_matches_plain_on_chip_windows(chip):
    """The model on every initializing pixel's window of the chip, plus a
    singular window (identical design columns: the Cholesky's NaN, no
    flags) and a pixel with no member."""
    Xtw, Y2, w, v2 = (a.copy() for a in _chip_windows(chip))
    members = w.sum(1)
    assert (members >= MEOW).sum() >= 20
    k = int(np.argmax(members))
    Xtw[k] = 1.0                                    # singular window
    w[k + 1 if k + 1 < len(w) else k - 1] = 0.0     # no member
    want = _check_screen(Xtw, Y2, w, v2)
    assert want.any()
    assert not want[k].any()


@pytest.mark.parametrize("W", [24, 40, 100])
def test_tmask_warp_matches_plain_random(W):
    """Random windows with outliers at the three instances' widths: slots
    past 32 (lanes' second to fourth slots), weights 0 inside the window."""
    rng = np.random.default_rng(W)
    N = 24
    Xtw = rng.normal(0, 1, (N, W, 5)).astype(np.float32)
    Xtw[..., 0] = 1.0
    Y2 = (400 + 80 * rng.normal(0, 1, (N, 2, W))).astype(np.float32)
    Y2[rng.random(Y2.shape) < 0.05] += 900
    w = (rng.random((N, W)) < 0.85).astype(np.float32)
    w[0] = 0.0
    Y2[1] = 444.0                                   # constant series
    v2 = np.abs(rng.normal(40, 10, (N, 2))).astype(np.float32)
    want = _check_screen(Xtw, Y2, w, v2)
    assert want[:, 32:].any() if W > 32 else want.any()
    assert not want[0].any()


# ---------------------------------------------------------------------------
# Shared memory of the two kernels
# ---------------------------------------------------------------------------

def test_init_window_smem_fits_every_shape():
    """init_window takes every shape the one-thread kernel took: T up to
    T_MAX at the widest window instance within the card's 227 KB."""
    for w in cuda_ops.W_MAX_CHOICES:
        assert cuda_ops.init_window_smem_bytes(cuda_ops.T_MAX, w) <= \
            cuda_ops.SMEM_BLOCK_MAX
    # One word column (4 T bytes a tile), then a fixed part by instance.
    a, b = (cuda_ops.init_window_smem_bytes(T, 32) for T in (768, 800))
    assert b - a == 4 * 32
    assert cuda_ops.init_window_smem_bytes(768, 128) > \
        cuda_ops.init_window_smem_bytes(768, 32)


@pytest.mark.parametrize("w_max", [32, 64, 128])
def test_tmask_bad_smem(w_max):
    """A tmask_bad block holds only its warps' window areas (12 rows of
    w_max + 1 floats and 16 more): the window itself is read from the
    gathered planes."""
    assert cuda_ops.tmask_bad_smem_bytes(w_max) == \
        4 * 8 * (12 * (w_max + 1) + 16) <= cuda_ops.SMEM_BLOCK_MAX
