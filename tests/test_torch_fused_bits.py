"""The tile kernels' bit-mask monitor and dense fit, rehearsed on the CPU.

``csrc/word_monitor.cuh`` (run by ``fused_round`` and
``monitor_chain_scored``) keeps two bits of each score (s > outlier, s >
change) beside the alive and included columns as 32-bit words and runs the
monitor's passes 1-4 on the words with popcounts.  :func:`word_events`
below is a numpy model of that word logic, line for line; it is held equal
to the plain event chain (``cuda_ops.monitor_chain_plain`` /
``monitor_chain_scored_plain``) on random states through a hypothesis
property and on named edge cases, and :func:`scored_launch` models a whole
``monitor_chain_scored`` launch (zeros for a pixel that does not monitor).
:func:`dense_fit_sums` models ``csrc/dense_fit.cuh``'s split of the fit
over eight lanes (12 bands: two a lane on lanes 0-3).  The launch-geometry
helpers are checked here too.  Nothing here needs a card.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from firebird_tpu_torch.ccd import cuda_ops, harmonic, params
from firebird_tpu_torch.ccd.sensor import chi2_thresholds


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CHANGE_THR, OUTLIER_THR = chi2_thresholds(5)
PEEK = params.PEEK_SIZE
FULL = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# The model: the kernel's helpers and passes, on Python ints
# ---------------------------------------------------------------------------

def popc(v):
    return bin(v).count("1")


def ffs(v):
    """1 + the index of the lowest set bit, 0 for none (CUDA __ffs)."""
    return (v & -v).bit_length()


def below(w, lim):
    k = lim - 32 * w
    return 0 if k <= 0 else (FULL if k >= 32 else (1 << k) - 1)


def between(a, b):
    return ((1 << b) - 1) & ~((2 << a) - 1) & FULL


def words(col):
    """A boolean column [T] as ceil(T/32) words."""
    T = len(col)
    return [sum(1 << j for j in range(32) if 32 * w + j < T and col[32 * w + j])
            for w in range(-(-T // 32))]


def count_below(m, t):
    return sum(popc(m[w] & below(w, t)) for w in range(len(m)) if 32 * w < t)


def step_of_rank(m, T, r):
    for w, v in enumerate(m):
        pc = popc(v)
        if r < pc:
            for _ in range(r):
                v &= v - 1
            return 32 * w + ffs(v) - 1
        r -= pc
    return T


def word_events(alive, included, s, ck, nl, change_thr, outlier_thr):
    """One monitoring pixel's event and partition from its columns (alive,
    included [T] bool, score s [T]), as fused_round.cu computes them."""
    T = len(alive)
    W = -(-T // 32)
    el_t = [bool(alive[t]) and t >= ck for t in range(T)]
    A = words(alive)
    I = words(included)
    O = words([el_t[t] and s[t] > outlier_thr for t in range(T)])
    E = words([el_t[t] and s[t] > change_thr for t in range(T)])
    INF = T + 1
    m = sum(popc(a) for a in A)
    kq = sum(popc(A[w] & below(w, ck)) for w in range(W))
    n0 = sum(popc(v) for v in I)
    # Pass 2.
    refit_thr = np.float32(params.REFIT_FACTOR) * np.float32(nl)
    has_refit, f_abs, f_rank, ninc_f, absq, ninc0, before = (False, 0, 0, 0,
                                                             0, n0, 0)
    for w in range(W):
        a = A[w]
        ab = a & ~below(w, ck) & ~O[w] & FULL
        pc = popc(ab)
        if w == 0:
            ninc0 = n0 + (ab & 1)
        if not has_refit and pc and np.float32(n0 + absq + pc) >= refit_thr:
            r, cnt = ab, absq
            while r:
                j = ffs(r) - 1
                cnt += 1
                if np.float32(n0 + cnt) >= refit_thr:
                    has_refit, f_abs = True, 32 * w + j
                    f_rank = before + popc(a & below(0, j))
                    ninc_f = n0 + cnt
                    break
                r &= r - 1
        absq += pc
        before += popc(a)
    # Pass 3.
    has_brk, b_abs, run, run_at = False, 0, 0, 0
    for w in range(W):
        el = A[w] & ~below(w, ck) & FULL
        x = E[w] & el
        n = el & ~x
        cont = x & ((n & -n) - 1) if n else x
        if cont:
            if run == 0:
                run_at = 32 * w + ffs(cont) - 1
            run += popc(cont)
        if run >= PEEK:
            has_brk, b_abs = True, run_at
            break
        if not n:
            continue
        lo, hi = ffs(n) - 1, n.bit_length() - 1
        if hi > lo and popc(x & between(lo, hi)) >= PEEK:
            a, r = lo, n & (n - 1)
            while r:
                b = ffs(r) - 1
                seg = x & between(a, b)
                if popc(seg) >= PEEK:
                    has_brk, b_abs = True, 32 * w + ffs(seg) - 1
                    break
                a, r = b, r & (r - 1)
            if has_brk:
                break
        tail = x & ~((2 << hi) - 1) & FULL
        run = popc(tail)
        run_at = 32 * w + ffs(tail) - 1 if tail else 0
        if run >= PEEK:
            has_brk, b_abs = True, run_at
            break
    b_rank = ninc_b = 0
    if has_brk:
        b_rank = count_below(A, b_abs)
        ninc_b = n0 + sum(popc(A[w] & ~below(w, ck) & ~O[w] & below(w, b_abs + 1))
                          for w in range(W) if 32 * w <= b_abs)
    q_tail = max(m - (PEEK - 1), kq)
    b_ev = b_rank if has_brk else INF
    f_ev = f_rank if has_refit else INF
    is_tail = q_tail <= min(b_ev, f_ev)
    is_brk = not is_tail and has_brk and b_ev <= f_ev
    is_refit = not is_tail and not is_brk and has_refit
    ev_rank = q_tail if is_tail else (b_ev if is_brk else f_ev)
    # Pass 4.
    n_pos = step_of_rank(A, T, ev_rank + 1 if is_refit else ev_rank)
    t_pos = step_of_rank(A, T, q_tail) if is_tail else T
    in_q, rm_q, n_exceed = [], [], 0
    for w in range(W):
        el = A[w] & ~below(w, ck) & FULL
        normal = el & below(w, n_pos)
        tail = el & ~below(w, t_pos) & FULL
        in_q.append((normal & ~O[w]) | (tail & ~E[w]))
        rm_q.append((normal & O[w]) | (tail & E[w]))
        n_exceed += popc(tail & E[w])
    bit = lambda ws, t: bool((ws[t // 32] >> (t % 32)) & 1)
    return dict(m=m, is_tail=is_tail, is_brk=is_brk, is_refit=is_refit,
                ev_rank=ev_rank, pos_ev=b_abs if is_brk else f_abs,
                n_exceed=n_exceed,
                n_rf=ninc_b if is_brk else (ninc_f if has_refit else ninc0),
                inc_q=[bit(in_q, t) for t in range(T)],
                rem_q=[bit(rm_q, t) for t in range(T)])


# ---------------------------------------------------------------------------
# Held to the plain chain
# ---------------------------------------------------------------------------

def _check(s, alive, included, cur_k, nlast):
    """The model against monitor_chain_plain on score plane s [1,T,P] and
    states (numpy), every pixel monitoring."""
    T, P = alive.shape
    want = cuda_ops.monitor_chain_plain(
        torch.from_numpy(s)[None], torch.from_numpy(alive)[None],
        torch.from_numpy(included)[None],
        torch.from_numpy(cur_k.astype(np.int32))[None],
        torch.from_numpy(nlast.astype(np.int32))[None],
        torch.ones(1, P, dtype=torch.bool), change_thr=CHANGE_THR,
        outlier_thr=OUTLIER_THR)
    for p in range(P):
        got = word_events(alive[:, p], included[:, p], s[:, p], int(cur_k[p]),
                           int(nlast[p]), CHANGE_THR, OUTLIER_THR)
        for k, v in got.items():
            w = want[k][0, :, p] if k in ("inc_q", "rem_q") else want[k][0, p]
            assert np.array_equal(np.asarray(v), w.numpy()), (p, k)


def _scored_states(seed, T, P, p_alive=0.85, spread=1.0):
    """Random states, scores from the plain scorer on spectra made from a
    per-pixel model with a step up half way through some pixels."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.choice(np.arange(729000, 729000 + 20 * T), T,
                           replace=False)).astype(np.float64)
    X = harmonic.design_matrix(t, t[0], 8).astype(np.float32)
    beta = np.zeros((P, 5, 8), np.float32)
    beta[..., 0] = rng.uniform(500, 3000, (P, 5))
    beta[..., 2:6] = rng.normal(0, 150, (P, 5, 4))
    Y = np.einsum("pbk,tk->btp", beta, X) + rng.normal(0, 20 * spread,
                                                        (5, T, P))
    Y[:, T // 2:, rng.random(P) < 0.4] += 300
    s = cuda_ops.score_plain(
        torch.from_numpy(Y.astype(np.int16))[None], torch.from_numpy(beta)[None],
        torch.from_numpy(rng.uniform(15, 40, (1, P, 5)).astype(np.float32)),
        torch.from_numpy(X)[None])[0].numpy()
    alive = rng.random((T, P)) < p_alive
    cur_k = rng.integers(-2, T + 3, P)
    included = alive & (np.arange(T)[:, None] < cur_k[None, :]) \
        & (rng.random((T, P)) < 0.9)
    nlast = np.where(rng.random(P) < 0.5, included.sum(0),
                     rng.integers(0, 3 * T, P))
    return s, alive, included, cur_k, nlast


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), T=st.sampled_from([20, 32, 45, 64,
                                                          97, 128]),
       p_alive=st.sampled_from([0.3, 0.85, 1.0]),
       spread=st.sampled_from([0.5, 1.0, 6.0]))
def test_word_events_match_plain(seed, T, p_alive, spread):
    _check(*_scored_states(seed, T, 12, p_alive, spread))


def _plane(T, P, value=1.0):
    return np.full((T, P), value, np.float32)


def test_word_events_t_not_multiple_of_32():
    for T in (33, 70, 95):
        _check(*_scored_states(7 + T, T, 16))


def test_word_events_no_alive_observation():
    T, P = 40, 3
    alive = np.zeros((T, P), bool)
    _check(_plane(T, P), alive, alive.copy(), np.array([0, 5, 40]),
           np.array([0, 3, 10]))


def test_word_events_all_alive_and_exceeding():
    T, P = 70, 3
    alive = np.ones((T, P), bool)
    included = np.arange(T)[:, None] < np.array([0, 10, 33])[None, :]
    _check(_plane(T, P, 1e6), alive, included, np.array([0, 10, 33]),
           np.array([1, 10, 1000]))


def test_word_events_peek_run_across_word_boundary():
    """Runs of exceedances that start in one word and end in the next, one
    too short and one long enough (and one cut by a gap of dead steps)."""
    T, P = 96, 3
    s = _plane(T, P)
    alive = np.ones((T, P), bool)
    s[29:34, 0] = 1e4                 # five exceedances: no break
    s[29:35, 1] = 1e4                 # six: a break at 29
    s[[28, 30, 31, 40, 41, 64], 2] = 1e4
    alive[32:40, 2] = False           # ranks 28, 30, 31, 40, 41 adjacent
    alive[42:64, 2] = False           # then 64: the run of six crosses two
    included = np.zeros((T, P), bool)
    _check(s, alive, included, np.array([3, 3, 3]), np.array([1000] * 3))
    got = word_events(alive[:, 1], included[:, 1], s[:, 1], 3, 1000,
                      CHANGE_THR, OUTLIER_THR)
    assert got["is_brk"] and got["pos_ev"] == 29


def test_word_events_cursor_past_last_alive():
    T, P = 50, 3
    rng = np.random.default_rng(5)
    alive = rng.random((T, P)) < 0.6
    alive[40:] = False
    _check(rng.uniform(0, 30, (T, P)).astype(np.float32), alive,
           alive & (rng.random((T, P)) < 0.5), np.array([41, 50, 200]),
           np.array([5, 5, 5]))


def test_word_events_refit_at_first_absorbed():
    """A last fit of 1: n0 + 1 >= 1.33 at the first absorbed observation."""
    T, P = 64, 2
    alive = np.ones((T, P), bool)
    alive[:5, 1] = False
    included = np.arange(T)[:, None] < 10
    s = _plane(T, P)
    s[10, 0] = 1e4                    # an outlier: the next step absorbs
    _check(s, alive, included & alive, np.array([10, 10]), np.array([1, 1]))
    got = word_events(alive[:, 0], included[:, 0], s[:, 0], 10, 1,
                      CHANGE_THR, OUTLIER_THR)
    assert got["is_refit"] and got["pos_ev"] == 11


# ---------------------------------------------------------------------------
# monitor_chain_scored: the word model over a whole launch
# ---------------------------------------------------------------------------

def scored_launch(Yd, coefs_d, dden, X, alive, included, cur_k, nlast,
                  in_mon):
    """monitor_chain_scored's outputs as csrc/monitor_chain_scored.cu
    computes them for one chip: the score of every eligible alive step of
    a monitoring pixel (the plain scorer's floats; only their two bits are
    kept), the word events and partition of :func:`word_events`, and the
    zero outputs of a pixel that does not monitor.  Inputs are numpy
    ([5,T,P] spectra, [P,5,8] / [P,5] model, [T,8] design, [T,P] planes,
    [P] vectors); returns the eight fields [P] and both planes [T,P]."""
    T, P = alive.shape
    s = cuda_ops.score_plain(
        torch.from_numpy(Yd)[None], torch.from_numpy(coefs_d)[None],
        torch.from_numpy(dden)[None], torch.from_numpy(X)[None])[0].numpy()
    out = {k: np.zeros(P, np.int64) for k in KEYS}
    out.update(inc_q=np.zeros((T, P), bool), rem_q=np.zeros((T, P), bool))
    for p in range(P):
        if not in_mon[p]:
            continue
        got = word_events(alive[:, p], included[:, p], s[:, p], int(cur_k[p]),
                          int(nlast[p]), CHANGE_THR, OUTLIER_THR)
        for k, v in got.items():
            if k in ("inc_q", "rem_q"):
                out[k][:, p] = v
            else:
                out[k][p] = v
    return out


KEYS = ("m", "is_tail", "is_brk", "is_refit", "ev_rank", "pos_ev",
        "n_exceed", "n_rf")


def _spectra_states(seed, T, P, p_mon=0.7):
    """Monitor inputs made from a per-pixel model with a step of 300 half
    way through some pixels, random cursors, included sets, last fit
    counts and monitoring flags."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.choice(np.arange(729000, 729000 + 20 * T), T,
                           replace=False)).astype(np.float64)
    X = harmonic.design_matrix(t, t[0], 8).astype(np.float32)
    beta = np.zeros((P, 5, 8), np.float32)
    beta[..., 0] = rng.uniform(500, 3000, (P, 5))
    beta[..., 2:6] = rng.normal(0, 150, (P, 5, 4))
    Y = np.einsum("pbk,tk->btp", beta, X) + rng.normal(0, 20, (5, T, P))
    Y[:, T // 2:, rng.random(P) < 0.4] += 300
    alive = rng.random((T, P)) < 0.85
    cur_k = rng.integers(-2, T + 3, P)
    included = alive & (np.arange(T)[:, None] < cur_k[None, :]) \
        & (rng.random((T, P)) < 0.9)
    nlast = np.where(rng.random(P) < 0.5, included.sum(0),
                     rng.integers(0, 3 * T, P))
    return dict(Yd=Y.astype(np.int16), coefs_d=beta,
                dden=rng.uniform(15, 40, (P, 5)).astype(np.float32), X=X,
                alive=alive, included=included, cur_k=cur_k.astype(np.int32),
                nlast=nlast.astype(np.int32), in_mon=rng.random(P) < p_mon)


def _check_scored(a):
    """The launch model against monitor_chain_scored_plain with the
    non-monitoring pixels' outputs zeroed (cuda_ops.monitoring_only)."""
    tt = lambda v: torch.from_numpy(np.ascontiguousarray(v))[None]
    want = cuda_ops.monitoring_only(cuda_ops.monitor_chain_scored_plain(
        tt(a["Yd"]), tt(a["coefs_d"]), tt(a["dden"]), tt(a["X"]),
        tt(a["alive"]), tt(a["included"]), tt(a["cur_k"]), tt(a["nlast"]),
        tt(a["in_mon"]), change_thr=CHANGE_THR, outlier_thr=OUTLIER_THR),
        tt(a["in_mon"]))
    got = scored_launch(**a)
    assert set(got) == set(want)
    for k, v in got.items():
        assert np.array_equal(v, want[k][0].numpy()), k
    return got


@pytest.mark.parametrize("seed,T", [(1, 64), (2, 96), (3, 33), (4, 70),
                                    (5, 95)])
def test_scored_launch_matches_plain(seed, T):
    """Seeded states, T a multiple of 32 and not."""
    got = _check_scored(_spectra_states(seed, T, 24))
    assert got["is_tail"].any() or got["is_brk"].any() or \
        got["is_refit"].any()


def test_scored_launch_edge_cases():
    """No alive step, a cursor past the last alive step, no monitoring
    pixel in the launch, and a PEEK run of exceedances across a word
    boundary (a step of 5000 from t = 29 on pixel 3)."""
    a = _spectra_states(11, 70, 8, p_mon=1.0)
    a["alive"][:, 0] = False
    a["alive"][50:, 1] = False
    a["cur_k"][1] = 55
    a["Yd"][:, 29:, 3] += 5000
    a["alive"][:, 3] = True
    a["cur_k"][3] = 5
    a["nlast"][3] = 1000
    got = _check_scored(a)
    assert got["m"][0] == 0 and got["is_tail"][0]
    assert got["is_brk"][3] and got["pos_ev"][3] == 29
    a["in_mon"][:] = False
    got = _check_scored(a)
    assert not any(v.any() for v in got.values())


# ---------------------------------------------------------------------------
# The dense fit's lane split (csrc/dense_fit.cuh)
# ---------------------------------------------------------------------------

LANES = 8
FIT_BATCH = 4


def lane_bands(l, nb):
    """The bands lane l of a group owns: l, l + 8, ... below nb."""
    return list(range(l, nb, LANES))


def dense_fit_sums(win, Y, X):
    """The Gram rows and correlations as dense_fit's lanes sum them: lane l
    walks the window's set bits FIT_BATCH at a time, in time order, adding
    x_l * x_j to its Gram row (j >= l) and y_b * x_k to each of its bands'
    correlations (the weight-1 products of Gram::add left out), every
    operation rounded to float32.  Returns (G [8,8] upper rows, c [nb,8],
    the order in which each band's terms were added)."""
    f = np.float32
    steps = [t for t in range(len(win)) if win[t]]
    nb = Y.shape[0]
    G = np.zeros((8, 8), f)
    c = np.zeros((nb, 8), f)
    order = {b: [] for b in range(nb)}
    for l in range(LANES):
        for k0 in range(0, len(steps), FIT_BATCH):
            for t in steps[k0:k0 + FIT_BATCH]:
                x = X[t]
                for j in range(l, 8):
                    G[l, j] = f(G[l, j] + f(x[l] * x[j]))
                for b in lane_bands(l, nb):
                    order[b].append(t)
                    for k in range(8):
                        c[b, k] = f(c[b, k] + f(f(Y[b, t]) * x[k]))
    return G, c, order


def fit_window_sums(win, Y, X):
    """fb::Gram::add over the window in time order, one observation at a
    time (fb::fit_window's accumulation), in float32."""
    f = np.float32
    nb = Y.shape[0]
    G = np.zeros((8, 8), f)
    c = np.zeros((nb, 8), f)
    for t in range(len(win)):
        if not win[t]:
            continue
        x = X[t]
        for i in range(8):
            for j in range(i, 8):
                G[i, j] = f(G[i, j] + f(f(1) * f(x[i] * x[j])))
        for b in range(nb):
            yw = f(f(Y[b, t]) * f(1))
            for k in range(8):
                c[b, k] = f(c[b, k] + f(yw * x[k]))
    return G, c


@pytest.mark.parametrize("nb", [7, 12])
def test_dense_fit_lane_split_keeps_time_order(nb):
    """Every band is owned by one lane (12 bands: lanes 0-3 two each,
    lanes 4-7 one), each band's correlation terms are added in time order,
    and the lanes' sums equal fit_window's bit for bit (the weight-1
    products it keeps are exact)."""
    owners = [l for b in range(nb) for l in range(LANES)
              if b in lane_bands(l, nb)]
    assert sorted(set(owners)) == list(range(min(nb, LANES)))
    assert len(owners) == nb
    if nb == 12:
        assert [len(lane_bands(l, nb)) for l in range(LANES)] == \
            [2, 2, 2, 2, 1, 1, 1, 1]
    rng = np.random.default_rng(nb)
    T = 77
    t = np.sort(rng.choice(np.arange(729000, 731000), T, replace=False))
    X = harmonic.design_matrix(t.astype(np.float64), float(t[0]),
                               8).astype(np.float32)
    Y = rng.integers(-2000, 9000, (nb, T)).astype(np.int16)
    win = rng.random(T) < 0.6
    G, c, order = dense_fit_sums(win, Y, X)
    G_ref, c_ref = fit_window_sums(win, Y, X)
    steps = [t for t in range(T) if win[t]]
    assert all(order[b] == steps for b in range(nb))
    assert np.array_equal(np.triu(G), np.triu(G_ref))
    assert np.array_equal(c, c_ref)


# ---------------------------------------------------------------------------
# Launch geometry
# ---------------------------------------------------------------------------

def test_fused_round_smem_bytes():
    # X and t (9T floats), 32 Grams of 65 floats, five masks of ceil(T/32)
    # words for 32 pixels, five ints a pixel and four more.
    assert cuda_ops.fused_round_smem_bytes(768) == 4 * (
        9 * 768 + 32 * 65 + 5 * 24 * 32 + 5 * 32 + 4) == 51984
    assert cuda_ops.fused_round_smem_bytes(33) == 4 * (
        9 * 33 + 32 * 65 + 5 * 2 * 32 + 5 * 32 + 4)


def test_fused_round_geometry_refuses_large_t():
    ok = cuda_ops.fused_round_geometry(3968)
    assert ok["smem_bytes"] <= 227 * 1024
    with pytest.raises(ValueError, match="shared memory"):
        cuda_ops.fused_round_geometry(4096)


def test_tile_kernels_smem_bytes():
    # lasso_fit: X (8T floats), 32 Grams of 65 floats, one weight mask of
    # ceil(T/32) words for 32 pixels, two ints a pixel and four more;
    # monitor_chain_scored: X and four masks, two ints a pixel.
    assert cuda_ops.lasso_fit_smem_bytes(768) == 4 * (
        8 * 768 + 32 * 65 + 24 * 32 + 2 * 32 + 4)
    assert cuda_ops.monitor_chain_scored_smem_bytes(768) == 4 * (
        8 * 768 + 4 * 24 * 32 + 2 * 32)
    for fn in (cuda_ops.lasso_fit_smem_bytes,
               cuda_ops.monitor_chain_scored_smem_bytes):
        assert fn(64) < fn(65) < fn(768)
        with pytest.raises(ValueError, match="shared memory"):
            cuda_ops._check_smem("tile", fn(8192))


@pytest.mark.parametrize("T,blocks", [(64, 3), (768, 3), (1536, 2),
                                      (2048, 1)])
def test_fused_round_blocks_per_sm(T, blocks):
    """Three blocks an SM (24 warps) at 80 registers a thread until the
    shared memory allows fewer."""
    g = cuda_ops.fused_round_geometry(T)
    assert g["blocks_per_sm"] == blocks
    assert g["warps_per_sm"] == blocks * 8
