"""The component route's tile kernels, rehearsed on the CPU.

``csrc/monitor_chain.cu`` runs ``monitor_chain_scored``'s word steps on a
precomputed score plane: it reads the score only at the alive steps t >=
cur_k of a monitoring pixel, keeps two bits of it (s > outlier, s >
change), runs the word events of ``csrc/word_monitor.cuh`` and gives a
pixel that does not monitor the zero outputs.  :func:`plane_launch` models
a launch with ``tests/test_torch_fused_bits.py``'s :func:`word_events` and
is held to ``cuda_ops.monitor_chain_plain`` through ``monitoring_only`` by a
hypothesis property and on named edges.

``csrc/lasso_cd.cu`` runs a pixel's bands over four lanes, each band's
chain on its own, and gives bands whose correlations are all +-0 (on a
finite Gram with a positive finite diagonal) +0 without their sweeps.  The premise of that skip, the split by band and a model of a
launch (:func:`cd_launch`) are held to ``cuda_ops.lasso_cd_plain`` bit for
bit.  The shared-memory formulas of both kernels are checked too.  Nothing
here needs a card.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from hypothesis.extra import numpy as hnp

from firebird_tpu_torch.ccd import cuda_ops, harmonic


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_fused_bits import (CHANGE_THR, KEYS, OUTLIER_THR,  # noqa: E402
                                   _scored_states, word_events)

K = cuda_ops.K


# ---------------------------------------------------------------------------
# monitor_chain: the word model over a launch on a score plane
# ---------------------------------------------------------------------------

def plane_launch(s, alive, included, cur_k, nlast, in_mon):
    """monitor_chain's outputs as csrc/monitor_chain.cu computes them for
    one chip (numpy [T,P] planes, [P] vectors): a monitoring pixel's score
    read at its eligible steps (alive, t >= cur_k) alone, the word events
    and partition of :func:`word_events` on it, and the zero outputs of a
    pixel that does not monitor."""
    T, P = alive.shape
    out = {k: np.zeros(P, np.int64) for k in KEYS}
    out.update(inc_q=np.zeros((T, P), bool), rem_q=np.zeros((T, P), bool))
    for p in range(P):
        if not in_mon[p]:
            continue
        eligible = alive[:, p] & (np.arange(T) >= cur_k[p])
        read = np.where(eligible, s[:, p], np.float32(np.nan))
        got = word_events(alive[:, p], included[:, p], read, int(cur_k[p]),
                          int(nlast[p]), CHANGE_THR, OUTLIER_THR)
        for k, v in got.items():
            if k in ("inc_q", "rem_q"):
                out[k][:, p] = v
            else:
                out[k][p] = v
    return out


def _check_plane(s, alive, included, cur_k, nlast, in_mon):
    """The launch model against monitor_chain_plain with the
    non-monitoring pixels' outputs zeroed (cuda_ops.monitoring_only)."""
    tt = lambda v: torch.from_numpy(np.ascontiguousarray(v))[None]
    mon = tt(in_mon)
    want = cuda_ops.monitoring_only(cuda_ops.monitor_chain_plain(
        tt(s.astype(np.float32)), tt(alive), tt(included),
        tt(cur_k.astype(np.int32)), tt(nlast.astype(np.int32)), mon,
        change_thr=CHANGE_THR, outlier_thr=OUTLIER_THR), mon)
    got = plane_launch(s, alive, included, cur_k, nlast, in_mon)
    assert set(got) == set(want)
    for k, v in got.items():
        assert np.array_equal(v, want[k][0].numpy()), k
    return got


def _states(seed, T, P, p_mon=0.7, **kw):
    s, alive, included, cur_k, nlast = _scored_states(seed, T, P, **kw)
    in_mon = np.random.default_rng(seed + 1).random(P) < p_mon
    return s, alive, included, cur_k, nlast, in_mon


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), T=st.integers(33, 130),
       p_alive=st.sampled_from([0.3, 0.85, 1.0]),
       spread=st.sampled_from([0.5, 1.0, 6.0]),
       p_mon=st.sampled_from([0.0, 0.5, 1.0]))
def test_plane_launch_matches_plain(seed, T, p_alive, spread, p_mon):
    _check_plane(*_states(seed, T, 12, p_mon, p_alive=p_alive,
                          spread=spread))


def test_plane_launch_scores_at_the_thresholds():
    """Scores exactly at each threshold (neither is exceeded: the compares
    are strict), one float above, NaN (exceeds neither) and +-inf."""
    s, alive, included, cur_k, nlast, in_mon = _states(21, 96, 16, 1.0)
    rng = np.random.default_rng(21)
    specials = np.float32([CHANGE_THR, OUTLIER_THR,
                           np.nextafter(np.float32(CHANGE_THR), np.inf),
                           np.nextafter(np.float32(OUTLIER_THR), np.inf),
                           np.nan, np.inf, -np.inf])
    pick = rng.random(s.shape) < 0.4
    s = np.where(pick, rng.choice(specials, s.shape), s).astype(np.float32)
    cur_k[:] = np.minimum(cur_k, 20)
    got = _check_plane(s, alive, included, cur_k, nlast, in_mon)
    assert got["is_brk"].any() or got["is_tail"].any()
    # A plane of NaN scores exceeds nothing: every eligible step absorbs.
    nan = np.full_like(s, np.nan)
    got = _check_plane(nan, alive, included, cur_k, nlast, in_mon)
    assert not got["is_brk"].any() and got["n_exceed"].sum() == 0


def test_plane_launch_edges():
    """No alive step, a cursor past the last alive step, a PEEK run across
    a word boundary (t = 29..34), T not a multiple of 32, and a launch
    with no monitoring pixel."""
    T, P = 70, 6
    s, alive, included, cur_k, nlast, in_mon = _states(31, T, P, 1.0)
    alive[:, 0] = False
    alive[50:, 1] = False
    cur_k[1] = 55
    alive[:, 2] = True
    s[:, 2] = 1.0
    s[29:35, 2] = 1e4
    cur_k[2], nlast[2] = 3, 1000
    included[:, 2] = False
    got = _check_plane(s, alive, included, cur_k, nlast, in_mon)
    assert got["m"][0] == 0 and got["is_tail"][0]
    assert got["is_brk"][2] and got["pos_ev"][2] == 29
    got = _check_plane(s, alive, included, cur_k, nlast,
                       np.zeros(P, bool))
    assert not any(v.any() for v in got.values())


def test_plane_launch_reads_no_score_it_does_not_need():
    """The plain chain ignores the scores at dead steps, before the cursor
    and of pixels that do not monitor: changing them all leaves its
    outputs (through monitoring_only) as they were."""
    s, alive, included, cur_k, nlast, in_mon = _states(41, 100, 16, 0.6)
    unread = ~(alive & (np.arange(100)[:, None] >= cur_k[None, :])
               & in_mon[None, :])
    noise = np.random.default_rng(41).uniform(0, 1e5, s.shape)
    a = _check_plane(s, alive, included, cur_k, nlast, in_mon)
    b = _check_plane(np.where(unread, noise, s).astype(np.float32), alive,
                     included, cur_k, nlast, in_mon)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# lasso_cd: the skip and the split by band
# ---------------------------------------------------------------------------

def _bits(t):
    return t.contiguous().view(torch.int32)


finite32 = st.floats(width=32, allow_nan=False, allow_infinity=False)
# The positive float32s, the least subnormal up.
positive32 = st.floats(width=32, min_value=float(np.float32(1e-45)),
                       max_value=float(np.finfo(np.float32).max))


@settings(max_examples=40, deadline=None)
@given(nb=st.sampled_from([7, 12]),
       G=hnp.arrays(np.float32, (2, K, K), elements=finite32),
       diag=hnp.arrays(np.float32, (2, K), elements=positive32),
       signs=hnp.arrays(np.bool_, (2, 12, K)),
       mask=hnp.arrays(np.bool_, (2, K)))
def test_zero_systems_give_positive_zero(nb, G, diag, signs, mask):
    """The skip's premise: a c row of +-0 on any finite Gram with a
    positive diagonal gives +0 bits on every coefficient."""
    G, d, m = (torch.from_numpy(a)[None] for a in (G, diag, mask))
    c = torch.where(torch.from_numpy(signs[:, :nb])[None], -0.0, 0.0)
    beta = cuda_ops.lasso_cd_plain(G, c, d, m)
    assert beta.shape == (1, 2, nb, K)
    assert (_bits(beta) == 0).all()


def _systems(seed, nb, C=2, P=37, T=48):
    """Gram systems of random spectra over random windows, some pixels'
    windows empty (their c rows +-0), coefficient masks of 4, 6 or 8."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.choice(np.arange(729000, 731000), T, replace=False))
    X = harmonic.design_matrix(t.astype(np.float64), float(t[0]), K)
    X = torch.from_numpy(np.broadcast_to(X, (C, T, K)).astype(np.float32))
    Yt = torch.from_numpy(rng.integers(-200, 8000, (C, nb, T, P))
                          .astype(np.int16))
    w = rng.random((C, T, P)) < 0.7
    w[:, :, rng.random(P) < 0.4] = False
    G, c, _ = cuda_ops.gram_plain(Yt, torch.from_numpy(w.astype(np.float32)),
                                  X.contiguous())
    diag = torch.diagonal(G, dim1=-2, dim2=-1).clamp_min(1e-12).contiguous()
    mask = torch.from_numpy(np.arange(K) < rng.choice([4, 6, 8], (C, P))
                            [..., None])
    return G, c, diag, mask


@pytest.mark.parametrize("nb", [7, 12])
@pytest.mark.parametrize("seed", [1, 2])
def test_lasso_cd_split_by_band(nb, seed):
    """lasso_cd_plain on each band alone equals it over all bands, bit for
    bit: the split the kernel makes, each band's chain on its own."""
    G, c, diag, mask = _systems(seed, nb)
    whole = cuda_ops.lasso_cd_plain(G, c, diag, mask)
    for b in range(nb):
        one = cuda_ops.lasso_cd_plain(G, c[:, :, b:b + 1].contiguous(), diag,
                                      mask)
        assert torch.equal(_bits(one[:, :, 0]), _bits(whole[:, :, b])), b


def cd_launch(G, c, diag, mask):
    """lasso_cd's output as csrc/lasso_cd.cu computes it: a pixel is unfit
    for the skip where its Gram is not finite or its diagonal not positive
    and finite; a (pixel, band) with a nonzero correlation, or of an unfit
    pixel, runs its chain (the plain loop on that one system), every other
    gets +0 without one."""
    C, P, B = c.shape[:3]
    unfit = (~torch.isfinite(G).flatten(2).all(-1)
             | ~((diag > 0) & (diag < float("inf"))).all(-1))
    out = torch.zeros(C, P, B, K)
    for ci in range(C):
        for p in range(P):
            for b in range(B):
                if unfit[ci, p] or (c[ci, p, b] != 0).any():
                    out[ci, p, b] = cuda_ops.lasso_cd_plain(
                        G[ci, p][None, None], c[ci, p, b][None, None, None],
                        diag[ci, p][None, None], mask[ci, p][None, None])[
                            0, 0, 0]
    return out


@pytest.mark.parametrize("nb", [7, 12])
def test_cd_launch_matches_plain(nb):
    """The launch model bit for bit against lasso_cd_plain, with pixels
    whose systems are all zero, some zero bands, and zero systems that may
    not be skipped: a Gram with a NaN or an inf, a zero or negative
    diagonal entry."""
    G, c, diag, mask = _systems(3, nb, C=1, P=40)
    zero = (c == 0).all(-1).all(-1)[0]
    assert zero.any() and (~zero).any()
    c[0, 1, : nb // 2] = 0.0
    c[0, 2, 1] = -0.0
    z = [int(p) for p in torch.nonzero(zero)[:4, 0]]
    G[0, z[0], 3, 5] = float("nan")
    G[0, z[1], 0, 0] = float("inf")
    diag[0, z[2], 4] = 0.0
    diag[0, z[3], 2] = -1.0
    want = cuda_ops.lasso_cd_plain(G, c, diag, mask)
    got = cd_launch(G, c, diag, mask)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.isnan(want[0, z[0]]).any()


# ---------------------------------------------------------------------------
# Shared memory
# ---------------------------------------------------------------------------

def test_component_kernels_smem_bytes():
    # monitor_chain: four masks of ceil(T/32) words for 32 pixels, two ints
    # a pixel.  lasso_cd: a Gram of 68 floats a pixel of the tile, a queue
    # of two tiles of ints and its length, a flag byte a pixel.
    assert cuda_ops.monitor_chain_smem_bytes(768) == 4 * (
        4 * 24 * 32 + 2 * 32) == 12544
    assert cuda_ops.monitor_chain_smem_bytes(33) == 4 * (4 * 2 * 32 + 64)
    assert cuda_ops.monitor_chain_smem_bytes(64) < \
        cuda_ops.monitor_chain_smem_bytes(65)
    assert cuda_ops.lasso_cd_smem_bytes() == 4 * (32 * 68 + 2 * 32 + 1) \
        + 32 == 8996
    # Past 227 KB a block (T > 14 496) the kernel has no other route.
    cuda_ops._check_smem("monitor_chain",
                         cuda_ops.monitor_chain_smem_bytes(14496))
    with pytest.raises(ValueError, match="shared memory"):
        cuda_ops._check_smem("monitor_chain",
                             cuda_ops.monitor_chain_smem_bytes(14497))
