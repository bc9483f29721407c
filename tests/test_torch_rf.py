"""The port's random forest against the JAX package's: the threefry draws
word for word, the 33-column feature contract, binning, training array
for array from the same seed, inference within float32 accumulation
order, and the model format both ways.

The JAX package draws its uniforms in float32 with ``jax_enable_x64``
off, its default outside these tests (the test harness turns it on), so
its forest and its draws are taken under ``jax.enable_x64(False)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firebird_tpu.rf import features as jfeatures
from firebird_tpu.rf import forest as jforest
from firebird_tpu_torch.rf import features, forest, prng
from firebird_tpu_torch.utils import dates as dt

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's forest on one torch thread: the suite runs several
    workers on the machine's cores, and torch's own threads would contend
    with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    return np.asarray(a).astype(np.int64)


# ---------------------------------------------------------------------------
# The draws
# ---------------------------------------------------------------------------

SEEDS = (0, 1, 7, 2**31 - 1, 2**40 + 5, -3)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_and_fold_in_equal_jax(seed):
    with jax.enable_x64(False):
        jk = jax.random.PRNGKey(seed)
        split3 = jax.random.split(jk, 3)
        folds = [jax.random.fold_in(jk, d) for d in (0, 5, 2**32 - 1)]
        vfold = jax.vmap(jax.random.fold_in, (None, 0))(jk, jnp.arange(6))
    tk = prng.prng_key(seed)
    assert np.array_equal(_np(jk), tk.numpy())
    assert np.array_equal(_np(split3), prng.split(tk, 3).numpy())
    for d, f in zip((0, 5, 2**32 - 1), folds):
        assert np.array_equal(_np(f), prng.fold_in(tk, d).numpy())
    assert np.array_equal(_np(vfold),
                          prng.fold_in(tk, torch.arange(6)).numpy())


@pytest.mark.parametrize("seed", (0, 3, 2**31 - 1))
@pytest.mark.parametrize("shape", ((7,), (3, 5), (2, 3, 33)))
def test_bits_and_uniform_equal_jax(seed, shape):
    with jax.enable_x64(False):
        jk = jax.random.PRNGKey(seed)
        bits = jax.random.bits(jk, shape, jnp.uint32)
        u = np.asarray(jax.random.uniform(jk, shape))
    tk = prng.prng_key(seed)
    assert np.array_equal(_np(bits), prng.random_bits(tk, shape).numpy())
    tu = prng.uniform(tk, shape).numpy()
    assert u.dtype == tu.dtype == np.float32
    assert np.array_equal(u.view(np.int32), tu.view(np.int32))


@pytest.mark.parametrize("seed,n", [(0, 2000), (11, 777), (2**31 - 1, 1500)])
def test_poisson_equals_jax(seed, n):
    with jax.enable_x64(False):
        want = np.asarray(jax.random.poisson(jax.random.PRNGKey(seed), 1.0,
                                             (n,)))
    got = prng.poisson(prng.prng_key(seed), 1.0, (n,)).numpy()
    assert np.array_equal(want, got)
    assert got.max() >= 4 and (got == 0).any()


def test_batched_bootstrap_equals_jax_vmap():
    """The forest's per-tree draw: fold_in the tree index, split, Poisson
    over the rows — vmapped in JAX, batched over keys in the port."""
    with jax.enable_x64(False):
        keys = jax.vmap(jax.random.fold_in, (None, 0))(
            jax.random.PRNGKey(5), jnp.arange(3, 9))
        want = np.asarray(jax.vmap(lambda k: jax.random.poisson(
            jax.random.split(k)[0], 1.0, (600,)))(keys))
    keys_t = forest.tree_keys(5, range(3, 9), CPU)
    assert np.array_equal(_np(keys), keys_t.numpy())
    got = forest.bootstrap_weights(keys_t, 600)
    assert got.dtype == torch.float32
    assert np.array_equal(want.astype(np.float32), got.numpy())


def test_poisson_refuses_outside_knuths_range():
    with pytest.raises(ValueError):
        prng.poisson(prng.prng_key(0), 12.0, (4,))


# ---------------------------------------------------------------------------
# Features
# ---------------------------------------------------------------------------

def _seg_frame(cx, cy, rows):
    """Minimal segment frame: rows = [(px, py, sday, eday)]."""
    n = len(rows)
    frame = {
        "cx": [cx] * n, "cy": [cy] * n,
        "px": [r[0] for r in rows], "py": [r[1] for r in rows],
        "sday": [r[2] for r in rows], "eday": [r[3] for r in rows],
        "bday": [r[3] for r in rows],
        "chprob": [1.0] * n, "curqa": [8] * n, "rfrawp": [None] * n,
    }
    for k, p in enumerate(("bl", "gr", "re", "ni", "s1", "s2", "th")):
        frame[f"{p}mag"] = list(np.arange(n, dtype=float) + k)
        frame[f"{p}rmse"] = [0.5 + k] * n
        frame[f"{p}coef"] = [[10.0 + i + k, 2.0, 3.0, 0, 0, 0, 0]
                             for i in range(n)]
        frame[f"{p}int"] = [7.0 + k] * n
    frame["thint"][1] = None                # a missing value: NaN feature
    return frame


def test_columns_equal_jax():
    assert features.COLUMNS == jfeatures.COLUMNS
    assert len(features.COLUMNS) == 33
    assert features.AUX_FEATURES == jfeatures.AUX_FEATURES
    assert features.TRENDS_EXCLUDE == jfeatures.TRENDS_EXCLUDE


def test_assemble_window_and_real_rows_equal_jax():
    cx, cy = 3000, 6000
    seg = _seg_frame(cx, cy, [
        (cx, cy, "1990-01-01", "1995-01-01"),
        (cx + 30, cy - 60, "1985-01-01", "1995-01-01"),
        (cx + 90, cy - 2970, "0001-01-01", "0001-01-01"),
        (cx + 2970, cy - 30, "1991-01-01", "1999-01-01"),
    ])
    rng = np.random.default_rng(4)
    aux = {name: rng.normal(0, 10, (100, 100)).astype(np.float32)
           for name in features.AUX_FEATURES}
    aux["trends"] = rng.integers(0, 10, (100, 100)).astype(np.uint8)
    lo, hi = dt.to_ordinal("1989-01-01"), dt.to_ordinal("1996-01-01")
    w, jw = (features.segment_window(seg, lo, hi),
             jfeatures.segment_window(seg, lo, hi))
    r, jr = features.real_rows(seg), jfeatures.real_rows(seg)
    assert np.array_equal(w, jw) and np.array_equal(r, jr)
    assert list(w & r) == [True, False, False, False]
    for mask in (None, r):
        X, meta = features.assemble(seg, aux, cx, cy, row_mask=mask)
        jX, jmeta = jfeatures.assemble(seg, aux, cx, cy, row_mask=mask)
        assert X.dtype == jX.dtype == np.float32
        np.testing.assert_array_equal(X, jX)
        assert np.isnan(X[1, features.COLUMNS.index("thint")])
        assert set(meta) == set(jmeta)
        for k in meta:
            np.testing.assert_array_equal(meta[k], jmeta[k])
    row, col = features.pixel_index(cx, cy, [cx + 2970], [cy - 30])
    assert (int(row[0]), int(col[0])) == (1, 99)
    with pytest.raises(ValueError):
        features.pixel_index(cx, cy, [cx + 3000], [cy])


def test_bin_edges_and_binize_equal_jax():
    rng = np.random.default_rng(8)
    X = rng.normal(0, 3, (900, 5)).astype(np.float32)
    X[:, 1] = np.round(X[:, 1])              # few distinct values: nudged
    X[:400, 2] = 7.0                         # a long run of one value
    X[::13, 3] = np.nan
    X[:, 4] = np.nan                         # no finite value at all
    for n_bins in (16, 64):
        e, je = forest._bin_edges(X, n_bins), jforest._bin_edges(X, n_bins)
        assert e.dtype == je.dtype == np.float32
        np.testing.assert_array_equal(e, je)
        assert (np.diff(e[:4], axis=1) > 0).all()
        b, jb = forest._binize(X, e), jforest._binize(X, je)
        np.testing.assert_array_equal(b, jb)
        assert (b[::13, 3] == 0).all()       # NaN -> bin 0


# ---------------------------------------------------------------------------
# Training, array for array
# ---------------------------------------------------------------------------

def _blobs(n=1500, f=6, classes=3, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, n)
    centers = rng.normal(0, 5, (classes, f))
    X = centers[y] + rng.normal(0, 1.0, (n, f))
    return X.astype(np.float32), y + 10     # labels need not be 0-based


def _tie_blobs():
    """Blobs whose last feature duplicates the one before it (every split
    on either ties exactly, so the argmax must take the first), with rows
    holding NaN (dropped from training)."""
    X, y = _blobs(n=1500, f=6, classes=3, seed=0)
    X[:, 5] = X[:, 4]
    X[3, 2] = np.nan
    X[700, 0] = np.nan
    return X, y


BLOB_KW = dict(n_trees=24, max_depth=6, n_bins=32, seed=1)
WIDE_KW = dict(n_trees=16, max_depth=8, n_bins=64, seed=3)


def _wide():
    rng = np.random.default_rng(9)
    X = rng.normal(0, 1, (400, 33)).astype(np.float32)
    y = rng.integers(1, 9, 400)
    X[:, 30] = X[:, 28]                      # an exact tie here too
    return X, y


@pytest.fixture(scope="module")
def blob_forests():
    X, y = _tie_blobs()
    with jax.enable_x64(False):
        jm = jforest.train(X, y, **BLOB_KW)
    return X, y, jm, forest.train(X, y, device=CPU, **BLOB_KW)


@pytest.fixture(scope="module")
def wide_forests():
    X, y = _wide()
    with jax.enable_x64(False):
        jm = jforest.train(X, y, **WIDE_KW)
    return X, y, jm, forest.train(X, y, device=CPU, **WIDE_KW)


FIELDS = ("feature", "threshold", "leaf_proba", "classes")


@pytest.mark.parametrize("which", ("blob_forests", "wide_forests"))
def test_train_equals_jax_array_for_array(which, request):
    _, _, jm, m = request.getfixturevalue(which)
    for f in FIELDS:
        a, b = getattr(m, f), getattr(jm, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert np.isfinite(m.threshold).any() and np.isinf(m.threshold).any()


def test_ties_take_the_first_feature(blob_forests):
    """Features 4 and 5 are copies: a node whose feature subset holds both
    and that splits on one of them ties exactly between them, and takes 4
    (the lower flat index), as XLA's argmax does."""
    X, _, _, m = blob_forests
    F, mtry = X.shape[1], int(np.sqrt(X.shape[1]))
    knode = prng.split(forest.tree_keys(BLOB_KW["seed"], range(m.n_trees),
                                        CPU))[:, 1]
    both_split = {4: 0, 5: 0}
    for d in range(m.depth):
        u = prng.uniform(prng.fold_in(knode, d), (2 ** d, F))
        rank = torch.argsort(torch.argsort(u, dim=2, stable=True), dim=2,
                             stable=True).numpy()
        both = (rank[:, :, 4] < mtry) & (rank[:, :, 5] < mtry)
        level = slice(2 ** d - 1, 2 ** (d + 1) - 1)
        split = np.isfinite(m.threshold[:, level])
        for f in both_split:
            both_split[f] += int((both & split
                                  & (m.feature[:, level] == f)).sum())
    assert both_split[4] > 0 and both_split[5] == 0, both_split


def test_argmax_takes_the_first_of_equal_maxima():
    flat = torch.tensor([[-torch.inf, 2.0, 5.0, 5.0, 1.0],
                         [-torch.inf] * 5, [3.0, 3.0, 3.0, 3.0, 3.0]])
    assert flat.argmax(1).tolist() == [2, 0, 0]


def test_train_does_not_depend_on_trees_per_chunk(blob_forests):
    X, y, _, m = blob_forests
    for tpc in (5, 24, 64):
        m2 = forest.train(X, y, device=CPU, trees_per_chunk=tpc, **BLOB_KW)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(m2, f), getattr(m, f))


def test_accuracy_floors():
    """tests/test_rf.py's floors: training accuracy over 0.95 with 24 votes
    a row, and over 0.9 on held-out rows."""
    X, y = _blobs()
    m = forest.train(X, y, n_trees=24, max_depth=6, n_bins=32, seed=1,
                     device=CPU)
    assert (m.predict(X, device=CPU) == y).mean() > 0.95
    raw = m.raw_predict(X[:10], device=CPU)
    np.testing.assert_allclose(raw.sum(axis=1), 24.0, rtol=1e-4)
    X, y = _blobs(n=2000, seed=5)
    m = forest.train(X[:1500], y[:1500], n_trees=24, max_depth=6, seed=2,
                     device=CPU)
    assert (m.predict(X[1500:], device=CPU) == y[1500:]).mean() > 0.9


def test_class_order_by_frequency():
    X, y = _blobs(n=600, classes=2, seed=3)
    keep = (y == 10) | (np.arange(600) % 3 == 0)
    m = forest.train(X[keep], y[keep], n_trees=4, max_depth=3, n_bins=8,
                     device=CPU)
    assert m.classes[0] == 10                # majority class first
    with pytest.raises(ValueError, match="finite"):
        forest.train(np.full((3, 2), np.nan), [1, 2, 3], device=CPU)


# ---------------------------------------------------------------------------
# Inference and the model format
# ---------------------------------------------------------------------------

def _queries(F, seed=9, n=600):
    Xq = np.random.default_rng(seed).normal(0, 3, (n, F)).astype(np.float32)
    Xq[0, :] = np.nan                        # every comparison false
    Xq[1, :3] = np.nan
    return Xq


@pytest.mark.parametrize("which", ("blob_forests", "wide_forests"))
def test_raw_predict_equals_jax(which, request):
    X, _, jm, m = request.getfixturevalue(which)
    Xq = np.concatenate([_queries(X.shape[1]), X[:200]])
    with jax.enable_x64(False):
        want = jm.raw_predict(Xq, batch=512, dense=False)
        want_dense = jm.raw_predict(Xq, batch=512, dense=True)
    top2 = np.sort(want, axis=1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > 1e-3
    assert decided.sum() > len(Xq) // 2
    for dense, batch in ((False, 512), (True, 512), (True, 97)):
        got = m.raw_predict(Xq, batch=batch, dense=dense, device=CPU)
        assert got.dtype == np.float32 and got.shape == want.shape
        for ref in (want, want_dense):
            np.testing.assert_allclose(got, ref, atol=1e-4)
            assert (got.argmax(1) == ref.argmax(1))[decided].all()
    # The all-NaN row walks left at every node: leaf 0 of each tree.
    np.testing.assert_allclose(
        m.raw_predict(Xq[:1], device=CPU)[0], m.leaf_proba[:, 0].sum(0),
        rtol=1e-6)
    assert m.raw_predict(Xq[:0], device=CPU).shape == (0, m.n_classes)


@pytest.mark.parametrize("which", ("blob_forests", "wide_forests"))
def test_dense_equals_walk_and_rows_do_not_depend_on_the_batch(which,
                                                               request):
    """Both forms add the trees in one order (a chunk's in order, then the
    chunks), so they agree bit for bit; a row's votes do not depend on the
    other rows of its batch."""
    X, _, _, m = request.getfixturevalue(which)
    Xq = np.concatenate([_queries(X.shape[1], seed=2, n=300), X[:300]])
    whole = m.raw_predict(Xq, dense=True, device=CPU)
    np.testing.assert_array_equal(
        whole, m.raw_predict(Xq, dense=False, batch=128, device=CPU))
    np.testing.assert_array_equal(
        whole[37:40], m.raw_predict(Xq[37:40], dense=True, device=CPU))


def test_model_format_loads_in_both_packages(blob_forests):
    X, _, jm, m = blob_forests
    assert m.dumps() == jm.dumps()
    from_jax = forest.RandomForest.loads(jm.dumps())
    to_jax = jforest.RandomForest.loads(m.dumps())
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(from_jax, f), getattr(jm, f))
        np.testing.assert_array_equal(getattr(to_jax, f), getattr(m, f))
    np.testing.assert_array_equal(from_jax.raw_predict(X[:50], device=CPU),
                                  m.raw_predict(X[:50], device=CPU))
    with pytest.raises(ValueError, match="format"):
        forest.RandomForest.loads('{"format": "other"}')
