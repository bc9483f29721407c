"""Random forest on the card: histogram trees, level-wise.

The port's own copy of the JAX package's ``rf/forest.py``, which replaces
Spark ML's ``RandomForestClassifier(numTrees=500)``
(ccdc/randomforest.py:25-39) with the same statistical procedure:
Poisson(1) bootstrap weights per tree, quantile-binned features, per-node
class histograms and gini-gain splits over a sqrt(F) feature subset.

- Trees are complete binary trees of fixed depth D.  A node that stops
  splitting gets threshold +inf, so its samples fall through to its
  leftmost descendant; class distributions are read at depth D.
- Growth is level-wise and batched over a chunk of trees: at level d every
  (tree, sample) carries its node index in [0, 2^d), one ``index_add_``
  builds the [trees, nodes, F, bins, classes] histogram of the level, and
  cumulative sums over the bins give every candidate split's left and
  right class counts at once.
- The random draws are the JAX package's, word for word (:mod:`.prng`):
  tree t's key is ``fold_in(PRNGKey(seed), t)``, so the forest does not
  depend on how many trees a chunk holds.

Poisson weights are whole numbers, so every histogram bin is an exact
float32 sum (below 2^24) whatever order the card's atomics take.  The
split scores square those counts; they stay exact while a node's weight
is under 4 096, and past that a near-tie between two splits may round
apart from the JAX package's.

Inference sums each tree's leaf class distribution (Spark's
``rawPrediction``; ``rfrawp`` in the segment table).  Two forms add the
trees in one order and agree bit for bit: the node walk (depth gathers a
tree; the CPU's default) and the dense leaf-reachability form (every
node's comparison at once, a broadcast AND chain, then a [N, 256] x
[256, C] product; the card's default).  Against the JAX package's sums
they differ by float32 accumulation order.  NaN features compare false
and route left in both.

Label indexing follows StringIndexer(handleInvalid='keep'): classes by
descending training frequency (randomforest.py:35), ties by value.
"""

from __future__ import annotations

import base64
import contextlib
import dataclasses
import json
import time

import numpy as np
import torch

from firebird_tpu_torch.ccd.kernel import _exact_f32, resolve_device
from firebird_tpu_torch.obs import metrics as obs_metrics
from firebird_tpu_torch.rf import prng
from firebird_tpu_torch.rf.tilemodel import FORMAT, decode_array, parse

NUM_TREES = 500          # randomforest.py:38
DEFAULT_DEPTH = 8
DEFAULT_BINS = 64
# Trees a dense inference step evaluates together (the JAX package's).
DENSE_CHUNK = 8


@dataclasses.dataclass(frozen=True)
class RandomForest:
    """A trained forest in flat arrays.

    Internal nodes use breadth-first indexing: level d occupies
    [2^d - 1, 2^(d+1) - 1); node i's children are 2i+1, 2i+2.  ``go right``
    iff x[feature] > threshold.
    """

    feature: np.ndarray      # [T, 2^D - 1] int32
    threshold: np.ndarray    # [T, 2^D - 1] float32 (+inf = always-left)
    leaf_proba: np.ndarray   # [T, 2^D, C] float32, rows sum to 1
    classes: np.ndarray      # [C] original label values, frequency-ordered

    @property
    def n_trees(self) -> int:
        return self.feature.shape[0]

    @property
    def depth(self) -> int:
        return int(np.log2(self.feature.shape[1] + 1))

    @property
    def n_classes(self) -> int:
        return self.leaf_proba.shape[2]

    # -- persistence (the tile table's `model` TEXT column, ccdc/tile.py) --

    def dumps(self) -> str:
        def enc(a):
            a = np.ascontiguousarray(a)
            return {"dtype": str(a.dtype), "shape": list(a.shape),
                    "data": base64.b64encode(a.tobytes()).decode()}
        return json.dumps({"format": FORMAT,
                           "feature": enc(self.feature),
                           "threshold": enc(self.threshold),
                           "leaf_proba": enc(self.leaf_proba),
                           "classes": enc(self.classes)})

    @classmethod
    def loads(cls, s: str) -> "RandomForest":
        d = parse(s)
        return cls(feature=decode_array(d["feature"]),
                   threshold=decode_array(d["threshold"]),
                   leaf_proba=decode_array(d["leaf_proba"]),
                   classes=decode_array(d["classes"]))

    # -- inference --

    def raw_predict(self, X: np.ndarray, batch: int = 16384,
                    dense: bool | None = None, device=None) -> np.ndarray:
        """rawPrediction [N, C]: the sum over trees of the leaf class
        distributions, as float32 numpy.

        ``device`` is where it runs (default CUDA; raises without a card
        unless "cpu" is asked).  ``dense`` picks the form: by default the
        dense leaf-reachability form on CUDA and the node walk on the CPU.
        Rows go through ``batch`` at a time."""
        dev = resolve_device(device)
        if dense is None:
            dense = dev.type != "cpu"
        kern = _raw_predict_dense if dense else _raw_predict_walk
        X = np.asarray(X, np.float32)
        N = X.shape[0]
        if N == 0:
            return np.zeros((0, self.n_classes), np.float32)
        _exact_f32()
        f = torch.as_tensor(self.feature, device=dev).long()
        t = torch.as_tensor(self.threshold, device=dev)
        lp = torch.as_tensor(self.leaf_proba, device=dev)
        out = np.empty((N, self.n_classes), np.float32)
        with _span("rf_predict_device_seconds", dev):
            for i in range(0, N, batch):
                xb = torch.as_tensor(X[i:i + batch]).to(dev)
                out[i:i + batch] = kern(f, t, lp, xb, self.depth).cpu().numpy()
        return out

    def predict(self, X: np.ndarray, device=None) -> np.ndarray:
        """Predicted original label values [N]."""
        raw = self.raw_predict(X, device=device)
        return self.classes[np.argmax(raw, axis=1)]


@contextlib.contextmanager
def _span(name: str, dev: torch.device):
    """Observe a block's seconds into the histogram ``name``: its span on
    the card's timeline (CUDA events, read after a synchronize) on CUDA,
    the host clock elsewhere."""
    if dev.type == "cuda":
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        yield
        ev[1].record()
        ev[1].synchronize()
        seconds = ev[0].elapsed_time(ev[1]) / 1e3
    else:
        t0 = time.perf_counter()
        yield
        seconds = time.perf_counter() - t0
    obs_metrics.histogram(name).observe(seconds)


def _chunk_sums(per_tree, chunk: int = DENSE_CHUNK):
    """[T, N, C] per-tree votes (T a multiple of ``chunk``) -> [T/chunk, N,
    C]: each chunk's trees added in order."""
    s = per_tree[0::chunk]
    for j in range(1, chunk):
        s = s + per_tree[j::chunk]
    return s


def _raw_predict_walk(feature, threshold, leaf_proba, X, depth,
                      chunk: int = DENSE_CHUNK):
    """Node-walk inference: ``depth`` gathers a tree, all trees at once.
    [T, M] trees x [N, F] samples -> [N, C].  The trees are summed as the
    dense form sums them (a chunk's trees in order, then the chunks in
    order), so the two forms agree bit for bit where they reach the same
    leaves."""
    T = feature.shape[0]
    N = X.shape[0]
    cols = torch.arange(N, device=X.device)
    Xt = X.t()
    node = torch.zeros((T, N), dtype=torch.long, device=X.device)
    for d in range(depth):
        nb = (2 ** d - 1) + node                                # [T, N]
        xv = Xt[feature.gather(1, nb), cols]
        node = 2 * node + (xv > threshold.gather(1, nb)).long()
    trees = torch.arange(T, device=X.device)[:, None]
    per_tree = torch.nn.functional.pad(leaf_proba[trees, node],
                                       (0, 0, 0, 0, 0, -T % chunk))
    acc = torch.zeros((N, leaf_proba.shape[2]), dtype=leaf_proba.dtype,
                      device=X.device)
    for s in _chunk_sums(per_tree, chunk):
        acc = acc + s
    return acc


def _raw_predict_dense(feature, threshold, leaf_proba, X, depth,
                       chunk: int = DENSE_CHUNK):
    """[T, M] trees x [N, F] samples -> [N, C] summed leaf distributions.

    Every node's comparison is evaluated at once ([chunk, N, M] from one
    column gather), leaf reachability is a chain of broadcast ANDs (leaf l
    is reached iff each level-d ancestor's bit equals bit depth-1-d of l),
    and the leaf lookup is a [N, L] x [L, C] product a tree (one term of
    it nonzero, so exact).  ``chunk`` trees go together; the last chunk is
    padded with inert trees (+inf thresholds, zero leaf mass).  A chunk's
    trees are added in order and the chunk added to the total, so a row's
    sum depends neither on the other rows of the batch nor on the form."""
    T, M = feature.shape
    L = M + 1
    N = X.shape[0]
    C = leaf_proba.shape[2]
    pad = -T % chunk
    if pad:
        feature = torch.nn.functional.pad(feature, (0, 0, 0, pad))
        threshold = torch.nn.functional.pad(threshold, (0, 0, 0, pad),
                                            value=float("inf"))
        leaf_proba = torch.nn.functional.pad(leaf_proba, (0, 0, 0, 0, 0, pad))
    leaves = torch.arange(L, device=X.device)
    dirs = [((leaves >> (depth - 1 - d)) & 1).bool() for d in range(depth)]
    acc = torch.zeros((N, C), dtype=leaf_proba.dtype, device=X.device)
    for c0 in range(0, T + pad, chunk):
        tf = feature[c0:c0 + chunk]
        bits = X[:, tf].permute(1, 0, 2) > threshold[c0:c0 + chunk, None, :]
        reached = torch.ones((chunk, N, L), dtype=torch.bool, device=X.device)
        for d in range(depth):
            lo = (1 << d) - 1
            bd = bits[:, :, lo:lo + (1 << d)]                   # level d
            reached &= bd.repeat_interleave(L >> d, dim=2) == dirs[d]
        per_tree = torch.bmm(reached.to(leaf_proba.dtype),
                             leaf_proba[c0:c0 + chunk])         # [chunk,N,C]
        acc = acc + _chunk_sums(per_tree, chunk)[0]
    return acc


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def _bin_edges(X: np.ndarray, n_bins: int) -> np.ndarray:
    """Per-feature quantile edges [F, n_bins-1] (Spark's findSplits uses
    sampled quantiles per feature; maxBins analogue is n_bins)."""
    F = X.shape[1]
    qs = np.linspace(0, 1, n_bins + 1)[1:-1]
    edges = np.empty((F, n_bins - 1), np.float32)
    for f in range(F):
        col = X[:, f]
        col = col[np.isfinite(col)]
        if col.size == 0:
            edges[f] = np.arange(n_bins - 1, dtype=np.float32)
            continue
        e = np.quantile(col, qs).astype(np.float32)
        # Strictly increasing edges make bins well-defined; pad duplicates
        # with tiny increments far above float32 ulp at these magnitudes.
        e = np.maximum.accumulate(e)
        dup = np.concatenate([[False], np.diff(e) == 0])
        if dup.any():
            e = e + np.cumsum(dup) * np.float32(1e-6) * np.maximum(
                1.0, np.abs(e))
        edges[f] = e
    return edges


def _binize(X: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """bin(x) = #(x > edge) in [0, n_bins-1]; NaN -> bin 0 (routes left,
    matching inference where NaN > thr is false)."""
    b = (np.nan_to_num(X, nan=-np.inf)[:, :, None]
         > edges[None, :, :]).sum(axis=2)
    return b.astype(np.int32)


def tree_keys(seed: int, trees, device) -> torch.Tensor:
    """Tree keys ``fold_in(PRNGKey(seed), t)`` for the tree indices
    ``trees``: [len(trees), 2]."""
    return prng.fold_in(prng.prng_key(seed, device),
                        torch.as_tensor(trees, device=device))


def bootstrap_weights(keys: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Each tree's Poisson(1) row weights [Tc, n_rows] float32, from its
    key's first split (the second seeds the feature subsets)."""
    kboot = prng.split(keys)[:, 0]
    return prng.poisson(kboot, 1.0, (n_rows,)).to(torch.float32)


def _train_chunk(Xb, y, keys, depth, n_bins, n_classes, mtry, min_leaf):
    """Grow a chunk of trees on binned features.

    Xb [N, F] int64 bins, y [N] int64 class indices, keys [Tc, 2] tree
    keys, all on one device.  Returns (feature [Tc, 2^D-1], split_bin
    [Tc, 2^D-1], leaf_counts [Tc, 2^D, C]); split_bin -1 marks always-left
    nodes."""
    dev = Xb.device
    N, F = Xb.shape
    B, C = n_bins, n_classes
    Tc = keys.shape[0]
    f32 = torch.float32
    eps = torch.tensor(1e-9, dtype=f32, device=dev)
    gain = torch.tensor(1e-6, dtype=f32, device=dev)
    n_feat = torch.tensor(float(F), dtype=f32, device=dev)
    knode = prng.split(keys)[:, 1]
    with _span("rf_draw_seconds", dev):
        w = bootstrap_weights(keys, N)                          # [Tc, N]
    with _span("rf_grow_seconds", dev):
        trees = torch.arange(Tc, device=dev)
        cols = torch.arange(N, device=dev)
        # A (sample, feature)'s histogram cell within its node:
        # (f * B + bin) * C + class.
        cell = ((torch.arange(F, device=dev) * B + Xb) * C + y[:, None])
        wf = w[:, :, None].expand(Tc, N, F).reshape(-1)
        last_bin = torch.arange(B, device=dev) < B - 1
        Xbt = Xb.t()
        feats, bins = [], []
        node = torch.zeros((Tc, N), dtype=torch.long, device=dev)
        for d in range(depth):
            n_nodes = 2 ** d
            idx = ((trees[:, None] * n_nodes + node) * (F * B * C))[:, :, None] \
                + cell
            hist = torch.zeros(Tc * n_nodes * F * B * C, dtype=f32,
                               device=dev).index_add_(
                0, idx.reshape(-1), wf).view(Tc, n_nodes, F, B, C)
            del idx
            left = hist.cumsum(3)                               # over bins
            right = left[:, :, :, -1:, :] - left
            nl = left.sum(-1)                                   # [Tc,n,F,B]
            nr = right.sum(-1)
            # Maximizing sum_c l^2/nl + r^2/nr minimizes weighted gini.
            score = ((left * left).sum(-1) / torch.maximum(nl, eps)
                     + (right * right).sum(-1) / torch.maximum(nr, eps))
            valid = (nl >= min_leaf) & (nr >= min_leaf) & last_bin
            # sqrt(F) feature subset per node: the features whose uniform
            # ranks below mtry (ranks by a stable double argsort).
            u = prng.uniform(prng.fold_in(knode, d), (n_nodes, F))
            rank = torch.argsort(torch.argsort(u, dim=2, stable=True), dim=2,
                                 stable=True)
            valid &= (rank < mtry)[..., None]
            flat = torch.where(valid, score, -torch.inf).reshape(
                Tc, n_nodes, F * B)
            best = flat.argmax(2)                     # the first maximum
            best_score = flat.gather(2, best[..., None])[..., 0]
            bf = best // B
            bb = best % B
            # No-gain guard: splitting must beat the parent's own purity
            # sum_c counts^2 / n (equality = pure node, nothing to gain).
            parent = hist.sum((2, 3)) / n_feat                  # [Tc, n, C]
            pn = parent.sum(-1)
            pscore = (parent * parent).sum(-1) / torch.maximum(pn, eps)
            use = torch.isfinite(best_score) & (best_score > pscore + gain)
            bf = torch.where(use, bf, 0)
            bb = torch.where(use, bb, -1)                       # stay left
            feats.append(bf)
            bins.append(bb)
            nbb = bb.gather(1, node)
            xb = Xbt[bf.gather(1, node), cols]
            node = 2 * node + ((nbb >= 0) & (xb > nbb)).long()
        leaf = torch.zeros(Tc * (2 ** depth) * C, dtype=f32,
                           device=dev).index_add_(
            0, ((trees[:, None] * 2 ** depth + node) * C + y).reshape(-1),
            w.reshape(-1)).view(Tc, 2 ** depth, C)
        return torch.cat(feats, 1), torch.cat(bins, 1), leaf


def train(X: np.ndarray, y: np.ndarray, *, n_trees: int = NUM_TREES,
          max_depth: int = DEFAULT_DEPTH, n_bins: int = DEFAULT_BINS,
          min_leaf: int = 1, seed: int = 0, trees_per_chunk: int = 16,
          device=None) -> RandomForest:
    """Train a forest on host arrays X [N, F] (float), y [N] (labels), on
    ``device`` (default CUDA; raises without a card unless "cpu" is
    asked).  The forest does not depend on ``trees_per_chunk``.

    Rows with any non-finite feature are dropped (the reference's join
    produces only complete rows; sentinel segments never reach training).
    """
    dev = resolve_device(device)
    X = np.asarray(X, np.float32)
    y = np.asarray(y)
    ok = np.isfinite(X).all(axis=1)
    X, y = X[ok], y[ok]
    if X.shape[0] == 0:
        raise ValueError("no finite training rows")

    # StringIndexer semantics: classes by descending frequency
    # (ties broken by value for determinism).
    vals, counts = np.unique(y, return_counts=True)
    order = np.lexsort((vals, -counts))
    classes = vals[order]
    lut = {v: i for i, v in enumerate(classes)}
    y_idx = np.array([lut[v] for v in y], np.int32)
    C = len(classes)

    with obs_metrics.timer() as tm:
        edges = _bin_edges(X, n_bins)
        Xb_host = _binize(X, edges)
    obs_metrics.histogram(
        "rf_bin_seconds",
        help="the forest's feature binning on the host, per train call"
    ).observe(tm.elapsed)
    Xb = torch.as_tensor(Xb_host).to(dev).long()
    yt = torch.as_tensor(y_idx).to(dev).long()
    mtry = max(1, int(np.sqrt(X.shape[1])))

    feats, bins, leaves = [], [], []
    for c0 in range(0, n_trees, trees_per_chunk):
        tc = min(trees_per_chunk, n_trees - c0)
        keys = tree_keys(seed, range(c0, c0 + tc), dev)
        f, b, l = _train_chunk(Xb, yt, keys, max_depth, n_bins, C, mtry,
                               min_leaf)
        feats.append(f.cpu().numpy())
        bins.append(b.cpu().numpy())
        leaves.append(l.cpu().numpy())
    feature = np.concatenate(feats).astype(np.int32)
    split_bin = np.concatenate(bins)
    leaf = np.concatenate(leaves)

    # bin threshold -> raw threshold: right iff bin > b iff x > edges[f, b];
    # b == n_bins-1 can't occur (excluded above); b == -1 -> +inf.
    thr = np.where(
        split_bin >= 0,
        edges[feature, np.clip(split_bin, 0, n_bins - 2)],
        np.inf).astype(np.float32)

    norm = leaf.sum(axis=2, keepdims=True)
    leaf_proba = (leaf / np.maximum(norm, 1e-9)).astype(np.float32)
    return RandomForest(feature=feature, threshold=thr,
                        leaf_proba=leaf_proba, classes=classes)


__all__ = ["NUM_TREES", "DEFAULT_DEPTH", "DEFAULT_BINS", "FORMAT",
           "RandomForest", "train", "tree_keys", "bootstrap_weights"]
