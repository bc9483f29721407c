"""The port's classification pipeline against the JAX package's: the same
segment rows in a store of each package, trained and classified by each,
must leave the same model in the tile table and the same rfrawp votes.
Also the synthetic AUX layers, the ``classification`` command on the CPU
and the refusal to run without a card unless asked.

The store holds segment frames made from a seed with numpy in the
schema's columns (no change detection runs).  The JAX package trains with
``jax_enable_x64`` off, its default outside these tests.
"""

import functools
import json

import jax
import numpy as np
import pytest
import torch

from firebird_tpu import grid as jgrid
from firebird_tpu.config import Config as JConfig
from firebird_tpu.ingest import SyntheticSource as JSource
from firebird_tpu.rf import pipeline as jpipeline
from firebird_tpu.store import MemoryStore as JMemoryStore
from firebird_tpu_torch import __main__ as tmain
from firebird_tpu_torch import grid
from firebird_tpu_torch.config import Config
from firebird_tpu_torch.driver import core
from firebird_tpu_torch.ingest import SyntheticSource
from firebird_tpu_torch.obs import Counters
from firebird_tpu_torch.rf import features, forest, pipeline
from firebird_tpu_torch.store import MemoryStore, SqliteStore
from firebird_tpu_torch.store.schema import primary_key
from firebird_tpu_torch.utils import dates as dt

POINT = (100, 200)
ACQ = "1995-01-01/1997-06-01"
MSDAY, MEDAY = dt.to_ordinal("1985-01-01"), dt.to_ordinal("2017-12-31")
TRAIN_KW = dict(n_trees=8, max_depth=5, n_bins=16)
SENTINEL = "0001-01-01"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's forest on one torch thread: the suite runs several
    workers on the machine's cores, and torch's own threads would contend
    with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tile_chips(n):
    return [tuple(int(v) for v in c)
            for c in grid.chips(grid.tile(*POINT))[:n]]


def segment_frames(seed, cids, pixels=150):
    """One segment frame a chip, in the segment table's columns: ``pixels``
    pixels a chip with one to three segments each (consecutive spans of
    1985-2017, the break of each closed span confirmed or not), and a
    sentinel row (sday == eday == 0001-01-01) for every tenth pixel."""
    rng = np.random.default_rng(seed)
    lo, hi = dt.to_ordinal("1985-01-01"), dt.to_ordinal("2017-12-31")
    frames = []
    for cx, cy in cids:
        rows = []
        for p in rng.choice(10000, pixels, replace=False):
            r, c = divmod(int(p), 100)
            px, py = cx + 30 * c, cy - 30 * r
            if p % 10 == 0:
                rows.append((px, py, SENTINEL, SENTINEL, SENTINEL, 0.0, 0))
                continue
            cuts = np.sort(rng.integers(lo, hi, rng.integers(0, 3)))
            edges = [lo, *cuts.tolist(), hi]
            for s, e in zip(edges[:-1], edges[1:]):
                broke = e != hi
                rows.append((px, py, dt.to_iso(s), dt.to_iso(e),
                             dt.to_iso(e if broke else hi),
                             float(broke and rng.random() < 0.8),
                             int(rng.choice([4, 8, 14, 24]))))
        n = len(rows)
        frame = {k: [row[i] for row in rows] for i, k in enumerate(
            ("px", "py", "sday", "eday", "bday", "chprob", "curqa"))}
        frame.update(cx=[cx] * n, cy=[cy] * n, rfrawp=[None] * n)
        for b, p in enumerate(("bl", "gr", "re", "ni", "s1", "s2", "th")):
            frame[f"{p}mag"] = rng.normal(0, 150, n).tolist()
            frame[f"{p}rmse"] = np.abs(rng.normal(60, 20, n)).tolist()
            frame[f"{p}coef"] = [
                (rng.normal(0, 1, 7) * [3e-3, 40, 30, 10, 8, 5, 3]).tolist()
                for _ in range(n)]
            frame[f"{p}int"] = rng.normal(800 + 200 * b, 300, n).tolist()
        frames.append(frame)
    return frames


def filled_stores(seed=3, n_chips=3):
    """A store of each package holding the same segment rows."""
    frames = segment_frames(seed, tile_chips(n_chips))
    jstore, store = JMemoryStore("test"), MemoryStore("test")
    for f in frames:
        jstore.write("segment", f)
        store.write("segment", f)
    return jstore, store


def _rows(store, table):
    d = store.read(table)
    key = primary_key(table)
    return {tuple(d[k][i] for k in key): {c: d[c][i] for c in d}
            for i in range(len(d[key[0]]))}


@pytest.fixture(scope="module")
def classified():
    jstore, store = filled_stores()
    kw = dict(msday=MSDAY, meday=MEDAY, acquired=ACQ, **TRAIN_KW)
    with jax.enable_x64(False):
        jm = jpipeline.classify_tile(
            *POINT, cfg=JConfig(store_backend="memory"),
            aux_source=JSource(seed=4), store=jstore, **kw)
    m = pipeline.classify_tile(
        *POINT, aux_source=SyntheticSource(seed=4), store=store,
        device="cpu", **kw)
    return jstore, store, jm, m


def test_classify_tile_stores_the_jax_packages_model(classified):
    jstore, store, jm, m = classified
    assert m is not None and m.n_trees == TRAIN_KW["n_trees"]
    assert m.dumps() == jm.dumps()
    t = grid.tile(*POINT)
    jt = jgrid.tile(*POINT)
    assert (t["x"], t["y"]) == (jt["x"], jt["y"])
    rows, jrows = _rows(store, "tile"), _rows(jstore, "tile")
    assert rows.keys() == jrows.keys() == {
        (int(t["x"]), int(t["y"]), pipeline.MODEL_NAME)}
    for k in rows:
        assert {c: v for c, v in rows[k].items() if c != "updated"} \
            == {c: v for c, v in jrows[k].items() if c != "updated"}
    loaded = pipeline.load_model(store, t["x"], t["y"])
    assert loaded.dumps() == m.dumps()
    assert set(m.classes.tolist()) <= set(range(1, 9))


def test_classify_tile_rfrawp_equals_jax(classified):
    jstore, store, _, m = classified
    rows, jrows = _rows(store, "segment"), _rows(jstore, "segment")
    assert rows.keys() == jrows.keys()
    n_real = 0
    for k, row in rows.items():
        jrow = jrows[k]
        for c in row:
            if c != "rfrawp":
                assert row[c] == jrow[c], (k, c)
        if row["sday"] == SENTINEL:
            assert row["rfrawp"] is None and jrow["rfrawp"] is None
            continue
        n_real += 1
        assert len(row["rfrawp"]) == m.n_classes
        np.testing.assert_allclose(row["rfrawp"], jrow["rfrawp"], atol=1e-4)
        np.testing.assert_allclose(sum(row["rfrawp"]), m.n_trees, rtol=1e-4)
    assert 300 < n_real <= 2000


def narrow_forest(monkeypatch, **kw):
    """``forest.train`` as the pipeline looks it up, narrowed to ``kw``:
    the entry points train the full forest, minutes on a CPU."""
    monkeypatch.setattr(pipeline.forest, "train",
                        functools.partial(forest.train, **kw))


def test_classification_counts_and_stages(monkeypatch):
    narrow_forest(monkeypatch, **TRAIN_KW)
    _, store = filled_stores(seed=5, n_chips=2)
    counters = Counters()
    m = core.classification(*POINT, msday=MSDAY, meday=MEDAY, acquired=ACQ,
                            cfg=Config(store_backend="memory"),
                            aux_source=SyntheticSource(seed=4), store=store,
                            device="cpu", counters=counters)
    snap = counters.snapshot()
    seg = store.read("segment")
    real = int(features.real_rows(seg).sum())
    assert snap["chips"] == 2 and snap["segments"] == len(seg["sday"])
    assert snap["segments_scored"] == real == snap["training_rows"]
    assert m.leaf_proba.shape == (8, 32, m.n_classes)
    stages = pipeline.classification_stage_seconds()
    assert set(stages) == set(pipeline.STAGES)
    assert all(stages[k] > 0 for k in ("store_read", "assemble", "bin",
                                       "draw", "grow", "train", "predict"))


def test_no_features_returns_none_in_both():
    """A training window that excludes every segment trains nothing
    (randomforest.py:76) and writes nothing."""
    jstore, store = filled_stores(seed=6, n_chips=1)
    kw = dict(msday=dt.to_ordinal("2050-01-01"),
              meday=dt.to_ordinal("2051-01-01"), acquired=ACQ, **TRAIN_KW)
    assert jpipeline.classify_tile(
        *POINT, cfg=JConfig(store_backend="memory"),
        aux_source=JSource(seed=4), store=jstore, **kw) is None
    assert pipeline.classify_tile(
        *POINT, aux_source=SyntheticSource(seed=4), store=store,
        device="cpu", **kw) is None
    assert store.count("tile") == jstore.count("tile") == 0


@pytest.mark.parametrize("cid", [(0, 0), (-15585, 14805), (3000, -6000)])
def test_synthetic_aux_equals_jax(cid):
    got = SyntheticSource(seed=9).aux(*cid)
    want = JSource(seed=9).aux(*cid)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == (100, 100)
        np.testing.assert_array_equal(got[k], want[k])
    assert set(np.unique(got["trends"]).tolist()) <= set(range(1, 9))


def test_make_aux_source_follows_the_source_backend():
    cfg = Config(source_backend="synthetic")
    assert isinstance(core.make_aux_source(cfg), SyntheticSource)
    chipmunk = core.make_aux_source(Config(source_backend="chipmunk"))
    assert type(chipmunk).__name__ == "ChipmunkSource"


def test_classification_command_on_the_cpu(tmp_path, monkeypatch, capsys):
    path = tmp_path / "fb.db"
    cfg = Config(store_backend="sqlite", store_path=str(path))
    store = SqliteStore(str(path), cfg.keyspace())
    for f in segment_frames(7, tile_chips(2), pixels=60):
        store.write("segment", f)
    store.close()
    monkeypatch.setenv("FIREBIRD_STORE_BACKEND", "sqlite")
    monkeypatch.setenv("FIREBIRD_STORE_PATH", str(path))
    monkeypatch.setenv("FIREBIRD_SOURCE", "synthetic")
    narrow_forest(monkeypatch, n_trees=4, max_depth=3, n_bins=8)
    tmain.main(["classification", "-x", str(POINT[0]), "-y", str(POINT[1]),
                "-s", str(MSDAY), "-e", str(MEDAY), "-a", ACQ,
                "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["trained"] and out["chips_classified"] == 2
    assert out["training_rows"] == out["segments_scored"] > 0
    assert out["seconds"]["total"] >= out["seconds"]["train"] > 0
    store = SqliteStore(str(path), cfg.keyspace())
    t = grid.tile(*POINT)
    m = pipeline.load_model(store, t["x"], t["y"])
    assert m.n_trees == 4 and m.depth == 3
    assert out["classes"] == m.classes.tolist()
    seg = store.read("segment")
    scored = [v for v in seg["rfrawp"] if v is not None]
    assert len(scored) == out["segments_scored"]
    np.testing.assert_allclose([sum(v) for v in scored], 4.0, rtol=1e-4)
    store.close()


def test_entry_points_need_cuda_unless_told(monkeypatch):
    from firebird_tpu_torch import products

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, store = filled_stores(seed=8, n_chips=1)
    kw = dict(msday=MSDAY, meday=MEDAY, acquired=ACQ,
              aux_source=SyntheticSource(seed=4), store=store)
    with pytest.raises(RuntimeError, match="CUDA"):
        core.classification(*POINT, cfg=Config(store_backend="memory"), **kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.classify_tile(*POINT, **kw)
    X = np.zeros((4, 33), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        forest.train(X, [1, 2, 1, 2])
    m = forest.train(X, [1, 2, 1, 2], n_trees=2, max_depth=2, n_bins=4,
                     device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        m.raw_predict(X)
    with pytest.raises(RuntimeError, match="CUDA"):
        products.save([(POINT[0], POINT[1])], ["seglength"], ["2000-01-01"],
                      cfg=Config(store_backend="memory"), store=store)
    assert store.count("tile") == 0


def test_classification_refuses_what_is_not_ported():
    with pytest.raises(ValueError, match="not ported"):
        core.classification(*POINT, msday=MSDAY, meday=MEDAY,
                            cfg=Config(store_backend="memory",
                                       faults="ingest:p=0.1"),
                            device="cpu")
