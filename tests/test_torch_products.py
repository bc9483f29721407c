"""The port's product rasters against the JAX package's: every product of
``chip_product`` at several dates on the same stored rows, the clip
masks, and ``save`` writing the same product rows into a store of each
package (and through the ``save`` command)."""

import json

import numpy as np
import pytest
import torch

from firebird_tpu import products as jproducts
from firebird_tpu.config import Config as JConfig
from firebird_tpu.store import MemoryStore as JMemoryStore
from firebird_tpu_torch import __main__ as tmain
from firebird_tpu_torch import products
from firebird_tpu_torch.config import Config
from firebird_tpu_torch.rf import forest, pipeline
from firebird_tpu_torch.store import MemoryStore, SqliteStore
from firebird_tpu_torch.store.schema import primary_key
from test_torch_rf_pipeline import POINT, segment_frames, tile_chips


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's forest and detection on one torch thread: the suite runs
    several workers on the machine's cores, and torch's own threads would
    contend with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DATES = ("1984-06-01", "1990-07-04", "2001-02-28", "2012-12-31",
         "2017-12-31")


def _voted(seed=11, n_chips=2):
    """Segment frames whose real rows carry vote vectors of 5 classes
    (a few rows unclassified), and the classes they map to."""
    frames = segment_frames(seed, tile_chips(n_chips), pixels=400)
    rng = np.random.default_rng(seed)
    for f in frames:
        f["rfrawp"] = [None if s == "0001-01-01" or rng.random() < 0.05
                       else rng.dirichlet(np.ones(5)).tolist()
                       for s in f["sday"]]
    return frames, np.array([3, 1, 7, 2, 5], np.uint8)


def test_products_listed_alike():
    assert products.available() == jproducts.available()


@pytest.mark.parametrize("name", products.PRODUCTS)
def test_chip_product_equals_jax(name):
    frames, classes = _voted()
    for f in frames:
        cx, cy = f["cx"][0], f["cy"][0]
        arrays = products.ChipSegmentArrays(cx, cy, f)
        for d in DATES:
            o = products.dt.to_ordinal(d)
            kw = dict(classes=classes) if name == "cover" else {}
            got = products.chip_product(name, o, cx, cy, f, **kw)
            want = jproducts.chip_product(name, o, cx, cy, f, **kw)
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want, err_msg=f"{name} {d}")
            np.testing.assert_array_equal(
                products.chip_product(name, o, cx, cy, arrays, **kw), got)
        if name == "cover":
            assert (got > 0).any()
            with pytest.raises(ValueError, match="classes"):
                products.chip_product(name, o, cx, cy, f)
    with pytest.raises(ValueError, match="unknown"):
        products.chip_product("nope", 1, 0, 0, frames[0])


@pytest.mark.parametrize("bounds", [
    [(-15570.0, 14790.0)],
    [(-15000.0, 14000.0), (-14000.0, 12500.0)],
    [(-15585.0, 14805.0), (-13000.0, 14000.0), (-15000.0, 12000.0)],
])
def test_clip_mask_and_covering_chips_equal_jax(bounds):
    cx, cy = tile_chips(1)[0]
    got = products.clip_mask(cx, cy, bounds)
    np.testing.assert_array_equal(got, jproducts.clip_mask(cx, cy, bounds))
    assert got.any() and got.dtype == bool
    assert products.covering_chips(bounds) == jproducts.covering_chips(bounds)


def _stores_with_votes():
    frames, _ = _voted()
    jstore, store = JMemoryStore("p"), MemoryStore("p")
    for f in frames:
        jstore.write("segment", f)
        store.write("segment", f)
    # The tile's model: its classes map the vote argmax to labels.
    X = np.random.default_rng(1).normal(0, 1, (50, 33)).astype(np.float32)
    m = forest.train(X, np.arange(50) % 5 + 1, n_trees=2, max_depth=2,
                     n_bins=4, device="cpu")
    t = products.grid.tile(*POINT)
    pipeline.save_model(store, t["x"], t["y"], m)
    jstore.write("tile", store.read("tile"))
    return jstore, store


def _rows(store, table):
    d = store.read(table)
    key = primary_key(table)
    return {tuple(d[k][i] for k in key): d["cells"][i]
            for i in range(len(d[key[0]]))}


@pytest.mark.parametrize("clip", (False, True))
def test_save_writes_the_jax_packages_rows(clip):
    jstore, store = _stores_with_votes()
    (cx, cy), (cx2, _) = tile_chips(2)
    bounds = [(cx + 45.0, cy - 45.0), (cx2 + 1000.0, cy - 2000.0)]
    names, dates = list(products.PRODUCTS), list(DATES[1:3])
    kw = dict(bounds=bounds, products=names, product_dates=dates,
              clip=clip, store=None)
    want = jproducts.save(**dict(kw, store=jstore),
                          cfg=JConfig(store_backend="memory"))
    got = products.save(**dict(kw, store=store),
                        cfg=Config(store_backend="memory"), device="cpu")
    assert got == want and len(got) == 2 * len(names) * len(dates)
    rows = _rows(store, "product")
    assert rows == _rows(jstore, "product")
    if clip:
        assert any(-9999 in v for v in rows.values())


def test_save_command_on_the_cpu(tmp_path, monkeypatch, capsys):
    path = tmp_path / "fb.db"
    cfg = Config(store_backend="sqlite", store_path=str(path))
    store = SqliteStore(str(path), cfg.keyspace())
    frames, _ = _voted(seed=12, n_chips=1)
    store.write("segment", frames[0])
    store.close()
    monkeypatch.setenv("FIREBIRD_STORE_BACKEND", "sqlite")
    monkeypatch.setenv("FIREBIRD_STORE_PATH", str(path))
    cx, cy = tile_chips(1)[0]
    # "--bounds=" keeps a negative easting from reading as an option.
    tmain.main(["save", f"--bounds={cx + 45},{cy - 45}",
                f"--bounds={cx + 1000},{cy - 1000}", "-p", "seglength",
                "-p", "ccd",
                "-d", "2001-02-28", "--clip", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["rasters"] == 2
    assert sorted(map(tuple, out["written"])) == [
        ("ccd", "2001-02-28", cx, cy), ("seglength", "2001-02-28", cx, cy)]
    store = SqliteStore(str(path), cfg.keyspace())
    rows = _rows(store, "product")
    o = products.dt.to_ordinal("2001-02-28")
    keep = products.clip_mask(cx, cy, [(cx + 45, cy - 45),
                                       (cx + 1000, cy - 1000)])
    want = np.where(keep, jproducts.chip_product("seglength", o, cx, cy,
                                                 frames[0]), -9999)
    np.testing.assert_array_equal(rows[("seglength", "2001-02-28", cx, cy)],
                                  want)
    store.close()


def test_save_detects_missing_chips_first():
    """With ``acquired``, a chip with no stored segments is detected on the
    device first (here the CPU), and its rasters come from those rows."""
    from firebird_tpu_torch.ccd.sensor import LANDSAT_ARD_TINY
    from firebird_tpu_torch.ingest import SyntheticSource

    store = MemoryStore("d")
    cx, cy = tile_chips(1)[0]
    src = SyntheticSource(seed=2, start="1995-01-01", end="1998-01-01",
                          sensor=LANDSAT_ARD_TINY)
    cfg = Config(store_backend="memory", chips_per_batch=1)
    bounds = [(cx + 15.0, cy - 15.0), (cx + 200.0, cy - 200.0)]
    got = products.save(bounds, ["seglength", "curveqa"], ["1996-06-01"],
                        acquired="1995-01-01/1998-01-01", cfg=cfg,
                        store=store, source=src, device="cpu")
    assert got == [("seglength", "1996-06-01", cx, cy),
                   ("curveqa", "1996-06-01", cx, cy)]
    assert store.chip_ids("segment") == {(cx, cy)}
    seg = store.read("segment", {"cx": cx, "cy": cy})
    o = products.dt.to_ordinal("1996-06-01")
    rows = _rows(store, "product")
    for name in ("seglength", "curveqa"):
        want = jproducts.chip_product(name, o, cx, cy, seg)
        assert (want[:10] > 0).any()
        np.testing.assert_array_equal(rows[(name, "1996-06-01", cx, cy)],
                                      want)
