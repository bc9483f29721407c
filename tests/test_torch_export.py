"""The port's raster export against the JAX package's, on the CPU.

The port keeps its own copy of ``export.py``.  Here, the cases of
tests/test_export.py, each run on both packages over the same product
rows (made from a seed with numpy): the mosaics are equal array for
array, and the ENVI (.dat + .hdr) and ``.npy`` (+ .json) files are equal
byte for byte.  The ``export`` command runs as JAX's does and loads no
torch.
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from firebird_tpu import cli
from firebird_tpu import export as jexport
from firebird_tpu.ccd.sensor import SENTINEL2 as JSENTINEL2
from firebird_tpu.serve import pyramid as jpyr
from firebird_tpu.store import MemoryStore as JMemoryStore
from firebird_tpu_torch import __main__ as tmain
from firebird_tpu_torch import export as texport
from firebird_tpu_torch.ccd.params import FILL_VALUE
from firebird_tpu_torch.ccd.sensor import SENTINEL2 as TSENTINEL2
from firebird_tpu_torch.config import Config
from firebird_tpu_torch.ingest.packer import CHIP_SIDE, PIXELS
from firebird_tpu_torch.serve import pyramid as tpyr
from firebird_tpu_torch.store import MemoryStore as TMemoryStore
from firebird_tpu_torch.store import SqliteStore

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Grid-aligned CONUS chip UL (as tests/test_products.py).
CX, CY = -585, 5805
CHIP_M = 3000

JAX = types.SimpleNamespace(name="jax", export=jexport, Memory=JMemoryStore,
                            SENTINEL2=JSENTINEL2, pyr=jpyr)
PORT = types.SimpleNamespace(name="torch", export=texport,
                             Memory=TMemoryStore, SENTINEL2=TSENTINEL2,
                             pyr=tpyr)
PKGS = (JAX, PORT)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cells_of(value, seed=None):
    """A chip's flat cells: ``value`` everywhere, or seeded noise around
    it when ``seed`` is given."""
    if seed is None:
        return np.full(PIXELS, value, np.int32)
    rng = np.random.default_rng(seed)
    return (value + rng.integers(-3, 4, PIXELS)).astype(np.int32)


def put_product(store, name, date, cx, cy, cells):
    col = np.empty(1, object)
    col[0] = np.asarray(cells, np.int32).tolist()
    store.write("product", {"name": [name], "date": [date],
                            "cx": [cx], "cy": [cy], "cells": col})


def stores(rows):
    """(JAX's store, the port's store), each holding ``rows``: (name,
    date, cx, cy, cells)."""
    out = []
    for P in PKGS:
        s = P.Memory()
        for r in rows:
            put_product(s, *r)
        out.append(s)
    return out


def files(d):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d))}


def test_mosaic_places_chips_and_fills_missing():
    rows = [("seglength", "2014-01-01", CX, CY, cells_of(11, 1)),
            ("seglength", "2014-01-01", CX + CHIP_M, CY, cells_of(22, 2)),
            ("seglength", "2014-01-01", CX, CY - CHIP_M, cells_of(33, 3))]
    bounds = [(CX + 10, CY - 10), (CX + 2 * CHIP_M - 10, CY - 2 * CHIP_M + 10)]
    (jc, jx, jy), (tc, tx, ty) = (
        P.export.mosaic("seglength", "2014-01-01", bounds, s)
        for P, s in zip(PKGS, stores(rows)))
    assert np.array_equal(tc, jc) and tc.dtype == jc.dtype == np.int32
    assert (tx, ty) == (jx, jy) == (CX, CY)
    assert tc.shape == (2 * CHIP_SIDE, 2 * CHIP_SIDE)
    assert np.array_equal(tc[:CHIP_SIDE, :CHIP_SIDE].ravel(), rows[0][4])
    assert np.all(tc[CHIP_SIDE:, CHIP_SIDE:] == FILL_VALUE)


@pytest.mark.parametrize("fmt", ["envi", "npy"])
def test_export_files_are_jaxs_byte_for_byte(fmt, tmp_path):
    rows = [("curveqa", "2010-06-01", CX + CHIP_M * i, CY - CHIP_M * j,
             cells_of(8, 10 * i + j)) for i in range(2) for j in range(2)
            if (i, j) != (1, 1)]
    bounds = [(CX + 10, CY - 10), (CX + 2 * CHIP_M - 10, CY - 2 * CHIP_M + 10)]
    for P, s in zip(PKGS, stores(rows)):
        paths = P.export.export(["curveqa"], ["2010-06-01"], bounds,
                                str(tmp_path / P.name), fmt=fmt, store=s)
        assert [os.path.basename(p) for p in paths] == (
            ["curveqa_2010-06-01.dat", "curveqa_2010-06-01.hdr"]
            if fmt == "envi" else
            ["curveqa_2010-06-01.npy", "curveqa_2010-06-01.json"])
    assert files(tmp_path / "torch") == files(tmp_path / "jax")


def test_export_envi_roundtrip(tmp_path):
    s = TMemoryStore()
    put_product(s, "curveqa", "2010-06-01", CX, CY, cells_of(8))
    paths = texport.export(["curveqa"], ["2010-06-01"], [(CX + 10, CY - 10)],
                           str(tmp_path), fmt="envi", store=s)
    dat = next(p for p in paths if p.endswith(".dat"))
    hdr = next(p for p in paths if p.endswith(".hdr"))
    arr = np.fromfile(dat, "<i4").reshape(CHIP_SIDE, CHIP_SIDE)
    assert np.all(arr == 8)
    text = open(hdr).read()
    assert f"samples = {CHIP_SIDE}" in text and f"lines = {CHIP_SIDE}" in text
    assert "data type = 3" in text and "Albers" in text
    assert f"{float(CX):.1f}" in text and f"{float(CY):.1f}" in text


def test_export_npy_sidecar(tmp_path):
    s = TMemoryStore()
    put_product(s, "ccd", "2011-01-01", CX, CY, cells_of(60, 4))
    paths = texport.export(["ccd"], ["2011-01-01"], [(CX + 10, CY - 10)],
                           str(tmp_path), fmt="npy", store=s)
    arr = np.load(next(p for p in paths if p.endswith(".npy")))
    assert arr.shape == (CHIP_SIDE, CHIP_SIDE)
    assert np.array_equal(arr.ravel(), cells_of(60, 4))
    meta = json.load(open(next(p for p in paths if p.endswith(".json"))))
    assert meta["ulx"] == CX and meta["uly"] == CY
    assert meta["pixel_size_m"] == 30.0 and meta["fill"] == FILL_VALUE
    assert meta["crs_wkt"].startswith("PROJCS")


@pytest.mark.parametrize("bad", [
    dict(products=["nope"], dates=["2011-01-01"], fmt="envi"),
    dict(products=["ccd"], dates=["2011-01-01"], fmt="tiff"),
    dict(products=["ccd"], dates=["2011/01/01"], fmt="envi")])
def test_export_rejects_unknown(bad, tmp_path):
    msgs = []
    for P in PKGS:
        with pytest.raises(ValueError) as e:
            P.export.export(bad["products"], bad["dates"], [(CX, CY)],
                            str(tmp_path), fmt=bad["fmt"], store=P.Memory())
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert os.listdir(tmp_path) == []


def test_cli_export_end_to_end(tmp_path, monkeypatch, capsys):
    """``python -m firebird_tpu_torch export`` over a sqlite store writes
    JAX's command's files and prints its lines; a fresh process runs it
    without loading torch."""
    db = str(tmp_path / "fb.db")
    monkeypatch.setenv("FIREBIRD_STORE_BACKEND", "sqlite")
    monkeypatch.setenv("FIREBIRD_STORE_PATH", db)
    store = SqliteStore(db, Config.from_env().keyspace())
    put_product(store, "seglength", "2014-01-01", CX, CY, cells_of(5, 6))
    store.close()
    argv = ["export", "-b", f"{CX + 10},{CY - 10}", "-p", "seglength",
            "-d", "2014-01-01", "-f", "npy"]
    tmain.main(argv + ["-o", str(tmp_path / "torch")])
    out = capsys.readouterr().out
    res = CliRunner().invoke(cli.entrypoint,
                             argv + ["-o", str(tmp_path / "jax")])
    assert res.exit_code == 0, res.output
    assert out.replace("torch", "jax") == res.output
    assert files(tmp_path / "torch") == files(tmp_path / "jax")
    npy = os.path.join(tmp_path, "torch", "seglength_2014-01-01.npy")
    assert np.array_equal(np.load(npy).ravel(), cells_of(5, 6))
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys; from firebird_tpu_torch import __main__ as m; "
         "m.main(sys.argv[1:]); print('loaded', [n for n in "
         "('torch', 'firebird_tpu_torch.ccd.kernel') if n in sys.modules])"]
        + argv + ["-f", "envi", "-o", str(tmp_path / "sub")],
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "loaded []"


def test_mosaic_rejects_cell_count_sensor_mismatch():
    msgs = []
    for P, s in zip(PKGS, stores([("seglength", "2014-01-01", CX, CY,
                                   cells_of(7))])):
        with pytest.raises(ValueError, match="sentinel2") as e:
            P.export.mosaic("seglength", "2014-01-01", [(CX + 10, CY - 10)],
                            s, sensor=P.SENTINEL2)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_mosaic_single_chip_bounds():
    got = [P.export.mosaic("curveqa", "2014-01-01",
                           [(CX + 1234.5, CY - 987.6)], s)
           for P, s in zip(PKGS, stores([("curveqa", "2014-01-01", CX, CY,
                                          cells_of(5, 8))]))]
    (jc, *jul), (tc, *tul) = got
    assert np.array_equal(tc, jc) and tul == jul == [CX, CY]
    assert tc.shape == (CHIP_SIDE, CHIP_SIDE)


def test_mosaic_non_aligned_bounds_snap_outward():
    rows = [("curveqa", "2014-01-01", CX, CY, cells_of(1, 9)),
            ("curveqa", "2014-01-01", CX + CHIP_M, CY, cells_of(2, 10))]
    bounds = [(CX + CHIP_M - 0.5, CY - 10.0), (CX + CHIP_M + 0.5, CY - 20.0)]
    (jc, *jul), (tc, *tul) = (P.export.mosaic("curveqa", "2014-01-01",
                                              bounds, s)
                              for P, s in zip(PKGS, stores(rows)))
    assert np.array_equal(tc, jc) and tul == jul == [CX, CY]
    assert tc.shape == (CHIP_SIDE, 2 * CHIP_SIDE)
    assert np.array_equal(tc[:, CHIP_SIDE:].ravel(),
                          cells_of(2, 10).reshape(CHIP_SIDE, CHIP_SIDE)
                          .ravel())


def test_mosaic_stored_row_size_mismatch_message():
    msgs = []
    for P, s in zip(PKGS, stores([("curveqa", "2014-01-01", CX, CY,
                                   [7] * 64)])):
        with pytest.raises(ValueError, match="pass the campaign's sensor") \
                as e:
            P.export.mosaic("curveqa", "2014-01-01", [(CX + 1, CY - 1)], s)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_pyramid_bounds_reject_off_domain(tmp_path):
    msgs = []
    for P in PKGS:
        p = P.pyr.TilePyramid(str(tmp_path / P.name),
                              P.pyr.store_read_chip(P.Memory()))
        with pytest.raises(ValueError, match="quadkey domain") as e:
            p.build_area(["curveqa"], ["2014-01-01"],
                         [(-9_000_000.0, CY)], levels=1)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
