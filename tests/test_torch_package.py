"""Package rules of the PyTorch port: no JAX, shared constants, explicit
devices, state conversion."""

import ast
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import firebird_tpu.ccd.params as jparams
from firebird_tpu.ccd import kernel as jk
from firebird_tpu.ccd import sensor as jsensor
from firebird_tpu_torch.ccd import convert, cuda_ops
from firebird_tpu_torch.ccd import kernel as tk
from firebird_tpu_torch.ccd import params as tparams
from firebird_tpu_torch.ccd import sensor as tsensor

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "firebird_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_port_imports_no_jax_and_no_jax_package(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "firebird_tpu"), (path, mod)


def test_port_sources_are_present():
    names = {p.name for p in (ROOT / "firebird_tpu_torch" / "csrc").iterdir()}
    assert {f"{n}.cu" for n in cuda_ops.SOURCES} <= names


def test_every_kernel_has_a_wrapper_a_plain_version_and_a_counter():
    kernels = {"lasso_fit", "monitor_chain_scored", "init_window",
               "fused_fit_close", "fused_round", "lasso_cd", "monitor_chain",
               "tmask_bad", "detect_mega", "ring_remote_copy"}
    assert set(cuda_ops.SOURCES) == kernels
    assert set(vars(cuda_ops.KERNELS)) == kernels
    assert set(vars(cuda_ops.PLAIN)) == kernels
    # A launch count for every build unit: each kernel and the mixed-
    # precision instance of each fitting kernel.
    fitting = {"lasso_fit", "init_window", "fused_fit_close", "fused_round",
               "detect_mega"}
    assert set(cuda_ops.MIXED_SOURCES) == fitting
    units = kernels | {f"{n}_mixed" for n in fitting}
    assert set(cuda_ops.UNITS) == units
    assert set(cuda_ops.LAUNCHES) == units
    assert {cuda_ops.source_of(u) for u in units} == kernels
    assert {f"fb_{n}" for n in kernels} == set(cuda_ops._ARGTYPES)
    for n in kernels:
        src = (ROOT / "firebird_tpu_torch" / "csrc" / f"{n}.cu").read_text()
        assert f'extern "C" int fb_{n}(' in src, n


def test_params_constants_equal_jax():
    names = [n for n in dir(jparams) if n.isupper()]
    assert len(names) > 30
    for n in names:
        assert getattr(tparams, n) == getattr(jparams, n), n
    assert tparams.VARIOGRAM_DEFAULT == "adjusted"


@pytest.mark.parametrize("nb", [1, 5, 7])
def test_chi2_thresholds_equal_jax(nb):
    assert tsensor.chi2_thresholds(nb) == jsensor.chi2_thresholds(nb)


def test_sensors_equal_jax():
    assert set(tsensor.SENSORS) == set(jsensor.SENSORS)
    for name, s in jsensor.SENSORS.items():
        t = tsensor.SENSORS[name]
        for f in ("band_names", "detection_bands", "tmask_bands",
                  "optical_bands", "thermal_bands", "blue_band", "chip_side",
                  "pixel_size_m"):
            assert getattr(t, f) == getattr(s, f), (name, f)


def test_entry_points_need_cuda_unless_told(monkeypatch):
    from firebird_tpu_torch.ingest import SyntheticSource, pack
    from firebird_tpu_torch.ccd.sensor import LANDSAT_ARD_TINY

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = pack([SyntheticSource(sensor=LANDSAT_ARD_TINY).chip(0, 0)])
    with pytest.raises(RuntimeError, match="CUDA"):
        tk.detect_packed(p)
    with pytest.raises(RuntimeError, match="CUDA"):
        tk.stage_packed(p)
    assert tk.resolve_device("cpu").type == "cpu"


def test_wrappers_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        cuda_ops._check(torch.zeros(2, 3), "x", torch.float32, (3, 2),
                        torch.device("cpu"))
    with pytest.raises(TypeError):
        cuda_ops._check(torch.zeros(2, 3, dtype=torch.int32), "x",
                        torch.float32, (2, 3), torch.device("cpu"))
    with pytest.raises(ValueError, match="contiguous"):
        cuda_ops._check(torch.zeros(3, 2).T, "x", torch.float32, (2, 3),
                        torch.device("cpu"))


def _jax_round_state():
    from firebird_tpu.ccd.sensor import LANDSAT_ARD_TINY
    from firebird_tpu.ingest import SyntheticSource, pack

    src = SyntheticSource(seed=2, start="1995-01-01", end="1997-06-01",
                          sensor=LANDSAT_ARD_TINY)
    p = pack([src.chip(0, 0)], bucket=32)
    days, n_obs, spectra, qa = jk.wire_args(p)
    X, Xt, t, valid = jk.device_designs(jnp.asarray(days), jnp.asarray(n_obs),
                                        jnp.float32)
    fit = functools.partial(jk._fit_chip, fit_pallas=False, on_tpu=False)
    prologue = jax.jit(functools.partial(
        jk._prologue, sensor=LANDSAT_ARD_TINY, S=3, fdtype=jnp.float32,
        fit=fit))
    res, st = prologue(X[0], Xt[0], t[0], valid[0], jnp.asarray(spectra[0]),
                       jnp.asarray(qa[0], jnp.int32))
    return jax.tree_util.tree_map(np.asarray, (res, st))


def test_round_state_roundtrip():
    res, st = _jax_round_state()
    res_t, st_t = convert.round_state_from_numpy(res, st)
    assert res_t["Yt"].dtype == torch.int16
    assert st_t["alive"].shape == (1,) + st["alive"].shape[::-1]
    assert st_t["bufs"][3].shape[2:] == (3, 7, 8)
    res_n, st_n = convert.round_state_to_numpy(res_t, st_t)
    for k, v in res.items():
        if k in ("Y", "XX"):
            assert k not in res_n
            continue
        np.testing.assert_array_equal(res_n[k][0], v, err_msg=k)
    for k, v in st.items():
        if k == "bufs":
            for a, b in zip(st_n[k], v):
                np.testing.assert_array_equal(a[0], b)
        else:
            np.testing.assert_array_equal(st_n[k][0], v, err_msg=k)


def test_flat_bufs_and_planes_roundtrip():
    rng = np.random.default_rng(4)
    P, S, B = 5, 3, 7
    flat = tuple(rng.random((P, S * k)).astype(np.float32)
                 for k in (6, B, B, B * 8))
    bufs = convert.bufs_from_flat(flat, B)
    assert [tuple(b.shape) for b in bufs] == [
        (1, P, S, 6), (1, P, S, B), (1, P, S, B), (1, P, S, B, 8)]
    np.testing.assert_array_equal(bufs[3][0, 2, 1, 4],
                                  flat[3][2, (1 * B + 4) * 8:(1 * B + 5) * 8])
    for a, b in zip(convert.bufs_to_flat(bufs), flat):
        np.testing.assert_array_equal(a[0], b)
    plane = rng.random((P, 11)) < 0.5
    t = convert.plane_from_numpy(plane)
    assert t.shape == (1, 11, P) and t.is_contiguous()
    np.testing.assert_array_equal(convert.plane_to_numpy(t)[0], plane)


def test_cli_fused_flag_picks_the_route(capsys):
    import json

    from firebird_tpu_torch.__main__ import main

    main(["detect", "--chips", "1", "--start", "1995-01-01", "--end",
          "1996-06-01", "--sensor", "landsat-ard-tiny", "--device", "cpu",
          "--fused", "mon"])
    out = json.loads(capsys.readouterr().out)
    assert out["route"] == "mon" and out["pixels"] == 100


@pytest.mark.parametrize("pallas, want", [
    ("mega", ["mega"]), ("lasso,monitor,tmask", ["lasso", "monitor", "tmask"])])
def test_cli_pallas_flag_picks_the_kernels(capsys, pallas, want):
    import json

    from firebird_tpu_torch.__main__ import main

    main(["detect", "--chips", "1", "--start", "1995-01-01", "--end",
          "1996-06-01", "--sensor", "landsat-ard-tiny", "--device", "cpu",
          "--pallas", pallas])
    out = json.loads(capsys.readouterr().out)
    assert out["pallas"] == want and out["pixels"] == 100
    assert out["rounds"] > 0


def test_segments_roundtrip():
    rng = np.random.default_rng(0)
    seg = tk.ChipSegments(
        n_segments=rng.integers(0, 3, (2, 5)).astype(np.int32),
        seg_meta=rng.random((2, 5, 3, 6)).astype(np.float32),
        seg_rmse=rng.random((2, 5, 3, 7)).astype(np.float32),
        seg_mag=rng.random((2, 5, 3, 7)).astype(np.float32),
        seg_coef=rng.random((2, 5, 3, 7, 8)).astype(np.float32),
        mask=rng.random((2, 5, 11)) < 0.5,
        procedure=np.zeros((2, 5), np.int32))
    t = convert.segments_from_numpy(seg)
    assert t.rounds is None and t.mask.dtype == torch.bool
    back = convert.segments_to_numpy(t)
    for f in ("n_segments", "seg_meta", "seg_coef", "mask"):
        np.testing.assert_array_equal(getattr(back, f), getattr(seg, f))


def test_packbits_matches_numpy():
    rng = np.random.default_rng(1)
    for T in (1, 8, 13, 64):
        m = rng.random((2, 3, T)) < 0.5
        np.testing.assert_array_equal(tk.packbits(torch.from_numpy(m)).numpy(),
                                      np.packbits(m, axis=-1))


def test_phase_codes_equal_the_kernels():
    import re

    from firebird_tpu_torch.ccd import round_state

    src = (ROOT / "firebird_tpu_torch" / "csrc" / "ccd_common.cuh").read_text()
    codes = dict(re.findall(r"constexpr int (PHASE_\w+) = (\d+);", src))
    assert {k: int(v) for k, v in codes.items()} == {
        k: getattr(round_state, k)
        for k in ("PHASE_INIT", "PHASE_MONITOR", "PHASE_DONE")}
    assert tk.PHASE_DONE == cuda_ops.PHASE_DONE == round_state.PHASE_DONE
