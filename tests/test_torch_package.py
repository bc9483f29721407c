"""Package rules of the PyTorch port: no JAX, shared constants, explicit
devices, state conversion."""

import ast
import dataclasses
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


# The modules the port keeps as its own copies of the JAX package's, under
# the same relative paths.
PORTED_MODULES = ("__about__.py", "config.py", "grid.py", "retry.py",
                  "utils/fn.py", "utils/dates.py", "obs/__init__.py",
                  "obs/metrics.py", "obs/tracing.py", "obs/jsonlog.py",
                  "obs/profiling.py", "obs/report.py", "obs/watchdog.py",
                  "obs/flightrec.py", "obs/httpd.py", "obs/server.py",
                  "obs/slo.py", "parallel/__init__.py", "parallel/dist.py",
                  "parallel/mesh.py", "store/__init__.py", "store/schema.py",
                  "store/backends.py", "store/writer.py",
                  "driver/__init__.py", "driver/core.py",
                  "driver/quarantine.py", "ingest/sources.py",
                  "ingest/registry.py", "ingest/packer.py",
                  "ccd/reference.py", "ccd/params.py", "ccd/harmonic.py",
                  "ccd/sensor.py", "ccd/synthetic.py", "ccd/format.py",
                  "ccd/incremental.py", "streamops/__init__.py",
                  "streamops/statestore.py", "alerts/__init__.py",
                  "alerts/log.py", "alerts/subindex.py", "alerts/repair.py",
                  "fleet/__init__.py", "fleet/queue.py", "fleet/plan.py",
                  "serve/__init__.py", "serve/changefeed.py",
                  "driver/stream.py", "rf/__init__.py", "rf/features.py",
                  "rf/forest.py", "rf/pipeline.py", "products.py",
                  "faults.py", "fleet/worker.py", "fleet/policy.py",
                  "fleet/supervisor.py", "obs/spool.py", "obs/collect.py",
                  "obs/series.py", "validate.py", "ccd/flops.py",
                  "store/objectstore.py", "streamops/watcher.py",
                  "serve/flight.py", "serve/cache.py", "serve/pyramid.py",
                  "serve/api.py", "export.py", "alerts/feed.py",
                  "alerts/fanout.py", "obs/prober.py", "native/__init__.py",
                  "analysis/__init__.py", "analysis/__main__.py",
                  "analysis/engine.py", "analysis/knobs.py",
                  "analysis/metrics_contract.py", "analysis/ownership.py")


@pytest.mark.parametrize("rel", PORTED_MODULES)
def test_ported_module_is_present_and_scanned(rel):
    path = ROOT / "firebird_tpu_torch" / rel
    assert path.exists(), rel
    assert (ROOT / "firebird_tpu" / rel).exists(), rel
    assert path in PORT_FILES


def test_port_version_names_the_jax_packages_tables():
    import firebird_tpu.__about__ as jabout

    import firebird_tpu_torch
    from firebird_tpu_torch.config import Config

    assert firebird_tpu_torch.__version__ == jabout.__version__
    assert Config().keyspace() == "ccdc_0_2_0"


def test_changedetection_needs_cuda_unless_told(monkeypatch):
    from firebird_tpu_torch.config import Config
    from firebird_tpu_torch.driver import core
    from firebird_tpu_torch.store import MemoryStore

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(store_backend="memory", source_backend="synthetic",
                 chips_per_batch=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        core.changedetection(x=100, y=200, number=1, chunk_size=1, cfg=cfg,
                             store=MemoryStore("x"))
    with pytest.raises(RuntimeError, match="CUDA"):
        core.stage_batch(None, "float32")


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


def test_stream_needs_cuda_unless_told(monkeypatch):
    from firebird_tpu_torch.ccd import incremental
    from firebird_tpu_torch.config import Config
    from firebird_tpu_torch.driver import stream
    from firebird_tpu_torch.store import MemoryStore

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(store_backend="memory", source_backend="synthetic",
                 chips_per_batch=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        stream.stream(x=100, y=200, number=1, cfg=cfg, store=MemoryStore("x"))
    seg = tk.ChipSegments(
        n_segments=np.ones(2, np.int32), seg_meta=np.zeros((2, 1, 6)),
        seg_rmse=np.zeros((2, 1, 7)), seg_mag=np.zeros((2, 1, 7)),
        seg_coef=np.zeros((2, 1, 7, 8)), mask=np.zeros((2, 3), bool),
        procedure=np.zeros(2, np.int32), vario=np.zeros((2, 7)))
    with pytest.raises(RuntimeError, match="CUDA"):
        incremental.StreamState.from_chip(seg)
    assert incremental.StreamState.from_chip(seg, device="cpu").nobs.shape == (2,)


def test_cli_stream_raises_without_a_card(monkeypatch):
    from firebird_tpu_torch import __main__ as tmain

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("FIREBIRD_STORE_BACKEND", "memory")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmain.main(["stream", "-x", "100", "-y", "200", "-n", "1"])


@pytest.mark.parametrize("field, value", [("compile_cache", "/x")])
def test_stream_refuses_each_not_ported_knob(field, value):
    from firebird_tpu_torch.config import NOT_PORTED, Config
    from firebird_tpu_torch.driver import stream
    from firebird_tpu_torch.store import MemoryStore

    assert field in NOT_PORTED
    cfg = dataclasses.replace(Config(store_backend="memory"),
                              **{field: value})
    with pytest.raises(ValueError, match=f"not ported.*{field}"):
        stream.stream(x=100, y=200, number=1, cfg=cfg, store=MemoryStore("x"),
                      device="cpu")


def test_stream_honours_the_fault_plan():
    """FIREBIRD_FAULTS is ported: a chip the plan poisons is fetched
    through the plan's proxy, fails, and is quarantined (no retries left),
    and the injection is counted."""
    from firebird_tpu_torch import grid
    from firebird_tpu_torch.config import NOT_PORTED, Config
    from firebird_tpu_torch.driver import stream
    from firebird_tpu_torch.obs import metrics as obs_metrics
    from firebird_tpu_torch.store import MemoryStore

    assert "faults" not in NOT_PORTED
    cx, cy = (int(v) for v in grid.chips(grid.tile(x=100, y=200))[0])
    cfg = Config(store_backend="memory", fetch_retries=0,
                 faults=f"ingest:chip={cx}:{cy}")
    s = stream.stream(x=100, y=200, number=1, cfg=cfg,
                      store=MemoryStore("x"), device="cpu")
    assert s["quarantined"] == 1 and s["bootstrapped"] == 0
    assert obs_metrics.counter("faults_injected_ingest").value == 1



@pytest.fixture(scope="module")
def stream_ops_run(tmp_path_factory):
    """A CPU stream run (one StepSource chip bootstrapped) with the ops
    knobs that used to be refused set, then a second pass with nothing new
    under FIREBIRD_PROFILE_DIR (its capture and a profile window cannot
    run at once: one torch profiler a process).  Returns what each knob
    left behind."""
    import json

    from conftest import free_port
    from firebird_tpu_torch.config import Config
    from firebird_tpu_torch.driver import stream
    from firebird_tpu_torch.obs import flightrec
    from firebird_tpu_torch.obs import server as obs_server
    from test_torch_stream import BOOT, StepSource

    root = tmp_path_factory.mktemp("stream_ops")
    base = dict(store_backend="sqlite", store_path=str(root / "s.db"),
                stream_dir=str(root / "state"), alert_db=str(root / "a.db"),
                fleet_db=str(root / "fleet.db"), source_backend="synthetic")
    port = free_port()
    cfg = Config(**base, trace="1", ops_port=port, ops_host="127.0.0.1",
                 stall_sec=600.0, obs_report=str(root / "r" / "report.json"),
                 profile=0.05, flightrec=0, slo="batch_p95=30;freshness=600",
                 slo_budget="probe_errors@99/1d",
                 object_root=str(root / "objects"))
    seen = dict(served=[], armed=0)
    start, arm = obs_server.start_ops_server, flightrec.arm

    def start_and_probe(p, status=None, host=None):
        import urllib.request

        srv = start(p, status, host=host)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/healthz", timeout=5) as r:
            seen["served"].append((srv.port, r.status))
        return srv

    def counting_arm(*a, **kw):
        seen["armed"] += 1
        return arm(*a, **kw)

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(obs_server, "start_ops_server", start_and_probe)
        mp.setattr(flightrec, "arm", counting_arm)
        # the store's mirror reads the environment, as JAX's does
        mp.setenv("FIREBIRD_OBJECT_ROOT", cfg.object_root)
        s1 = stream.stream(100, 200, acquired=BOOT, number=1, cfg=cfg,
                           source=StepSource(), device="cpu")
        mp.delenv("FIREBIRD_OBJECT_ROOT")
        s2 = stream.stream(100, 200, acquired=BOOT, number=1,
                           cfg=Config(**base, profile_dir=str(root / "pd")),
                           source=StepSource(), device="cpu")
    torch.set_num_threads(n)
    assert s1["bootstrapped"] == 1 and s2["bootstrapped"] == 0
    # the second run's default config arms the recorder; the first did not
    assert seen["armed"] == 1
    return root, port, seen, json.load(open(root / "r" / "report.json"))


@pytest.mark.parametrize("field", [
    "trace", "ops_port", "stall_sec", "obs_report", "profile", "profile_dir",
    "flightrec", "slo", "slo_budget", "object_root"])
def test_stream_honours_each_ported_ops_knob(stream_ops_run, field,
                                             monkeypatch):
    import json

    from firebird_tpu_torch.config import NOT_PORTED

    root, port, seen, rep = stream_ops_run
    assert field not in NOT_PORTED
    if field == "trace":
        trace = json.load(open(root / "trace.json"))
        assert {"fetch", "pack", "dispatch", "drain"} <= {
            e["name"] for e in trace["traceEvents"]}
    elif field == "ops_port":
        assert seen["served"] == [(port, 200)]
    elif field == "stall_sec":
        # the freshness objective reads the run's watchdog: no_data
        # without one
        by = {o["name"]: o for o in rep["slo"]["objectives"]}
        assert by["freshness"]["value_sec"] is not None
        assert rep["metrics"]["counters"].get("watchdog_stall_total", 0) == 0
    elif field == "obs_report":
        assert rep["run"]["bootstrapped"] == 1
        assert not (root / "obs_report.json").exists() or \
            json.load(open(root / "obs_report.json"))["run"][
                "bootstrapped"] == 0
    elif field == "profile":
        [w] = rep["profile"]["windows"]
        assert "error" not in w and w["seconds"] == 0.05
        assert w["attribution"]["source"] == "no-device-events"
    elif field == "profile_dir":
        assert list((root / "pd").glob("*.trace.json.gz"))
    elif field == "flightrec":
        assert seen["armed"] == 1       # the second run's, not the first's
    elif field == "slo_budget":
        # the run that set it was not refused, and the budget readers
        # evaluate the configured spec over the run's telemetry home
        from firebird_tpu_torch import __main__ as tmain
        from firebird_tpu_torch.config import Config

        assert rep["run"]["bootstrapped"] == 1
        monkeypatch.setenv("FIREBIRD_STORE_PATH", str(root / "s.db"))
        monkeypatch.setenv("FIREBIRD_SLO_BUDGET", "probe_errors@99/1d")
        doc = tmain._status_doc(Config.from_env())
        assert list(doc["budgets"]["budgets"]) == ["probe_errors"]
        assert (root / "telemetry" / "series").is_dir()
    elif field == "object_root":
        # the bootstrap's rows and its checkpoint were mirrored to the
        # object tier, where the JAX package reads them
        from firebird_tpu.store import objectstore as jobj
        from firebird_tpu.streamops import statestore as jss
        from firebird_tpu_torch.store import SqliteStore
        from firebird_tpu_torch.streamops import statestore as tss

        objects = jobj.open_object_root(root=str(root / "objects"))
        mirror = jobj.ObjectBackedStore(
            objects, jobj.scope_for_path(str(root / "s.db")), "ccdc_0_2_0")
        local = SqliteStore(str(root / "s.db"), "ccdc_0_2_0")
        assert mirror.count("segment") == local.count("segment") > 0
        assert mirror.chip_ids() == local.chip_ids()
        [cid] = local.chip_ids()
        state = jss.ObjectStateStore(
            objects, jobj.scope_for_path(str(root / "state")))
        packed = tss.TileStateStore(str(root / "state"))
        want, got = packed.peek_arrays(cid), state.peek_arrays(cid)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        packed.close()
        local.close()
    else:
        assert rep["slo"]["spec"] == "batch_p95=30;freshness=600"
        assert [o["name"] for o in rep["slo"]["objectives"]] == [
            "batch_p95", "freshness"]
