"""The port's closed-form FLOP / byte model (firebird_tpu_torch/ccd/
flops.py) against the JAX package's (firebird_tpu/ccd/flops.py), on the
CPU: the same arithmetic, so every function must equal JAX's exactly on a
grid of shapes, sensors, component sets and mixed precision.  The peaks
are the port's own: the H100's, and no TPU's."""

import itertools

import numpy as np
import pytest
import torch

from firebird_tpu.ccd import flops as jflops
from firebird_tpu.ccd import kernel as jkernel
from firebird_tpu.ccd.sensor import LANDSAT_ARD as J_LANDSAT
from firebird_tpu.ccd.sensor import SENTINEL2 as J_S2
from firebird_tpu_torch.ccd import flops, kernel
from firebird_tpu_torch.ccd.sensor import LANDSAT_ARD, SENTINEL2
from firebird_tpu_torch.obs import metrics as obs_metrics

SENSORS = [(LANDSAT_ARD, J_LANDSAT), (SENTINEL2, J_S2)]
SHAPES = [(1, 8, 1), (256, 128, 24), (10_000, 768, 24), (90_000, 64, 40)]
COMPONENT_SETS = [(), ("fit",), ("score",), ("init",), ("fit", "score"),
                  ("fit", "init", "score"), ("fit", "init", "score", "fused"),
                  ("fused",), ("mega",), ("lasso", "monitor", "tmask")]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("si", [0, 1], ids=["landsat", "sentinel2"])
@pytest.mark.parametrize("mixed", [False, True])
def test_round_setup_and_detect_flops_equal_jax(shape, si, mixed):
    P, T, W = shape
    ts, js = SENSORS[si]
    assert flops.round_flops(P, T, W, ts, mixed=mixed) == \
        jflops.round_flops(P, T, W, js, mixed=mixed)
    assert flops.setup_flops(P, T, ts) == jflops.setup_flops(P, T, js)
    for rounds, phases in ((23, None), (23.0, (7.0, 23.0, 22.0)),
                           (1.5, (0.5, 1.0, 0.25))):
        assert flops.detect_flops(P, T, W, rounds, ts, phase_rounds=phases,
                                  mixed=mixed) == \
            jflops.detect_flops(P, T, W, rounds, js, phase_rounds=phases,
                                mixed=mixed)


@pytest.mark.parametrize("comps", COMPONENT_SETS, ids=lambda c: "+".join(c)
                         or "plain")
@pytest.mark.parametrize("si", [0, 1], ids=["landsat", "sentinel2"])
def test_round_bytes_equal_jax(comps, si):
    """The same component set models the same bytes: the port's route
    names are JAX's switches ('lasso', 'monitor', 'tmask' model as the
    plain path, as JAX's XLA path around its component kernels)."""
    ts, js = SENSORS[si]
    jcomps = tuple(c for c in comps if c in ("score", "init", "fit",
                                              "fused", "mega"))
    for (P, T, W), S, dtype_bytes, mixed in itertools.product(
            SHAPES, (1, 4, 8), (4, 8), (False, True)):
        for rounds, phases in ((23.0, None), (23.0, (7.0, 23.0, 22.0))):
            got = flops.round_bytes(P, T, W, S, dtype_bytes, ts,
                                    rounds=rounds, phase_rounds=phases,
                                    pallas=comps, mixed=mixed)
            assert got == jflops.round_bytes(
                P, T, W, S, dtype_bytes, js, rounds=rounds,
                phase_rounds=phases, pallas=jcomps, mixed=mixed)


@pytest.mark.parametrize("pallas, fused, want", [
    ("1", 0, {"fit", "score", "init"}),
    ("1", 1, {"fit", "score", "init", "fused"}),
    ("1", "mon", {"fit", "score", "init", "fused"}),
    ("mega", 0, {"mega"}),
    ("mega", 1, {"mega"}),
    ("lasso,monitor,tmask", 0, {"lasso", "monitor", "tmask"})])
def test_modeled_components_of_a_route(pallas, fused, want):
    route = kernel.pallas_components(pallas, mixed=False)
    assert flops.modeled_components(route, fused) == frozenset(want)


def _occupancy(seed, C=3, R=40, P=512):
    rng = np.random.default_rng(seed)
    rounds = rng.integers(1, R + 8, C).astype(np.int32)
    active = rng.integers(0, P + 1, (C, R))
    paid = np.minimum(P, active + rng.integers(0, 64, (C, R)))
    return np.stack([active, paid], -1).astype(np.int32), rounds, P


@pytest.mark.parametrize("seed", range(4))
def test_occupancy_detail_equals_jax(seed):
    occ, rounds, P = _occupancy(seed, R=40 + 60 * seed)
    a, b = flops.occupancy_detail(occ, rounds, P), \
        jflops.occupancy_detail(occ, rounds, P)
    np.testing.assert_array_equal(a.pop("_fractions"), b.pop("_fractions"))
    assert a == b
    for frac in (0.0, 0.01, 0.125, 0.5, 1.0, 1.5):
        assert flops.expected_compaction_speedup(frac) == \
            jflops.expected_compaction_speedup(frac)
        assert flops.expected_compaction_speedup(frac, 256, 90_000) == \
            jflops.expected_compaction_speedup(frac, 256, 90_000)


@pytest.mark.parametrize("rounds_by_shard, wall, moved", [
    ([23, 23], 1.0, 0), ([23, 11, 7, 0], 2.5, 384), ([0, 0], 1.0, 0), ([],
                                                                    3.0, 5)])
def test_rebalance_detail_equals_jax(rounds_by_shard, wall, moved):
    assert flops.rebalance_detail(rounds_by_shard, wall, moved) == \
        jflops.rebalance_detail(rounds_by_shard, wall, moved)


def test_record_occupancy_feeds_jax_counters_and_histogram():
    """kernel.record_occupancy goes through flops.occupancy_detail: its
    summary, counters and histogram equal the JAX package's on the same
    capture."""
    from firebird_tpu.obs import metrics as jmetrics

    occ, rounds, P = _occupancy(5)
    C = occ.shape[0]
    comp = np.array([2] + [0] * (C - 1), np.int32)
    moved = np.array([17] + [0] * (C - 1), np.int32)

    def seg(cls):
        return cls(n_segments=np.zeros((C, P), np.int32),
                   seg_meta=None, seg_rmse=None, seg_mag=None,
                   seg_coef=None, mask=np.zeros((C, P, 8), bool),
                   procedure=None, rounds=rounds, vario=None,
                   occupancy=occ, compactions=comp, lanes_migrated=moved)

    obs_metrics.reset_registry()
    jmetrics.reset_registry()
    try:
        mine = kernel.record_occupancy(seg(kernel.ChipSegments))
        theirs = jkernel.record_occupancy(seg(jkernel.ChipSegments))
        assert mine == theirs and mine["lanes_migrated"] == 17
        a = obs_metrics.get_registry().snapshot()
        b = jmetrics.get_registry().snapshot()
        assert a["counters"] == b["counters"]
        assert a["counters"]["kernel_compactions"] == 2
        ha = a["histograms"]["kernel_round_active_fraction"]
        hb = b["histograms"]["kernel_round_active_fraction"]
        for k in ("count", "sum", "bucket_bounds", "bucket_counts"):
            assert ha[k] == hb[k], k
    finally:
        obs_metrics.reset_registry()
        jmetrics.reset_registry()


def test_peaks_are_the_h100s_and_no_tpus():
    assert [p.name for p in flops.PEAKS] == ["H100"]
    pk = flops.peak_for("NVIDIA H100 80GB HBM3")
    assert (pk.bf16_flops, pk.f32_flops, pk.hbm_bytes) == \
        (989e12, 67e12, 3.35e12)
    for kind in ("TPU v5 lite", "TPU v4", "TPU v6e", "cpu",
                 "NVIDIA A100-SXM4-80GB"):
        assert flops.peak_for(kind) is None, kind
    src = open(flops.__file__).read()
    for tpu in ("v5p", "v5 lite", "v5e", "v4", "v6", "Trillium"):
        assert f'"{tpu}"' not in src


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("comps", [(), ("fit", "init", "score"), ("mega",)],
                         ids=["plain", "route0", "mega"])
def test_bench_detail_equals_jax(monkeypatch, mixed, comps):
    """With no peak (a CPU) both packages give the same block; with the
    H100's peak set on JAX's side too, the same block with the roofline
    shares and ceilings."""
    kw = dict(pixels_per_sec=43_210.5, P=10_000, T=768, W=24, S=8,
              rounds=23.0, phase_rounds=(7.0, 23.0, 22.0), pallas=comps,
              mixed=mixed)
    assert flops.bench_detail(device_kind="cpu", sensor=LANDSAT_ARD, **kw) \
        == jflops.bench_detail(device_kind="cpu", sensor=J_LANDSAT, **kw)
    pk = flops.PEAKS[0]
    monkeypatch.setattr(jflops, "PEAKS", (jflops.Peak(
        "h100", pk.bf16_flops, pk.f32_flops, pk.hbm_bytes),))
    kind = "NVIDIA H100 80GB HBM3"
    got = flops.bench_detail(device_kind=kind, sensor=LANDSAT_ARD, **kw)
    assert got == jflops.bench_detail(device_kind=kind, sensor=J_LANDSAT,
                                      **kw)
    assert got["mfu_pct_vs_f32_peak"] > 0 and got["hbm_util_pct"] > 0
    assert ("mixed_compute_bound_pixels_per_sec" in got.get("mixed", {})) \
        == mixed
