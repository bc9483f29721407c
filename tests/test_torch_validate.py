"""The port's parity audit (firebird_tpu_torch/validate.py and
``python -m firebird_tpu_torch validate``) against the JAX package's
(firebird_tpu/validate.py, ``firebird validate``), on the CPU: the same
chips, the same sampled pixels, the same report."""

import json

import numpy as np
import pytest
import torch

from firebird_tpu import validate as jvalidate
from firebird_tpu.ingest import SyntheticSource as JSyntheticSource
from firebird_tpu.ingest import pack as jpack
from firebird_tpu.ingest.packer import PackedChips as JPackedChips
from firebird_tpu_torch import __main__ as tmain
from firebird_tpu_torch import validate
from firebird_tpu_torch.ccd import cuda_ops
from firebird_tpu_torch.ccd.sensor import SENTINEL2
from firebird_tpu_torch.ingest.packer import PackedChips

EXACT = ("pixels_audited", "dtype", "obs_per_pixel", "structural_agreement",
         "mismatches", "break_day_agreement", "band_segments_checked")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_packed():
    """JAX's test chip (tests/test_validate.py): seed 3, 1995-1997, the
    pixel axis slimmed to 256; as (port, JAX) PackedChips of one array
    set."""
    src = JSyntheticSource(seed=3, start="1995-01-01", end="1998-01-01")
    p = jpack([src.chip(100, 200)], bucket=32)
    arrays = dict(cids=p.cids, dates=p.dates,
                  spectra=p.spectra[:, :, :256, :],
                  qas=p.qas[:, :256, :], n_obs=p.n_obs)
    return PackedChips(**arrays), JPackedChips(**arrays)


def sentinel2_packed():
    """JAX's Sentinel-2 audit chip: 16 fuzzed 12-band pixels."""
    from firebird_tpu.ccd.sensor import SENTINEL2 as J_S2
    from test_fuzz_parity import SPECIALS, _dates, _fuzz_pixel, _pack_pixels

    rng = np.random.default_rng(4)
    t = _dates("2019-01-01", "2021-01-01", 10, 0.1, 0.0, rng)
    pixels = [_fuzz_pixel(t, rng, special=SPECIALS.get(i), sensor=J_S2)
              for i in range(16)]
    p = _pack_pixels(t, [Y for Y, _ in pixels], [q for _, q in pixels],
                     bucket=32, sensor=J_S2)
    arrays = dict(cids=p.cids, dates=p.dates, spectra=p.spectra, qas=p.qas,
                  n_obs=p.n_obs)
    return PackedChips(**arrays, sensor=SENTINEL2), p


def assert_reports_agree(mine, theirs, rel=1e-6):
    for k in EXACT:
        assert mine[k] == theirs[k], (k, mine[k], theirs[k])
    assert mine["change_probability_max_abs_err"] == pytest.approx(
        theirs["change_probability_max_abs_err"], abs=1e-6)
    for k, v in theirs["numeric_max_rel_err"].items():
        assert mine["numeric_max_rel_err"][k] <= max(10 * v, rel), k


@pytest.fixture(scope="module")
def small():
    return small_packed()


def test_validate_chip_agrees_structurally_as_jax(small):
    mine = validate.validate_chip(small[0], n_pixels=24, dtype="float64",
                                  device="cpu")
    theirs = jvalidate.validate_chip(small[1], n_pixels=24, dtype="float64")
    assert_reports_agree(mine, theirs)
    assert mine["structural_agreement"], mine["mismatches"]
    assert mine["break_day_agreement"] == 1.0
    assert mine["pixels_audited"] == 24 and mine["dtype"] == "float64"
    assert mine["numeric_max_rel_err"]["coefficients"] < 1e-3
    assert mine["change_probability_max_abs_err"] < 1e-6
    assert mine["band_segments_checked"] > 0


def test_validate_chip_float32_as_jax(small):
    """The float32 route (the kernels' plain versions on the CPU) audits
    to JAX's float32 report: the same mismatches on the same pixels."""
    mine = validate.validate_chip(small[0], n_pixels=48, dtype="float32",
                                  device="cpu", seed=5)
    theirs = jvalidate.validate_chip(small[1], n_pixels=48, dtype="float32",
                                     seed=5)
    for k in EXACT:
        assert mine[k] == theirs[k], (k, mine[k], theirs[k])
    assert mine["dtype"] == "float32"


def test_validate_detects_divergence(small, monkeypatch):
    """A corrupted detector result shows up as a structural mismatch."""
    real = validate.kernel.detect_packed

    def corrupt(packed, **kw):
        seg = real(packed, **kw)
        bad = seg.n_segments.clone()
        bad[:, ::2] += 1          # claim an extra segment on half the pixels
        return validate.kernel.ChipSegments(
            n_segments=bad, seg_meta=seg.seg_meta, seg_rmse=seg.seg_rmse,
            seg_mag=seg.seg_mag, seg_coef=seg.seg_coef, mask=seg.mask,
            procedure=seg.procedure, rounds=seg.rounds, vario=seg.vario)

    monkeypatch.setattr(validate.kernel, "detect_packed", corrupt)
    rep = validate.validate_chip(small[0], n_pixels=16, dtype="float64",
                                 device="cpu")
    assert not rep["structural_agreement"]
    assert rep["mismatches"]["n_models"] > 0


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_validate_chip_sentinel2(dtype, monkeypatch):
    """The audit is sensor-generic: a 12-band chip replays through the
    sensor-generic oracle.  In float32 it runs route 0's three wrappers
    at 12 bands (on the card: their 12-band instances) and no other."""
    mine_p, their_p = sentinel2_packed()
    seen = {}
    for name in vars(cuda_ops.KERNELS):
        fn = getattr(cuda_ops.KERNELS, name)

        def spy(*a, _fn=fn, _n=name, **kw):
            # the band axis of the int16 spectra the wrapper takes
            seen.setdefault(_n, set()).update(
                int(v.shape[1]) for v in (*a, *kw.values())
                if torch.is_tensor(v) and v.dtype == torch.int16)
            return _fn(*a, **kw)

        monkeypatch.setattr(cuda_ops.KERNELS, name, spy)
    mine = validate.validate_chip(mine_p, n_pixels=12, dtype=dtype,
                                  device="cpu")
    theirs = jvalidate.validate_chip(their_p, n_pixels=12, dtype=dtype)
    assert_reports_agree(mine, theirs, rel=1e-3 if dtype == "float32"
                         else 1e-6)
    if dtype == "float64":
        assert mine["structural_agreement"], mine["mismatches"]
        assert mine["break_day_agreement"] == 1.0
        assert seen == {}                 # the f64 route runs no kernel
    else:
        nd = len(SENTINEL2.detection_bands)
        assert seen == {"lasso_fit": {12}, "monitor_chain_scored": {nd},
                        "init_window": {12}}


def test_validate_replays_in_spawned_workers_alike(small):
    """The oracle replayed in a pool of two spawned processes (a caller's
    ``replay``) gives the report of the replay in this process."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    one = validate.validate_chip(small[0], n_pixels=6, dtype="float64",
                                 device="cpu", seed=2)
    with ProcessPoolExecutor(
            2, mp_context=multiprocessing.get_context("spawn")) as pool:
        two = validate.validate_chip(
            small[0], n_pixels=6, dtype="float64", device="cpu", seed=2,
            replay=lambda tasks: list(pool.map(validate.oracle, tasks)))
    assert one == two


def test_validate_rejects_single_coordinate(monkeypatch):
    monkeypatch.setenv("FIREBIRD_SOURCE", "synthetic")
    with pytest.raises(ValueError, match="both x and y"):
        validate.validate(x=542000.0, device="cpu")
    with pytest.raises(ValueError, match="positive"):
        validate.validate_chip(small_packed()[0], n_pixels=0, device="cpu")


def test_validate_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        validate.validate(n_pixels=1, acquired="1995-01-01/1995-06-01")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmain.main(["validate", "-n", "1", "-a", "1995-01-01/1995-06-01"])


def test_cli_validate_synthetic_as_jax(monkeypatch, capsys):
    from click.testing import CliRunner

    from firebird_tpu import cli

    monkeypatch.setenv("FIREBIRD_SOURCE", "synthetic")
    args = ["validate", "-n", "8", "--dtype", "float64",
            "-a", "1995-01-01/1997-06-01"]
    tmain.main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    rep = json.loads(out)
    res = CliRunner().invoke(cli.entrypoint, args)
    assert res.exit_code == 0, res.output
    theirs = json.loads(res.output[res.output.index("{"):])
    assert list(rep) == list(theirs)
    assert_reports_agree(rep, theirs)
    assert rep["structural_agreement"] is True and rep["pixels_audited"] == 8
    assert rep["chip"] == theirs["chip"] == [100, 200]
    assert out == json.dumps(rep, indent=1) + "\n"


def test_cli_validate_exits_2_on_disagreement(monkeypatch, capsys):
    monkeypatch.setenv("FIREBIRD_SOURCE", "synthetic")
    monkeypatch.setattr(validate, "validate", lambda **kw: {
        "structural_agreement": False, "pixels_audited": 1})
    with pytest.raises(SystemExit) as e:
        tmain.main(["validate", "--device", "cpu"])
    assert e.value.code == 2
    assert json.loads(capsys.readouterr().out)["structural_agreement"] \
        is False
