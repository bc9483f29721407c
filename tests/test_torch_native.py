"""The port's native data plane (firebird_tpu_torch/native) against the JAX
package's, on the CPU.

``firebird_tpu_torch.native`` is the port's own copy of ``firebird_tpu.native``
(the same fastpack.cpp, built with g++ into build/firebird_tpu_torch/ at
first use): every function must give the JAX package's bytes, on the C++
path and on the NumPy fallback (FIREBIRD_NO_NATIVE) alike — the cases of
tests/test_native.py, each held to JAX's output.  ``ingest.pack`` must give
JAX's PackedChips array for array, and ``decode_raster`` must decode as
JAX's does: a payload wrapped with whitespace gives JAX's array, a corrupt
one raises where JAX raises (fault C4: the port decoded with the lenient
``base64.b64decode``, which drops any character outside the alphabet).
"""

import base64
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from firebird_tpu import native as jnative
from firebird_tpu.ingest import pack as jpack
from firebird_tpu.ingest import sources as jsources
from firebird_tpu.ingest.packer import ChipData as JChipData
from firebird_tpu.ingest.sources import SyntheticSource as JSyntheticSource
from firebird_tpu_torch import native
from firebird_tpu_torch.ingest import pack as tpack
from firebird_tpu_torch.ingest import sources as tsources
from firebird_tpu_torch.ingest.packer import ChipData as TChipData

ROOT = Path(__file__).resolve().parents[1]
DATA = ROOT / "tests" / "data" / "recorded"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(params=["native", "numpy"])
def path(request, monkeypatch):
    """Each case on the C++ path and on the NumPy fallback (the port's; the
    JAX package's native module runs as it is)."""
    if request.param == "numpy":
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", True)
    else:
        assert native.available()
    return request.param


def test_library_builds_into_the_build_directory():
    # g++ is part of the toolchain: the library compiles and loads, into
    # build/firebird_tpu_torch/, never next to its source.
    assert native.available()
    lib = native.lib_path()
    assert lib.exists() and lib.parent == ROOT / "build" / "firebird_tpu_torch"
    assert not list((ROOT / "firebird_tpu_torch" / "native").glob("*.so"))
    assert native.SRC.read_text().split("#include", 1)[1] == \
        (ROOT / "firebird_tpu" / "native" / "fastpack.cpp").read_text() \
        .split("#include", 1)[1]


@pytest.mark.parametrize("n", [0, 1, 2, 3, 57, 20000])
def test_b64_roundtrip_equals_jax(n, path):
    rng = np.random.default_rng(n)
    raw = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    enc = base64.b64encode(raw)
    assert native.b64_decode(enc) == raw == jnative.b64_decode(enc)
    assert native.b64_decode(enc.decode()) == jnative.b64_decode(enc.decode())


def test_b64_whitespace_and_invalid_as_jax(path):
    raw = b"hello world!"
    enc = base64.b64encode(raw).decode()
    wrapped = enc[:4] + "\n" + enc[4:8] + " " + enc[8:]
    assert native.b64_decode(wrapped) == jnative.b64_decode(wrapped) == raw
    for bad in ("@@@@", "QUJD@@@@RUZH"):
        with pytest.raises(ValueError):
            native.b64_decode(bad)
        with pytest.raises(ValueError):
            jnative.b64_decode(bad)


def test_b64_int16_payload_equals_jax(path):
    # The wire shape: 20,000 bytes of little-endian int16 -> [100,100].
    rng = np.random.default_rng(0)
    a = rng.integers(-30000, 30000, (100, 100), dtype=np.int16)
    enc = base64.b64encode(a.astype("<i2").tobytes())
    out = np.empty(10001, "<i2")
    n = native.b64_decode_into(enc, out)
    jout = np.empty(10001, "<i2")
    assert n == jnative.b64_decode_into(enc, jout) == 20000
    np.testing.assert_array_equal(out[:10000].reshape(100, 100), a)
    np.testing.assert_array_equal(out[:10000], jout[:10000])


@pytest.mark.parametrize("T,cap", [(0, 8), (1, 8), (37, 64), (64, 64)])
def test_pack_spectra_equals_jax(T, cap, path):
    rng = np.random.default_rng(T)
    src = rng.integers(-9999, 30000, (7, T, 251), dtype=np.int16)
    got = native.pack_spectra(src, cap, -9999)
    want = jnative.pack_spectra(src, cap, -9999)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("T,cap", [(0, 8), (37, 64)])
def test_pack_qa_equals_jax(T, cap, path):
    rng = np.random.default_rng(T)
    src = rng.integers(0, 2**16, (T, 333), dtype=np.uint16)
    got = native.pack_qa(src, cap, 1)
    want = jnative.pack_qa(src, cap, 1)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_fallback_b64_strict(monkeypatch):
    """The stdlib fallback keeps the native decoder's error contract:
    whitespace skipped, any other invalid character raises ValueError."""
    raw = bytes(range(256)) * 4
    enc = base64.b64encode(raw).decode()
    wrapped = "\n".join(enc[i: i + 76] for i in range(0, len(enc), 76))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    assert native.b64_decode(wrapped) == raw == jnative.b64_decode(wrapped)
    for bad in ("@@@@", "QUJD@@@@RUZH"):
        with pytest.raises(ValueError, match="invalid base64 payload"):
            native.b64_decode(bad)


def test_fallback_parity_on_a_chip(monkeypatch):
    """The NumPy fallback and the C++ path agree on a chip-sized workload,
    and both equal the JAX package's."""
    rng = np.random.default_rng(7)
    src = rng.integers(-9999, 30000, (7, 120, 10000), dtype=np.int16)
    qa = rng.integers(0, 2**16, (120, 10000), dtype=np.uint16)
    fast_s = native.pack_spectra(src, 128, -9999)
    fast_q = native.pack_qa(qa, 128, 1)
    np.testing.assert_array_equal(fast_s, jnative.pack_spectra(src, 128,
                                                               -9999))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    assert not native.available()
    np.testing.assert_array_equal(native.pack_spectra(src, 128, -9999), fast_s)
    np.testing.assert_array_equal(native.pack_qa(qa, 128, 1), fast_q)


def test_pack_uses_out_buffer(path):
    src = np.zeros((7, 4, 16), np.int16)
    out = np.empty((7, 16, 8), np.int16)
    assert native.pack_spectra(src, 8, -9999, out=out) is out
    with pytest.raises(ValueError, match="C-contiguous"):
        native.pack_spectra(src, 8, -9999, out=np.empty((7, 16, 9),
                                                        np.int16))


def test_no_native_knob_selects_the_fallback(monkeypatch):
    monkeypatch.setenv("FIREBIRD_NO_NATIVE", "1")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert not native.available()
    assert native.b64_decode(base64.b64encode(b"abc")) == b"abc"


def _chips(n=3):
    src = JSyntheticSource(seed=4, start="1996-01-01", end="1999-01-01")
    return [src.chip(1000 * c, 2000) for c in range(n)]


@pytest.mark.parametrize("bucket,max_obs", [(64, 0), (16, 40)])
def test_pack_equals_jaxs_packed_chips(bucket, max_obs, path):
    jchips = _chips()
    tchips = [TChipData(cx=c.cx, cy=c.cy, dates=c.dates, spectra=c.spectra,
                        qas=c.qas, sensor=c.sensor) for c in jchips]
    got = tpack(tchips, bucket=bucket, max_obs=max_obs)
    want = jpack(jchips, bucket=bucket, max_obs=max_obs)
    for f in ("cids", "dates", "spectra", "qas", "n_obs"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f


def test_decode_recorded_payloads_equal_jax(path):
    for rec in json.loads((DATA / "chip_response.json").read_text()):
        np.testing.assert_array_equal(tsources.decode_raster(rec),
                                      jsources.decode_raster(rec))


def _payload(kind):
    """The payload of np.arange(4, dtype='<i2') at side 2, with ``kind``
    put after its fourth character."""
    enc = base64.b64encode(np.arange(4, dtype="<i2").tobytes()).decode()
    insert = {"clean": "", "newline": "\n", "spaces": "  ", "crlf": "\r\n",
              "at": "@@@@", "bang": "!", "dash": "-"}[kind]
    return enc[:4] + insert + enc[4:]


@pytest.mark.parametrize("kind", ["clean", "newline", "spaces", "crlf", "at",
                                  "bang", "dash"])
def test_decode_raster_raises_where_jax_raises(kind, path):
    """C4: a corrupt Chipmunk payload raises ValueError in both packages
    (its chip is quarantined); a wrapped one decodes to JAX's array."""
    rec = {"data": _payload(kind)}
    try:
        want = jsources.decode_raster(rec, side=2)
    except ValueError:
        with pytest.raises(ValueError, match="invalid base64"):
            tsources.decode_raster(rec, side=2)
        assert kind in ("at", "bang", "dash")
        return
    np.testing.assert_array_equal(tsources.decode_raster(rec, side=2), want)
    np.testing.assert_array_equal(want, [[0, 1], [2, 3]])


# A stand-in for g++: logs its call, then writes its output slowly, so
# that two builds of the library would overlap.
FAKE_GXX = textwrap.dedent("""\
    import os, sys, time
    out = sys.argv[sys.argv.index("-o") + 1]
    with open(os.environ["FB_GXX_LOG"], "a") as f:
        f.write(f"{os.getpid()} {out}\\n")
    with open(out, "wb") as f:
        for i in range(25):
            f.write(bytes([i]) * 4096)
            f.flush()
            time.sleep(0.02)
    """)

BUILD_CHILD = textwrap.dedent("""\
    import hashlib, sys, time
    from pathlib import Path
    from firebird_tpu_torch import native
    build, me = Path(sys.argv[1]), sys.argv[2]
    native.BUILD_DIR = build
    (build.parent / f"ready.{me}").touch()
    while len(list(build.parent.glob("ready.*"))) < 2:
        time.sleep(0.005)
    out = native.lib_path()
    assert native._build(out)
    print("LIB", out, hashlib.sha256(out.read_bytes()).hexdigest())
    """)


def test_two_processes_build_the_library_once(tmp_path):
    """The build under two processes (one process per card): one g++ run,
    and both processes find its complete library (C3's lock and
    per-process temp name, as the kernels' build)."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    gxx = bindir / "g++"
    gxx.write_text(f"#!{sys.executable}\n" + FAKE_GXX)
    gxx.chmod(0o755)
    log = tmp_path / "gxx.log"
    env = dict(os.environ, PYTHONPATH=str(ROOT), FB_GXX_LOG=str(log),
               PATH=f"{bindir}{os.pathsep}{os.environ['PATH']}")
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_CHILD,
                               str(tmp_path / "build"), str(i)], env=env,
                              stdout=subprocess.PIPE, text=True)
             for i in (0, 1)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    libs = [o.split("LIB ")[1].split() for o in outs]
    assert len(log.read_text().splitlines()) == 1
    assert libs[0] == libs[1]
    assert Path(libs[0][0]).read_bytes() == b"".join(
        bytes([i]) * 4096 for i in range(25))
    assert not [p for p in (tmp_path / "build").iterdir() if ".tmp" in p.name]
