"""ctypes bindings for the native ingest data plane (fastpack.cpp).

The port's own copy of the JAX package's ``native/``: the same C++ source
and API.  The shared library is compiled with g++ at first use into
``build/firebird_tpu_torch/`` (never next to the source), keyed by a hash
of the source and flags.  Two processes reaching the build together build
it once: the build holds an exclusive lock and looks for the library again
once it has it, g++ writes to a name of this process's own, and the
library lands by an atomic rename (as the CUDA kernels' build,
``ccd/cuda_ops._compile``).  Every entry point has a NumPy fallback, so the
package works, only slower, where no C++ toolchain exists.  ``available()``
reports which path is active; FIREBIRD_NO_NATIVE=1 forces the fallback
(the tests use it to cover both).  The port decodes chip payloads here
(``ingest.sources.decode_raster``); its packer keeps NumPy's one-core
transposes (``ingest/packer.py`` says why), so ``pack_spectra`` and
``pack_qa`` serve callers that have the cores to spare.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

from firebird_tpu_torch.config import env_knob

SRC = Path(__file__).resolve().with_name("fastpack.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "firebird_tpu_torch"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
# Mutated only inside _load's `with _lock:`; the double-checked fast
# path reads the references lock-free.
_lib = None  # guarded-by: _lock
_tried = False  # guarded-by: _lock


def lib_path() -> Path:
    """The library's path: ``libfastpack-<hash of source and flags>.so``."""
    h = hashlib.sha1(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libfastpack-{h.hexdigest()[:12]}.so"


def _build(out: Path) -> bool:
    """Build the library into ``out`` unless it exists; False where g++
    fails or is missing (the NumPy fallback then runs)."""
    if out.exists():
        return True
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / "fastpack.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if out.exists():
                return True
            tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
            try:
                subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp)],
                               check=True, capture_output=True, timeout=120)
                tmp.replace(out)
            finally:
                tmp.unlink(missing_ok=True)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def _load():
    """The ctypes handle, building the library if needed; None = fallback."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if env_knob("FIREBIRD_NO_NATIVE"):
            return None
        path = lib_path()
        if not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        i64, u8p = ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)
        i16p = ctypes.POINTER(ctypes.c_int16)
        u16p = ctypes.POINTER(ctypes.c_uint16)
        lib.fb_b64_decode.argtypes = [ctypes.c_char_p, i64, u8p]
        lib.fb_b64_decode.restype = i64
        lib.fb_pack_spectra.argtypes = [i16p, i64, i64, i64, i64,
                                        ctypes.c_int16, i16p]
        lib.fb_pack_spectra.restype = None
        lib.fb_pack_qa.argtypes = [u16p, i64, i64, i64, ctypes.c_uint16, u16p]
        lib.fb_pack_qa.restype = None
        _lib = lib
        return _lib


def _b64_fallback(data: bytes) -> bytes:
    """Strict stdlib decode matching the native decoder: whitespace is
    skipped (JSON payloads may wrap), any other invalid char raises."""
    import base64
    import binascii

    try:
        return base64.b64decode(data.translate(None, b" \t\r\n"),
                                validate=True)
    except binascii.Error as e:
        raise ValueError(f"invalid base64 payload: {e}") from None


def available() -> bool:
    """True when the C++ library is loaded (False = NumPy fallback)."""
    return _load() is not None


def b64_decode(data: bytes | str) -> bytes:
    """base64 -> raw bytes (native decoder; falls back to the stdlib)."""
    if isinstance(data, str):
        data = data.encode("ascii")
    lib = _load()
    if lib is None:
        return _b64_fallback(data)
    out = np.empty((len(data) // 4 + 1) * 3, np.uint8)
    n = lib.fb_b64_decode(
        data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if n < 0:
        raise ValueError("invalid base64 payload")
    return out[:n].tobytes()


def b64_decode_into(data: bytes | str, out: np.ndarray) -> int:
    """Decode base64 straight into ``out``'s buffer (no intermediate bytes
    object); returns the decoded byte count.  ``out`` must be C-contiguous
    and at least large enough.  Little-endian hosts only — the wire format
    is little-endian int16 and the reinterpret is a plain memory view."""
    if isinstance(data, str):
        data = data.encode("ascii")
    if not out.flags.c_contiguous:
        raise ValueError("out must be C-contiguous")
    # Worst-case output: 3 bytes per 4 chars, minus what padding removes.
    tail = data.rstrip(b" \t\r\n")
    pad = 2 if tail.endswith(b"==") else (1 if tail.endswith(b"=") else 0)
    if out.nbytes < (3 * len(tail)) // 4 - pad:
        raise ValueError(
            f"out too small: {out.nbytes} bytes for {len(tail)} b64 chars")
    lib = _load()
    if lib is None or sys.byteorder != "little":
        raw = _b64_fallback(data)
        flat = out.view(np.uint8).reshape(-1)
        flat[:len(raw)] = np.frombuffer(raw, np.uint8)
        return len(raw)
    n = lib.fb_b64_decode(
        data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if n < 0:
        raise ValueError("invalid base64 payload")
    return n


def pack_spectra(src: np.ndarray, cap: int, fill: int,
                 out: np.ndarray | None = None) -> np.ndarray:
    """[B, T, HW] int16 -> [B, HW, cap] int16 transpose + fill padding."""
    B, T, HW = src.shape
    if cap < T:
        raise ValueError(f"cap {cap} < T {T}")
    src = np.ascontiguousarray(src, np.int16)
    if out is None:
        out = np.empty((B, HW, cap), np.int16)
    if out.shape != (B, HW, cap) or out.dtype != np.int16 \
            or not out.flags.c_contiguous:
        raise ValueError("out must be C-contiguous int16 [B, HW, cap]")
    lib = _load()
    if lib is None:
        out[..., :T] = src.transpose(0, 2, 1)
        out[..., T:] = fill
        return out
    lib.fb_pack_spectra(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        B, T, HW, cap, fill,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
    return out


def pack_qa(src: np.ndarray, cap: int, fill: int,
            out: np.ndarray | None = None) -> np.ndarray:
    """[T, HW] uint16 -> [HW, cap] uint16 transpose + fill padding."""
    T, HW = src.shape
    if cap < T:
        raise ValueError(f"cap {cap} < T {T}")
    src = np.ascontiguousarray(src, np.uint16)
    if out is None:
        out = np.empty((HW, cap), np.uint16)
    if out.shape != (HW, cap) or out.dtype != np.uint16 \
            or not out.flags.c_contiguous:
        raise ValueError("out must be C-contiguous uint16 [HW, cap]")
    lib = _load()
    if lib is None:
        out[:, :T] = src.T
        out[:, T:] = fill
        return out
    lib.fb_pack_qa(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        T, HW, cap, fill,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    return out
