"""Tile-packed stream checkpoint store: one file per tile, 2500 slots.

The port's own copy of the JAX package's ``streamops/statestore.py``,
with the same on-disk format byte for byte (file and slot headers, the
double-bank protocol, the checksums and the canonical payload), so a
checkpoint either package wrote loads in the other: that checkpoint is
how stream state crosses between them.  Loads give
``incremental.StreamState`` tensors on the store's ``device``; saves take
tensors on any device (or arrays).  With ``object_root`` set, every
checkpoint publish is also mirrored to the object tier
(:class:`MirroredStateStore` over :class:`ObjectStateStore`), its payload
the same canonical bytes.

The per-chip ``.npz`` checkpoint layout (one file per chip) costs 2500
files per tile — ~1.8M small files at CONUS scale, which no shared
filesystem or backup path survives.  This store packs a whole tile's
stream checkpoints into ONE file of fixed-size chip slots with O(1)
slot access:

``tile_<h>_<v>.fbss`` layout::

    [file header 4096 B]
    [slot 0][slot 1] ... [slot n_slots-1]
    slot  := [hdr A 256 B][hdr B 256 B][bank A cap B][bank B cap B]
    hdr   := magic, generation, payload length, crc32, cx, cy
    bank  := the serialized StreamState arrays + side dict (a fixed
             canonical little-endian layout derived from (P, B, K))

**Crash safety (the double-bank protocol).**  A slot publish never
overwrites the live generation: generation g lives in bank ``g & 1``,
so publishing g+1 writes the payload into the OTHER bank (destroying
only the obsolete g-1) and then commits by writing that bank's 40-byte
header.  A SIGKILL torn anywhere in the sequence leaves the previous
generation's bank and header untouched: load verifies the highest-
generation header's checksum and falls back to the other bank — the
previous generation — with a warning (``statestore_torn_recoveries``).
This preserves the per-chip tmp+rename guarantees (fleet
zombies and their successors may overlap on the same chip) with a
region ``flock`` serializing same-slot publishers; different slots of
one tile file never contend.

**O(1) access.**  A chip id maps to its slot index by pure grid math
(row-major position inside its tile), so load/save touch exactly one
slot's bytes — no scans, no directory churn.  ``load_batch`` reads many
slots and stacks them into one leading-``[C]``-axis StreamState so a
single jitted ``incremental.step`` dispatch can carry many chips.

**Migration.**  ``load``/``exists`` fall through to the legacy per-chip
``state_<cx>_<cy>.npz`` files in the same directory; a legacy hit is
re-published into its packed slot (``statestore_migrations``) so the
fleet migrates as it streams, no offline rewrite step.

The packed layout is canonical float32 state (the dtypes the stream
driver's float32 bootstrap produces).  A float64 state (the
``FIREBIRD_DTYPE=float64`` compat path) does not fit losslessly and is
rejected with a pointer at the ``FIREBIRD_STREAM_STATESTORE=npz``
escape hatch.  ``peek_arrays`` gives the raw numpy arrays.  The
detector's state type (``ccd/incremental.py``) and torch are imported
where a state is built or taken apart, so a reader of the store's census
(``status``) loads neither.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib

import numpy as np

from firebird_tpu_torch import grid
from firebird_tpu_torch.obs import logger
from firebird_tpu_torch.obs import metrics as obs_metrics

log = logger("statestore")

STATESTORE_SCHEMA = "firebird-statestore/1"

# incremental.StreamState's fields, in its order (the JAX package's
# module keeps the same literal; a test holds the two equal).
STATE_FIELDS = ("coefs", "rmse", "vario", "nobs", "n_exceed", "end_day",
                "exceed_day0", "break_day", "active")
SIDE_FIELDS = ("sday", "curqa", "anchor", "horizon")

FILE_MAGIC = b"FBSS"
FILE_VERSION = 1
FILE_HDR_SIZE = 4096
_FILE_HDR = struct.Struct("<4sIIIIIQQii")   # magic, ver, P, B, K, n_slots,
#                                             payload_cap, slot_span, h, v

SLOT_HDR_SIZE = 256
_SLOT_HDR = struct.Struct("<IQQIqq")        # magic, gen, length, crc, cx, cy
SLOT_MAGIC = 0xFB55A7E5


class StateStoreError(RuntimeError):
    """A packed state file violates its own layout contract."""


def _layout(P: int, B: int, K: int) -> tuple:
    """The canonical slot payload: (name, dtype, shape) in file order.
    Fixed given the chip geometry, so every slot is the same size."""
    return (
        ("coefs", np.float32, (P, B, K)),
        ("rmse", np.float32, (P, B)),
        ("vario", np.float32, (P, B)),
        ("nobs", np.int32, (P,)),
        ("n_exceed", np.int32, (P,)),
        ("end_day", np.float32, (P,)),
        ("exceed_day0", np.float32, (P,)),
        ("break_day", np.float32, (P,)),
        ("active", np.bool_, (P,)),
        ("sday", np.float64, (P,)),
        ("curqa", np.int64, (P,)),
        ("anchor", np.float64, ()),
        ("horizon", np.float64, ()),
    )


def _payload_cap(P: int, B: int, K: int) -> int:
    return sum(int(np.dtype(d).itemsize * max(int(np.prod(s)), 1))
               for _, d, s in _layout(P, B, K))


def _host(a) -> np.ndarray:
    """A tensor on any device, or an array, as a host numpy array."""
    import torch

    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _canonical(name: str, arr, dtype, shape) -> np.ndarray:
    """Cast to the canonical dtype, refusing lossy conversions: a
    float64 state belongs on the npz escape hatch, not silently rounded
    into the packed file."""
    a = _host(arr)
    if a.shape != shape:
        raise StateStoreError(
            f"state field {name!r} has shape {a.shape}, layout wants "
            f"{shape}")
    c = np.ascontiguousarray(a, dtype=dtype)
    if a.dtype != np.dtype(dtype):
        back = c.astype(a.dtype)
        same = np.array_equal(back, a, equal_nan=True) \
            if np.issubdtype(a.dtype, np.floating) \
            else np.array_equal(back, a)
        if not same:
            raise StateStoreError(
                f"state field {name!r} ({a.dtype}) does not fit the "
                f"packed {np.dtype(dtype).name} layout losslessly — "
                "use FIREBIRD_STREAM_STATESTORE=npz for f64/compat "
                "state")
    return c


def serialize_state(st, side: dict) -> bytes:
    """One chip's state as the canonical payload bytes.  ``st`` is a
    StreamState (or any object with the STATE_FIELDS attributes);
    fields may be tensors on any device or numpy arrays."""
    coefs = _host(st.coefs)
    if coefs.ndim != 3:
        raise StateStoreError(
            f"serialize_state packs one chip ([P,B,K] coefs); got "
            f"{coefs.shape}")
    P, B, K = coefs.shape
    parts = []
    for name, dtype, shape in _layout(P, B, K):
        src = side[name] if name in SIDE_FIELDS else getattr(st, name)
        parts.append(_canonical(name, src, dtype, shape).tobytes())
    return b"".join(parts)


def deserialize_state(buf: bytes, P: int, B: int, K: int) -> dict:
    """Payload bytes -> {field: numpy array}."""
    out = {}
    off = 0
    for name, dtype, shape in _layout(P, B, K):
        n = int(np.dtype(dtype).itemsize * max(int(np.prod(shape)), 1))
        a = np.frombuffer(buf[off:off + n], dtype=dtype).reshape(shape)
        out[name] = a.copy() if shape else a.reshape(()).copy()
        off += n
    if off != len(buf):
        raise StateStoreError(
            f"payload length {len(buf)} does not match the (P={P}, "
            f"B={B}, K={K}) layout ({off} bytes)")
    return out


def _wrap_state(arrays: dict, device="cpu"):
    """{field: np array} -> (StreamState of tensors on ``device``, side
    dict of numpy arrays), the load_state contract."""
    import torch

    from firebird_tpu_torch.ccd.incremental import StreamState

    st = StreamState(*(torch.from_numpy(np.ascontiguousarray(arrays[f]))
                       .to(device) for f in STATE_FIELDS))
    side = {k: arrays[k] for k in SIDE_FIELDS}
    return st, side


# ---------------------------------------------------------------------------
# Legacy per-chip .npz checkpoints (the pre-streamops layout, kept as
# the f64/compat escape hatch and the migration source)
# ---------------------------------------------------------------------------

def state_dir(cfg) -> str:
    """Checkpoint directory: FIREBIRD_STREAM_DIR, else '<store_path>.stream'."""
    return cfg.stream_dir or (cfg.store_path + ".stream")


def legacy_state_path(sdir: str, cid) -> str:
    return os.path.join(sdir, f"state_{int(cid[0])}_{int(cid[1])}.npz")


def save_state(path: str, st, side: dict) -> None:
    """Atomic legacy checkpoint write (tmp + rename, the crash-safe
    idiom).  The temp name carries the pid: a fleet zombie and its
    successor can both be writing the same chip's checkpoint
    (fleet/worker.py designs for exactly that overlap), and a SHARED
    temp would interleave two writers into one corrupt .npz before the
    rename publishes it."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrs = {f: _host(getattr(st, f)) for f in STATE_FIELDS}
    arrs.update({k: _host(side[k]) for k in SIDE_FIELDS})
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrs)
    os.replace(tmp, path)


def load_state(path: str, device="cpu"):
    with np.load(path, allow_pickle=False) as d:
        arrays = {f: d[f] for f in STATE_FIELDS + SIDE_FIELDS}
    return _wrap_state(arrays, device)


class LegacyNpzStore:
    """The per-chip ``.npz`` layout behind the statestore API — the
    ``FIREBIRD_STREAM_STATESTORE=npz`` escape hatch (float64 state, old
    deployments) and the read-through migration source."""

    backend = "npz"

    def __init__(self, root: str, device="cpu"):
        self.root = root
        self.device = device        # a torch device or its name

    def _path(self, cid) -> str:
        return legacy_state_path(self.root, cid)

    def exists(self, cid) -> bool:
        return os.path.exists(self._path(cid))

    def save(self, cid, st, side: dict) -> None:
        save_state(self._path(cid), st, side)

    def load(self, cid):
        return load_state(self._path(cid), self.device)

    def peek_horizon(self, cid) -> float | None:
        """The chip's checkpoint horizon (last ingested ordinal day),
        or None when it has no checkpoint — the watcher's coverage
        sweep reads this to spot chips lagging the newest scene."""
        try:
            with np.load(self._path(cid), allow_pickle=False) as d:
                return float(d["horizon"])
        except OSError:
            return None

    def chips(self) -> list:
        import re

        out = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return out
        for n in names:
            m = re.fullmatch(r"state_(-?\d+)_(-?\d+)\.npz", n)
            if m:
                out.append((int(m.group(1)), int(m.group(2))))
        return sorted(out)

    def void(self, cid) -> None:
        """Discard a chip's checkpoint (unrecoverable state): the next
        stream run sees no checkpoint and re-bootstraps."""
        try:
            os.remove(self._path(cid))
        except OSError:
            pass

    def status(self) -> dict:
        return {"backend": self.backend, "root": self.root,
                "chips": len(self.chips())}

    def close(self) -> None:
        pass                      # no held fds in the per-chip layout


# ---------------------------------------------------------------------------
# The packed tile store
# ---------------------------------------------------------------------------

class TileStateStore:
    """One packed state file per tile, O(1) slot load/save per chip.

    Thread-safe within a process (one lock over the fd table) and
    process-safe across workers: same-slot publishes serialize under a
    byte-range ``lockf`` over the slot, and the double-bank protocol
    keeps the previous generation intact through any torn write (module
    docstring has the full argument)."""

    backend = "packed"

    def __init__(self, root: str, gridcfg: grid.GridConfig = grid.CONUS,
                 device="cpu"):
        self.root = root
        self.gridcfg = gridcfg
        self.device = device        # a torch device or its name
        self.legacy = LegacyNpzStore(root, device)
        self._ncols = int(round(gridcfg.tile.sx / gridcfg.chip.sx))
        self._nrows = int(round(gridcfg.tile.sy / gridcfg.chip.sy))
        self.n_slots = self._ncols * self._nrows
        self._lock = threading.Lock()
        self._fds: dict = {}      # guarded-by: _lock  (h, v) -> fd
        self._geom: dict = {}     # guarded-by: _lock  (h, v) -> (P, B, K)
        # Process-local activity tallies for the /progress streamops
        # block (cheap; the full-file scan lives in scan()).
        self.tallies = {k: 0 for k in ("saves", "loads", "migrations",
                                       "torn_recoveries")}

    # -- geometry ----------------------------------------------------------

    def slot_of(self, cid) -> tuple[tuple[int, int], int]:
        """((tile h, tile v), slot index) for a chip id — pure grid
        math, the O(1) access path."""
        cx, cy = int(cid[0]), int(cid[1])
        th, tv = grid.grid_pt(cx, cy, self.gridcfg.tile)
        ulx, uly = grid.proj_pt(th, tv, self.gridcfg.tile)
        col = (cx - ulx) / self.gridcfg.chip.sx
        row = (uly - cy) / self.gridcfg.chip.sy
        ic, ir = int(col), int(row)
        if col != ic or row != ir or not (0 <= ic < self._ncols
                                          and 0 <= ir < self._nrows):
            raise StateStoreError(
                f"chip ({cx},{cy}) is not a chip-grid point of tile "
                f"({th},{tv})")
        return (th, tv), ir * self._ncols + ic

    def tile_path(self, hv: tuple[int, int]) -> str:
        return os.path.join(self.root, f"tile_{hv[0]}_{hv[1]}.fbss")

    @staticmethod
    def _spans(P: int, B: int, K: int) -> tuple[int, int]:
        cap = _payload_cap(P, B, K)
        return cap, 2 * SLOT_HDR_SIZE + 2 * cap

    def _slot_offset(self, idx: int, slot_span: int) -> int:
        return FILE_HDR_SIZE + idx * slot_span

    # -- file bring-up -----------------------------------------------------

    def _open(self, hv, geom=None):
        """fd + (P, B, K) for a tile file; ``geom`` creates the file on
        first save (loads pass None: absent file -> KeyError so the
        legacy fallback can run)."""
        with self._lock:
            fd = self._fds.get(hv)
            if fd is not None:
                return fd, self._geom[hv]
        path = self.tile_path(hv)
        if geom is None and not os.path.exists(path):
            raise KeyError(f"no packed state file for tile {hv}")
        os.makedirs(self.root, exist_ok=True)
        fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            got = self._init_header(fd, hv, geom)
        except BaseException:
            os.close(fd)
            raise
        with self._lock:
            if hv in self._fds:          # lost the open race to a peer
                os.close(fd)
                return self._fds[hv], self._geom[hv]
            self._fds[hv] = fd
            self._geom[hv] = got
        return fd, got

    def _init_header(self, fd, hv, geom):
        """Read-or-write the file header under a header-region lock, so
        two processes creating the same tile file agree on one layout."""
        import fcntl

        fcntl.lockf(fd, fcntl.LOCK_EX, FILE_HDR_SIZE, 0, os.SEEK_SET)
        try:
            raw = os.pread(fd, _FILE_HDR.size, 0)
            if len(raw) == _FILE_HDR.size and raw[:4] == FILE_MAGIC:
                (_, ver, P, B, K, n_slots, cap, span, h, v) = \
                    _FILE_HDR.unpack(raw)
                if ver != FILE_VERSION:
                    raise StateStoreError(
                        f"{self.tile_path(hv)}: version {ver}, this "
                        f"build reads {FILE_VERSION}")
                if (h, v) != hv or n_slots != self.n_slots:
                    raise StateStoreError(
                        f"{self.tile_path(hv)}: header names tile "
                        f"({h},{v})x{n_slots}, expected {hv}x"
                        f"{self.n_slots}")
                want_cap, want_span = self._spans(P, B, K)
                if cap != want_cap or span != want_span:
                    raise StateStoreError(
                        f"{self.tile_path(hv)}: slot geometry drifted "
                        "from its own (P,B,K) header")
                if geom is not None and geom != (P, B, K):
                    raise StateStoreError(
                        f"{self.tile_path(hv)} holds (P,B,K)={(P, B, K)} "
                        f"state; this save carries {geom}")
                return (P, B, K)
            if geom is None:
                raise KeyError(f"packed state file for tile {hv} has no "
                               "header yet")
            P, B, K = geom
            cap, span = self._spans(P, B, K)
            os.pwrite(fd, _FILE_HDR.pack(
                FILE_MAGIC, FILE_VERSION, P, B, K, self.n_slots, cap,
                span, hv[0], hv[1]), 0)
            # Sparse-extend to full size: unwritten slots read as zeros
            # (magic 0 == absent) and consume no disk.
            os.ftruncate(fd, FILE_HDR_SIZE + self.n_slots * span)
            return (P, B, K)
        finally:
            fcntl.lockf(fd, fcntl.LOCK_UN, FILE_HDR_SIZE, 0, os.SEEK_SET)

    # -- slot I/O ----------------------------------------------------------

    def _read_banks(self, fd, base: int, cap: int):
        """Both banks' parsed headers: [(gen, length, crc, cx, cy,
        payload_offset), ...] for banks whose magic matches."""
        out = []
        for bank in (0, 1):
            raw = os.pread(fd, _SLOT_HDR.size, base + bank * SLOT_HDR_SIZE)
            if len(raw) < _SLOT_HDR.size:
                continue
            magic, gen, length, crc, cx, cy = _SLOT_HDR.unpack(raw)
            if magic != SLOT_MAGIC or gen == 0 or length > cap:
                continue
            out.append((gen, length, crc, cx, cy,
                        base + 2 * SLOT_HDR_SIZE + bank * cap))
        return out

    def save(self, cid, st, side: dict) -> None:
        self.save_arrays(cid, None, st=st, side=side)

    def save_arrays(self, cid, arrays: dict | None, *, st=None,
                    side=None) -> None:
        """Publish one chip's state: payload into the non-live bank,
        then the 40-byte commit header — under a slot-region lock so
        racing same-slot publishers (zombie + successor) serialize
        instead of interleaving."""
        import fcntl

        if arrays is not None:
            coefs = np.asarray(arrays["coefs"])
            P, B, K = coefs.shape
            payload = b"".join(
                _canonical(n, arrays[n], d, s).tobytes()
                for n, d, s in _layout(P, B, K))
        else:
            payload = serialize_state(st, side)
            P, B, K = st.coefs.shape
        hv, idx = self.slot_of(cid)
        fd, geom = self._open(hv, geom=(P, B, K))
        cap, span = self._spans(*geom)
        base = self._slot_offset(idx, span)
        fcntl.lockf(fd, fcntl.LOCK_EX, span, base, os.SEEK_SET)
        try:
            banks = self._read_banks(fd, base, cap)
            gen = 1 + max((b[0] for b in banks), default=0)
            bank = gen & 1
            os.pwrite(fd, payload, base + 2 * SLOT_HDR_SIZE + bank * cap)
            os.pwrite(fd, _SLOT_HDR.pack(
                SLOT_MAGIC, gen, len(payload), zlib.crc32(payload),
                int(cid[0]), int(cid[1])), base + bank * SLOT_HDR_SIZE)
        finally:
            fcntl.lockf(fd, fcntl.LOCK_UN, span, base, os.SEEK_SET)
        self.tallies["saves"] += 1
        obs_metrics.counter(
            "statestore_slot_saves",
            help="packed stream-checkpoint slot publishes").inc()

    def _load_arrays(self, cid) -> dict:
        """One slot's verified payload as {field: np array}; KeyError
        when the slot was never written; falls back one generation
        (with a warning) when the newest bank is torn."""
        hv, idx = self.slot_of(cid)
        fd, geom = self._open(hv)
        cap, span = self._spans(*geom)
        base = self._slot_offset(idx, span)
        banks = sorted(self._read_banks(fd, base, cap), reverse=True)
        for rank, (gen, length, crc, cx, cy, off) in enumerate(banks):
            if (cx, cy) != (int(cid[0]), int(cid[1])):
                raise StateStoreError(
                    f"slot {idx} of tile {hv} holds chip ({cx},{cy}), "
                    f"asked for {tuple(int(v) for v in cid)} — slot "
                    "mapping drift")
            payload = os.pread(fd, length, off)
            if len(payload) == length and zlib.crc32(payload) == crc:
                if rank > 0:
                    self.tallies["torn_recoveries"] += 1
                    obs_metrics.counter(
                        "statestore_torn_recoveries",
                        help="packed slot loads that fell back to the "
                             "previous generation past a torn "
                             "write").inc()
                    log.warning(
                        "chip (%s,%s): generation %d torn; recovered "
                        "generation %d", cid[0], cid[1], banks[0][0], gen)
                self.tallies["loads"] += 1
                obs_metrics.counter(
                    "statestore_slot_loads",
                    help="packed stream-checkpoint slot loads").inc()
                return deserialize_state(payload, *geom)
        if banks:
            raise StateStoreError(
                f"chip ({cid[0]},{cid[1]}): every bank of its slot "
                "fails its checksum — state lost, re-bootstrap the chip")
        raise KeyError(f"no packed state for chip "
                       f"({int(cid[0])},{int(cid[1])})")

    def load(self, cid):
        """(StreamState, side) — read-through: a chip absent from the
        packed file but present as a legacy ``.npz`` is migrated into
        its slot on the way out."""
        try:
            return _wrap_state(self._load_arrays(cid), self.device)
        except KeyError:
            if not self.legacy.exists(cid):
                raise
        st, side = self.legacy.load(cid)
        self.save(cid, st, side)
        self.tallies["migrations"] += 1
        obs_metrics.counter(
            "statestore_migrations",
            help="legacy per-chip .npz checkpoints migrated into "
                 "packed slots on read-through").inc()
        log.info("chip (%s,%s): legacy .npz checkpoint migrated into "
                 "the packed store", cid[0], cid[1])
        return st, side

    def exists(self, cid) -> bool:
        try:
            hv, idx = self.slot_of(cid)
            fd, geom = self._open(hv)
        except (KeyError, StateStoreError):
            return self.legacy.exists(cid)
        cap, span = self._spans(*geom)
        banks = self._read_banks(fd, self._slot_offset(idx, span), cap)
        return bool(banks) or self.legacy.exists(cid)

    def peek_arrays(self, cid) -> dict:
        """Raw numpy state arrays, no tensors built."""
        return self._load_arrays(cid)

    def peek_horizon(self, cid) -> float | None:
        """The chip's checkpoint horizon without deserializing the
        slot: the payload's trailing float64 (layout invariant).  A
        scheduling HINT, deliberately unchecksummed — its only consumer
        (the watcher's coverage sweep) enqueues idempotent jobs, so a
        torn tail costs one redundant no-op job, not correctness."""
        try:
            hv, idx = self.slot_of(cid)
            fd, geom = self._open(hv)
        except (KeyError, StateStoreError):
            return self.legacy.peek_horizon(cid)
        cap, span = self._spans(*geom)
        banks = sorted(self._read_banks(
            fd, self._slot_offset(idx, span), cap), reverse=True)
        for gen, length, crc, cx, cy, off in banks:
            raw = os.pread(fd, 8, off + length - 8)
            if len(raw) == 8:
                return struct.unpack("<d", raw)[0]
        return self.legacy.peek_horizon(cid)

    def load_batch(self, cids):
        """Many chips stacked on a leading [C] axis: one StreamState
        whose every field is ``stack([chip0, chip1, ...])`` plus the
        side dicts, tensors on the store's device (StreamState's [C, P]
        contract)."""
        import torch

        from firebird_tpu_torch.ccd.incremental import StreamState

        all_arrays = [self._load_arrays(c) for c in cids]
        st = StreamState(*(torch.from_numpy(
            np.stack([a[f] for a in all_arrays])).to(self.device)
            for f in STATE_FIELDS))
        sides = [{k: a[k] for k in SIDE_FIELDS} for a in all_arrays]
        return st, sides

    def void(self, cid) -> None:
        """Discard a chip's slot (both bank headers zeroed under the
        slot lock) AND any legacy npz behind it — the self-healing
        move when every bank fails its checksum (e.g. power loss
        persisted a commit header before its payload): ``exists``
        turns False and the next stream run re-bootstraps the chip
        instead of erroring forever on unrecoverable state."""
        import fcntl

        try:
            hv, idx = self.slot_of(cid)
            fd, geom = self._open(hv)
        except (KeyError, StateStoreError):
            self.legacy.void(cid)
            return
        cap, span = self._spans(*geom)
        base = self._slot_offset(idx, span)
        fcntl.lockf(fd, fcntl.LOCK_EX, span, base, os.SEEK_SET)
        try:
            os.pwrite(fd, b"\x00" * (2 * SLOT_HDR_SIZE), base)
        finally:
            fcntl.lockf(fd, fcntl.LOCK_UN, span, base, os.SEEK_SET)
        self.legacy.void(cid)

    def chips(self) -> list:
        """Chip ids with a live packed slot (file scan; operator path)."""
        out = []
        for hv, path in self._tile_files():
            try:
                fd, geom = self._open(hv)
            except (KeyError, StateStoreError):
                continue
            cap, span = self._spans(*geom)
            for idx in range(self.n_slots):
                banks = self._read_banks(
                    fd, self._slot_offset(idx, span), cap)
                if banks:
                    out.append((banks[0][3], banks[0][4]))
        return sorted(set(out) | set(self.legacy.chips()))

    def _tile_files(self):
        import re

        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        out = []
        for n in sorted(names):
            m = re.fullmatch(r"tile_(-?\d+)_(-?\d+)\.fbss", n)
            if m:
                out.append(((int(m.group(1)), int(m.group(2))),
                            os.path.join(self.root, n)))
        return out

    def status(self) -> dict:
        """The cheap /progress block: this process's activity tallies
        plus file counts — no slot scan (scan() is the deep view)."""
        files = self._tile_files()
        return {"backend": self.backend, "root": self.root,
                "schema": STATESTORE_SCHEMA, "tile_files": len(files),
                **self.tallies}

    def scan(self) -> dict:
        """The deep operator view (``firebird status``): per-tile slot
        occupancy and actual disk bytes (sparse-aware)."""
        tiles = []
        slots = 0
        disk = 0
        for hv, path in self._tile_files():
            try:
                st = os.stat(path)
                used = 0
                fd, geom = self._open(hv)
                cap, span = self._spans(*geom)
                for idx in range(self.n_slots):
                    if self._read_banks(
                            fd, self._slot_offset(idx, span), cap):
                        used += 1
            except (OSError, KeyError, StateStoreError) as e:
                tiles.append({"tile": list(hv),
                              "error": f"{type(e).__name__}: {e}"})
                continue
            disk += st.st_blocks * 512
            slots += used
            tiles.append({"tile": list(hv), "slots_used": used,
                          "slots_total": self.n_slots,
                          "disk_bytes": st.st_blocks * 512})
        return {**self.status(), "slots_used": slots,
                "disk_bytes": disk, "legacy_npz": len(self.legacy.chips()),
                "tiles": tiles}

    def close(self) -> None:
        with self._lock:
            for fd in self._fds.values():
                try:
                    os.close(fd)
                except OSError:
                    pass
            self._fds.clear()
            self._geom.clear()


# ---------------------------------------------------------------------------
# The object-tier statestore (store/objectstore.py)
# ---------------------------------------------------------------------------

class ObjectStateStore:
    """Stream checkpoints as versioned objects: one object per chip.

    The double-bank CRC slot protocol maps onto the object tier's
    retained generations — a publish is a new manifest generation, and a
    torn newest (truncated chunk, dropped manifest) falls back one
    generation inside ``objectstore.get`` exactly as the ``.fbss`` path
    falls back one bank.  The payload is the same canonical
    ``serialize_state`` byte layout, so object and packed checkpoints
    are byte-comparable; geometry and the scheduling horizon ride the
    manifest user metadata so ``exists``/``peek_horizon`` are head-only.
    Loads give tensors on ``device``; torch is imported only there (the
    ``_wrap_state`` contract).
    """

    backend = "object"

    def __init__(self, objstore, scope: str, device="cpu"):
        self._obj = objstore
        self.scope = scope
        self.device = device        # a torch device or its name
        self.tallies = {"saves": 0, "loads": 0}

    def _key(self, cid) -> str:
        return f"{self.scope}/state/chip_{int(cid[0])}_{int(cid[1])}"

    def save(self, cid, st, side: dict) -> None:
        self.save_arrays(cid, None, st=st, side=side)

    def save_arrays(self, cid, arrays: dict | None, *, st=None,
                    side=None) -> None:
        if arrays is not None:
            coefs = np.asarray(arrays["coefs"])
            P, B, K = coefs.shape
            payload = b"".join(
                _canonical(n, arrays[n], d, s).tobytes()
                for n, d, s in _layout(P, B, K))
        else:
            payload = serialize_state(st, side)
            P, B, K = st.coefs.shape
        horizon = struct.unpack("<d", payload[-8:])[0]
        self._obj.put(self._key(cid), payload,
                      meta={"geom": [int(P), int(B), int(K)],
                            "horizon": float(horizon)})
        self.tallies["saves"] += 1

    def _load_arrays(self, cid) -> dict:
        try:
            payload, meta = self._obj.get(self._key(cid))
        except KeyError:
            raise KeyError(f"no object state for chip "
                           f"({int(cid[0])},{int(cid[1])})") from None
        self.tallies["loads"] += 1
        return deserialize_state(payload, *meta.meta["geom"])

    def peek_arrays(self, cid) -> dict:
        return self._load_arrays(cid)

    def load(self, cid):
        return _wrap_state(self._load_arrays(cid), self.device)

    def exists(self, cid) -> bool:
        return self._obj.head(self._key(cid)) is not None

    def peek_horizon(self, cid) -> float | None:
        h = self._obj.head(self._key(cid))
        if h is None or "horizon" not in h.meta:
            return None
        return float(h.meta["horizon"])

    def chips(self) -> list:
        import re

        out = []
        for key in self._obj.list(f"{self.scope}/state/chip_"):
            m = re.fullmatch(r"chip_(-?\d+)_(-?\d+)",
                             key.rsplit("/", 1)[-1])
            if m:
                out.append((int(m.group(1)), int(m.group(2))))
        return sorted(out)

    def void(self, cid) -> None:
        self._obj.delete(self._key(cid))

    def status(self) -> dict:
        return {"backend": self.backend, "scope": self.scope,
                "chips": len(self.chips()), **self.tallies}

    def close(self) -> None:
        close = getattr(self._obj, "close", None)
        if close is not None:
            close()


class MirroredStateStore:
    """Write-through mirror: the local packed store stays
    read-authoritative, every checkpoint publish ALSO lands in the
    object tier (local first here — checkpoints carry no fencing
    precondition, and the stream driver re-reads its own writes
    locally on the hot path)."""

    backend = "packed+object"

    def __init__(self, local, mirror: ObjectStateStore):
        self._local = local
        self._mirror = mirror

    def save(self, cid, st, side: dict) -> None:
        self._local.save(cid, st, side)
        self._mirror.save(cid, st, side)

    def save_arrays(self, cid, arrays, *, st=None, side=None) -> None:
        self._local.save_arrays(cid, arrays, st=st, side=side)
        self._mirror.save_arrays(cid, arrays, st=st, side=side)

    def void(self, cid) -> None:
        self._local.void(cid)
        self._mirror.void(cid)

    def status(self) -> dict:
        return {**self._local.status(), "backend": self.backend,
                "object_scope": self._mirror.scope}

    def close(self) -> None:
        try:
            self._mirror.close()
        finally:
            self._local.close()

    def __getattr__(self, name):
        return getattr(self._local, name)


def open_statestore(cfg, root: str | None = None, device="cpu"):
    """The config's stream checkpoint store: packed (default) or the
    legacy per-chip npz layout (``FIREBIRD_STREAM_STATESTORE=npz``), its
    loads on ``device``.

    A ``FIREBIRD_DTYPE=float64`` config routes to the npz layout
    automatically: f64 state does not fit the packed canonical-f32
    slots losslessly, and a supported dtype must not crash at its
    first checkpoint save just because the layout default changed.

    With ``FIREBIRD_OBJECT_ROOT`` set, the packed store is wrapped in
    the object tier's write-through mirror (npz mode is not: its f64
    payloads are what the canonical object layout refuses to round)."""
    root = root or state_dir(cfg)
    mode = getattr(cfg, "stream_statestore", "packed")
    if mode == "npz" or getattr(cfg, "dtype", "float32") == "float64":
        return LegacyNpzStore(root, device)
    store = TileStateStore(root, device=device)
    if getattr(cfg, "object_root", ""):
        from firebird_tpu_torch.store import objectstore as objlib
        mirror = ObjectStateStore(objlib.open_object_root(cfg=cfg),
                                  objlib.scope_for_path(root), device)
        return MirroredStateStore(store, mirror)
    return store
