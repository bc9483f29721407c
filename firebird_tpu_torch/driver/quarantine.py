"""Dead-letter quarantine + run manifest: per-chip failure isolation.

The port's own copy of the JAX package's ``driver/quarantine.py``; its
JSON files have the JAX package's format, so either package resumes a run
the other left:

- :class:`Quarantine` is the dead-letter manifest (``quarantine.json``
  next to the results store): every chip that exhausts its retries is
  recorded with its error class and attempt history, the rest of its
  chunk completes, and the run exits having lost *chips*, not *chunks*.
  ``--resume`` drains the quarantine first (quarantined chips sort to
  the front of the todo list) and entries are discarded as their chips
  land.
- :func:`write_manifest` and :func:`check_resume` pin the run's acquired
  range, result-affecting config fingerprint and run_id in
  ``run_manifest.json``; a resume against a different acquired range
  **refuses** (the stored segments would silently mix date windows), and
  a different config fingerprint warns.

Both artifacts live next to the store for file-backed backends and stay
in-memory for the 'memory' backend.
"""

from __future__ import annotations

import datetime
import hashlib
import json
import os
import threading

from firebird_tpu_torch.obs import metrics as obs_metrics

QUARANTINE_SCHEMA = "firebird-quarantine/1"
MANIFEST_SCHEMA = "firebird-run-manifest/1"

# Exception text in the manifest is for diagnosis, not a log archive
# (the JAX package's limit).
_MSG_LIMIT = 500


def _artifact_dir(cfg) -> str | None:
    """Directory the store-adjacent artifacts live in; None for the
    'memory' backend (nothing on disk to sit next to)."""
    if cfg.store_backend == "memory":
        return None
    if cfg.store_backend == "parquet":
        return os.path.abspath(cfg.store_path)
    return os.path.dirname(os.path.abspath(cfg.store_path))


def quarantine_path(cfg) -> str | None:
    d = _artifact_dir(cfg)
    return None if d is None else os.path.join(d, "quarantine.json")


def manifest_path(cfg) -> str | None:
    d = _artifact_dir(cfg)
    return None if d is None else os.path.join(d, "run_manifest.json")


def _key(cid) -> str:
    return f"{int(cid[0])},{int(cid[1])}"


def _now_iso() -> str:
    return datetime.datetime.now(
        datetime.timezone.utc).isoformat(timespec="seconds")


def atomic_write_json(path: str, doc: dict) -> None:
    """Crash-atomic JSON write: temp file -> flush -> fsync ->
    ``os.replace``.  A SIGKILL (or power cut, with the fsync) at ANY
    instant leaves either the old file or the new one — never a torn
    half-document that would block ``--resume`` behind a JSON parse
    error.  The temp name carries the pid so concurrent fleet workers
    sharing one artifact directory cannot stomp each other's temp file
    mid-rename."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class Quarantine:
    """The dead-letter manifest: chip id -> error class + attempt history.

    Thread-safe (records arrive from the fetch pool); every mutation
    persists atomically when a path is configured, so a crashed run's
    quarantine survives for the resume.  ``path=None`` keeps the ledger
    in memory only (memory-backend runs, unit tests).
    """

    def __init__(self, path: str | None, run_id: str = ""):
        self.path = path
        self.run_id = run_id
        self._lock = threading.Lock()
        self._entries: dict[str, dict] = {}

    @classmethod
    def load(cls, path: str | None, run_id: str = "") -> "Quarantine":
        """A Quarantine seeded from the manifest at ``path`` when one
        exists (a previous run's dead letters carry into this run's
        drain); unreadable/foreign files start empty with a warning."""
        q = cls(path, run_id=run_id)
        if path is None or not os.path.exists(path):
            return q
        try:
            with open(path) as f:
                doc = json.load(f)
            if doc.get("schema") != QUARANTINE_SCHEMA:
                raise ValueError(f"schema {doc.get('schema')!r}")
            q._entries = dict(doc.get("chips", {}))
        except (OSError, ValueError) as e:
            from firebird_tpu_torch.obs import logger
            logger("change-detection").warning(
                "unreadable quarantine manifest at %s (%s); starting "
                "empty", path, e)
        return q

    def record(self, cid, error: BaseException, attempts: int,
               stage: str = "ingest") -> None:
        """Dead-letter one chip.  Repeated failures of the same chip
        (across runs or chunks) append to its attempt history rather
        than overwriting it — the manifest shows the whole story."""
        key = _key(cid)
        with self._lock:
            e = self._entries.setdefault(key, {
                "cx": int(cid[0]), "cy": int(cid[1]), "history": []})
            e["error"] = type(error).__name__
            e["message"] = str(error)[:_MSG_LIMIT]
            e["stage"] = stage
            e["history"].append({
                "at": _now_iso(), "run_id": self.run_id,
                "error": type(error).__name__, "attempts": int(attempts)})
            entry = dict(e)
            self._mutate_disk_locked(
                lambda chips: chips.__setitem__(key, entry))
        obs_metrics.counter(
            "chips_quarantined",
            help="chips dead-lettered to quarantine.json").inc()

    def record_many(self, cids, error: BaseException, attempts: int,
                    stage: str) -> None:
        for cid in cids:
            self.record(cid, error, attempts, stage=stage)

    def discard(self, cid) -> bool:
        """Remove a chip that has since landed; True when it was held."""
        key = _key(cid)
        with self._lock:
            held = self._entries.pop(key, None) is not None
            if held:
                self._mutate_disk_locked(
                    lambda chips: chips.pop(key, None))
        return held

    def discard_many(self, cids) -> int:
        keys = [_key(cid) for cid in cids]
        with self._lock:
            gone = [k for k in keys if self._entries.pop(k, None)
                    is not None]
            if gone:
                self._mutate_disk_locked(
                    lambda chips: [chips.pop(k, None) for k in gone])
        return len(gone)

    def chip_ids(self) -> set[tuple[int, int]]:
        with self._lock:
            return {(e["cx"], e["cy"]) for e in self._entries.values()}

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def snapshot(self) -> dict:
        with self._lock:
            return {"schema": QUARANTINE_SCHEMA, "updated_at": _now_iso(),
                    "run_id": self.run_id, "chips": dict(self._entries)}

    def _mutate_disk_locked(self, mutate) -> None:
        """Apply ONE mutation to the on-disk manifest as a
        load-freshest -> mutate -> atomic-write under an exclusive
        flock.  Concurrent fleet workers share quarantine.json; a
        whole-file dump of this process's in-memory view would silently
        erase entries another worker recorded since our load (the
        classic lost update) — folding each mutation into the freshest
        disk state keeps every worker's dead letters.  Caller holds
        self._lock (thread side); the flock is the process side."""
        if self.path is None:
            return
        import fcntl
        try:
            fd = os.open(self.path + ".lock",
                         os.O_CREAT | os.O_RDWR, 0o644)
        except OSError as e:
            from firebird_tpu_torch.obs import logger
            logger("change-detection").error(
                "quarantine manifest lock failed: %s", e)
            return
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            chips: dict = {}
            if os.path.exists(self.path):
                try:
                    with open(self.path) as f:
                        doc = json.load(f)
                    if doc.get("schema") == QUARANTINE_SCHEMA:
                        chips = dict(doc.get("chips", {}))
                except (OSError, ValueError):
                    pass          # torn file: rebuilt from this mutation
            mutate(chips)
            atomic_write_json(self.path, {
                "schema": QUARANTINE_SCHEMA, "updated_at": _now_iso(),
                "run_id": self.run_id, "chips": chips})
        except OSError as e:
            # The ledger must never fail the run it exists to protect.
            from firebird_tpu_torch.obs import logger
            logger("change-detection").error(
                "quarantine manifest write failed: %s", e)
        finally:
            os.close(fd)          # closing the fd releases the flock

    def save(self) -> None:
        """Fold this ledger's entries into the on-disk manifest (no
        deletions — discards already wrote through)."""
        with self._lock:
            mine = {k: dict(v) for k, v in self._entries.items()}
            self._mutate_disk_locked(lambda chips: chips.update(mine))


# ---------------------------------------------------------------------------
# Run manifest: refuse-or-warn resume identity
# ---------------------------------------------------------------------------

def config_fingerprint(cfg) -> str:
    """Hash of the RESULT-affecting knobs: two runs sharing it produce
    row-identical stores for the same inputs.  Parallelism/batching/ops
    knobs are deliberately excluded — changing them between a run and
    its resume is legitimate tuning, not result mixing."""
    doc = {"dtype": cfg.dtype, "max_obs": cfg.max_obs,
           "obs_bucket": cfg.obs_bucket, "keyspace": cfg.keyspace()}
    return hashlib.sha256(
        json.dumps(doc, sort_keys=True).encode()).hexdigest()[:16]


def write_manifest(cfg, *, acquired: str, run_id: str,
                   tile: dict | None = None) -> str | None:
    """Pin this run's identity next to the store (atomic write).
    Returns the path, or None for the memory backend."""
    path = manifest_path(cfg)
    if path is None:
        return None
    doc = {"schema": MANIFEST_SCHEMA, "written_at": _now_iso(),
           "run_id": run_id, "acquired": acquired,
           "config_fingerprint": config_fingerprint(cfg),
           "config": {"dtype": cfg.dtype, "max_obs": cfg.max_obs,
                      "obs_bucket": cfg.obs_bucket,
                      "keyspace": cfg.keyspace()}}
    if tile:
        doc["tile"] = {"h": tile.get("h"), "v": tile.get("v")}
    try:
        atomic_write_json(path, doc)
    except OSError as e:
        from firebird_tpu_torch.obs import logger
        logger("change-detection").error("run manifest write failed: %s", e)
        return None
    return path


class ResumeMismatch(ValueError):
    """--resume against a store whose manifest pins different inputs."""


def check_resume(cfg, *, acquired: str, log) -> None:
    """Refuse-or-warn gate for ``--resume`` (the old behavior silently
    *assumed* the acquired range matched, driver/core.py:900-903):

    - no manifest: warn (pre-manifest store) and proceed on the old
      assumption;
    - acquired mismatch: **raise** :class:`ResumeMismatch` — resuming
      would interleave segments from two date windows in one keyspace;
    - config-fingerprint mismatch: warn with the differing knobs (the
      operator may have changed dtype deliberately; the manifest makes
      it a choice instead of an accident).
    """
    path = manifest_path(cfg)
    if path is None:
        return
    if not os.path.exists(path):
        log.warning("resume: no run manifest at %s (store predates the "
                    "manifest); assuming the acquired range matches", path)
        return
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        log.warning("resume: unreadable run manifest at %s (%s); assuming "
                    "the acquired range matches", path, e)
        return
    want = doc.get("acquired")
    if want and want != acquired:
        raise ResumeMismatch(
            f"resume refused: store at {cfg.store_path!r} was produced "
            f"with acquired={want!r}, this run asks for {acquired!r} — "
            "resuming would mix date windows; rerun without --resume "
            "(or against a fresh store) to recompute")
    fp = doc.get("config_fingerprint")
    if fp and fp != config_fingerprint(cfg):
        log.warning(
            "resume: config fingerprint changed since the stored run "
            "(stored %s: %s); results may mix variants", fp,
            doc.get("config"))
