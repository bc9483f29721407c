"""Deterministic fault injection: the testable half of graceful degradation.

The port's own copy of the JAX package's ``faults.py``: the same plan
grammar, the same injectors and the same schedule, so one plan string and
seed fail the same operation indices in either package.  A seeded fault
plan (``FIREBIRD_FAULTS`` / ``Config.faults``) wraps the ingest source,
aux source, store backend and async writer in thin proxies that raise
realistic errors on a deterministic schedule, so a drill can show that an
ingest brownout or a store blip costs retries, never results.  The wrap
sites are the drivers' ``robustness_setup`` (driver/core.py: source,
store, writer), ``fetch``'s sources (driver/fetch.py),
``classification``'s aux source, the fleet worker's lease heartbeats
(fleet/worker.py), the watcher's poll (streamops/watcher.py), every
object root (store/objectstore.open_object_root) and the query API's
``/v1`` requests (serve/api.py).

Plan grammar (scopes separated by ``;``, options by ``,``)::

    FIREBIRD_FAULTS="ingest:p=0.05,seed=7;store:after=40,brownout=3"

======================  =====================================================
scope target            what the injector wraps
======================  =====================================================
``ingest``              ``source.chip`` (and ``source.aux`` when the same
                        object serves both)
``aux``                 ``aux_source.aux``
``store``               ``store.write`` (the backend, under the writer)
``writer``              ``AsyncWriter.write`` (the enqueue seam)
``lease``               fleet-worker lease heartbeats (fleet/worker.py): an
                        injected failure drops the beat, so the lease ages
                        toward expiry — ``lease:p=1`` models a worker
                        partitioned from the queue (a zombie)
``serve``               ``/v1`` request handling (serve/api.py)
``watch``               ``watcher.poll_once`` (streamops/watcher.py): an
                        injected failure aborts the poll before any scene
                        is mapped, so the landing zone backs up (a stalled
                        watcher)
``object``              every object-tier operation
                        (store/objectstore.py): puts/gets/heads/lists
                        fail per the schedule; the ``torn`` kind (puts
                        only) also leaves a *torn upload* behind (see
                        below).  ``chip=`` is rejected here: object ops
                        carry no chip identity
======================  =====================================================

======================  =====================================================
option                  meaning
======================  =====================================================
``p=<float>``           each operation fails independently with probability p
``after=<int>``         operations ``after+1 .. after+brownout`` fail — a
                        one-shot brownout window (brownout defaults to 1)
``brownout=<int>``      window length for ``after``; with ``p``, each
                        triggered failure extends to that many consecutive ops
``chip=<cx>:<cy>``      poison one chip id: every op for it fails
                        (ingest/aux scopes only; repeatable)
``seed=<int>``          RNG seed for ``p`` (default 0) — the plan is fully
                        deterministic given the seed and call order
``timeout``             raise :class:`InjectedTimeout` (TimeoutError)
``conn``                raise :class:`InjectedConnError` (ConnectionError)
``ioerror``             raise :class:`InjectedFault` (OSError) — the default
``torn``                object scope only: raise :class:`TornUpload` AND
                        leave a torn upload on disk — occurrences alternate
                        between committing a truncated chunk (the manifest
                        promises bytes that are not there) and dropping the
                        manifest write (the chunks upload, the object never
                        becomes visible).  NonRetryable: the damage must
                        persist for the reader's recovery, not be healed by
                        the retry wrapper
======================  =====================================================

The ``serve`` scope wraps the query API as in the JAX package: a plan
naming it fires the injector on every ``/v1`` request before admission,
and an injected failure answers 503 (serve/api.py).

With ``FIREBIRD_FAULTS`` unset, :func:`wrap_source` / :func:`wrap_store` /
:func:`wrap_writer` return their argument unchanged — no proxy object, no
per-call overhead, nothing on the hot path.  Every injected failure
increments ``faults_injected`` (and ``faults_injected_<scope>``) so a chaos
run's telemetry shows exactly how much adversity it absorbed.
"""

from __future__ import annotations

import random
import threading
import zlib

from firebird_tpu_torch import retry as retrylib
from firebird_tpu_torch.obs import metrics as obs_metrics

TARGETS = ("ingest", "aux", "store", "writer", "lease", "serve", "watch",
           "object")
_KINDS = ("ioerror", "timeout", "conn", "torn")


class InjectedFault(OSError):
    """A fault-plan-injected I/O error (the default kind)."""


class InjectedTimeout(TimeoutError):
    """A fault-plan-injected timeout."""


class InjectedConnError(ConnectionError):
    """A fault-plan-injected connection failure."""


class TornUpload(OSError, retrylib.NonRetryable):
    """A fault-plan-injected torn object upload (``object`` scope).

    NonRetryable on purpose: the proxy has already left real damage on
    disk (a truncated chunk under a committed manifest, or uploaded
    chunks with the manifest write dropped), and the drill is the
    *reader's* recovery path — a retry wrapper silently re-putting would
    erase the very state under test."""


_ERRORS = {"ioerror": InjectedFault, "timeout": InjectedTimeout,
           "conn": InjectedConnError, "torn": TornUpload}


class FaultSpec:
    """One scope's parsed options (see the module grammar table)."""

    def __init__(self, target: str, *, p: float = 0.0,
                 after: int | None = None, brownout: int = 1,
                 seed: int = 0, kind: str = "ioerror",
                 chips: frozenset | None = None):
        if target not in TARGETS:
            raise ValueError(
                f"fault scope target must be one of {TARGETS}, got "
                f"{target!r}")
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"fault p must be in [0, 1], got {p}")
        if after is not None and after < 0:
            raise ValueError(f"fault after must be >= 0, got {after}")
        if brownout < 1:
            raise ValueError(f"fault brownout must be >= 1, got {brownout}")
        if kind not in _KINDS:
            raise ValueError(f"fault kind must be one of {_KINDS}, got "
                             f"{kind!r}")
        if kind == "torn" and target != "object":
            # A torn upload is an object-tier phenomenon (chunks vs
            # manifest); on any other scope it would be a misspelled
            # ioerror that silently changed semantics.
            raise ValueError(
                f"fault kind 'torn' only applies to the object scope, "
                f"not {target!r}")
        if chips and target not in ("ingest", "aux"):
            # store/writer ops carry no chip identity, so chip= there
            # would validate yet never fire — the silent-no-op chaos run
            # the config-time parse exists to prevent.
            raise ValueError(
                f"chip= poisoning only applies to ingest/aux scopes, not "
                f"{target!r}")
        if p <= 0 and after is None and not chips:
            raise ValueError(
                f"fault scope {target!r} injects nothing: set p=, after=, "
                "or chip=")
        self.target = target
        self.p = float(p)
        self.after = after
        self.brownout = int(brownout)
        self.seed = int(seed)
        self.kind = kind
        self.chips = chips or frozenset()


def _parse_scope(scope: str) -> FaultSpec:
    target, sep, body = scope.partition(":")
    target = target.strip()
    if not sep or not body.strip():
        raise ValueError(
            f"fault scope {scope!r} must be '<target>:<opt>[,<opt>...]'")
    kw: dict = {"chips": set()}
    for raw in body.split(","):
        opt = raw.strip()
        if not opt:
            continue
        if opt in _KINDS:
            kw["kind"] = opt
            continue
        key, sep, val = opt.partition("=")
        if not sep:
            raise ValueError(
                f"unknown fault option {opt!r} in scope {target!r} "
                f"(flags: {_KINDS})")
        key = key.strip()
        try:
            if key == "p":
                kw["p"] = float(val)
            elif key == "after":
                kw["after"] = int(val)
            elif key == "brownout":
                kw["brownout"] = int(val)
            elif key == "seed":
                kw["seed"] = int(val)
            elif key == "chip":
                cx, _, cy = val.partition(":")
                kw["chips"].add((int(cx), int(cy)))
            else:
                raise ValueError(
                    f"unknown fault option key {key!r} in scope {target!r}")
        except ValueError as e:
            if "unknown fault option" in str(e):
                raise
            raise ValueError(
                f"bad value for fault option {key!r}: {val!r}") from e
    kw["chips"] = frozenset(kw["chips"])
    return FaultSpec(target, **kw)


class FaultInjector:
    """One scope's live failure schedule.  Thread-safe: the driver calls
    ingest ops from ``input_parallelism`` threads and store ops from the
    writer pool, and the op counter / RNG / brownout window must agree on
    one call order to stay deterministic per seed."""

    def __init__(self, spec: FaultSpec):
        self.spec = spec
        self._lock = threading.Lock()
        # random.Random, not numpy: one bounded uniform draw per op, and
        # the stdlib generator is cheap to seed per scope.  crc32, not
        # hash(): str hashing is salted per process and the whole point
        # is a plan that replays identically across runs.
        self._rng = random.Random(spec.seed ^ zlib.crc32(
            spec.target.encode()))
        self._ops = 0
        self._brownout_until = 0      # ops <= this value fail (window)
        self._after_fired = False

    def fire(self, chip=None) -> None:
        """Count one operation; raise the scope's error when the schedule
        says this op fails.  ``chip`` is the (cx, cy) the op serves, for
        ``chip=`` poisoning."""
        spec = self.spec
        with self._lock:
            self._ops += 1
            n = self._ops
            fail = False
            if chip is not None and tuple(int(v) for v in chip) in spec.chips:
                fail = True
            elif n <= self._brownout_until:
                fail = True
            elif spec.after is not None and not self._after_fired \
                    and n > spec.after:
                self._after_fired = True
                self._brownout_until = n + spec.brownout - 1
                fail = True
            elif spec.p > 0 and self._rng.random() < spec.p:
                if spec.brownout > 1:
                    self._brownout_until = n + spec.brownout - 1
                fail = True
        if fail:
            obs_metrics.counter(
                "faults_injected",
                help="failures raised by the FIREBIRD_FAULTS plan").inc()
            obs_metrics.counter(f"faults_injected_{spec.target}").inc()
            raise _ERRORS[spec.kind](
                f"injected {spec.kind} fault ({spec.target} op {n}"
                f"{f', chip {chip}' if chip is not None else ''})")

    def snapshot(self) -> dict:
        with self._lock:
            return {"target": self.spec.target, "ops": self._ops}


class FaultPlan:
    """The parsed ``FIREBIRD_FAULTS`` spec: one injector per scope."""

    def __init__(self, specs: list[FaultSpec], spec_text: str = ""):
        seen = set()
        for s in specs:
            if s.target in seen:
                raise ValueError(
                    f"duplicate fault scope {s.target!r} in plan")
            seen.add(s.target)
        self.spec_text = spec_text
        self._injectors = {s.target: FaultInjector(s) for s in specs}

    @classmethod
    def parse(cls, text: str | None) -> "FaultPlan | None":
        """Plan from the env-spec string; None when unset/empty (the
        zero-cost default — callers skip wrapping entirely)."""
        if not text or not text.strip():
            return None
        specs = [_parse_scope(s) for s in text.split(";") if s.strip()]
        if not specs:
            return None
        return cls(specs, spec_text=text)

    @classmethod
    def from_config(cls, cfg) -> "FaultPlan | None":
        return cls.parse(getattr(cfg, "faults", ""))

    def injector(self, target: str) -> FaultInjector | None:
        return self._injectors.get(target)


# ---------------------------------------------------------------------------
# Proxies: thin, explicit seams; identity when the plan has no scope
# ---------------------------------------------------------------------------

class FaultySource:
    """Source proxy: injects before ``chip``/``aux`` delegation.  ``chip``
    fires the wrapping scope's injector with the chip id (so ``chip=``
    poisoning works); ``aux`` fires the plan's ``aux`` scope when present,
    else this scope.  Either injector may be None (an aux-only plan still
    wraps the source so its ``aux`` calls inject)."""

    def __init__(self, inner, injector: FaultInjector | None,
                 aux_injector: FaultInjector | None = None):
        self._inner = inner
        self._inj = injector
        self._aux_inj = aux_injector or injector

    def chip(self, cx, cy, acquired=None):
        if self._inj is not None:
            self._inj.fire(chip=(cx, cy))
        return self._inner.chip(cx, cy, acquired)

    def aux(self, cx, cy, acquired=None):
        if self._aux_inj is not None:
            self._aux_inj.fire(chip=(cx, cy))
        return self._inner.aux(cx, cy, acquired)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class FaultyStore:
    """Store-backend proxy: injects before ``write``; reads pass through
    (the durability model is write-side — a read failure is a different
    campaign's problem)."""

    def __init__(self, inner, injector: FaultInjector):
        self._inner = inner
        self._inj = injector

    def write(self, table: str, frame: dict) -> int:
        self._inj.fire()
        return self._inner.write(table, frame)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class FaultyWriter:
    """AsyncWriter proxy: injects at the enqueue seam (``write``) — the
    failure mode where the *host-side* egress path dies rather than the
    backend behind it."""

    def __init__(self, inner, injector: FaultInjector):
        self._inner = inner
        self._inj = injector

    def write(self, table: str, frame: dict, key=None) -> None:
        self._inj.fire()
        return self._inner.write(table, frame, key=key)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class FaultyObjectStore:
    """Object-store proxy (store/objectstore.py protocol).

    ``put`` always rides the injector; the read-side ops (get/head/list/
    delete) ride it only for the transient kinds — a ``torn`` schedule
    is about *uploads*, and firing it on reads would raise TornUpload
    from operations that cannot tear anything.

    On a TornUpload the proxy first performs the damaged put for real —
    alternating deterministically between a truncated final chunk
    (``_torn="chunk"``: manifest commits over missing bytes) and a
    dropped manifest (``_torn="manifest"``: chunks land, the object
    never becomes visible) — then re-raises, so the on-disk state
    matches what a crashed uploader leaves behind."""

    def __init__(self, inner, injector: FaultInjector):
        self._inner = inner
        self._inj = injector
        self._torn_lock = threading.Lock()
        self._torn_count = 0

    def _fire_transient(self):
        if self._inj.spec.kind != "torn":
            self._inj.fire()

    def put(self, key, data, **kw):
        try:
            self._inj.fire()
        except TornUpload:
            with self._torn_lock:
                mode = "chunk" if self._torn_count % 2 == 0 else "manifest"
                self._torn_count += 1
            self._inner.put(key, data, **{**kw, "_torn": mode})
            raise
        return self._inner.put(key, data, **kw)

    def get(self, key):
        self._fire_transient()
        return self._inner.get(key)

    def head(self, key):
        self._fire_transient()
        return self._inner.head(key)

    def list(self, prefix=""):
        self._fire_transient()
        return self._inner.list(prefix)

    def delete(self, key):
        self._fire_transient()
        return self._inner.delete(key)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def wrap_source(source, plan: FaultPlan | None, scope: str = "ingest"):
    """Source under the plan's ``scope`` injector; the source itself
    (zero indirection) when no plan covers either the scope or ``aux``
    (an aux-only plan still needs the proxy for its ``aux`` calls)."""
    if plan is None:
        return source
    inj = plan.injector(scope)
    aux_inj = plan.injector("aux")
    if inj is None and aux_inj is None:
        return source
    return FaultySource(source, inj, aux_injector=aux_inj)


def wrap_store(store, plan: FaultPlan | None):
    if plan is None:
        return store
    inj = plan.injector("store")
    return store if inj is None else FaultyStore(store, inj)


def wrap_writer(writer, plan: FaultPlan | None):
    if plan is None:
        return writer
    inj = plan.injector("writer")
    return writer if inj is None else FaultyWriter(writer, inj)


def wrap_objectstore(store, plan: FaultPlan | None):
    if plan is None:
        return store
    inj = plan.injector("object")
    return store if inj is None else FaultyObjectStore(store, inj)
