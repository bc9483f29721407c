"""Configuration for firebird_tpu_torch.

The port's own copy of the JAX package's ``config.py`` (standard library
only): the same knob registry, the same :class:`Config` fields, defaults,
``from_env`` parsing and validation, and the same ``keyspace()``, so that a
store one package writes names the tables the other reads.  Two
validations differ, because their subsystems are not ported: the fault
plan (FIREBIRD_FAULTS) and the SLO budget spec (FIREBIRD_SLO_BUDGET) are
kept as strings here, not parsed; the drivers refuse a run that sets them
(:data:`NOT_PORTED`).  The knobs that stay refused, and why:

- ``faults``: the fault-injection plan (``faults.py``) and its wrappers
  are not ported;
- ``object_root``: the object store (``store/objectstore.py``) is not
  ported;
- ``slo_budget``: the durable error budgets read the series store
  (``obs/series.py``), which is not ported (the live SLO evaluation,
  ``slo``, is);
- ``compile_cache``: XLA's compilation cache has no counterpart; this
  package builds its kernels with nvcc into ``build/``, keyed by a hash
  of their sources.


The reference reads env vars at import time into module constants
(ccdc/__init__.py:11-26: ARD_CHIPMUNK, AUX_CHIPMUNK, CASSANDRA_*,
INPUT_PARTITIONS, PRODUCT_PARTITIONS) and derives a Cassandra keyspace from
the ARD/AUX URL paths + version.txt (ccdc/__init__.py:29-44).

Here configuration is an explicit, immutable dataclass constructed from env
(:meth:`Config.from_env`) or keyword arguments, passed down the stack.  The
same three tiers exist: deploy-time env, per-run CLI options, and derived
config (``keyspace``).
"""

from __future__ import annotations

import dataclasses
import os
import re
from urllib.parse import urlparse

from firebird_tpu_torch.__about__ import __version__ as _VERSION


def _cqlstr(s: str) -> str:
    """Sanitize a string for use as a store namespace (keyspace).

    Mirrors merlin.functions.cqlstr semantics used by the reference keyspace
    derivation (ccdc/__init__.py:44): strip non-alphanumeric to underscores.
    """
    return re.sub(r"[^a-zA-Z0-9_]", "_", s)


# ---------------------------------------------------------------------------
# Knob registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Knob:
    """One declared ``FIREBIRD_*`` environment knob.

    The registry below is THE contract firebird-lint's knob-registry rule
    family enforces (docs/STATIC_ANALYSIS.md): every env read in the
    codebase must be of a registered knob, from ``Config.from_env`` /
    :func:`env_knob` or a module declared in ``readers``; every
    non-internal knob must appear in the docs; and every registered knob
    must still have a reader somewhere (dead-knob detection).

    ``field``: the :class:`Config` attribute ``from_env`` feeds, or None
    for knobs deliberately outside Config (trace-time kernel knobs read
    per trace, tool artifact dirs).  ``readers``: repo-relative modules
    (``.py`` or ``.sh``) allowed to read the env var directly — the
    declared exceptions to the route-through-config rule, each with a
    reason a reviewer can audit here.  ``internal``: exempt from the
    documentation requirement (harness-only switches).
    """

    name: str
    help: str
    field: str | None = None
    default: str | None = None
    readers: tuple = ()
    internal: bool = False


# NOTE for firebird-lint: this tuple must stay a literal of Knob(...)
# calls with constant arguments — the linter parses it from source (so
# fixture repos lint hermetically) and ast.literal_eval's each argument.
KNOBS = (
    # ---- data plumbing (Config-backed) ----
    Knob(name="FIREBIRD_STORE_BACKEND", field="store_backend",
         help="results store backend: sqlite | parquet | memory"),
    Knob(name="FIREBIRD_STORE_PATH", field="store_path",
         help="results store path"),
    Knob(name="FIREBIRD_OBJECT_ROOT", field="object_root",
         help="object-tier root directory (store/objectstore.py): when "
              "set, every durable write (store shards, stream "
              "checkpoints, pyramid tiles) also publishes to the object "
              "store, object-first — and 'object' becomes a valid "
              "FIREBIRD_STORE_BACKEND"),
    Knob(name="FIREBIRD_OBJECT_CHUNK_KB", field="object_chunk_kb",
         help="object-tier chunk size (KiB) for content-addressed "
              "multi-chunk uploads"),
    Knob(name="FIREBIRD_OBJECT_SCRUB_GRACE_SEC",
         field="object_scrub_grace_sec",
         help="minimum orphaned-chunk age (seconds) before `firebird "
              "objectstore scrub` reclaims it — the guard against "
              "scrubbing a live writer's not-yet-committed upload"),
    Knob(name="FIREBIRD_SOURCE", field="source_backend",
         help="ingest source: chipmunk | synthetic | file"),
    Knob(name="FIREBIRD_SOURCE_PATH", field="source_path",
         help="file-source archive directory (FIREBIRD_SOURCE=file)"),
    Knob(name="FIREBIRD_SYNTH_SENSOR", field="synth_sensor",
         help="sensor spec the synthetic source generates "
              "(ccd.sensor.SENSORS; landsat-ard-tiny = fleet-scale "
              "test chips)"),
    Knob(name="FIREBIRD_BAND_PARALLELISM", field="band_parallelism",
         help="concurrent per-chip band fetches"),
    Knob(name="FIREBIRD_CHIPS_PER_BATCH", field="chips_per_batch",
         help="chips per device dispatch (<= 0: auto-size)"),
    Knob(name="FIREBIRD_MAX_OBS", field="max_obs",
         help="max padded observations per pixel series"),
    Knob(name="FIREBIRD_OBS_BUCKET", field="obs_bucket",
         help="time-axis padding granularity (compile-shape bucketing)"),
    Knob(name="FIREBIRD_DTYPE", field="dtype",
         help="kernel compute dtype: float32 | float64"),
    Knob(name="FIREBIRD_DEVICE_SHARDING", field="device_sharding",
         help="chip-batch sharding over local devices: auto | off"),
    Knob(name="FIREBIRD_FETCH_RETRIES", field="fetch_retries",
         help="per-chip fetch retries before quarantine"),
    Knob(name="FIREBIRD_HTTP_TIMEOUT", field="http_timeout",
         help="Chipmunk HTTP timeout (seconds)"),
    Knob(name="FIREBIRD_RETRY_BUDGET", field="retry_budget",
         help="run-wide total retry ceiling (0 = unlimited)"),
    Knob(name="FIREBIRD_BREAKER_THRESHOLD", field="breaker_threshold",
         help="consecutive fetch failures that open the ingest breaker"),
    Knob(name="FIREBIRD_BREAKER_COOLDOWN", field="breaker_cooldown_sec",
         help="ingest breaker cooldown (seconds)"),
    Knob(name="FIREBIRD_FAULTS", field="faults",
         help="deterministic fault-injection plan (docs/ROBUSTNESS.md)"),
    Knob(name="FIREBIRD_WRITER_THREADS", field="writer_threads",
         help="async store-writer worker threads"),
    Knob(name="FIREBIRD_PIPELINE_DEPTH", field="pipeline_depth",
         help="max device batches in flight"),
    Knob(name="FIREBIRD_COMPILE_CACHE", field="compile_cache",
         help="persistent XLA compile cache directory"),
    Knob(name="FIREBIRD_STREAM_DIR", field="stream_dir",
         help="streaming-state checkpoint directory"),
    Knob(name="FIREBIRD_STREAM_STATESTORE", field="stream_statestore",
         help="stream checkpoint layout: packed (tile-packed slot "
              "files) | npz (legacy per-chip, the f64/compat escape "
              "hatch)"),
    Knob(name="FIREBIRD_WATCH_INTERVAL", field="watch_interval",
         help="acquisition-watcher manifest poll interval (seconds)"),
    Knob(name="FIREBIRD_WATCH_DB", field="watch_db",
         help="acquisition-watcher durable scene-cursor sqlite path "
              "(default: watcher.db next to the store)"),
    # ---- observability (Config-backed) ----
    Knob(name="FIREBIRD_PROFILE_DIR", field="profile_dir",
         help="whole-run device profiler trace directory (device-side)"),
    Knob(name="FIREBIRD_TRACE", field="trace",
         help="host span tracer output (Chrome-trace JSON)"),
    Knob(name="FIREBIRD_OBS_REPORT", field="obs_report",
         help="per-run obs_report.json destination policy"),
    Knob(name="FIREBIRD_OPS_PORT", field="ops_port",
         help="embedded ops endpoint port (0 = never bound)"),
    Knob(name="FIREBIRD_OPS_HOST", field="ops_host",
         default="0.0.0.0",
         help="ops endpoint bind address"),
    Knob(name="FIREBIRD_STALL_SEC", field="stall_sec",
         help="watchdog stall deadline (seconds; 0 = off)"),
    Knob(name="FIREBIRD_OBS_MERGE_TIMEOUT", field="obs_merge_timeout",
         default="30",
         help="seconds process 0 waits for host report shards"),
    Knob(name="FIREBIRD_PROFILE", field="profile",
         help="auto device-profile window seconds at first batch (0 off)"),
    Knob(name="FIREBIRD_SLO", field="slo",
         help="SLO spec name=target;... (empty = defaults, 0 disables)"),
    Knob(name="FIREBIRD_SLO_BUDGET", field="slo_budget",
         help="error-budget spec name[<threshold]@target/window;... "
              "(empty = defaults, 0 disables; obs/slo.py)"),
    Knob(name="FIREBIRD_SLO_FAST_SEC", field="slo_fast_sec",
         default="300",
         help="fast burn-rate window seconds (multi-window paging "
              "pair's short leg)"),
    Knob(name="FIREBIRD_SLO_SLOW_SEC", field="slo_slow_sec",
         default="3600",
         help="slow burn-rate window seconds (filters one-batch blips)"),
    Knob(name="FIREBIRD_SLO_BURN", field="slo_burn", default="14.4",
         help="burn-rate threshold: page when BOTH windows burn this "
              "many times the budget rate"),
    Knob(name="FIREBIRD_SERIES", field="series", default="512",
         help="metric-history ring: points per segment file per "
              "resolution (0 disables the series store)"),
    Knob(name="FIREBIRD_SERIES_SEGMENTS", field="series_segments",
         default="4",
         help="metric-history segment files per resolution (bounded "
              "ring)"),
    Knob(name="FIREBIRD_SERIES_DIR", field="series_dir",
         help="metric-history directory (default: series/ inside the "
              "telemetry spool dir)"),
    Knob(name="FIREBIRD_PROBE_SEC", field="probe_sec", default="10",
         help="black-box canary probe interval seconds (firebird "
              "probe; 0 refuses to arm)"),
    Knob(name="FIREBIRD_PROBE_TIMEOUT", field="probe_timeout",
         default="30",
         help="per-probe deadline seconds (request timeout / SSE alert "
              "wait)"),
    Knob(name="FIREBIRD_FLIGHTREC", field="flightrec", default="128",
         help="crash flight-recorder ring size per thread (0 off)"),
    Knob(name="FIREBIRD_TELEMETRY", field="telemetry", default="4096",
         help="telemetry spool ring: span/mark events per segment file "
              "(0 disarms the fleet telemetry plane)"),
    Knob(name="FIREBIRD_TELEMETRY_SEGMENTS", field="telemetry_segments",
         default="4",
         help="telemetry spool segment files per process (bounded ring)"),
    Knob(name="FIREBIRD_TELEMETRY_DIR", field="telemetry_dir",
         help="telemetry spool directory (default: telemetry/ next to "
              "the store)"),
    Knob(name="FIREBIRD_TELEMETRY_SNAPSHOT_SEC",
         field="telemetry_snapshot_sec", default="5",
         help="seconds between metric-registry snapshots into the "
              "telemetry spool"),
    # ---- fleet work queue (Config-backed; docs/ROBUSTNESS.md) ----
    Knob(name="FIREBIRD_FLEET_DB", field="fleet_db",
         help="fleet job-queue sqlite path (default: fleet.db next to "
              "the store)"),
    Knob(name="FIREBIRD_FLEET_LEASE_SEC", field="fleet_lease_sec",
         help="job lease length (seconds) before a silent worker's job "
              "re-delivers"),
    Knob(name="FIREBIRD_FLEET_HEARTBEAT_SEC", field="fleet_heartbeat_sec",
         help="worker heartbeat cadence (seconds; 0 = lease/4)"),
    Knob(name="FIREBIRD_FLEET_MAX_ATTEMPTS", field="fleet_max_attempts",
         help="job attempts (failures or expired leases) before "
              "dead-lettering"),
    Knob(name="FIREBIRD_FLEET_MIN_WORKERS", field="fleet_min_workers",
         help="supervisor floor: workers kept alive even when the "
              "queue is idle (0 = scale-to-zero)"),
    Knob(name="FIREBIRD_FLEET_MAX_WORKERS", field="fleet_max_workers",
         help="supervisor ceiling: batch workers the supervisor may "
              "run concurrently"),
    Knob(name="FIREBIRD_FLEET_GRACE_SEC", field="fleet_grace_sec",
         help="seconds a retiring worker gets to finish its lease "
              "after SIGTERM before the supervisor SIGKILLs it"),
    # ---- alerting (Config-backed; docs/ALERTS.md) ----
    Knob(name="FIREBIRD_ALERTS", field="alerts_enabled", default="1",
         help="0 disables alerting: stream emission AND the serve "
              "layer's /v1/alerts mount"),
    Knob(name="FIREBIRD_ALERT_DB", field="alert_db",
         help="durable alert-log sqlite path (default: alerts.db next "
              "to the store)"),
    Knob(name="FIREBIRD_ALERT_REPAIR", field="alert_repair", default="1",
         help="0 disables automatic cold-path repair scheduling on the "
              "fleet queue"),
    Knob(name="FIREBIRD_ALERT_WEBHOOK_TIMEOUT",
         field="alert_webhook_timeout",
         help="webhook delivery HTTP timeout (seconds)"),
    # ---- alert fanout plane (Config-backed; docs/ALERTS.md) ----
    Knob(name="FIREBIRD_FANOUT", field="fanout_enabled", default="1",
         help="0 disables the fanout rollup loop in firebird serve "
              "(subscription index + flat deliverer still run)"),
    Knob(name="FIREBIRD_FANOUT_SHARD_PREFIX", field="fanout_shard_prefix",
         help="fanout shard key width (quadkey prefix digits, 1-11): "
              "4**n possible shards; changeable without restamping"),
    Knob(name="FIREBIRD_FANOUT_MAX_CELLS", field="fanout_max_cells",
         help="covering-cell budget per subscriber AOI in the quadkey "
              "subscription index"),
    Knob(name="FIREBIRD_FANOUT_PARK_AFTER", field="fanout_park_after",
         help="consecutive delivery failures before a subscriber is "
              "parked under decorrelated backoff"),
    Knob(name="FIREBIRD_FANOUT_PARK_BASE", field="fanout_park_base_sec",
         help="parked-subscriber backoff base (seconds)"),
    Knob(name="FIREBIRD_FANOUT_PARK_CAP", field="fanout_park_cap_sec",
         help="parked-subscriber backoff cap (seconds)"),
    Knob(name="FIREBIRD_FANOUT_POLL", field="fanout_poll_sec",
         help="fanout rollup poll interval (seconds) — alert-append to "
              "shard-job-enqueued latency bound"),
    # ---- serving layer (Config-backed) ----
    Knob(name="FIREBIRD_SERVE_PORT", field="serve_port",
         help="firebird serve listen port"),
    Knob(name="FIREBIRD_SERVE_HOST", field="serve_host",
         default="0.0.0.0",
         help="firebird serve bind address"),
    Knob(name="FIREBIRD_SERVE_CACHE_ENTRIES", field="serve_cache_entries",
         help="in-memory serve cache bound (entries)"),
    Knob(name="FIREBIRD_SERVE_CACHE_DIR", field="serve_cache_dir",
         help="serve cache disk spill tier directory"),
    Knob(name="FIREBIRD_SERVE_INFLIGHT", field="serve_inflight",
         help="concurrent /v1 requests executing"),
    Knob(name="FIREBIRD_SERVE_QUEUE", field="serve_queue",
         help="admission waiting-line bound (past it: 429)"),
    Knob(name="FIREBIRD_SERVE_DEADLINE", field="serve_deadline_sec",
         help="per-request deadline (seconds; past it: 504)"),
    Knob(name="FIREBIRD_SERVE_PYRAMID_DIR", field="serve_pyramid_dir",
         help="quadkey tile-pyramid root (default: pyramid/ under the "
              "serve cache dir, else next to the store)"),
    Knob(name="FIREBIRD_SERVE_EDGE_TTL", field="serve_edge_ttl",
         help="Cache-Control max-age seconds on /v1/product, /v1/tile, "
              "/v1/pyramid (0 = no Cache-Control header)"),
    Knob(name="FIREBIRD_SERVE_FEED_POLL", field="serve_feed_poll_sec",
         help="replica changefeed poll interval (seconds) — the "
              "serving staleness bound is one poll + one apply"),
    Knob(name="FIREBIRD_SERVE_REPLICA", field="serve_replica",
         help="stable serve replica id for changefeed cursor resume "
              "(default host:pid — an unseen id replays the feed)"),
    Knob(name="FIREBIRD_CHANGEFEED_DB", field="changefeed_db",
         help="product_writes changefeed + replica-registry sqlite "
              "path (default: changefeed.db next to the store)"),
    # ---- trace-time kernel knobs (read per trace, not per run — a
    # Config field would freeze them at construction; declared readers
    # route through env_knob) ----
    Knob(name="FIREBIRD_COMPACT", field="compact", default="1",
         help="active-lane compaction in the CCD event loop"),
    Knob(name="FIREBIRD_COMPACT_EVERY", default="4",
         readers=("tools/compact_smoke.py",),  # pins the child kernel's env
         help="event-loop rounds between compaction sweeps"),
    Knob(name="FIREBIRD_COMPACT_MIN_LANES", default="1024",
         help="min padded lanes before bucketed re-entry applies"),
    Knob(name="FIREBIRD_COMPACT_FLOOR", default="0.125",
         readers=("tools/compact_smoke.py",),  # pins the child kernel's env
         help="bucket fraction that triggers loop re-entry"),
    Knob(name="FIREBIRD_PALLAS", default="0",
         help="Pallas kernel component selection (0/1/comma list)"),
    Knob(name="FIREBIRD_FUSED_FIT", default="0",
         help="fused gram→CD→close Pallas round kernel (one VMEM "
              "residency serves the close + shared-fit pair); 'mon' "
              "(or 2) widens the fusion to the whole post-INIT round — "
              "monitor chain + close + fit in one pallas_call"),
    Knob(name="FIREBIRD_MIXED_PRECISION", default="0",
         help="bf16 split-dot gram + int32 counts inside the Pallas fit "
              "routes, f32 decision envelope (f32 stores only; XLA "
              "paths stay f32 and are the decision-identity oracle)"),
    Knob(name="FIREBIRD_MEGA_BLOCK_P", default="0",
         help="static lane-block width override for the mega/fused-round "
              "kernels (multiple of 128; 0 = size from the VMEM budget; "
              "bench seeds it from fuse_repro.json's smallest compiling "
              "block)"),
    Knob(name="FIREBIRD_REBALANCE", default="0",
         help="cross-device straggler rebalancing ring at the "
              "bucketed-tail boundary (sharded dispatches)"),
    Knob(name="FIREBIRD_REBALANCE_THRESHOLD", default="0.25",
         help="alive-count gap (fraction of a device's stage-2 lanes) "
              "that triggers a migration hop"),
    Knob(name="FIREBIRD_WIRE_QA8", default="1",
         help="ship the staged QA plane as uint8 (0: full uint16)"),
    Knob(name="FIREBIRD_WIRE_EGRESS", default="1",
         help="drain batches as int-coded tables sliced to observed "
              "segment depth (0: raw float32 drain)"),
    Knob(name="FIREBIRD_VARIOGRAM", default="adjusted",
         help="variogram mode: adjusted | plain"),
    # ---- process-wide switches read before/without a Config ----
    Knob(name="FIREBIRD_JAX_PLATFORM",
         help="pin the JAX platform (cpu/tpu) before first use"),
    Knob(name="FIREBIRD_NO_NATIVE",
         help="disable the native acceleration extensions"),
    Knob(name="FIREBIRD_METRICS", default="1",
         readers=("firebird_tpu/obs/metrics.py",),  # per-call hot gate
         help="0 disables all metric recording"),
    Knob(name="FIREBIRD_LOG_LEVEL", default="INFO",
         readers=("firebird_tpu/obs/__init__.py",),  # logging bootstrap
         help="root log level"),
    Knob(name="FIREBIRD_LOG_LEVELS",
         readers=("firebird_tpu/obs/__init__.py",),
         help="per-category log levels (comma list)"),
    Knob(name="FIREBIRD_LOG_FORMAT", default="text",
         readers=("firebird_tpu/obs/__init__.py",
                  "firebird_tpu/obs/jsonlog.py"),
         help="text | json structured log lines"),
    # ---- bench/smoke harness knobs (artifact dirs + budgets; read by
    # the tools that own the artifact, folded by bench.py) ----
    Knob(name="FIREBIRD_BENCH_BUDGET", default="2700",
         readers=("bench.py", "tools/tpu_watchdog.sh"),
         help="bench wall-clock budget (seconds)"),
    Knob(name="FIREBIRD_TILE_BUDGET", default="3000",
         readers=("tools/tpu_tile_run.sh",),
         help="full-tile TPU run timeout (seconds)"),
    Knob(name="FIREBIRD_SOAK_DIR", default="/tmp/fb_soak",
         readers=("bench.py",),
         help="soak-run artifact directory"),
    Knob(name="FIREBIRD_CHAOS_DIR", default="/tmp/fb_chaos",
         help="chaos-soak artifact directory"),
    Knob(name="FIREBIRD_COMPACT_DIR", default="/tmp/fb_compact",
         readers=("tools/compact_smoke.py",),
         help="compact-smoke artifact directory"),
    Knob(name="FIREBIRD_SERVE_DIR", default="/tmp/fb_serve",
         help="serve-loadtest artifact directory"),
    Knob(name="FIREBIRD_POSTMORTEM_DIR", default="/tmp/fb_postmortem",
         help="postmortem-smoke artifact directory"),
    Knob(name="FIREBIRD_FLEET_DIR", default="/tmp/fb_fleet",
         help="fleet-chaos artifact directory"),
    Knob(name="FIREBIRD_OBJECTSTORE_DIR", default="/tmp/fb_objectstore",
         help="objectstore-chaos artifact directory"),
    Knob(name="FIREBIRD_OBJECT_COMMIT_HOLD_SEC", default="0",
         internal=True,
         help="chaos hook: seconds to sleep between the last chunk "
              "upload and the manifest commit (widens the torn-upload "
              "SIGKILL window for tools/objectstore_chaos.py)"),
    Knob(name="FIREBIRD_ELASTIC_DIR", default="/tmp/fb_elastic",
         help="elastic-soak artifact directory"),
    Knob(name="FIREBIRD_ALERT_DIR", default="/tmp/fb_alerts",
         help="alert-soak artifact directory"),
    Knob(name="FIREBIRD_FANOUT_DIR", default="/tmp/fb_fanout",
         help="fanout-loadtest artifact directory"),
    Knob(name="FIREBIRD_STREAMFLEET_DIR", default="/tmp/fb_streamfleet",
         help="stream-fleet-soak artifact directory"),
    Knob(name="FIREBIRD_TELEMETRY_SMOKE_DIR", default="/tmp/fb_telemetry",
         help="telemetry-smoke artifact directory"),
    Knob(name="FIREBIRD_SLO_DIR", default="/tmp/fb_slo",
         help="slo-smoke artifact directory"),
    Knob(name="FIREBIRD_WIRE_DIR", default="/tmp/fb_wire",
         help="wire-smoke artifact directory"),
    Knob(name="FIREBIRD_PYRAMID_DIR", default="/tmp/fb_pyramid",
         help="pyramid-smoke artifact directory"),
    Knob(name="FIREBIRD_FUSE_DIR", default="/tmp/fb_fuse",
         help="fuse-smoke / fuse-repro artifact directory"),
    Knob(name="FIREBIRD_PRECISION_DIR", default="/tmp/fb_precision",
         readers=("tools/precision_smoke.py",),
         help="precision-smoke artifact directory"),
    Knob(name="FIREBIRD_LINT_DIR", default="/tmp/fb_lint",
         readers=("Makefile",), internal=True,
         help="lint-report artifact directory (make lint)"),
)

KNOBS_BY_NAME = {k.name: k for k in KNOBS}


def env_knob(name: str, env: dict | None = None) -> str | None:
    """Read a registered ``FIREBIRD_*`` knob from the environment.

    The declared route for read sites outside ``Config.from_env``
    (trace-time kernel knobs, tool artifact dirs): unset returns the
    registry default, and an unregistered name raises KeyError loudly —
    firebird-lint's knob-registry rules keep every raw ``os.environ``
    read either here or in a declared ``readers`` module.
    """
    k = KNOBS_BY_NAME[name]
    e = os.environ if env is None else env
    v = e.get(name)
    return k.default if v is None else v


@dataclasses.dataclass(frozen=True)
class Config:
    """Deploy-time configuration.

    Attributes mirror the reference's env contract where one exists; TPU/JAX
    specific knobs replace the Spark/Cassandra tuning.
    """

    # Data sources (reference: ARD_CHIPMUNK / AUX_CHIPMUNK urls)
    ard_url: str = "http://localhost:5656"
    aux_url: str = "http://localhost:5656"

    # Results store. backend: 'sqlite' | 'parquet' | 'memory' | 'object'
    store_backend: str = "sqlite"
    store_path: str = "firebird.db"

    # Object tier (store/objectstore.py).  object_root "" = off; when
    # set, durable writes mirror to the object store (object-first, so
    # stale fenced writes reject before any local byte lands) and
    # store_backend='object' serves reads from it natively.
    object_root: str = ""
    object_chunk_kb: int = 256
    object_scrub_grace_sec: float = 60.0

    # Ingest source: 'chipmunk' (HTTP, ard_url/aux_url) | 'synthetic' | 'file'
    source_backend: str = "chipmunk"
    source_path: str = "."

    # Sensor spec the SYNTHETIC source generates chips for
    # (ccd.sensor.SENSORS).  The kernel/pack path is data-driven, so a
    # tiny spec (landsat-ard-tiny, 10x10 px) runs full-CONUS fleet
    # drills through every production code path at smoke cost
    # (tools/elastic_soak.py).  Real sources ignore it.
    synth_sensor: str = "landsat-ard"

    # Host-side ingest parallelism (reference: INPUT_PARTITIONS, default 1,
    # "controls parallel requests to chipmunk")
    input_parallelism: int = 1

    # HTTP requests in flight per chip (the 8 logical bands fetched
    # concurrently).  Total concurrent requests to the raster service is
    # input_parallelism * band_parallelism; set to 1 to restore a strict
    # INPUT_PARTITIONS ceiling.
    band_parallelism: int = 8

    # Device batching: chips fitted per device dispatch (replaces
    # PRODUCT_PARTITIONS; sizing is per-device batch, not partition count).
    # <= 0 means auto-size from the device memory budget and the acquired
    # range (driver.core.auto_chips_per_batch).
    chips_per_batch: int = 8

    # Max observations capacity per pixel time series (padded/bucketed).
    max_obs: int = 512

    # Time-bucket granularity for padding (ingest pads T up to a multiple).
    obs_bucket: int = 64

    # JAX compute dtype for the CCD kernel ('float32' or 'float64').
    dtype: str = "float32"

    # Device sharding of chip batches: 'auto' shards over all local devices
    # when more than one is visible; 'off' forces single-device dispatch.
    device_sharding: str = "auto"

    # Retries per chip fetch before the chip is quarantined (reference
    # semantics: Spark task retry absorbed transient ingest errors).
    fetch_retries: int = 3

    # HTTP timeout (seconds) for the Chipmunk raster client — the knob
    # behind the previously hardcoded 60 s urlopen timeout.
    http_timeout: float = 60.0

    # Run-wide ceiling on TOTAL retries across every retry site (ingest
    # fetches + store writes); 0 = unlimited.  A systemic outage fails
    # fast into the quarantine instead of multiplying per-chip backoff.
    retry_budget: int = 0

    # Ingest circuit breaker: this many CONSECUTIVE fetch failures open
    # the circuit (fetching pauses, half-open probes resume it) for
    # breaker_cooldown_sec.  0 disables the breaker.
    breaker_threshold: int = 5
    breaker_cooldown_sec: float = 30.0

    # Deterministic fault-injection plan (firebird_tpu.faults), e.g.
    # "ingest:p=0.05,seed=7;store:after=40,brownout=3".  "" (default)
    # injects nothing and puts no proxy on the hot path.
    faults: str = ""

    # Async egress worker threads.  1 preserves global write order; more
    # raise store throughput (parquet/cassandra scale well; sqlite WAL
    # serializes writers anyway).  Per-chip ordering holds at any setting
    # (frames are keyed by chip id).
    writer_threads: int = 1

    # When set, the run executes under one torch.profiler capture whose
    # Chrome trace is written into this directory (obs/profiling.py).
    profile_dir: str = ""

    # Host-side span tracer (firebird_tpu_torch.obs.tracing): ""/"0" off;
    # "1" writes Chrome-trace JSON next to the store; a path writes there.
    # This is the HOST pipeline trace (fetch/pack/dispatch/drain overlap) —
    # complementary to profile_dir's device trace.
    trace: str = ""

    # Per-run obs_report.json (firebird_tpu.obs.report): "" auto (written
    # next to the store for file-backed backends, skipped for 'memory');
    # "0" never; a path always writes there.
    obs_report: str = ""

    # Streaming-state checkpoint directory (driver/stream.py); empty means
    # '<store_path>.stream' next to the store.
    stream_dir: str = ""

    # Stream checkpoint layout (FIREBIRD_STREAM_STATESTORE;
    # streamops/statestore.py): 'packed' (default) stores a whole
    # tile's 2500 chip checkpoints in ONE crash-safe slot file with
    # O(1) access and transparent read-through migration from the
    # legacy layout; 'npz' keeps the one-.npz-per-chip layout — the
    # escape hatch for float64 state, which the packed float32 layout
    # refuses to round (docs/STREAMING.md).
    stream_statestore: str = "packed"

    # Acquisition watcher (FIREBIRD_WATCH_*; streamops/watcher.py):
    # manifest poll cadence, and the durable scene-cursor sqlite path
    # ("" derives watcher.db next to the store — the fleet.db
    # placement rule; the memory backend needs an explicit path).
    watch_interval: float = 30.0
    watch_db: str = ""

    # Embedded HTTP ops endpoint (obs/server.py): /healthz /readyz
    # /metrics /progress /report.  0 (the default) binds NO port — the
    # surface only exists when FIREBIRD_OPS_PORT / --ops-port asks for it.
    ops_port: int = 0

    # Stall watchdog deadline in seconds (obs/watchdog.py): no batch
    # completing within it flips /healthz to 503 and increments
    # watchdog_stall_total.  <= 0 disables the watchdog.
    stall_sec: float = 0.0

    # Ops endpoint bind address (FIREBIRD_OPS_HOST): 0.0.0.0 serves the
    # fleet network; 127.0.0.1 keeps the surface host-local.
    ops_host: str = "0.0.0.0"

    # Seconds process 0 waits for the other hosts' obs-report shards
    # before merging what arrived (FIREBIRD_OBS_MERGE_TIMEOUT).
    obs_merge_timeout: float = 30.0

    # On-demand device profiling (obs/profiling.py): > 0 arms ONE
    # automatic torch.profiler capture window of this many seconds,
    # opening at the run's first dispatch (the kernels are built before
    # it).  POST /profile?seconds=N on the
    # ops endpoint captures further windows on demand; artifacts land
    # under <store dir>/device_profile/.  0 (default) arms nothing.
    profile: float = 0.0

    # Declared service-level objectives (obs/slo.py), evaluated against
    # the live histograms at /slo and in every obs_report.json:
    # "name=target;..." with targets in seconds ("" = the default spec,
    # "0" disables evaluation).  Known objectives: batch_p95, serve_p99,
    # freshness.
    slo: str = ""

    # Error budgets over the durable series store (obs/slo.py):
    # "name[<threshold]@target/window;..." — e.g.
    # "alert_freshness<60@99.9/28d" budgets 0.1% of 28 days' alert
    # observations over 60s.  "" = the default budgets, "0" disables.
    # The fast/slow burn-window pair pages only when BOTH windows burn
    # >= slo_burn times the budget rate (the multi-window rule: fast
    # catches cliffs, slow filters blips).
    slo_budget: str = ""
    slo_fast_sec: float = 300.0
    slo_slow_sec: float = 3600.0
    slo_burn: float = 14.4

    # Durable metric history (obs/series.py): spool snapshots
    # downsampled into fixed-resolution segment rings that survive
    # process death.  FIREBIRD_SERIES is the points-per-segment bound
    # per resolution (0 disables — no series files anywhere);
    # FIREBIRD_SERIES_SEGMENTS the ring's file count; FIREBIRD_SERIES_DIR
    # overrides the series/ placement inside the telemetry spool dir.
    series: int = 512
    series_segments: int = 4
    series_dir: str = ""

    # Black-box canary prober (obs/prober.py; `firebird probe`):
    # interval between probe cycles and the per-probe deadline (request
    # timeout and the scene-drop -> SSE-alert wait).
    probe_sec: float = 10.0
    probe_timeout: float = 30.0

    # Crash flight recorder (obs/flightrec.py): per-thread ring size of
    # recent spans/logs/progress marks dumped to postmortem.json on
    # unhandled exception, watchdog stall, or SIGTERM.  0 disarms.
    flightrec: int = 128

    # Fleet telemetry spool (obs/spool.py; docs/OBSERVABILITY.md "Fleet
    # telemetry plane"): every fleet-role process (watcher, worker,
    # supervisor, deliverer, serve) appends its span/mark events and
    # periodic metric snapshots to a bounded per-process segment ring
    # next to the store, so a SIGKILLed worker's telemetry survives it
    # and `firebird trace collect` can stitch the fleet into one
    # Perfetto trace.  FIREBIRD_TELEMETRY is the events-per-segment
    # bound (0 disarms — zero hot-path cost, the tracing no-op gate);
    # FIREBIRD_TELEMETRY_SEGMENTS bounds the ring's segment-file count.
    telemetry: int = 4096
    telemetry_segments: int = 4

    # Spool directory override (FIREBIRD_TELEMETRY_DIR); "" derives
    # telemetry/ next to the results store (the quarantine.json
    # placement rule; the memory backend then disables spooling).
    telemetry_dir: str = ""

    # Seconds between metric-registry snapshots written into the spool
    # (the counter/gauge/histogram state `firebird top` and the
    # collector read for a dead process).
    telemetry_snapshot_sec: float = 5.0

    # Active-lane compaction in the CCD event loop (FIREBIRD_COMPACT,
    # default on): dense-prefix lane permutation + per-block skip guards
    # + bucketed re-entry for the long tail, so loop cost tracks the
    # ACTIVE pixel set instead of the padded batch (docs/ROOFLINE.md
    # "Occupancy").  Results are row-identical either way; cadence and
    # re-entry floor tune via FIREBIRD_COMPACT_EVERY /
    # FIREBIRD_COMPACT_FLOOR (ccd.params.compact_*).
    compact: bool = True

    # Max device batches in flight (the one computing + draining ones).
    # 2 is the classic double-buffer; deeper keeps the device busier when
    # egress is slow — staged inputs are donated to the dispatch
    # (driver/core.py detect_chunk), so depth pins only result buffers.
    # Default 3 since the wire diet made transfer/compute overlap the
    # e2e lever (docs/ROOFLINE.md "Wire budget").  NOTE: each in-flight
    # batch holds its FULL-capacity device result buffers until drained
    # (kernel.result_bytes; the egress diet shrinks the wire, not this
    # residency) — auto batch sizing budgets depth explicitly
    # (auto_chips_per_batch), but a manually pinned chips_per_batch
    # tuned tight against HBM at depth 2 should either shrink the batch
    # or set FIREBIRD_PIPELINE_DEPTH=2.
    pipeline_depth: int = 3

    # Persistent XLA compilation cache directory (FIREBIRD_COMPILE_CACHE /
    # --compile-cache); "" disables.  With it set, every compiled kernel
    # shape serializes to disk — the second run of a shape skips XLA — and
    # the drivers AOT-compile the predicted batch shape on a background
    # thread at run start so the first compile overlaps batch-0 fetch
    # (driver.core.warm_start).
    compile_cache: str = ""

    # ---- fleet work queue (firebird_tpu.fleet; docs/ROBUSTNESS.md) ----
    # Queue database path (FIREBIRD_FLEET_DB); "" derives fleet.db next
    # to the results store (the quarantine.json placement rule).
    fleet_db: str = ""

    # Lease length: a job whose worker goes silent this long re-delivers
    # to the next claimer.  Shorter leases re-deliver crashed work
    # faster but tolerate less heartbeat jitter before a healthy worker
    # reads as dead.
    fleet_lease_sec: float = 30.0

    # Heartbeat cadence; 0 (default) derives lease/4 — three missable
    # beats of margin before the lease expires.
    fleet_heartbeat_sec: float = 0.0

    # Attempts (failures or expired leases) a job gets before it
    # dead-letters instead of crash-looping the fleet.
    fleet_max_attempts: int = 3

    # ---- elastic fleet supervisor (fleet/supervisor.py;
    # docs/ROBUSTNESS.md "Elastic operation") ----
    # Worker-count bounds for `firebird fleet supervise`: the policy
    # sizes the batch fleet from queue pressure between these.  min 0
    # (the default) is scale-to-zero: an idle queue costs nothing.
    fleet_min_workers: int = 0
    fleet_max_workers: int = 8

    # Graceful-drain deadline: a retiring worker gets SIGTERM (finish
    # the current lease, exit) and this many seconds before SIGKILL —
    # safe either way, the lease fencing already rejects a straggler's
    # writes.
    fleet_grace_sec: float = 30.0

    # ---- alerting (firebird_tpu.alerts; docs/ALERTS.md) ----
    # Alerting (FIREBIRD_ALERTS, default on): a confirmed tail break
    # appends one durable record to the alert log next to the store,
    # deduped on (pixel, break_day), and `firebird serve` mounts the
    # /v1/alerts feed over it.  Off, breaks still publish to the
    # segment table and repair scheduling still runs (FIREBIRD_ALERT_
    # REPAIR is independent) — only the alert feed goes dark, on both
    # the emitting and the serving side.
    alerts_enabled: bool = True

    # Alert-log sqlite path (FIREBIRD_ALERT_DB); "" derives alerts.db
    # next to the results store (the fleet.db placement rule).  The
    # memory store backend has no "next to": alerting silently disables
    # unless a path is set explicitly.
    alert_db: str = ""

    # Automatic cold-path repair (FIREBIRD_ALERT_REPAIR, default on):
    # pixels flagged needs_batch roll up per chip into idempotent
    # `repair` jobs on the fleet queue — at most one open job per chip —
    # instead of a count an operator reads.
    alert_repair: bool = True

    # Webhook delivery HTTP timeout in seconds
    # (FIREBIRD_ALERT_WEBHOOK_TIMEOUT).
    alert_webhook_timeout: float = 10.0

    # ---- alert fanout plane (firebird_tpu.alerts.fanout;
    # docs/ALERTS.md "Fanout plane") ----
    # Fanout rollup (FIREBIRD_FANOUT, default on): `firebird serve`
    # runs the coordinator loop that groups new quadkey-stamped alerts
    # by shard and enqueues `fanout` fleet jobs.  Off, the subscription
    # index still maintains itself and the flat webhook deliverer still
    # sweeps — only the sharded fleet delivery path goes dark.
    fanout_enabled: bool = True

    # Shard key width in quadkey digits (FIREBIRD_FANOUT_SHARD_PREFIX,
    # 1-11): 4**n possible shards.  Alerts are stamped with their FULL
    # base quadkey and sharded by substr() at rollup, so this can
    # change on a live log without restamping.
    fanout_shard_prefix: int = 2

    # Covering-cell budget per subscriber AOI in the subscription index
    # (FIREBIRD_FANOUT_MAX_CELLS): the most index rows one registration
    # may cost; coarser coalescing past it, exactness unaffected (the
    # exact AOI post-filter runs either way).
    fanout_max_cells: int = 64

    # Failure parking (FIREBIRD_FANOUT_PARK_AFTER / _PARK_BASE /
    # _PARK_CAP): after this many CONSECUTIVE delivery failures a
    # subscriber parks under decorrelated backoff between base and cap
    # seconds, so one dead endpoint never stalls its shard (or the flat
    # sweep).  Any 2xx heals and unparks.
    fanout_park_after: int = 3
    fanout_park_base_sec: float = 5.0
    fanout_park_cap_sec: float = 300.0

    # Rollup poll interval (FIREBIRD_FANOUT_POLL, seconds): the
    # alert-append to shard-job-enqueued latency bound of the
    # coordinator loop.
    fanout_poll_sec: float = 2.0

    # ---- serving layer (firebird_tpu.serve; docs/SERVING.md) ----
    # `firebird serve` port (FIREBIRD_SERVE_PORT).  Unlike ops_port this
    # is only read by the serve command — nothing auto-binds it.
    serve_port: int = 8080

    # `firebird serve` bind address (FIREBIRD_SERVE_HOST / --host).
    serve_host: str = "0.0.0.0"

    # In-memory serve cache bound, entries (one decoded chip frame or
    # product raster each; FIREBIRD_SERVE_CACHE_ENTRIES).
    serve_cache_entries: int = 256

    # Disk spill tier directory (FIREBIRD_SERVE_CACHE_DIR); "" disables
    # the second tier.
    serve_cache_dir: str = ""

    # Admission control: concurrent /v1 requests executing, waiting-line
    # bound past which requests shed with 429, and the per-request
    # deadline (504) in seconds (FIREBIRD_SERVE_INFLIGHT /
    # FIREBIRD_SERVE_QUEUE / FIREBIRD_SERVE_DEADLINE).
    serve_inflight: int = 16
    serve_queue: int = 64
    serve_deadline_sec: float = 30.0

    # Quadkey tile-pyramid root (FIREBIRD_SERVE_PYRAMID_DIR;
    # serve/pyramid.py): "" derives pyramid/ under serve_cache_dir when
    # set, else next to the results store; the memory backend with
    # neither disables the /v1/pyramid endpoint.
    serve_pyramid_dir: str = ""

    # Edge caching (FIREBIRD_SERVE_EDGE_TTL): Cache-Control max-age in
    # seconds stamped (with a strong ETag) on /v1/product, /v1/tile and
    # /v1/pyramid responses so CDN/browser caches revalidate with
    # If-None-Match -> 304 instead of refetching bodies.  0 sends no
    # Cache-Control (ETag/304 still work).
    serve_edge_ttl: int = 30

    # Replica changefeed (FIREBIRD_SERVE_FEED_POLL / _SERVE_REPLICA /
    # _CHANGEFEED_DB; serve/changefeed.py): each serve replica tails
    # the alert log + product_writes cursors every poll and bumps
    # exactly the touched chip generations — the serving staleness
    # bound is one poll interval + one apply.  The replica id keys the
    # durable cursor row; "" derives host:pid (an id never seen before
    # replays the whole feed — the safe default for an unknown cache
    # dir).  changefeed_db "" derives changefeed.db next to the store.
    serve_feed_poll_sec: float = 2.0
    serve_replica: str = ""
    changefeed_db: str = ""

    # Framework version (reference: version.txt read in keyspace()).
    version: str = _VERSION

    def __post_init__(self):
        # Fail fast at construction: a bad dtype inside the driver's
        # per-chunk failure isolation would log-and-skip every chunk and
        # exit "successfully" having done nothing.
        if self.dtype not in ("float32", "float64"):
            raise ValueError(
                f"FIREBIRD_DTYPE must be float32 or float64, got "
                f"{self.dtype!r} (bfloat16 is rejected: ordinal days have a "
                "bf16 ulp of 4096 days)")
        if self.synth_sensor != "landsat-ard":
            # Lazy import (the faults/slo fail-fast pattern): a typo'd
            # sensor failing every chunk inside the driver's isolation
            # would exit "successfully" having detected nothing.
            from firebird_tpu_torch.ccd.sensor import SENSORS as _SENSORS

            if self.synth_sensor not in _SENSORS:
                raise ValueError(
                    f"FIREBIRD_SYNTH_SENSOR must be one of "
                    f"{sorted(_SENSORS)}, got {self.synth_sensor!r}")
        if self.device_sharding not in ("auto", "off"):
            raise ValueError(
                "FIREBIRD_DEVICE_SHARDING must be 'auto' or 'off', got "
                f"{self.device_sharding!r}")
        if self.fetch_retries < 0:
            raise ValueError("FIREBIRD_FETCH_RETRIES must be >= 0, got "
                             f"{self.fetch_retries}")
        if self.http_timeout <= 0:
            raise ValueError("FIREBIRD_HTTP_TIMEOUT must be > 0 seconds, "
                             f"got {self.http_timeout}")
        if self.retry_budget < 0:
            raise ValueError("FIREBIRD_RETRY_BUDGET must be >= 0 "
                             f"(0 = unlimited), got {self.retry_budget}")
        if self.breaker_threshold > 0 and self.breaker_cooldown_sec <= 0:
            raise ValueError("FIREBIRD_BREAKER_COOLDOWN must be > 0 when "
                             "the breaker is enabled, got "
                             f"{self.breaker_cooldown_sec}")
        if not 0 <= self.ops_port <= 65535:
            raise ValueError("FIREBIRD_OPS_PORT must be 0 (off) or a valid "
                             f"TCP port, got {self.ops_port}")
        if self.pipeline_depth < 1:
            raise ValueError("FIREBIRD_PIPELINE_DEPTH must be >= 1, got "
                             f"{self.pipeline_depth}")
        if self.obs_merge_timeout < 0:
            raise ValueError("FIREBIRD_OBS_MERGE_TIMEOUT must be >= 0 "
                             "seconds (0 = merge whatever already "
                             f"arrived), got {self.obs_merge_timeout}")
        if self.profile < 0:
            raise ValueError("FIREBIRD_PROFILE must be >= 0 seconds "
                             f"(0 = no auto window), got {self.profile}")
        if self.flightrec < 0:
            raise ValueError("FIREBIRD_FLIGHTREC must be >= 0 "
                             f"(0 = disarmed), got {self.flightrec}")
        if self.telemetry < 0:
            raise ValueError("FIREBIRD_TELEMETRY must be >= 0 "
                             f"(0 = disarmed), got {self.telemetry}")
        if self.telemetry_segments < 2:
            raise ValueError("FIREBIRD_TELEMETRY_SEGMENTS must be >= 2 "
                             "(one live + one sealed segment), got "
                             f"{self.telemetry_segments}")
        if self.telemetry_snapshot_sec <= 0:
            raise ValueError("FIREBIRD_TELEMETRY_SNAPSHOT_SEC must be "
                             "> 0 seconds, got "
                             f"{self.telemetry_snapshot_sec}")
        # Parse the SLO spec now (the JAX package's fail-fast): a typo'd
        # objective silently evaluating nothing is worse than a crash at
        # bring-up.  "" and "0" are both valid.  (The budget grammar,
        # FIREBIRD_SLO_BUDGET, belongs to the series store: NOT_PORTED.)
        if self.slo and self.slo != "0":
            from firebird_tpu_torch.obs import slo as _slo

            _slo.parse_spec(self.slo)
        if self.slo_fast_sec <= 0 or self.slo_slow_sec <= 0:
            raise ValueError(
                "FIREBIRD_SLO_FAST_SEC / FIREBIRD_SLO_SLOW_SEC must be "
                f"> 0 seconds, got {self.slo_fast_sec} / "
                f"{self.slo_slow_sec}")
        if self.slo_fast_sec >= self.slo_slow_sec:
            raise ValueError(
                "FIREBIRD_SLO_FAST_SEC must be shorter than "
                "FIREBIRD_SLO_SLOW_SEC (the multi-window pair needs "
                f"two scales), got {self.slo_fast_sec} >= "
                f"{self.slo_slow_sec}")
        if self.slo_burn <= 0:
            raise ValueError("FIREBIRD_SLO_BURN must be > 0, got "
                             f"{self.slo_burn}")
        if self.series < 0:
            raise ValueError("FIREBIRD_SERIES must be >= 0 "
                             f"(0 = disabled), got {self.series}")
        if self.series_segments < 2:
            raise ValueError("FIREBIRD_SERIES_SEGMENTS must be >= 2 "
                             "(one live + one sealed segment), got "
                             f"{self.series_segments}")
        if self.probe_sec < 0:
            raise ValueError("FIREBIRD_PROBE_SEC must be >= 0 seconds "
                             f"(0 = prober refuses to arm), got "
                             f"{self.probe_sec}")
        if self.probe_timeout <= 0:
            raise ValueError("FIREBIRD_PROBE_TIMEOUT must be > 0 "
                             f"seconds, got {self.probe_timeout}")
        if self.stream_statestore not in ("packed", "npz"):
            raise ValueError(
                "FIREBIRD_STREAM_STATESTORE must be 'packed' or 'npz', "
                f"got {self.stream_statestore!r}")
        if self.watch_interval <= 0:
            raise ValueError("FIREBIRD_WATCH_INTERVAL must be > 0 "
                             f"seconds, got {self.watch_interval}")
        if self.fleet_lease_sec <= 0:
            raise ValueError("FIREBIRD_FLEET_LEASE_SEC must be > 0 "
                             f"seconds, got {self.fleet_lease_sec}")
        if self.fleet_heartbeat_sec < 0:
            raise ValueError("FIREBIRD_FLEET_HEARTBEAT_SEC must be >= 0 "
                             "(0 = lease/4), got "
                             f"{self.fleet_heartbeat_sec}")
        if 0 < self.fleet_lease_sec <= self.fleet_heartbeat_sec:
            raise ValueError(
                "FIREBIRD_FLEET_HEARTBEAT_SEC must be shorter than the "
                f"lease ({self.fleet_lease_sec}s), got "
                f"{self.fleet_heartbeat_sec} — a worker that beats "
                "slower than its lease expires is always a zombie")
        if self.fleet_max_attempts < 1:
            raise ValueError("FIREBIRD_FLEET_MAX_ATTEMPTS must be >= 1, "
                             f"got {self.fleet_max_attempts}")
        if self.fleet_min_workers < 0:
            raise ValueError("FIREBIRD_FLEET_MIN_WORKERS must be >= 0, "
                             f"got {self.fleet_min_workers}")
        if self.fleet_max_workers < max(self.fleet_min_workers, 1):
            raise ValueError(
                "FIREBIRD_FLEET_MAX_WORKERS must be >= 1 and >= "
                f"FIREBIRD_FLEET_MIN_WORKERS ({self.fleet_min_workers}), "
                f"got {self.fleet_max_workers}")
        if self.fleet_grace_sec <= 0:
            raise ValueError("FIREBIRD_FLEET_GRACE_SEC must be > 0 "
                             f"seconds, got {self.fleet_grace_sec}")
        if self.alert_webhook_timeout <= 0:
            raise ValueError("FIREBIRD_ALERT_WEBHOOK_TIMEOUT must be > 0 "
                             f"seconds, got {self.alert_webhook_timeout}")
        if not 1 <= self.fanout_shard_prefix <= 11:
            raise ValueError("FIREBIRD_FANOUT_SHARD_PREFIX must be a "
                             "quadkey depth in [1, 11], got "
                             f"{self.fanout_shard_prefix}")
        if self.fanout_max_cells < 4:
            raise ValueError("FIREBIRD_FANOUT_MAX_CELLS must be >= 4 "
                             "(a quadkey split is 4 children), got "
                             f"{self.fanout_max_cells}")
        if self.fanout_park_after < 1:
            raise ValueError("FIREBIRD_FANOUT_PARK_AFTER must be >= 1, "
                             f"got {self.fanout_park_after}")
        if self.fanout_park_base_sec <= 0:
            raise ValueError("FIREBIRD_FANOUT_PARK_BASE must be > 0 "
                             f"seconds, got {self.fanout_park_base_sec}")
        if self.fanout_park_cap_sec < self.fanout_park_base_sec:
            raise ValueError(
                "FIREBIRD_FANOUT_PARK_CAP must be >= FIREBIRD_FANOUT_"
                f"PARK_BASE ({self.fanout_park_base_sec}), got "
                f"{self.fanout_park_cap_sec}")
        if self.fanout_poll_sec <= 0:
            raise ValueError("FIREBIRD_FANOUT_POLL must be > 0 seconds, "
                             f"got {self.fanout_poll_sec}")
        if not 0 < self.serve_port <= 65535:
            raise ValueError("FIREBIRD_SERVE_PORT must be a valid TCP "
                             f"port, got {self.serve_port}")
        if self.serve_cache_entries < 1:
            raise ValueError("FIREBIRD_SERVE_CACHE_ENTRIES must be >= 1, "
                             f"got {self.serve_cache_entries}")
        if self.serve_inflight < 1:
            raise ValueError("FIREBIRD_SERVE_INFLIGHT must be >= 1, got "
                             f"{self.serve_inflight}")
        if self.serve_queue < 0:
            raise ValueError("FIREBIRD_SERVE_QUEUE must be >= 0, got "
                             f"{self.serve_queue}")
        if self.serve_deadline_sec <= 0:
            raise ValueError("FIREBIRD_SERVE_DEADLINE must be > 0 seconds, "
                             f"got {self.serve_deadline_sec}")
        if self.serve_edge_ttl < 0:
            raise ValueError("FIREBIRD_SERVE_EDGE_TTL must be >= 0 "
                             "seconds (0 = no Cache-Control), got "
                             f"{self.serve_edge_ttl}")
        if self.serve_feed_poll_sec <= 0:
            raise ValueError("FIREBIRD_SERVE_FEED_POLL must be > 0 "
                             f"seconds, got {self.serve_feed_poll_sec}")
        if self.object_chunk_kb <= 0:
            raise ValueError("FIREBIRD_OBJECT_CHUNK_KB must be > 0 KiB, "
                             f"got {self.object_chunk_kb}")
        if self.object_scrub_grace_sec < 0:
            raise ValueError("FIREBIRD_OBJECT_SCRUB_GRACE_SEC must be >= "
                             f"0 seconds, got {self.object_scrub_grace_sec}")
        if self.store_backend == "object" and not self.object_root:
            raise ValueError(
                "FIREBIRD_STORE_BACKEND=object needs FIREBIRD_OBJECT_ROOT "
                "set to the object-tier root directory")

    @classmethod
    def from_env(cls, env: dict | None = None, **overrides) -> "Config":
        """Build a Config from environment variables (explicitly, not at
        import time).  Recognized vars mirror the reference where possible:
        ARD_CHIPMUNK, AUX_CHIPMUNK, INPUT_PARTITIONS, plus
        FIREBIRD_STORE_BACKEND, FIREBIRD_STORE_PATH, FIREBIRD_CHIPS_PER_BATCH,
        FIREBIRD_MAX_OBS, FIREBIRD_DTYPE.
        """
        e = os.environ if env is None else env
        kw = dict(
            ard_url=e.get("ARD_CHIPMUNK", cls.ard_url),
            aux_url=e.get("AUX_CHIPMUNK", cls.aux_url),
            store_backend=e.get("FIREBIRD_STORE_BACKEND", cls.store_backend),
            store_path=e.get("FIREBIRD_STORE_PATH", cls.store_path),
            object_root=e.get("FIREBIRD_OBJECT_ROOT", cls.object_root),
            object_chunk_kb=int(e.get("FIREBIRD_OBJECT_CHUNK_KB",
                                      cls.object_chunk_kb)),
            object_scrub_grace_sec=float(
                e.get("FIREBIRD_OBJECT_SCRUB_GRACE_SEC",
                      cls.object_scrub_grace_sec)),
            source_backend=e.get("FIREBIRD_SOURCE", cls.source_backend),
            source_path=e.get("FIREBIRD_SOURCE_PATH", cls.source_path),
            synth_sensor=e.get("FIREBIRD_SYNTH_SENSOR", cls.synth_sensor),
            input_parallelism=int(e.get("INPUT_PARTITIONS", cls.input_parallelism)),
            band_parallelism=int(e.get("FIREBIRD_BAND_PARALLELISM",
                                       cls.band_parallelism)),
            chips_per_batch=int(e.get("FIREBIRD_CHIPS_PER_BATCH", cls.chips_per_batch)),
            max_obs=int(e.get("FIREBIRD_MAX_OBS", cls.max_obs)),
            obs_bucket=int(e.get("FIREBIRD_OBS_BUCKET", cls.obs_bucket)),
            dtype=e.get("FIREBIRD_DTYPE", cls.dtype),
            device_sharding=e.get("FIREBIRD_DEVICE_SHARDING",
                                  cls.device_sharding),
            fetch_retries=int(e.get("FIREBIRD_FETCH_RETRIES",
                                    cls.fetch_retries)),
            http_timeout=float(e.get("FIREBIRD_HTTP_TIMEOUT",
                                     cls.http_timeout)),
            retry_budget=int(e.get("FIREBIRD_RETRY_BUDGET",
                                   cls.retry_budget)),
            breaker_threshold=int(e.get("FIREBIRD_BREAKER_THRESHOLD",
                                        cls.breaker_threshold)),
            breaker_cooldown_sec=float(e.get("FIREBIRD_BREAKER_COOLDOWN",
                                             cls.breaker_cooldown_sec)),
            faults=e.get("FIREBIRD_FAULTS", cls.faults),
            writer_threads=int(e.get("FIREBIRD_WRITER_THREADS",
                                     cls.writer_threads)),
            profile_dir=e.get("FIREBIRD_PROFILE_DIR", cls.profile_dir),
            trace=e.get("FIREBIRD_TRACE", cls.trace),
            obs_report=e.get("FIREBIRD_OBS_REPORT", cls.obs_report),
            stream_dir=e.get("FIREBIRD_STREAM_DIR", cls.stream_dir),
            stream_statestore=e.get("FIREBIRD_STREAM_STATESTORE",
                                    cls.stream_statestore),
            watch_interval=float(e.get("FIREBIRD_WATCH_INTERVAL",
                                       cls.watch_interval)),
            watch_db=e.get("FIREBIRD_WATCH_DB", cls.watch_db),
            ops_port=int(e.get("FIREBIRD_OPS_PORT", cls.ops_port)),
            ops_host=e.get("FIREBIRD_OPS_HOST", cls.ops_host),
            stall_sec=float(e.get("FIREBIRD_STALL_SEC", cls.stall_sec)),
            obs_merge_timeout=float(e.get("FIREBIRD_OBS_MERGE_TIMEOUT",
                                          cls.obs_merge_timeout)),
            profile=float(e.get("FIREBIRD_PROFILE", cls.profile)),
            slo=e.get("FIREBIRD_SLO", cls.slo),
            slo_budget=e.get("FIREBIRD_SLO_BUDGET", cls.slo_budget),
            slo_fast_sec=float(e.get("FIREBIRD_SLO_FAST_SEC",
                                     cls.slo_fast_sec)),
            slo_slow_sec=float(e.get("FIREBIRD_SLO_SLOW_SEC",
                                     cls.slo_slow_sec)),
            slo_burn=float(e.get("FIREBIRD_SLO_BURN", cls.slo_burn)),
            series=int(e.get("FIREBIRD_SERIES", cls.series)),
            series_segments=int(e.get("FIREBIRD_SERIES_SEGMENTS",
                                      cls.series_segments)),
            series_dir=e.get("FIREBIRD_SERIES_DIR", cls.series_dir),
            probe_sec=float(e.get("FIREBIRD_PROBE_SEC", cls.probe_sec)),
            probe_timeout=float(e.get("FIREBIRD_PROBE_TIMEOUT",
                                      cls.probe_timeout)),
            flightrec=int(e.get("FIREBIRD_FLIGHTREC", cls.flightrec)),
            telemetry=int(e.get("FIREBIRD_TELEMETRY", cls.telemetry)),
            telemetry_segments=int(e.get("FIREBIRD_TELEMETRY_SEGMENTS",
                                         cls.telemetry_segments)),
            telemetry_dir=e.get("FIREBIRD_TELEMETRY_DIR",
                                cls.telemetry_dir),
            telemetry_snapshot_sec=float(
                e.get("FIREBIRD_TELEMETRY_SNAPSHOT_SEC",
                      cls.telemetry_snapshot_sec)),
            compact=e.get("FIREBIRD_COMPACT", "1") not in ("", "0"),
            pipeline_depth=int(e.get("FIREBIRD_PIPELINE_DEPTH",
                                     cls.pipeline_depth)),
            compile_cache=e.get("FIREBIRD_COMPILE_CACHE", cls.compile_cache),
            fleet_db=e.get("FIREBIRD_FLEET_DB", cls.fleet_db),
            fleet_lease_sec=float(e.get("FIREBIRD_FLEET_LEASE_SEC",
                                        cls.fleet_lease_sec)),
            fleet_heartbeat_sec=float(e.get("FIREBIRD_FLEET_HEARTBEAT_SEC",
                                            cls.fleet_heartbeat_sec)),
            fleet_max_attempts=int(e.get("FIREBIRD_FLEET_MAX_ATTEMPTS",
                                         cls.fleet_max_attempts)),
            fleet_min_workers=int(e.get("FIREBIRD_FLEET_MIN_WORKERS",
                                        cls.fleet_min_workers)),
            fleet_max_workers=int(e.get("FIREBIRD_FLEET_MAX_WORKERS",
                                        cls.fleet_max_workers)),
            fleet_grace_sec=float(e.get("FIREBIRD_FLEET_GRACE_SEC",
                                        cls.fleet_grace_sec)),
            alerts_enabled=e.get("FIREBIRD_ALERTS", "1") not in ("", "0"),
            alert_db=e.get("FIREBIRD_ALERT_DB", cls.alert_db),
            alert_repair=e.get("FIREBIRD_ALERT_REPAIR", "1")
            not in ("", "0"),
            alert_webhook_timeout=float(
                e.get("FIREBIRD_ALERT_WEBHOOK_TIMEOUT",
                      cls.alert_webhook_timeout)),
            fanout_enabled=e.get("FIREBIRD_FANOUT", "1")
            not in ("", "0"),
            fanout_shard_prefix=int(e.get("FIREBIRD_FANOUT_SHARD_PREFIX",
                                          cls.fanout_shard_prefix)),
            fanout_max_cells=int(e.get("FIREBIRD_FANOUT_MAX_CELLS",
                                       cls.fanout_max_cells)),
            fanout_park_after=int(e.get("FIREBIRD_FANOUT_PARK_AFTER",
                                        cls.fanout_park_after)),
            fanout_park_base_sec=float(e.get("FIREBIRD_FANOUT_PARK_BASE",
                                             cls.fanout_park_base_sec)),
            fanout_park_cap_sec=float(e.get("FIREBIRD_FANOUT_PARK_CAP",
                                            cls.fanout_park_cap_sec)),
            fanout_poll_sec=float(e.get("FIREBIRD_FANOUT_POLL",
                                        cls.fanout_poll_sec)),
            serve_port=int(e.get("FIREBIRD_SERVE_PORT", cls.serve_port)),
            serve_host=e.get("FIREBIRD_SERVE_HOST", cls.serve_host),
            serve_cache_entries=int(e.get("FIREBIRD_SERVE_CACHE_ENTRIES",
                                          cls.serve_cache_entries)),
            serve_cache_dir=e.get("FIREBIRD_SERVE_CACHE_DIR",
                                  cls.serve_cache_dir),
            serve_inflight=int(e.get("FIREBIRD_SERVE_INFLIGHT",
                                     cls.serve_inflight)),
            serve_queue=int(e.get("FIREBIRD_SERVE_QUEUE", cls.serve_queue)),
            serve_deadline_sec=float(e.get("FIREBIRD_SERVE_DEADLINE",
                                           cls.serve_deadline_sec)),
            serve_pyramid_dir=e.get("FIREBIRD_SERVE_PYRAMID_DIR",
                                    cls.serve_pyramid_dir),
            serve_edge_ttl=int(e.get("FIREBIRD_SERVE_EDGE_TTL",
                                     cls.serve_edge_ttl)),
            serve_feed_poll_sec=float(e.get("FIREBIRD_SERVE_FEED_POLL",
                                            cls.serve_feed_poll_sec)),
            serve_replica=e.get("FIREBIRD_SERVE_REPLICA",
                                cls.serve_replica),
            changefeed_db=e.get("FIREBIRD_CHANGEFEED_DB",
                                cls.changefeed_db),
        )
        kw.update(overrides)
        return cls(**kw)

    def keyspace(self) -> str:
        """Derive the store namespace from ARD/AUX URL paths + version.

        Mirrors ccdc/__init__.py:29-44: results are namespaced by input
        source and code version so reruns against different inputs or code
        never collide.
        """
        ard = urlparse(self.ard_url).path.replace("/", "")
        aux = urlparse(self.aux_url).path.replace("/", "")
        ks = _cqlstr(f"{ard}_{aux}_ccdc_{self.version}").strip().lower().lstrip("_")
        return ks


# The Config fields whose subsystems this package does not port yet, and
# the subsystem each belongs to.  A run whose config sets one (a value other
# than the field's default) is refused by the driver
# (driver.core.refuse_not_ported); none is ignored quietly.
NOT_PORTED = {
    "faults": "the fault-injection plan (faults.py)",
    "object_root": "the object store (store/objectstore.py)",
    "slo_budget": "the SLO error budgets (they read obs/series.py, the "
                  "series store)",
    "compile_cache": "the compile cache (this package compiles its kernels "
                     "with nvcc and caches them under build/)",
}
# Store backends this package does not port yet.
NOT_PORTED_BACKENDS = {
    "object": "the object store (store/objectstore.py)",
    "cassandra": "the Cassandra store (store/backends.CassandraStore)",
}
