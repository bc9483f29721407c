"""Sources and the archive mirror: the drivers' host-only ingest side.

The source factories (:func:`make_source`, :func:`make_aux_source`), the
drivers' retry helper (:func:`with_retries`) and :func:`fetch`, the port's
counterpart of the JAX package's ``driver.core.fetch``: mirror a tile's
chips from the configured source into a ``FileSource`` directory, once,
for any number of offline runs with ``FIREBIRD_SOURCE=file``.  None of it
imports torch or the detector, so ``python -m firebird_tpu_torch fetch``
and the acquisition watcher start without them; ``driver.core`` re-exports
every name here.
"""

from __future__ import annotations

import concurrent.futures as cf
import os

from firebird_tpu_torch import faults as faultlib
from firebird_tpu_torch import grid
from firebird_tpu_torch import retry as retrylib
from firebird_tpu_torch.config import Config
from firebird_tpu_torch.driver import quarantine as qlib
from firebird_tpu_torch.ingest import ChipmunkSource, FileSource, SyntheticSource
from firebird_tpu_torch.obs import logger
from firebird_tpu_torch.utils import dates as dt
from firebird_tpu_torch.utils.fn import take


def make_source(cfg: Config, kind: str | None = None):
    """Source factory (cfg.source_backend): chipmunk | synthetic | file."""
    kind = kind or cfg.source_backend
    if kind == "chipmunk":
        return ChipmunkSource(cfg.ard_url,
                              band_parallelism=cfg.band_parallelism,
                              timeout=cfg.http_timeout)
    if kind == "synthetic":
        from firebird_tpu_torch.ccd.sensor import SENSORS

        return SyntheticSource(seed=0, sensor=SENSORS[cfg.synth_sensor])
    if kind == "file":
        return FileSource(cfg.source_path)
    raise ValueError(f"unknown source backend: {kind!r}")


def make_aux_source(cfg: Config, kind: str | None = None):
    """AUX source factory: the Chipmunk service at ``cfg.aux_url``, or the
    ARD source of the same kind (synthetic and file sources serve both)."""
    kind = kind or cfg.source_backend
    if kind == "chipmunk":
        return ChipmunkSource(cfg.aux_url,
                              band_parallelism=cfg.band_parallelism,
                              timeout=cfg.http_timeout)
    return make_source(cfg, kind)


def with_retries(cfg: Config, log, what: str, fn, policy=None):
    """Run fn() under the driver's transient-failure policy (a one-off
    ``RetryPolicy(cfg.fetch_retries)`` without a run-scoped ``policy``);
    raises the last error when the retries run out."""
    if policy is None:
        policy = retrylib.RetryPolicy(cfg.fetch_retries)
    return policy.run(log, what, fn)


def fetch(x, y, outdir: str, acquired: str | None = None,
          number: int = 2500, aux: bool = False,
          cfg: Config | None = None, source=None,
          aux_source=None) -> tuple[int, int]:
    """Mirror a tile's chips from the configured source into a FileSource
    directory (.npz per chip) for offline reruns and fixture building.

    Uses the driver's fetch retries (one budget and breaker for the run)
    and INPUT_PARTITIONS parallelism, under the config's fault plan.
    Chips that exhaust their retries are dead-lettered to
    ``<outdir>/quarantine.json`` (error class and attempts), so a partial
    mirror resumes like a partial store: rerun the same fetch and a
    redeemed chip leaves the quarantine.  A chip's AUX layers retry on
    their own: a written chip is never fetched again because its AUX
    failed.  Returns (chips written, chips attempted)."""
    cfg = cfg or Config.from_env()
    acquired = acquired or dt.default_acquired()
    log = logger("timeseries")
    plan = faultlib.FaultPlan.from_config(cfg)
    source = faultlib.wrap_source(source or make_source(cfg), plan)
    aux_source = aux_source or (make_aux_source(cfg) if aux else None)
    if aux_source is not None:
        aux_source = faultlib.wrap_source(aux_source, plan)
    os.makedirs(outdir, exist_ok=True)
    sink = FileSource(outdir)
    policy = retrylib.RetryPolicy.for_ingest(
        cfg, budget=retrylib.RetryBudget(cfg.retry_budget),
        breaker=retrylib.make_breaker(cfg))
    quarantine = qlib.Quarantine.load(
        os.path.join(outdir, "quarantine.json"))

    tile = grid.tile(x=x, y=y)
    cids = list(take(number, grid.chips(tile)))
    log.info("fetch: tile h=%s v=%s -> %s (%d chips, acquired %s, aux=%s)",
             tile["h"], tile["v"], outdir, len(cids), acquired, aux)

    def one(xy):
        try:
            with_retries(cfg, log, f"chip ({xy[0]},{xy[1]}) fetch",
                         lambda: sink.save_chip(
                             source.chip(xy[0], xy[1], acquired)),
                         policy=policy)
        except Exception as e:
            log.error("chip (%s,%s) failed: %s", xy[0], xy[1], e)
            quarantine.record(xy, e, attempts=cfg.fetch_retries + 1,
                              stage="fetch")
            return 0
        quarantine.discard(xy)       # a redeemed dead letter drains
        if aux_source is not None:
            try:
                with_retries(cfg, log, f"aux ({xy[0]},{xy[1]}) fetch",
                             lambda: sink.save_aux(
                                 xy[0], xy[1],
                                 aux_source.aux(xy[0], xy[1], acquired)),
                             policy=policy)
            except Exception as e:
                log.error("aux (%s,%s) failed: %s — archive holds the "
                          "chip but no aux layers", xy[0], xy[1], e)
        return 1

    with cf.ThreadPoolExecutor(
            max_workers=max(cfg.input_parallelism, 1)) as ex:
        n = sum(ex.map(one, cids))
    failed = len(cids) - n
    log.info("fetch complete: %d/%d chips written, %d failed%s",
             n, len(cids), failed,
             f" (dead letters in {quarantine.path})" if failed else "")
    return n, len(cids)


__all__ = ["fetch", "make_aux_source", "make_source", "with_retries"]
