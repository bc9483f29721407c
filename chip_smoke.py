"""Smoke run of the PyTorch/CUDA detector on one GPU.

    python3 chip_smoke.py [--seed N] [--chips 8] [--reps 20]
    python3 chip_smoke.py --only-mp-ring    # build, sharded path, item 20

From the root of a checkout, on a machine with a CUDA card:

1. prints the card (nvidia-smi name and power limit) and the torch / CUDA
   versions;
2. builds the ten CUDA kernels from ``firebird_tpu_torch/csrc`` and the
   mixed-precision instances of the five that fit (one nvcc per build
   unit, in parallel), times the build, and counts the tensor-core HMMA
   instructions in each fitting unit's SASS (``cuobjdump -sass``: at least
   one in every ``*_mixed`` unit, none in the f32 ones);
3. kernel phase: runs each kernel's wrapper at the main path's full width
   (``--chips`` chips of 100x100 pixels from ``SyntheticSource(--seed)``,
   1985-2017, T=768, the archive's window cap) on round states drawn from
   the seed with numpy (the fused kernels' events come from the plain
   monitor and INIT on those states; ``detect_mega`` starts from the
   batch's own prologue state; ``ring_remote_copy`` moves two shards'
   stage-2 carries of four chips at the 2048-lane bucket), holds the
   result against the kernel's plain PyTorch version on the same inputs,
   and times both with CUDA events (``ring_remote_copy`` also against one
   ``torch._foreach_copy_``); ``init_window`` also on a late-round state
   (the same inputs with ``in_init`` thinned by the seed to about 2 % of
   the pixels), held to its plain version and timed beside its bound;
   ``lasso_cd`` also on a late round's systems (the fit windows of a tenth
   of the pixels kept, the others empty), its bound counting the systems
   it must fit (a band with a nonzero correlation), the pixels not
   bit-equal to the plain version printed; ``monitor_chain`` held to its
   plain version through ``cuda_ops.monitoring_only``; the
   mixed instances of ``lasso_fit``, ``init_window``, ``fused_fit_close``,
   ``fused_round`` and ``detect_mega`` on the same inputs against their
   plain mixed versions (exact fields equal, coefficients and RMSE within
   ``params.MIXED_ULP_BUDGET`` scaled ulps on at least 0.999 of the
   pixels, the count outside printed), timed beside their f32 instances,
   their bound the split dots at the bf16 tensor rate and the rest at the
   float32 rate; then the skip guard (``active=``) of the eight kernels
   that take one (``guard_phase``; its seconds printed): at 100, 30, 2 and
   0 % of each chip's lanes active (a dense prefix), the guarded launch
   equals the unguarded one with ``cuda_ops.guard``'s fill over the tiles
   without an active lane bit for bit, and its guarded plain version bit
   for bit on those tiles (the mixed instances too); on the inputs a
   compacted loop hands over (the other lanes with no window, no
   monitoring, no INIT, no fit, no close) guarded equals unguarded on
   every lane the loop reads, each timed at 100, 30 and 2 % beside the
   share of dead tiles, and a row "<kernel>+guard" at 30 %;
4. main paths, one for each route: the round routes ``fused`` 0, 1 and
   "mon", the whole-loop route ``pallas="mega"`` and the component route
   ``pallas="lasso,monitor,tmask"``, all with compaction off, route 0
   with compaction on ("0+compact"), routes 1, "mon" and the component
   route with it on ("1+compact", "mon+compact", "components+compact":
   every guarded kernel runs guarded on a main path; one run each, its
   launches read around it, every field equal to its compaction-off
   route's bit for bit), and routes 0, 1, "mon" and mega with
   ``mixed=True`` ("0+mixed", ...: their fitting kernels' mixed instances
   launch, no f32 one).  Each is ``SyntheticSource`` ->
   ``pack`` -> ``detect_packed`` on the card for the same full-size
   Landsat chips, with the launch counters set to 0 just before and read
   just after, and held to the route's set of kernels (the mega route to
   one ``detect_mega`` launch per dispatch, its shape accepted by
   ``cuda_ops.mega_fits`` and no refusal counted); the same batch through the
   route's plain versions on the card, and the fraction of pixels whose
   decision fields agree.  Route 1 must equal route 0 byte for byte, route
   "mon" in every field but seg_mag (held to rtol 5e-3, atol 1e-2), the
   mega route route "mon" in every field but the per-chip rounds and
   round_counts (their maximum over chips is route 0's rounds), the
   component route route 0 in the decisions of at least 0.999 of the
   pixels, "0+compact" route 0 in every field; the mixed routes the same
   identities among themselves, and "0+mixed" route 0 in the decisions of
   at least 0.999 of the pixels (the count that differ and the largest
   scaled-ulp drift printed).  On route 0, egress packing and decoding and
   the store's table frames for one chip;
5. the sharded main path: ``detect_sharded`` over two shards on the card
   (route 0, compaction and the rebalancing ring on) for the same chips,
   the second shard's four keeping a 10-row strip of land; it must migrate
   lanes through three ``ring_remote_copy`` hops a dispatch and equal the
   ring-off dispatch and the unsharded "0+compact" route in the store
   fields;
6. a small input (two 10x10 chips) through the card and through the plain
   versions on the CPU, decision fields compared; the threshold-fuzz chip
   of tests/test_precision.py (seed 11) on routes 0, 1, "mon" and mega,
   mixed against f32: decisions identical, drift within
   ``params.MIXED_ULP_BUDGET``;
7. what the redesigned kernels are judged by: registers, stack and spills
   (the build's ``-Xptxas -v``), shared memory and resident blocks an SM
   (the CUDA runtime) of ``fused_round``, ``fused_fit_close`` and each
   window instance of ``detect_mega``, ``init_window``, ``tmask_bad``,
   ``lasso_cd`` and ``monitor_chain``, those of ``lasso_fit`` and
   ``monitor_chain_scored``, each with its time
   beside its bound, the ring's achieved TB/s beside
   ``torch._foreach_copy_``'s, and the walls of routes "mon", 1 and mega
   beside route 0's;
8. the Sentinel-2 path (bench.py's rung: one 300x300-pixel chip of 12
   bands, 2019-2020, T=64): every kernel's 12-band instance on that chip's
   round states against its plain version (the pixels that disagree
   counted) and timed, the mixed instances too, one bit check of each
   guarded instance's skip guard at 30 % active, then routes 0, 1, "mon",
   mega, the component route, "0+mixed" and "mon+mixed", each with its
   launches read around it and against its plain route, held to the
   Landsat paths' rules;
9. the batch driver (``driver_phase``): ``driver.core.changedetection``
   on the card over the first 24 full Landsat chips of one tile
   (``SyntheticSource(--seed)``, acquired 1985-01-01/2017-12-31, T=768),
   in batches of 8 with 3 in flight, into a sqlite store in a temporary
   directory, on the default route.  The chips are made first and served
   to the driver from memory (their making is timed apart), so the wall
   is the pipeline's: fetch, pack, stage, dispatch, drain and write.  One
   chip's fetch fails and is quarantined, and the run goes on; a resumed
   run drains it first; a second resume with a source that raises on any
   fetch returns all 24 chips, writes nothing and launches nothing.
   Every stored row must equal ``detect_packed`` plus
   ``format.batch_frames`` on the same batches on the card, and the run
   must have launched route 0's kernels and no other.  Printed: px/s
   (pixels over the wall from the first fetch to the writer's close),
   each stage's seconds, the peak device memory a batch beside
   ``kernel.working_set_bytes``, and the batch that
   ``auto_chips_per_batch`` picks on this card.  The native data plane
   (``native.available()`` must hold): the 24 chips packed natively (in
   a thread beside the rows' check) must equal the packer's NumPy packs
   (those the rows' check runs, as the driver packs) byte for byte;
   printed: the driver's ``pipeline_pack`` seconds and both packs'
   seconds;
10. one process per card and the ops surface (``ops_phase``, right after
   ``driver_phase``): ``python -m torch.distributed.run --nproc-per-node 2
   -m firebird_tpu_torch changedetection`` on the one card (both processes
   on cuda:0) over the tile's first 8 chips (the driver phase's chips,
   served from ``.npz`` files through FIREBIRD_SOURCE=file), batches of 8
   with 3 in flight, into a fresh sqlite store, each process with its own
   FIREBIRD_OPS_PORT, ``--trace 1``, ``--profile 2`` and
   FIREBIRD_STALL_SEC=600.  While they run, every process's ``/healthz``,
   ``/readyz``, ``/metrics`` and ``/progress`` are polled until each has
   answered 200 (the codes seen printed).  Each process must take 4 of the
   8 chips; every stored row must equal the driver phase's row for the
   chip; the two report shards carry one run id and process 0's fleet
   report merges both, its counters the shards' sums (8 chips, 80 000
   pixels); each shard's one profile window must hold device events
   (``source`` "trace", ``total_ms`` > 0) among them ``lasso_fit_kernel``,
   ``monitor_kernel`` and ``init_kernel`` by name (its device busy share
   printed); each process's trace passes ``validate_driver_artifacts``
   with its shard; no postmortem bundle.  Printed: the launch-to-exit wall
   and px/s, the pipelines' wall and px/s, and the phase's seconds;
11. the fleet (``fleet_phase``, right after ``ops_phase``): the tile's
   first 8 chips (the driver phase's chips, with their AUX layers from
   ``SyntheticSource(--seed)``, served from ``.npz`` files through
   FIREBIRD_SOURCE=file) enqueued with ``python -m firebird_tpu_torch
   fleet enqueue -n 8 -c 2`` as 4 detect jobs, then a classify job
   (1985-2017) on them, a product job (seglength, ccd, curveqa and
   cover at 2010-06-01) on it and a ``pyramid`` job (those rasters' quadkey
   tiles, 2 levels) on that, through ``FleetQueue.enqueue``,
   then drained by ``fleet supervise --until-drained`` with
   FIREBIRD_FLEET_MIN_WORKERS = FIREBIRD_FLEET_MAX_WORKERS = 2 (two ``fleet
   work`` processes on cuda:0), a 10 s lease, the telemetry spool on, a
   15 s profile window a worker (FIREBIRD_PROFILE: the lease and 5 s, so
   that a window the freeze lands in still runs after the hold),
   FIREBIRD_STALL_SEC=600
   and an ops port on the supervisor.  The zombie drill: the first worker
   whose ``job_claimed`` mark for a detect job reaches the spool is
   SIGSTOPped, held until that job's lease has lapsed (or was taken
   over), then SIGCONTed.  (a) Every job done, none dead, the supervisor
   exits 0.  (b) The frozen worker's job ran again (attempts >= 2) and the
   queue recorded the lease's expiry or a fence rejection; the 8 chips'
   chip, pixel and segment rows equal the driver phase's, key for key
   (all columns but the classify job's rfrawp).  (c) The full-width model
   is stored, every real segment row of the 8 chips holds its votes,
   each product raster equals ``chip_product`` of the stored rows, each
   base tile of the pyramid job is its chip's raster and each parent tile
   the 2x selection of its four children.  (d)
   ``trace collect`` over the spool: the supervisor and every worker (the
   frozen one too) among the processes, each job's ack mark with a claim
   mark under its trace id, ``dispatch`` and ``drain`` spans on worker
   pids.  (e) nvidia-smi's compute apps, sampled during the drain, hold
   every worker's pid and never the supervisor's (where the sandbox's pid
   namespace shows every context as one pid: at most, and once, three
   contexts, this process's and the two workers'), and each worker's
   profile window holds route 0's kernels by name.  (f) No postmortem, no
   watchdog stall in the spooled snapshots, and the supervisor's
   ``/progress`` answered 200.  Printed: the drain's wall, the hold, the
   first claim after launch, the collect and each check's seconds;
12. the read side over the fleet's telemetry home (``history_phase``,
   right after ``fleet_phase``): while the supervisor's ops port was up,
   its ``/metrics/history?res=10`` answered 200 with points from the
   workers' spools and its ``/slo`` carried a budgets block (not
   disabled) with a verdict for every objective of the default budget
   spec.  Then, as commands over that home: ``slo --no-record`` exits 0
   or 1 with a verdict for every objective and records nothing; ``slo -b
   'batch_p95<0.001@99/1h'`` (a budget every drained batch burns) exits
   1 and records the exhaustion in ``slo_events.jsonl``; ``slo
   --no-record -b 'batch_p95<30@99/1h'`` is ok over the drained batches;
   ``status`` shows the queue drained and the budget view; ``top
   --iterations 1`` renders one frame with the history block and the
   workers' counters.  Printed: each command's seconds and the phase's;
13. the stream path (``stream_phase``): ``driver.stream.stream`` on the
   card over the tile's first 8 chips (the same archive; the eighth
   stepped +800 on every band from 2016-06-01), served from memory cut to
   each asked range, batches of 8 into sqlite in a temporary directory.
   Pass 1 bootstraps 1985-2015: it must launch route 0's kernels and no
   other, store exactly ``detect_packed`` + ``format.batch_frames``'s rows
   and save 8 checkpoints, with no alert.  Pass 2 updates over 2016-2017
   (only the delta past each horizon fetched, no kernel launched): every
   field of the card's final state must equal, bit for bit, the port's
   ``step`` replayed on the CPU from a copy of the pass-1 checkpoints; on
   the 7 synthetic chips, the pixels comparable with a batch rerun over
   1985-2017 (test_incremental.py's rule: the same last-segment model and
   no exceedance in the window, an exceed run live at the seed included;
   and the window replayed with the rerun's variogram decides alike)
   must be at least a third and all equal it in end_day, nobs and
   n_exceed; one alert per newly broken pixel (the step chip's dated
   2016) and one open repair job per flagged chip.  Pass 3 (the same
   range) fetches no acquisition, launches nothing, writes no row and
   alerts and enqueues nothing.  ``alerts.repair_chip`` on the step chip
   must store ``detect_packed`` + ``batch_frames``'s rows and leave no
   pixel flagged.  Printed: bootstrap px/s; the update's wall,
   chip-steps and pixel-observations and their rates, the step loops'
   span on the card (CUDA events) and its share of the wall, one chip's
   step loop replayed under ``torch.profiler`` (its kernels' own time,
   and so their busy share of the wall), statestore load and save ms a
   chip, publish and alert seconds; the peak memory;
14. stream ingest under the fleet and the object tier (``ingest_phase``,
   right after ``stream_phase``, on its first two chips, the second
   stepped): ``driver.fetch.fetch`` mirrors them, cut to 1985-2015, into a
   ``FileSource`` archive in a temporary directory, and the archive's
   newest acquisition is published on its ``scenes.jsonl``; with
   FIREBIRD_OBJECT_ROOT set (restored after), ``AcquisitionWatcher.
   poll_once`` over that tile, then a ``FleetWorker`` in this process on
   the card drains the queue; then 2016-2017 land (``save_chip``), their
   last acquisition is published, and a second poll and drain follow (the
   repair roll-up off in both legs).  (a) The first poll enqueues a
   ``detect`` bootstrap and a ``stream`` job a chip, each stream job dep'd
   on its chip's bootstrap, and a second watcher on the same
   ``watcher.db`` enqueues nothing.  (b) Every job ends done, none dead;
   the bootstraps launch route 0's three kernels and nothing else
   launches; the update steps state that lives on the card.  (c) A serial
   leg (``driver.stream.stream`` over the same two ranges, no watcher,
   fleet or object tier) has the same (cx, cy, px, py, break_day) alert
   rows, no duplicates, the same checkpoint bytes (``serialize_state``'s
   canonical layout) and the same chip, pixel and segment rows key for
   key; the stepped chip alerts on every pixel its bootstrap left
   monitoring a standard-procedure model.  (d) Each checkpoint object
   equals its packed slot byte for byte, the object store's mirror reads
   back the sqlite rows key for key, ``objectstore census`` counts those
   objects with no orphan, ``objectstore scrub --dry-run --grace 0``
   reclaims nothing, and ``status`` shows the watcher cursor (2 scenes)
   and the object census with no error entry.  (e)
   ``acquisition_to_alert_seconds`` has an observation and ``slo
   --no-record`` over the phase's home evaluates ``alert_freshness``.
   Printed: each step's and check's seconds and the phase's;
15. the float64 route (``f64_phase``): one full chip through
   ``detect_packed(dtype=torch.float64)`` on the card, which must launch
   no kernel; on 256 of its pixels drawn from the seed every decision must
   equal the port's ``reference.detect`` (run in 8 processes) and the
   floats be within tests/test_ccd_kernel.py's tolerances.  Printed: its
   wall and its decision agreement with f32 route 0 on the whole chip;
16. the parity audit (``validate_phase``, right after ``f64_phase``):
   ``validate.validate`` on the default synthetic chip (100, 200), 10 000
   pixels of 7 bands over 1985-2017, 100 pixels drawn from seed 0
   replayed through ``ccd/reference.py`` in the f64 phase's pool of 8
   spawned processes (once: the float32 audit takes the oracle's answers
   for the same pixels from the float64 audit), in float64 (structural agreement must be 100 % and no kernel launch)
   and in float32 (it must launch route 0's three kernels and no
   other; its mismatches, break-day agreement and the exit code the
   command would give are printed, not gated: the f32 route is not held
   to the f64 oracle on a full chip).  Then ``flops.bench_detail`` for
   route 0 on that chip (P, T, W and the measured round counts, the
   H100's peaks) beside the kernel phase's bounds of the three kernels;
17. classification and the product rasters (``classify_phase``, run
   right after ``driver_phase`` on its sqlite store of 24 detected chips):
   ``driver.core.classification`` at the driver's point over 1985-2017 on
   the card, at the JAX package's width (500 trees, depth 8, 64 bins), the
   AUX layers from ``SyntheticSource(--seed)``; it must launch none of the
   ten kernels.  (a) The stored model loads back, equals the model
   returned and has classes of the synthetic trends alphabet (1-8).  (b)
   Every real segment row of the 24 chips holds C votes, equal to
   ``raw_predict`` on the card for its features and summing to 500 (rtol
   1e-4).  (c) The dense form against the walk on the card over those
   rows: within 1e-4, and the same argmax wherever the top two votes are
   more than 1e-3 apart.  (d) On a sample of 20 000 training rows drawn
   from the seed, a 32-tree forest trained on the card against the one
   trained on the CPU: the bootstrap lanes, trees and nodes that differ are
   printed; the predictions agree on every decided row and at most 1 % of
   the trees differ.  (e) ``products.save`` of seglength, ccd, curveqa and
   cover at 2010-06-01 over the 24 chips: each raster equals
   ``chip_product`` recomputed from the stored rows, and cover the vote
   argmax mapped through the stored classes.  Printed: the training rows,
   the classes and their counts, the stage seconds (store read, assemble,
   bin, draw and grow (CUDA events), train, model save, predict, write),
   rows/s trained and classified, the card's spans' share of the wall,
   the peak device memory, each check's seconds and the wall;
18. serving over the card's results (``serve_phase``, right after
   ``classify_phase`` on its store): two ``python -m firebird_tpu_torch
   serve --port 0`` replicas as subprocesses sharing the store, one
   changefeed db (0.5 s poll) and one pyramid directory.  (a) Every
   stored raster of the 24 chips at 2010-06-01 is served by both replicas
   equal, byte for byte, to the row ``products.save`` wrote; ``/v1/pixel``
   at 8 seeded points equals those rasters; ``serve_product_computes`` is
   0.  (b) 16 concurrent identical cold ``cover`` requests at 2012-06-01
   compute once, and the persisted row is ``chip_product`` of the stored
   rows through the stored model's classes.  (c) ``pyramid build`` over
   the 24 chips, 2 levels: base tiles are the rasters, parents the 2x
   selection of their children; ``/v1/pyramid`` answers 200 with the
   tile file's bytes, then 304 on its ETag.  (d) A clipped
   ``products.save`` of one chip in this process reaches both replicas
   within one poll and 1 s: new bytes under a new ETag, the chip's base
   tile stale-stamped and rebuilt at the next version; ``status`` shows
   both replicas, none behind.  (e) ``export`` of curveqa over the area
   equals the mosaic of the stored rows.  (f) 8 threads x 100 warm GETs
   over kept-alive connections, every body the stored raster's.  The
   card's compute apps do not rise while the replicas run.  Printed: the
   replicas' start-up, the coherence delays, req/s with p50/p99, each
   check's seconds and the phase's;
19. alert delivery and the canary (``alert_phase``, inside
   ``ingest_phase``'s temporary directory after its check (e), over what
   it left: the store and the alert log its watcher-fed stream jobs wrote
   on the card, its queue, archive and in-process ``FleetWorker`` on
   ``cuda:0``).  One ``python -m firebird_tpu_torch serve --port 0``
   replica runs as a subprocess over that store with a 0.5 s fanout
   rollup poll (FIREBIRD_FANOUT_POLL).  (a) ``/v1/alerts?since=0`` paged
   to the end equals ``AlertLog.since`` over the whole log, record for
   record, and one ``bbox`` + ``t0``/``t1`` query equals the brute-force
   filter of the same rows.  (b) Three local sinks register through
   ``POST /v1/alerts/webhooks`` (``all``: no AOI, immediate; ``aoi``: the
   upper half of the stepped chip, batch; ``far``: an AOI 600 km east,
   digest); the replica's coordinator enqueues ``fanout`` jobs and the
   worker drains them, launching nothing; each sink's distinct record ids
   equal the records its AOI contains (``far`` none), the duplicate POSTs
   are printed, ``status`` shows lag 0 and no open fanout job, and a
   second rollup enqueues nothing.  (c) ``python -m firebird_tpu_torch
   probe`` runs as a subprocess over the replica and the archive for one
   probe chip (the tile's third), while this process polls an
   ``AcquisitionWatcher`` covering it and drains the worker, until an
   alert probe and a webhook probe resolve and the ``all`` sink holds the
   probe chip's alerts: the prober's spool then shows no failure,
   attempts on the serve, alert and webhook surfaces, a 304 and a latency
   sample each for the alert and webhook probes; the probe chip's jobs
   launch route 0's three kernels and nothing else; its 10 000 alerts are
   in the log and on the ``all`` sink.  (d) The card's compute apps do
   not rise while the replica and the prober run.  Printed: the records,
   the sinks' distinct and duplicate records, the prober's counters and
   latencies, each step's seconds and the phase's;
20. the ring between processes (``mp_ring_phase``, right after
   ``classify_phase``): two processes of this script (``--mp-ring-child``)
   on ``cuda:0``, started before ``classify_phase`` so that their imports,
   CUDA contexts, kernels, gloo group, chips and check (c) come up behind
   it, then released through the group's store.  They form a global mesh
   of two shards (``parallel.make_mesh``), process p holding chips [4p,
   4p+4) of the sharded path's ragged batch at full width, and run
   ``detect_sharded`` over it, route 0 with compaction and the ring on,
   both hops of each ring exchange crossing the processes.  (a) Every
   store field of each process's chips and its ``lanes_migrated`` equal
   the one-process sharded path's (more than 0 lanes migrate).  (b) Each
   process launches route 0's kernels and ``ring_remote_copy`` and
   nothing else, ``ring_remote_copy`` 3 times a dispatch.  (c) The
   cross-process hop of ``ring_row``'s full-width payload (drawn on the
   card from the seed, so that each process remakes the other's) equals
   its plain cross-process version (gloo, host-staged) and its source,
   byte for byte.  (d) The median of 20 CUDA-event-timed launches of each
   sender into the other's IPC-opened buffer, the processes in turn, the
   hop their sum, beside its bound (bytes) and ``torch._foreach_copy_``
   into the IPC-opened views; then the median wall of 5 whole hops
   (``ring_remote_copy`` over the mesh: exports, mappings and the store's
   messages) and of 5 agreements of the dispatch.  (e) The card's compute
   apps rise by exactly the two processes and fall back.  (f) A second
   dispatch at a segment capacity 2 above the first's (another payload
   signature) gives the same segment counts, and once each dispatch's
   result is gone, at most 64 MiB more is allocated on the card than
   before the first (a receive buffer kept would be 191 MB).  Printed: the
   dispatches' seconds, the launches, the hop's times, the memory held,
   the wait for the children and the phase's visible seconds;
21. every kernel instance's registers, stack and spills, and the total
   seconds.

Any failed check raises before the result.  The last three lines are the
kernels' JSON summary, the card's name and power limit as nvidia-smi gives
them, and the device JSON.  A longer report goes to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import json
import multiprocessing
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from firebird_tpu_torch import grid, native
from firebird_tpu_torch.ccd import (cuda_ops, flops as flops_model,
                                    format as fmt, incremental, kernel,
                                    params, synthetic)
from firebird_tpu_torch.ccd.reference import detect as reference_detect
from firebird_tpu_torch.ccd.primitives import (coefmask_for,
                                               first_at_or_after, variogram)
from firebird_tpu_torch.ccd.sensor import (LANDSAT_ARD, LANDSAT_ARD_TINY,
                                           SENTINEL2, chi2_thresholds)
from firebird_tpu_torch.config import Config
from firebird_tpu_torch.driver import core as driver
from firebird_tpu_torch.driver import quarantine as qlib
from firebird_tpu_torch.ingest import SyntheticSource, pack, pixel_timeseries
from firebird_tpu_torch.ingest.packer import QA_FILL_PACKED, PackedChips
from firebird_tpu_torch.obs import Counters
from firebird_tpu_torch.store import MemoryStore, SqliteStore
from firebird_tpu_torch.parallel import detect_sharded
from firebird_tpu_torch.utils import dates as dt

# The H100's peaks, from the port's roofline model (ccd/flops.PEAKS): the
# device memory rate, float32 outside the tensor cores, dense bf16 on them.
H100 = flops_model.peak_for("NVIDIA H100")
HBM_BYTES_S, F32_FLOPS_S, BF16_FLOPS_S = (H100.hbm_bytes, H100.f32_flops,
                                          H100.bf16_flops)
START, END = "1985-01-01", "2017-12-31"
PALLAS = "firebird_tpu/ccd/pallas_ops.py"
KERNEL_INFO = {
    "lasso_fit": f"{PALLAS}:375",
    "monitor_chain_scored": f"{PALLAS}:706",
    "init_window": f"{PALLAS}:976",
    "fused_fit_close": f"{PALLAS}:1426",
    "fused_round": f"{PALLAS}:1727",
    "lasso_cd": f"{PALLAS}:170",
    "monitor_chain": f"{PALLAS}:652",
    "tmask_bad": f"{PALLAS}:1225",
    "detect_mega": f"{PALLAS}:2283",
    "ring_remote_copy": f"{PALLAS}:1877",
}
COMPONENTS = "lasso,monitor,tmask"
ROUTE_0 = {"lasso_fit", "monitor_chain_scored", "init_window"}
# Each main path: its detect_packed arguments and the kernels it launches
# (the routes after "0" fit the prologue's snow / insufficient-clear
# pixels with lasso_fit; the component route with lasso_cd).  The five
# routes run with compaction off, "0+compact" is route 0 with it on, and
# "1+compact", "mon+compact" and "components+compact" routes 1, "mon" and
# the component route with it on (with compaction every kernel of a route
# but detect_mega runs its skip guard, cuda_ops.guard); the "+mixed"
# routes are routes 0, 1, "mon" and mega with the mixed-precision Gram,
# which launch the mixed instances of their fitting kernels and no f32
# instance of one.
ROUTES = {
    "0": (dict(pallas="1", fused=0, compact=False), ROUTE_0),
    "1": (dict(pallas="1", fused=1, compact=False),
          ROUTE_0 | {"fused_fit_close"}),
    "mon": (dict(pallas="1", fused="mon", compact=False),
            {"lasso_fit", "init_window", "fused_round"}),
    "mega": (dict(pallas="mega", compact=False), {"lasso_fit", "detect_mega"}),
    COMPONENTS: (dict(pallas=COMPONENTS, fused=0, compact=False),
                 {"lasso_cd", "monitor_chain", "tmask_bad"}),
    "0+compact": (dict(pallas="1", fused=0, compact=True), ROUTE_0),
    "1+compact": (dict(pallas="1", fused=1, compact=True),
                  ROUTE_0 | {"fused_fit_close"}),
    "mon+compact": (dict(pallas="1", fused="mon", compact=True),
                    {"lasso_fit", "init_window", "fused_round"}),
    "components+compact": (dict(pallas=COMPONENTS, fused=0, compact=True),
                           {"lasso_cd", "monitor_chain", "tmask_bad"}),
}
# The compacted routes held by compact_path to their compaction-off route.
COMPACT_OF = {"1+compact": "1", "mon+compact": "mon",
              "components+compact": COMPONENTS}
# Every route names its precision: FIREBIRD_MIXED_PRECISION decides none.
for _r in ROUTES.values():
    _r[0]["mixed"] = False
MIXED = "+mixed"
ROUTES.update({
    r + MIXED: (dict(ROUTES[r][0], mixed=True),
                {cuda_ops.unit_of(k, k in cuda_ops.MIXED_SOURCES)
                 for k in ROUTES[r][1]})
    for r in ("0", "1", "mon", "mega")})
# The sharded main path: two shards on the one card, route 0, compaction
# and the rebalancing ring on (its default threshold).
SHARDS = 2
SHARDED = dict(pallas="1", fused=0, compact=True)
STORE_FIELDS = ("n_segments", "seg_meta", "seg_rmse", "seg_mag", "seg_coef",
                "mask", "procedure")
# The route whose main-path launches a kernel's JSON row reports.
HOME_ROUTE = {"lasso_fit": "0", "monitor_chain_scored": "0",
              "init_window": "0", "fused_fit_close": "1",
              "fused_round": "mon", "lasso_cd": COMPONENTS,
              "monitor_chain": COMPONENTS, "tmask_bad": COMPONENTS,
              "detect_mega": "mega", "ring_remote_copy": "sharded"}
HOME_ROUTE.update({cuda_ops.unit_of(k, True): HOME_ROUTE[k] + MIXED
                   for k in cuda_ops.MIXED_SOURCES})
# The kernels with a skip guard (``active=``), their rows ("<name>+guard":
# the guarded launch at GUARD_ROW_SHARE of the lanes active) and the
# compacted route whose main-path launches those rows report.
GUARDED = ("lasso_fit", "monitor_chain_scored", "init_window",
           "fused_fit_close", "fused_round", "lasso_cd", "monitor_chain",
           "tmask_bad")
GUARD_SUFFIX = "+guard"
HOME_ROUTE.update({k + GUARD_SUFFIX: r for k, r in (
    ("lasso_fit", "0+compact"), ("monitor_chain_scored", "0+compact"),
    ("init_window", "0+compact"), ("fused_fit_close", "1+compact"),
    ("fused_round", "mon+compact"), ("lasso_cd", "components+compact"),
    ("monitor_chain", "components+compact"),
    ("tmask_bad", "components+compact"))})
SEGMENT_FIELDS = ("n_segments", "seg_meta", "seg_rmse", "seg_mag",
                  "seg_coef", "mask", "procedure", "rounds", "vario",
                  "round_counts")


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, reps, warm=1):
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for s, e in ev:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in ev]))


def bound(nbytes, flops, tensor_flops=0.0):
    """The least time for ``nbytes`` moved and ``flops`` float32 operations
    outside the tensor cores plus ``tensor_flops`` bf16 tensor-core
    operations, and which of the two bounds it."""
    b_ms = nbytes / HBM_BYTES_S * 1e3
    f_ms = (flops / F32_FLOPS_S + tensor_flops / BF16_FLOPS_S) * 1e3
    return (b_ms, "bytes") if b_ms >= f_ms else (f_ms, "operations")


def gram_ops(n_obs, B):
    """Float operations of the f32 Gram and correlations over ``n_obs``
    weighted observations of B bands (the upper Gram, B x 8 products and
    sums, the count)."""
    return n_obs * (36 * 2 + B * 17 + 1)


def mixed_dot_ops(n_obs, B):
    """Tensor-core operations of the mixed Gram and correlations over
    ``n_obs`` weighted observations: the Gram's two split terms (its 36
    distinct entries) and the B bands' three split terms (8 each), a
    product and a sum each."""
    return n_obs * (2 * 36 * 2 + 3 * B * 8 * 2)


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------------------
# Kernel phase
# ---------------------------------------------------------------------------

def kernel_inputs(seed, staged, W, sensor=LANDSAT_ARD):
    """Full-width kernel inputs: the main path's staged batch (spectra,
    dates, QA) and round states drawn from the seed — alive sets from the
    QA's clear observations, a model fitted by the plain Lasso over them,
    random cursors, phases, segment counts and result buffers; the
    monitor's inputs gathered at ``sensor``'s detection bands."""
    rng = np.random.default_rng(seed + 1)
    days, n_obs, spectra, qa = staged
    dev = spectra.device
    C, B, P, T = spectra.shape
    X, Xt, t, valid = kernel.device_designs(days, n_obs)
    Yt = spectra.transpose(2, 3).contiguous()
    g = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    clear = (((qa >> params.QA_CLEAR_BIT) & 1) == 1).transpose(1, 2).contiguous()
    alive = clear & valid[:, :, None] & g(rng.random((C, T, P)) < 0.95)
    vario = variogram(Yt.float(), alive, t).contiguous()
    coefs, rmse = cuda_ops.lasso_fit_plain(
        Yt, alive.float(), X, torch.ones(C, P, 8, dtype=torch.bool, device=dev))
    det = list(sensor.detection_bands)
    cut = g(rng.integers(T // 8, T // 2, (C, P)).astype(np.int32))
    ar = torch.arange(T, device=dev)[None, :, None]
    included = alive & (ar < cut[:, None, :])
    # Half the pixels were last fit on their included count (they reach a
    # refit point), half on more than the series holds (they end in a
    # tail or a break).
    n_last_fit = torch.where(g(rng.random((C, P)) < 0.5),
                             included.sum(1, dtype=torch.int32).clamp_min(1),
                             4 * T)
    S = kernel.MAX_SEGMENTS
    bufs = tuple(g(rng.standard_normal((C, P, S) + k).astype(np.float32))
                 for k in ((6,), (B,), (B,), (B, 8)))
    return dict(
        coefs=coefs, rmse=rmse, bufs=bufs,
        first_seg=g(rng.random((C, P)) < 0.5),
        nseg=g(rng.integers(0, S + 1, (C, P)).astype(np.int32)),
        T=T, W=W, X=X, Xt=Xt, t=t, Yt=Yt, vario=vario, alive=alive,
        sensor=sensor,
        w=(alive & (ar < g(rng.integers(T // 4, T, (C, P)))[:, None, :])).float(),
        coefmask=coefmask_for(g(rng.integers(12, 30, (C, P)))),
        Yd=Yt[:, det].contiguous(),
        coefs_d=coefs[:, :, det].contiguous(),
        dden=torch.maximum(rmse, vario)[:, :, det].contiguous(),
        included=included, cur_k=cut,
        n_last_fit=n_last_fit,
        in_mon=g(rng.random((C, P)) < 0.7),
        cur_i=g(rng.integers(0, T // 2, (C, P)).astype(np.int32)),
        in_init=g(rng.random((C, P)) < 0.6))


def window_sizes(inp):
    """Members of each pixel's initialization window ([C,P], 0 where the
    pixel is not initializing or has no window)."""
    alive, t = inp["alive"], inp["t"]
    T = alive.shape[1]
    ar = torch.arange(T, device=alive.device)[None, :, None]
    has_i, i = first_at_or_after(alive, inp["cur_i"])
    t_i = torch.gather(t, 1, i)
    cnt = torch.cumsum(alive & (ar >= i[:, None, :]), 1)
    okj = (alive & (ar >= i[:, None, :]) & (cnt >= params.MEOW_SIZE)
           & (t[:, :, None] - t_i[:, None, :] >= params.INIT_DAYS))
    has_w, j = first_at_or_after(okj, torch.zeros_like(i))
    n = torch.gather(cnt, 1, j[:, None, :])[:, 0]
    return torch.where(has_i & has_w & inp["in_init"], n, torch.zeros_like(n))


def kernel_phase(inp, staged, reps, seed, ring=True, mixed=False,
                 guards=None):
    """Every kernel at full width on ``inp``'s round states (its sensor's
    band layout), held to its plain version, then timed beside it; the
    ring's row only where ``ring``; where ``mixed``, the fitting kernels'
    mixed instances too (:func:`mixed_rows`); then the skip guards
    (:func:`guard_phase`, "full" or "bits"; None: not).  Returns the rows by
    kernel (with the guard rows where ``guards`` is "full") and the phase's
    report (each kernel's count of pixels whose decisions differ from the
    plain version's under ``disagreeing_pixels``; the guards' under
    ``guard``)."""
    C, B, T, P = inp["Yt"].shape
    sensor = inp["sensor"]
    rows, report = [], {}
    dis = report["disagreeing_pixels"] = {}
    kw_mon = dict(zip(("change_thr", "outlier_thr"),
                      chi2_thresholds(5)))

    # ---- lasso_fit ----
    a = (inp["Yt"], inp["w"], inp["X"], inp["coefmask"])
    got = cuda_ops.lasso_fit(*a)
    want = cuda_ops.lasso_fit_plain(*a)
    torch.cuda.synchronize()
    err = max(float((got[i] - want[i]).abs().max()) for i in range(2))
    rel = max(float((got[i] - want[i]).abs().max() / want[i].abs().max())
              for i in range(2))
    dis["lasso_fit"] = int(check_floats("lasso_fit", zip(got, want), FIT_TOL,
                                        sensor).sum())
    fl, by = kernel_work("lasso_fit", a, got, inp)
    rows.append(("lasso_fit", a, {}, err, rel, fl, by,
                 dict(fit_obs=float(inp["w"].sum()))))

    # ---- monitor_chain_scored ----
    a = (inp["Yd"], inp["coefs_d"], inp["dden"], inp["X"], inp["alive"],
         inp["included"], inp["cur_k"], inp["n_last_fit"], inp["in_mon"])
    got = cuda_ops.monitor_chain_scored(*a, **kw_mon)
    mon = cuda_ops.monitor_chain_scored_plain(*a, **kw_mon)
    # The kernel gives a pixel that does not monitor the zero outputs.
    want = cuda_ops.monitoring_only(mon, inp["in_mon"])
    torch.cuda.synchronize()
    dis["monitor_chain_scored"] = n_pixels_differing(got, want)
    for k in want:
        n_diff = int((got[k] != want[k]).sum())
        check(n_diff == 0, f"monitor_chain_scored {k}: {n_diff} differ")
    fl, by = kernel_work("monitor_chain_scored", a, got, inp)
    rows.append(("monitor_chain_scored", a, kw_mon, 0.0, 0.0, fl, by))

    # ---- init_window ----
    a = (inp["alive"], inp["cur_i"], inp["in_init"], inp["t"], inp["X"],
         inp["Xt"], inp["Yt"], inp["vario"])
    kw_init = dict(W=inp["W"], sensor=sensor)
    got = cuda_ops.init_window(*a, **kw_init)
    want = init = cuda_ops.init_window_plain(*a, **kw_init)
    torch.cuda.synchronize()
    dis["init_window"] = n_pixels_differing(got, want)
    for k in INIT_EXACT:
        n_diff = int((got[k] != want[k]).sum())
        check(n_diff == 0, f"init_window {k}: {n_diff} differ")
    verdict = {k: float((got[k] != want[k]).float().mean())
               for k in ("init_ok", "init_bad")}
    check(max(verdict.values()) <= 1e-3,
          f"init_window stability verdicts: {verdict}")
    report["init_window_verdict_disagreement"] = verdict
    err = max(float((got[k].int() - want[k].int()).abs().max()) for k in want)
    fl, by = kernel_work("init_window", a, got, inp)
    rows.append(("init_window", a, kw_init, err, 0.0, fl, by,
                 dict(fit_obs=float(window_sizes(inp).sum()))))
    report["init_window_late_round"] = init_late_round(inp, a, kw_init, seed,
                                                       reps)
    rows += fused_rows(inp, mon, init, kw_mon, report)
    rows += component_rows(inp, kw_mon, report, seed, reps)
    rows.append(mega_row(staged, inp["W"], kw_mon, report, sensor))
    if mixed:
        rows += mixed_rows(inp, mon, init, kw_mon, report, rows)
        rows.append(mega_row(staged, inp["W"], kw_mon, report, sensor,
                             mixed=True))
    if ring:
        rows.append(ring_row(seed, T, inp["Yt"].device, report))

    out = {}
    for name, args, kw, err, rel, fl, by, *timing in rows:
        tm = dict(reps=reps, plain_reps=max(reps // 4, 3), plain_warm=1,
                  tensor_flops=0.0)
        tm.update(*timing)
        src = cuda_ops.source_of(name)
        ms = cuda_ms(lambda: getattr(cuda_ops.KERNELS, src)(*args, **kw),
                     tm["reps"])
        plain_ms = cuda_ms(lambda: getattr(cuda_ops.PLAIN, src)(*args, **kw),
                           tm["plain_reps"], tm["plain_warm"])
        lib = tm.get("library")
        library_ms = None if lib is None else cuda_ms(lib, tm["reps"])
        b_ms, b_by = bound(by, fl, tm["tensor_flops"])
        out[name] = dict(name=name, route="cuda",
                         source=f"firebird_tpu_torch/csrc/{src}.cu",
                         replaces=KERNEL_INFO[src], max_abs_err=err,
                         max_rel_err=rel, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=library_ms, bytes=by, flops=fl,
                         tensor_flops=tm["tensor_flops"])
        f32 = ""
        if name != src:
            out[name]["f32_ms"] = out[src]["ms"]
            out[name].update(report["mixed"][name])
            f32 = (f"; f32 instance {out[src]['ms']:.3f} ms; pixels outside "
                   f"the ulp budget {report['mixed'][name]['pixels_outside']}")
        print(f"kernel {name} ({sensor.name}, {B} bands): {ms:.3f} ms (plain "
              f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by}, library "
              f"{library_ms} ms), max abs err {err}, max rel err {rel}, "
              f"pixels disagreeing {dis.get(name)}{f32}", flush=True)
    if guards:
        out.update(guard_phase(rows, inp, reps, report, full=guards == "full"))
    return out, report


INIT_EXACT = ("init_nowin", "init_tm", "has_adv", "i_next_tm", "i_adv", "j",
              "n_ok", "w_stab", "alive_init")


# ---------------------------------------------------------------------------
# The skip guards (cuda_ops.guard)
# ---------------------------------------------------------------------------

# The active shares of the guards' bit checks, of their timings, and of
# their rows: each chip's lanes a dense prefix, as compaction leaves them.
GUARD_SHARES = (1.0, 0.3, 0.02, 0.0)
GUARD_TIMED = (1.0, 0.3, 0.02)
GUARD_ROW_SHARE = 0.3
MONITORS = ("monitor_chain_scored", "monitor_chain")
# INIT's cursor fields, which a pixel that does not initialize computes too
# (the loop reads them where in_init).
INIT_CURSOR = ("i_next_tm", "i_adv", "j", "has_adv")


def gcall(fns, name, a, kw, active):
    """Kernel ``name`` of ``fns`` (cuda_ops.KERNELS or PLAIN) on the
    arguments ``a``, the fused kernels' buffers (their last argument)
    cloned first: they are updated in place."""
    if name in ("fused_fit_close", "fused_round"):
        a = a[:-1] + (tuple(b.clone() for b in a[-1]),)
    return getattr(fns, name)(*a, **kw, active=active)


def out_leaves(out):
    """An output's tensors in order (a dict's by key, a tuple's by place)."""
    if torch.is_tensor(out):
        return [out]
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    return [t for o in out for t in out_leaves(o)]


def lanes_of(v, mask):
    """The [C,P] lanes ``mask`` of an output: [C,P,...] or a [C,T,P]
    plane."""
    return v[mask] if v.shape[:2] == mask.shape else v.transpose(1, 2)[mask]


def bits(v):
    return v.view(torch.int32) if v.dtype == torch.float32 else v


def n_differing(got, want, mask=None):
    """Elements whose bits differ between two outputs (``mask``: the [C,P]
    lanes to compare; all where None)."""
    n = 0
    for g, w in zip(out_leaves(got), out_leaves(want)):
        if mask is not None:
            g, w = lanes_of(g, mask), lanes_of(w, mask)
        n += int((bits(g) != bits(w)).sum())
    return n


def reader_view(name, out, a):
    """What the loop reads of an output: the monitors' fields of monitoring
    pixels (the kernel zeroes the others, the plain version keeps the
    Pallas values there), INIT's cursor fields of initializing pixels."""
    if name in MONITORS:
        return cuda_ops.monitoring_only(out, a[-1])
    if name == "init_window":
        return {k: (torch.where(a[2], v, torch.zeros_like(v))
                    if k in INIT_CURSOR else v) for k, v in out.items()}
    return out


def inert_args(name, a, keep):
    """The arguments as a compacted loop hands them over: the lanes outside
    ``keep`` [C,P] (each chip's dense prefix) with an empty window, no
    monitoring, no INIT, no fit and no close; and the lane set the caller
    guards with (kernel.BatchLoop)."""
    a, plane = list(a), keep[:, None, :]
    if name == "lasso_fit":
        a[1] = a[1] * plane
        return a, a[1].sum(1) > 0
    if name == "lasso_cd":
        z = lambda v: torch.where(keep.reshape(keep.shape + (1,) * (
            v.dim() - 2)), v, torch.zeros_like(v))
        a[0], a[1] = z(a[0]), z(a[1])
        a[2] = torch.where(keep[..., None], a[2], torch.full_like(a[2], 1e-12))
        return a, (a[1] != 0).flatten(2).any(-1)
    if name == "tmask_bad":
        a[2] = a[2] * keep[..., None]
        return a, a[2].sum(-1) > 0
    if name in MONITORS:
        a[-1] = a[-1] & keep
        return a, a[-1]
    if name == "init_window":
        a[2] = a[2] & keep
        return a, a[2]
    if name == "fused_fit_close":
        a[3] = a[3] * plane
        for i in (4, 10, 11):
            a[i] = a[i] & keep
        return a, a[4] | a[10] | a[11]
    a[7], a[11], a[12] = a[7] & keep, a[11] & keep, a[12] & plane
    return a, a[7] | a[11]


def dead_tile_share(active, flat):
    """The share of the launch's tiles with no active lane."""
    live = cuda_ops.tile_live(active, flat=flat)
    heads = (live.reshape(-1)[::cuda_ops.TILE] if flat
             else live[:, ::cuda_ops.TILE])
    return 1.0 - float(heads.float().mean())


def guard_phase(rows, inp, reps, report, full):
    """The skip guard of each guarded kernel of ``rows`` (the kernel phase's
    f32 rows and mixed instances), on their full-width inputs:

    - bit checks, at every share of GUARD_SHARES (each chip's first lanes
      active) where ``full``, else at GUARD_ROW_SHARE: the guarded launch
      equals the unguarded launch with cuda_ops.guard's fill laid over the
      tiles without an active lane, bit for bit on every output (at 0 % the
      fill alone, the in-place buffers untouched); and its guarded plain
      version on those tiles, bit for bit (on the others the kernel phase's
      row holds the two);
    - where ``full``, the f32 kernels on the inputs a compacted loop hands
      over (:func:`inert_args`) at GUARD_TIMED shares: guarded against
      unguarded bit for bit on every lane the loop reads, each timed (median
      of ``reps`` CUDA-event launches) beside the dead-tile share, and a
      row "<name>+guard" at GUARD_ROW_SHARE (its plain version, the guarded
      plain; its bound, the work of those inputs).

    Returns the rows by name; the checks go under ``report["guard"]``."""
    t0 = time.perf_counter()
    C, B, T, P = inp["Yt"].shape
    sensor = inp["sensor"]
    rep = report["guard"] = {}
    out = {}
    for name, a, kw, *_ in rows:
        src = cuda_ops.source_of(name)
        if src not in GUARDED:
            continue
        flat = src in cuda_ops.FLAT_TILES
        r = rep[name] = dict(bits={})
        u = gcall(cuda_ops.KERNELS, src, a, kw, None)
        for share in GUARD_SHARES if full else (GUARD_ROW_SHARE,):
            act = torch.arange(P, device=inp["Yt"].device).expand(
                C, P) < int(share * P)
            g = gcall(cuda_ops.KERNELS, src, a, kw, act)
            n_fill = n_differing(g, cuda_ops.guard(src, u, act, a))
            dead = ~cuda_ops.tile_live(act, flat=flat)
            n_plain = 0
            if bool(dead.any()):
                p = gcall(cuda_ops.PLAIN, src, a, kw, act)
                if src in MONITORS:
                    p = cuda_ops.monitoring_only(p, a[-1])
                n_plain = n_differing(g, p, dead)
            torch.cuda.synchronize()
            r["bits"][share] = dict(not_the_fill=n_fill,
                                    dead_not_the_plain=n_plain,
                                    dead_tile_share=dead_tile_share(act, flat))
            check(n_fill == 0 and n_plain == 0,
                  f"guard {name} ({sensor.name}) at {share}: {n_fill} "
                  f"elements off the guarded fill, {n_plain} off the guarded "
                  f"plain version on the dead tiles")
        if not full or name != src:
            print(f"guard {name} ({sensor.name}, {B} bands): bit checks at "
                  f"{sorted(r['bits'])} of the lanes active: "
                  f"{r['bits']}", flush=True)
            continue
        # The inputs a compacted loop hands over, timed.
        r["timed"] = {}
        for share in GUARD_TIMED:
            keep = torch.arange(P, device=inp["Yt"].device).expand(
                C, P) < int(share * P)
            ai, act = inert_args(src, a, keep)
            ai = tuple(ai)
            gi = gcall(cuda_ops.KERNELS, src, ai, kw, act)
            ui = gcall(cuda_ops.KERNELS, src, ai, kw, None)
            n_diff = n_differing(reader_view(src, gi, ai),
                                 reader_view(src, ui, ai))
            check(n_diff == 0, f"guard {name} at {share}: {n_diff} elements "
                  f"of the guarded launch differ from the unguarded one")
            timed = ai[:-1] + (tuple(b.clone() for b in ai[-1]),) \
                if src in ("fused_fit_close", "fused_round") else ai
            fn = getattr(cuda_ops.KERNELS, src)
            ms = cuda_ms(lambda: fn(*timed, **kw, active=act), reps)
            ms_u = cuda_ms(lambda: fn(*timed, **kw), reps)
            r["timed"][share] = dict(
                guarded_ms=ms, unguarded_ms=ms_u,
                active_lanes_share=float(act.float().mean()),
                dead_tile_share=dead_tile_share(act, flat))
            if share != GUARD_ROW_SHARE:
                continue
            p = gcall(cuda_ops.PLAIN, src, ai, kw, act)
            plain_ms = cuda_ms(
                lambda: gcall(cuda_ops.PLAIN, src, ai, kw, act), 3, warm=0)
            if src in MONITORS:
                p = cuda_ops.monitoring_only(p, ai[-1])
            diffs = [(g.double() - w.double()).abs()
                     for g, w in zip(out_leaves(gi), out_leaves(p))]
            err = max(float(d.max()) for d in diffs if d.numel())
            scale = max(float(w.double().abs().max())
                        for w in out_leaves(p) if w.numel())
            fl, by = kernel_work(src, ai, gi, inp)
            b_ms, b_by = bound(by, fl)
            out[src + GUARD_SUFFIX] = dict(
                name=src + GUARD_SUFFIX, route="cuda",
                source=f"firebird_tpu_torch/csrc/{src}.cu",
                replaces=KERNEL_INFO[src], max_abs_err=err,
                max_rel_err=err / max(scale, 1e-30), ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, bytes=by, flops=fl, tensor_flops=0.0,
                active_share=share, unguarded_ms=ms_u, timed=r["timed"])
        print(f"guard {name} ({sensor.name}, {B} bands): " + "; ".join(
            f"{100 * sh:g} % active: guarded {v['guarded_ms']:.3f} ms, "
            f"unguarded {v['unguarded_ms']:.3f} ms, dead tiles "
            f"{100 * v['dead_tile_share']:.1f} %"
            for sh, v in r["timed"].items())
            + f"; bound at {100 * GUARD_ROW_SHARE:g} % "
            f"{out[src + GUARD_SUFFIX]['bound_ms']:.4f} ms by "
            f"{out[src + GUARD_SUFFIX]['bound_by']}, guarded plain "
            f"{out[src + GUARD_SUFFIX]['plain_ms']:.3f} ms; bit checks at "
            f"{sorted(r['bits'])} of the lanes active: exact", flush=True)
    rep["seconds"] = time.perf_counter() - t0
    print(f"guard checks ({sensor.name}): {rep['seconds']:.1f} s",
          flush=True)
    return out


def init_work(inp, a, got):
    """init_window's float operations and bytes on ``inp``'s state: the
    INIT body over the initializing pixels' windows; their members'
    detection-band values, the alive plane, the designs and per-pixel
    inputs once, the outputs once."""
    n = window_sizes(inp).double()
    nz = n[n > 0]
    return init_flops(nz), float(nz.sum()) * 5 * 2 + nbytes(
        *a[:6], inp["vario"], *got.values())


def thin_init(inp, seed, share=0.02):
    """``inp``'s ``in_init`` (about 0.6 of the pixels) thinned by the seed
    to about ``share`` of them: a later round's INIT, where few pixels
    initialize."""
    rng = np.random.default_rng(seed + 3)
    keep = torch.from_numpy(rng.random(tuple(inp["in_init"].shape))
                            < share / 0.6)
    return inp["in_init"] & keep.to(inp["in_init"].device)


def init_late_round(inp, a, kw_init, seed, reps):
    """``init_window`` on a late round's state (:func:`thin_init`, 2 %),
    held to its plain version on the exact fields and timed beside its
    bound."""
    late = (a[0], a[1], thin_init(inp, seed)) + a[3:]
    got = cuda_ops.init_window(*late, **kw_init)
    want = cuda_ops.init_window_plain(*late, **kw_init)
    torch.cuda.synchronize()
    for k in INIT_EXACT:
        n_diff = int((got[k] != want[k]).sum())
        check(n_diff == 0, f"init_window late round {k}: {n_diff} differ")
    fl, by = init_work(dict(inp, in_init=late[2]), late, got)
    b_ms, b_by = bound(by, fl)
    ms = cuda_ms(lambda: cuda_ops.init_window(*late, **kw_init), reps)
    share = float(late[2].float().mean())
    print(f"kernel init_window late round ({inp['sensor'].name}, "
          f"{100 * share:.2f} % initializing): {ms:.3f} ms, bound "
          f"{b_ms:.4f} ms by {b_by}", flush=True)
    return dict(initializing_share=share, ms=ms, bound_ms=b_ms, bound_by=b_by,
                bytes=by, flops=fl)


# The fits' envelope against the plain versions (a Gram summed in another
# order, amplified by 50 CD sweeps), and the break magnitudes' (a median of
# differently rounded residuals).
FIT_TOL = dict(rtol=1e-2, atol=1e-2)
MAG_TOL = dict(rtol=5e-3, atol=1e-2)


def check_floats(name, pairs, tol, sensor, where=None):
    """Holds a kernel's fitted floats to its plain version's within ``tol``
    (pairs of tensors whose leading dims are [C,P]; ``where``: only those
    pixels) and returns the pixels outside it.  On the Landsat layout every
    element must be inside.  On another layout at least 0.999 of the
    pixels must be: Sentinel-2's 64-step series leave windows of 12-30
    observations for up to 8 coefficients, whose ill-conditioned Grams a
    sum in another order moves further."""
    pairs = list(pairs)
    C, P = pairs[0][0].shape[:2]
    sel = (torch.ones(C, P, dtype=torch.bool, device=pairs[0][0].device)
           if where is None else where)
    bad = torch.zeros_like(sel)
    for g, w in pairs:
        bad |= ~torch.isclose(g, w, **tol).reshape(C, P, -1).all(-1) & sel
        if sensor.n_bands == LANDSAT_ARD.n_bands:
            torch.testing.assert_close(g[sel], w[sel], **tol,
                                       msg=lambda m: f"{name}: {m}")
    agree = 1.0 - float(bad.sum()) / max(float(sel.sum()), 1.0)
    check(agree >= 0.999, f"{name}: {int(bad.sum())} pixels outside "
          f"{tol}, agreement {agree} < 0.999")
    return bad


def n_pixels_differing(got, want):
    """The count of pixels [C,P] that differ in any field of two dicts of
    per-pixel vectors [C,P] and time planes [C,T,P]."""
    C, P = next(v for v in want.values() if v.dim() == 2).shape
    differ = torch.zeros(C, P, dtype=torch.bool, device=want[
        next(iter(want))].device)
    for k, w in want.items():
        d = got[k] != w
        differ |= d.any(1) if d.dim() == 3 else d
    return int(differ.sum())


def tmask_flops(nz):
    """Float operations of the Tmask screen over windows of ``nz`` members:
    12 weighted 5x5 solves (Gram, correlations, Cholesky), 10 residual
    passes with their medians (insertion sorts) and the final flags."""
    lg = torch.log2(nz.clamp_min(2))
    return float((12 * (nz * 42 + 110) + 10 * (nz * 17 + 2 * nz * lg)
                  + 24 * nz).sum())


def init_flops(nz):
    """Float operations of the INIT body over windows of ``nz`` members:
    the Tmask screen, then the stability fit (Gram, 50 CD sweeps of the 5
    detection bands, the window's residuals)."""
    return tmask_flops(nz) + float((nz * 158 + 5 * 50 * 8 * 20
                                    + 5 * nz * 19).sum())


def fit_flops(w, do_fit, B):
    """Float operations of the shared refit over the fitting pixels'
    windows: the Gram, 50 CD sweeps and the RMSE (the lasso_fit count,
    over the fitting pixels only)."""
    nnz = float((w * do_fit[:, None, :]).sum())
    n_fit = float(do_fit.sum())
    return nnz * (36 * 2 + B * 17 + 1) + n_fit * B * 50 * 8 * 20 + nnz * B * 19


def kernel_work(name, a, got, inp):
    """The float operations and bytes of guarded kernel ``name`` on its
    arguments ``a`` (its outputs ``got``), counted from this call's data;
    ``inp`` supplies the shapes (and init_window's state).  The work of a
    pixel that does nothing (no weight, not monitoring, not initializing,
    no fit or close) is its inputs' and outputs' bytes alone."""
    C, B, T, P = inp["Yt"].shape
    if name == "lasso_fit":
        # The Gram over the weighted steps, the CD loop of every pixel with
        # a weight (the others' fit is zero), the RMSE pass.
        w = a[1]
        nnz, n_fit = float(w.sum()), float((w.sum(1) > 0).sum())
        fl = (nnz * (36 * 2 + B * 17 + 1) + n_fit * B * 50 * 8 * 20
              + nnz * B * 19)
        return fl, nnz * B * 2 + nbytes(w, a[2], a[3], *got)
    if name == "monitor_chain_scored":
        # The detection bands at the monitoring pixels' alive observations,
        # their alive / included columns and model, the vectors and the
        # partition planes out.
        n_alive = float((a[4] & a[8][:, None, :]).sum())
        n_mon = float(a[8].sum())
        return n_alive * 5 * 19, (
            n_alive * 5 * 2 + n_mon * (2 * T + 5 * 8 * 4 + 5 * 4)
            + nbytes(a[3], *a[6:], *got.values()))
    if name == "init_window":
        return init_work(dict(inp, alive=a[0], cur_i=a[1], in_init=a[2]), a,
                         got)
    if name == "lasso_cd":
        by, fl, _ = cd_work(a, got)
        return fl, by
    if name == "monitor_chain":
        # The score plane at the monitoring pixels' alive observations.
        # Integer counts and threshold compares only: no float arithmetic.
        n_alive = float((a[1] & a[5][:, None, :]).sum())
        return 0.0, n_alive * 4 + nbytes(*a[1:], *got.values())
    if name == "tmask_bad":
        # The members' design rows and Tmask-band values, the initializing
        # pixels' slot weights and variograms, and the flags.
        n = a[2].sum(-1).double()
        return tmask_flops(n[n > 0]), (
            float(a[2].sum()) * (5 + 2) * 4
            + float((n > 0).sum()) * (a[2].shape[-1] + 2) * 4 + nbytes(got))
    K, S = 8, inp["bufs"][0].shape[2]
    row_bytes = (6 + 2 * B + B * K) * 4
    vec_bytes = C * P * (B * K + B) * 4 * 2      # model in and out
    if name == "fused_fit_close":
        # The fitting pixels' window spectra and f32 weight columns, the
        # closing pixels' included columns, the written rows and the rest.
        w_fit, do_fit, nseg = a[3], a[4], a[15]
        close = a[10] | a[11]
        n_rows = float((close & (nseg < S)).sum())
        return fit_flops(w_fit, do_fit, B), (
            float((w_fit * do_fit[:, None, :]).sum()) * B * 2
            + float(do_fit.sum()) * T * 4 + float(close.sum()) * T
            + n_rows * row_bytes + vec_bytes + C * P * (B * 4 + 4 * 7)
            + nbytes(a[1], a[2]))
    assert name == "fused_round"
    # Spectra: the 5 detection bands where the monitor or the fit reads
    # them, the other bands in the fit windows only.  Weights: the init-ok
    # pixels' u8 w_stab columns; a refit reads back its own included_mon
    # output.  Then the alive / included planes in and out, the written
    # rows and the rest.
    ev, init_ok, nseg = got[4], a[11], a[15]
    w_round = torch.where(init_ok[:, None, :], a[12],
                          ev["included_mon"] & ev["is_refit"][:, None, :])
    mon_obs = a[3] & a[7][:, None, :]
    fit_obs = w_round & ev["do_fit"][:, None, :]
    close = ev["is_tail"] | ev["is_brk"]
    n_rows = float((close & (nseg < S)).sum())
    fl = (fit_flops(w_round.float(), ev["do_fit"], B)
          + float(mon_obs.sum()) * 5 * 19)
    return fl, (2 * (5 * float((mon_obs | fit_obs).sum())
                     + (B - 5) * float(fit_obs.sum()))
                + float(init_ok.sum()) * T + 4 * C * T * P
                + n_rows * row_bytes + vec_bytes + C * P * (B * 4 + 4 * 12)
                + nbytes(a[1], a[2]))


def fused_rows(inp, mon, init, kw_mon, report):
    """The fused kernels at full width on one round: the events and the
    INIT handoff come from the plain monitor and init_window results of
    the kernel phase's states.  Buffers are cloned for each call (the
    kernels write them in place)."""
    dis = report["disagreeing_pixels"]
    clone = lambda: tuple(b.clone() for b in inp["bufs"])
    in_mon, init_ok, is_refit = inp["in_mon"], init["init_ok"], mon["is_refit"]
    incm = inp["included"] | (mon["inc_q"] & in_mon[:, None, :])
    do_fit = init_ok | is_refit
    w_fit = torch.where(init_ok[:, None, :], init["w_stab"],
                        incm & is_refit[:, None, :]).float()
    rows = []

    # ---- fused_fit_close ----
    a = (inp["Yt"], inp["X"], inp["t"], w_fit, do_fit,
         torch.where(init_ok, init["n_ok"], mon["n_rf"]), incm, inp["coefs"],
         inp["rmse"], cuda_ops.peek_run_mags(inp["Yt"], inp["X"], inp["alive"],
                                             inp["coefs"], mon["ev_rank"],
                                             mon["m"]),
         mon["is_tail"], mon["is_brk"], mon["pos_ev"], mon["n_exceed"],
         inp["first_seg"], inp["nseg"])
    got = cuda_ops.fused_fit_close(*a, clone())
    want = cuda_ops.fused_fit_close_plain(*a, clone())
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        check(torch.equal(g, w), f"fused_fit_close buffer {i} differs")
    check(torch.equal(got[1], want[1]), "fused_fit_close nseg differs")
    dis["fused_fit_close"] = int(check_floats(
        "fused_fit_close", zip(got[2:], want[2:]), FIT_TOL,
        inp["sensor"]).sum())
    err = max(float((got[i] - want[i]).abs().max()) for i in (2, 3))
    rel = max(float((got[i] - want[i]).abs().max() / want[i].abs().max())
              for i in (2, 3))
    fl, by = kernel_work("fused_fit_close", a, got, inp)
    rows.append(("fused_fit_close", a + (clone(),), {}, err, rel, fl, by,
                 dict(fit_obs=float((w_fit * do_fit[:, None, :]).sum()))))

    # ---- fused_round ----
    a = (inp["Yt"], inp["X"], inp["t"], inp["alive"], inp["included"],
         inp["cur_k"], inp["n_last_fit"], in_mon, inp["coefs"], inp["rmse"],
         inp["vario"], init_ok, init["w_stab"], init["n_ok"],
         inp["first_seg"], inp["nseg"])
    kw_round = dict(kw_mon, sensor=inp["sensor"])
    got = cuda_ops.fused_round(*a, clone(), **kw_round)
    want = cuda_ops.fused_round_plain(*a, clone(), **kw_round)
    torch.cuda.synchronize()
    dis["fused_round"] = n_pixels_differing(got[4], want[4])
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        if i == 2:
            torch.testing.assert_close(
                g, w, rtol=5e-3, atol=1e-2,
                msg=lambda m: f"fused_round seg_mag: {m}")
        else:
            check(torch.equal(g, w), f"fused_round buffer {i} differs")
    check(torch.equal(got[1], want[1]), "fused_round nseg differs")
    for k in want[4]:
        n_diff = int((got[4][k] != want[4][k]).sum())
        check(n_diff == 0, f"fused_round {k}: {n_diff} differ")
    dis["fused_round"] += int(check_floats(
        "fused_round", zip(got[2:4], want[2:4]), FIT_TOL,
        inp["sensor"]).sum())
    err = max(float((got[i] - want[i]).abs().max()) for i in (2, 3))
    rel = max(float((got[i] - want[i]).abs().max() / want[i].abs().max())
              for i in (2, 3))
    report["fused_round_seg_mag_max_abs_err"] = float(
        (got[0][2] - want[0][2]).abs().max())
    report["fused_round_events"] = {
        k: int(want[4][k].sum()) for k in ("is_tail", "is_brk", "is_refit",
                                           "do_fit")}
    fl, by = kernel_work("fused_round", a, want, inp)
    w_round = torch.where(init_ok[:, None, :], init["w_stab"],
                          want[4]["included_mon"]
                          & want[4]["is_refit"][:, None, :])
    fit_obs = w_round & want[4]["do_fit"][:, None, :]
    rows.append(("fused_round", a + (clone(),), kw_round, err, rel, fl, by,
                 dict(fit_obs=float(fit_obs.sum()))))
    return rows


EPS32 = 2.0 ** -23
# The decision columns of a segment's meta row: sday, eday, bday, curqa,
# nobs (chprob is a ratio of counts the budget does not cover).
DECISION_META_COLS = (0, 1, 2, 4, 5)


def scaled_ulps(got, want, vector=False):
    """params.MIXED_ULP_BUDGET's metric: |got - want| / (eps32 * scale),
    scale max(|want|, 1), or with ``vector`` max(|coefficient vector|, 1)
    (the last axis)."""
    want = want.double()
    scale = (want.abs().amax(-1, keepdim=True) if vector
             else want.abs()).clamp_min(1.0)
    return (got.double() - want).abs() / (EPS32 * scale)


def budget_report(name, coefs, rmses, report, where=None):
    """Holds a mixed kernel's (coefficients [C,P,...,B,8], RMSE [C,P,...])
    to its plain mixed version's (each a (kernel, plain) pair) within
    MIXED_ULP_BUDGET scaled ulps on at least 0.999 of the pixels [C,P]
    (``where``: those pixels only); records and prints the count outside
    and the largest drifts."""
    cu = scaled_ulps(*coefs, vector=True)
    ru = scaled_ulps(*rmses)
    C, P = cu.shape[:2]
    sel = (torch.ones(C, P, dtype=torch.bool, device=cu.device)
           if where is None else where)
    bad = ((cu.reshape(C, P, -1) > params.MIXED_ULP_BUDGET).any(-1)
           | (ru.reshape(C, P, -1) > params.MIXED_ULP_BUDGET).any(-1)) & sel
    within = 1.0 - float(bad.sum()) / max(float(sel.sum()), 1.0)
    r = report["mixed"][name] = dict(
        pixels_outside=int(bad.sum()), within_budget=within,
        max_coef_ulps=float(cu.reshape(C, P, -1)[sel].max()),
        max_rmse_ulps=float(ru.reshape(C, P, -1)[sel].max()))
    print(f"{name} vs its plain mixed version: {r}", flush=True)
    check(within >= 0.999, f"{name}: {int(bad.sum())} pixels outside "
          f"{params.MIXED_ULP_BUDGET} scaled ulps, {within} < 0.999")
    return bad


def mixed_rows(inp, mon, init, kw_mon, report, f32_rows):
    """The mixed-precision instances of lasso_fit, init_window,
    fused_fit_close and fused_round on the kernel phase's inputs (those of
    their f32 rows), each against its plain mixed version: the exact fields
    equal, the coefficients and RMSE within MIXED_ULP_BUDGET scaled ulps
    on at least 0.999 of the pixels (:func:`budget_report`).  Their bounds
    count the split dots at the bf16 tensor rate, the rest at the float32
    rate."""
    B = inp["Yt"].shape[1]
    report["mixed"] = {}
    dis = report["disagreeing_pixels"]
    f32 = {r[0]: r for r in f32_rows}
    rows = []

    def row(name, pairs, bad, n_obs, nb=B):
        src = cuda_ops.source_of(name)
        _, args, kw, _, _, fl, by, tm = f32[src]
        dis[name] = int(bad.sum())
        err = max((float((g - w).abs().max()) for g, w in pairs), default=0.0)
        rel = max((float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
                   for g, w in pairs), default=0.0)
        return (name, args, dict(kw, mixed=True), err, rel,
                fl - gram_ops(n_obs, nb), by,
                dict(tensor_flops=mixed_dot_ops(n_obs, nb)))

    mx = dict(mixed=True)
    a = f32["lasso_fit"][1]
    got = cuda_ops.lasso_fit(*a, **mx)
    want = cuda_ops.lasso_fit_plain(*a, **mx)
    torch.cuda.synchronize()
    bad = budget_report("lasso_fit_mixed", (got[0], want[0]),
                        (got[1], want[1]), report)
    rows.append(row("lasso_fit_mixed", list(zip(got, want)), bad,
                    f32["lasso_fit"][7]["fit_obs"]))

    a, kw = f32["init_window"][1:3]
    got = cuda_ops.init_window(*a, **kw, **mx)
    want = cuda_ops.init_window_plain(*a, **kw, **mx)
    torch.cuda.synchronize()
    for k in INIT_EXACT:
        n_diff = int((got[k] != want[k]).sum())
        check(n_diff == 0, f"init_window_mixed {k}: {n_diff} differ")
    bad = (got["init_ok"] != want["init_ok"]) | (
        got["init_bad"] != want["init_bad"])
    report["mixed"]["init_window_mixed"] = dict(
        pixels_outside=int(bad.sum()),
        verdict_disagreement=float(bad.float().mean()))
    check(float(bad.float().mean()) <= 1e-3,
          f"init_window_mixed stability verdicts: {int(bad.sum())} differ")
    rows.append(row("init_window_mixed", [], bad,
                    f32["init_window"][7]["fit_obs"], nb=5))

    clone = lambda: tuple(b.clone() for b in inp["bufs"])
    a = f32["fused_fit_close"][1][:-1]
    got = cuda_ops.fused_fit_close(*a, clone(), **mx)
    want = cuda_ops.fused_fit_close_plain(*a, clone(), **mx)
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        check(torch.equal(g, w), f"fused_fit_close_mixed buffer {i} differs")
    check(torch.equal(got[1], want[1]), "fused_fit_close_mixed nseg differs")
    bad = budget_report("fused_fit_close_mixed", (got[2], want[2]),
                        (got[3], want[3]), report)
    rows.append(row("fused_fit_close_mixed", list(zip(got[2:], want[2:])),
                    bad, f32["fused_fit_close"][7]["fit_obs"]))

    a, kw = f32["fused_round"][1][:-1], f32["fused_round"][2]
    got = cuda_ops.fused_round(*a, clone(), **kw, **mx)
    want = cuda_ops.fused_round_plain(*a, clone(), **kw, **mx)
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        if i == 2:
            torch.testing.assert_close(
                g, w, **MAG_TOL, msg=lambda m: f"fused_round_mixed seg_mag: {m}")
        else:
            check(torch.equal(g, w), f"fused_round_mixed buffer {i} differs")
    check(torch.equal(got[1], want[1]), "fused_round_mixed nseg differs")
    for k in want[4]:
        n_diff = int((got[4][k] != want[4][k]).sum())
        check(n_diff == 0, f"fused_round_mixed {k}: {n_diff} differ")
    bad = budget_report("fused_round_mixed", (got[2], want[2]),
                        (got[3], want[3]), report)
    rows.append(row("fused_round_mixed", list(zip(got[2:4], want[2:4])),
                    bad, f32["fused_round"][7]["fit_obs"]))
    return rows


def cd_args(inp, seed, share=1.0):
    """``lasso_cd``'s inputs on the kernel phase's fit windows: the Gram,
    correlations, floored diagonal and coefficient mask.  ``share`` < 1
    keeps the windows of about that share of the pixels (drawn from the
    seed) and empties the others': a late round, where the component route
    hands the kernel every pixel and most have no weight."""
    w = inp["w"]
    if share < 1.0:
        rng = np.random.default_rng(seed + 5)
        keep = torch.from_numpy(rng.random((w.shape[0], w.shape[2]))
                                < share).to(w.device)
        w = w * keep[:, None, :]
    G, c, _ = cuda_ops.gram_plain(inp["Yt"], w, inp["X"])
    diag = torch.diagonal(G, dim1=-2, dim2=-1).clamp_min(1e-12).contiguous()
    return G, c, diag, inp["coefmask"]


def cd_work(a, beta):
    """``lasso_cd``'s bytes and float operations on inputs ``a``: every
    input and the output once, 50 sweeps of 8 updates (~20 operations) for
    each system it must fit (a band with a nonzero correlation); and the
    operations over every system, fitted or not."""
    c = a[1]
    per = 50 * 8 * 20
    n_fit = float((c != 0).any(-1).sum())
    return nbytes(*a, beta), n_fit * per, c[..., 0].numel() * per


def cd_late_round(inp, seed, reps):
    """``lasso_cd`` on a late round's systems (:func:`cd_args` at a tenth
    of the pixels), held to its plain version (the pixels not bit-equal
    counted) and timed beside its bound."""
    a = cd_args(inp, seed, share=0.1)
    got = cuda_ops.lasso_cd(*a)
    want = cuda_ops.lasso_cd_plain(*a)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5,
                               msg=lambda m: f"lasso_cd late round: {m}")
    by, fl, fl_all = cd_work(a, got)
    b_ms, b_by = bound(by, fl)
    ms = cuda_ms(lambda: cuda_ops.lasso_cd(*a), reps)
    share = float((a[1] != 0).any(-1).any(-1).float().mean())
    print(f"kernel lasso_cd late round ({inp['sensor'].name}, "
          f"{100 * share:.2f} % fitting): {ms:.3f} ms, bound {b_ms:.4f} ms "
          f"by {b_by} (over every system {bound(by, fl_all)[0]:.4f} ms)",
          flush=True)
    return dict(fitting_share=share, ms=ms, bound_ms=b_ms, bound_by=b_by,
                bytes=by, flops=fl, flops_every_system=fl_all,
                pixels_not_bit_equal=n_not_bit_equal(got, want))


def n_not_bit_equal(got, want):
    """The count of pixels [C,P] of two [C,P,B,8] float tensors whose bits
    differ anywhere."""
    return int((got.view(torch.int32) != want.view(torch.int32))
               .flatten(2).any(-1).sum())


def component_rows(inp, kw_mon, report, seed, reps):
    """The component route's kernels at full width: ``lasso_cd`` on the
    Gram of the kernel phase's fit windows (and of a late round's,
    :func:`cd_late_round`), ``monitor_chain`` on the score plane of its
    monitor states, ``tmask_bad`` on the windows of its initializing
    pixels."""
    C, B, T, P = inp["Yt"].shape
    rows = []

    # ---- lasso_cd ----
    a = cd_args(inp, seed)
    got = cuda_ops.lasso_cd(*a)
    want = cuda_ops.lasso_cd_plain(*a)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5,
                               msg=lambda m: f"lasso_cd: {m}")
    dis = report["disagreeing_pixels"]
    dis["lasso_cd"] = int((~torch.isclose(got, want, rtol=1e-5, atol=1e-5))
                          .flatten(2).any(-1).sum())
    n_bits = n_not_bit_equal(got, want)
    err = float((got - want).abs().max())
    fl, by = kernel_work("lasso_cd", a, got, inp)
    fl_all = cd_work(a, got)[2]
    report["lasso_cd"] = dict(pixels_not_bit_equal=n_bits, flops=fl,
                              flops_every_system=fl_all,
                              bound_every_system_ms=bound(by, fl_all)[0])
    print(f"lasso_cd ({inp['sensor'].name}): {n_bits} pixels not bit-equal "
          f"to the plain version; operations {fl:.6g} over the systems it "
          f"fits, {fl_all:.6g} over every system", flush=True)
    rows.append(("lasso_cd", a, {}, err, err / float(want.abs().max()),
                 fl, by))
    report["lasso_cd_late_round"] = cd_late_round(inp, seed, reps)

    # ---- monitor_chain ----
    s = cuda_ops.score_plain(inp["Yd"], inp["coefs_d"], inp["dden"],
                             inp["X"])
    a = (s, inp["alive"], inp["included"], inp["cur_k"], inp["n_last_fit"],
         inp["in_mon"])
    got = cuda_ops.monitor_chain(*a, **kw_mon)
    # The kernel gives a pixel that does not monitor the zero outputs.
    want = cuda_ops.monitoring_only(cuda_ops.monitor_chain_plain(*a, **kw_mon),
                                    inp["in_mon"])
    torch.cuda.synchronize()
    dis["monitor_chain"] = n_pixels_differing(got, want)
    for k in want:
        n_diff = int((got[k] != want[k]).sum())
        check(n_diff == 0, f"monitor_chain {k}: {n_diff} differ")
    rows.append(("monitor_chain", a, kw_mon, 0.0, 0.0,
                 *kernel_work("monitor_chain", a, got, inp)))

    # ---- tmask_bad ----
    win = cuda_ops.init_window_gather(
        inp["alive"], inp["cur_i"], inp["in_init"], inp["t"], inp["X"],
        inp["Xt"], inp["Yt"], W=inp["W"])
    a = cuda_ops.tmask_args(win, inp["vario"], inp["sensor"])
    got = cuda_ops.tmask_bad(*a)
    want = cuda_ops.tmask_bad_plain(*a)
    torch.cuda.synchronize()
    n_diff = int((got != want).sum())
    dis["tmask_bad"] = int((got != want).any(-1).sum())
    check(n_diff == 0, f"tmask_bad: {n_diff} flags differ")
    rows.append(("tmask_bad", a, {}, 0.0, 0.0,
                 *kernel_work("tmask_bad", a, got, inp)))
    return rows


def mega_row(staged, W, kw_mon, report, sensor, mixed=False):
    """``detect_mega`` at full width: one launch on the prologue state of
    the main path's batch, against its plain lockstep loop (one run: it
    takes seconds).  The kernel sums its fits' Grams in another order than
    the plain einsum, so the two are held to decision agreement >= 0.999
    (printed) and, on the pixels that agree, the float fields to the fit
    envelope (``mixed``: its mixed instance against the plain mixed loop,
    the coefficients and RMSE within MIXED_ULP_BUDGET scaled ulps).  The
    operations bound sums the INIT, monitor and fit work of the plain
    run's rounds (mixed: the split dots at the bf16 tensor rate); the bytes
    bound counts the spectra and state once and the result buffers at the
    slots written."""
    name = cuda_ops.unit_of("detect_mega", mixed)
    days, n_obs, spectra, qa = staged
    X, Xt, t, valid = kernel.device_designs(days, n_obs)
    Yt = spectra.transpose(2, 3).contiguous()
    qa_t = qa.transpose(1, 2).contiguous().to(torch.int32)
    S = kernel.MAX_SEGMENTS
    res, st = kernel._prologue(X, Xt, t, valid, Yt, qa_t, sensor=sensor,
                               S=S, variogram_mode=params.VARIOGRAM_DEFAULT,
                               ops=cuda_ops.KERNELS)
    C, B, T, P = Yt.shape
    check(cuda_ops.mega_fits(T, W), f"detect_mega refuses T={T}, W={W}")
    clone = lambda: tuple(b.clone() for b in st["bufs"])
    a = (Yt, st["phase"], st["cur_i"], st["alive"], st["nseg"])
    tail = (t, X, Xt, res["vario"])
    kw = dict(W=W, sensor=sensor, mixed=mixed, **kw_mon)
    got = cuda_ops.detect_mega(*a, clone(), *tail, **kw)
    work = dict(init=0.0, monitor=0.0, fit=0.0)
    obs = dict(init=0.0, fit=0.0)

    def count(s, init, ev):
        in_init = s["phase"] == kernel.PHASE_INIT
        n = window_sizes(dict(alive=s["alive"], t=t, cur_i=s["cur_i"],
                              in_init=in_init)).double()
        work["init"] += init_flops(n[n > 0])
        obs["init"] += float(n.sum())
        in_mon = s["phase"] == kernel.PHASE_MONITOR
        work["monitor"] += float((s["alive"] & in_mon[:, None, :]).sum()) * 5 * 19
        w = torch.where(init["init_ok"][:, None, :], init["w_stab"],
                        ev["included_mon"] & ev["is_refit"][:, None, :])
        work["fit"] += fit_flops(w.float(), ev["do_fit"], B)
        obs["fit"] += float((w & ev["do_fit"][:, None, :]).sum())

    want = cuda_ops.detect_mega_plain(*a, clone(), *tail, **kw,
                                      on_round=count)
    torch.cuda.synchronize()
    view = lambda o: types.SimpleNamespace(
        n_segments=o["nseg"], seg_meta=o["meta"], procedure=res["procedure"],
        mask=o["alive"].transpose(1, 2))
    same = agreeing(view(got), view(want))
    agree, n_dis = float(same.float().mean()), int((~same).sum())
    print(f"{name} vs its plain loop: decision agreement {agree} "
          f"({n_dis} pixels differ), rounds {got['rounds'].tolist()} / "
          f"{want['rounds'].tolist()}", flush=True)
    check(agree >= 0.999, f"{name} decision agreement {agree} < 0.999")
    err = rel = 0.0
    bad = ~same
    for k in ("rmse", "mag", "coef"):
        tol = MAG_TOL if k == "mag" else FIT_TOL
        if k == "mag" or not mixed:
            bad |= check_floats(f"{name} {k}", [(got[k], want[k])], tol,
                                sensor, where=same)
        g, w = got[k][same], want[k][same]
        e = float((g - w).abs().max())
        err, rel = max(err, e), max(rel, e / max(float(w.abs().max()), 1e-30))
    if mixed:
        bad |= budget_report(name, (got["coef"], want["coef"]),
                             (got["rmse"], want["rmse"]), report, where=same)
        report["mixed"][name].update(decision_agreement=agree,
                                     pixels_outside=int(bad.sum()))
    report["disagreeing_pixels"][name] = int(bad.sum())
    report[name] = dict(
        decision_agreement=agree, pixels_disagreeing=n_dis,
        rounds=got["rounds"].tolist(), rounds_plain=want["rounds"].tolist(),
        counts=got["counts"].tolist(), counts_plain=want["counts"].tolist(),
        flops=work, fit_obs=obs)
    row_bytes = (6 + 2 * B + B * 8) * 4
    n_rows = float((got["nseg"].clamp_max(S) - st["nseg"].clamp_max(S)).sum())
    by = (nbytes(*a, *tail, got["nseg"], got["rounds"]) + C * T * P
          + n_rows * row_bytes + C * 3 * (2 * T + 8) * 4)
    fl, tensor = sum(work.values()), 0.0
    if mixed:
        fl -= gram_ops(obs["fit"], B) + gram_ops(obs["init"], 5)
        tensor = mixed_dot_ops(obs["fit"], B) + mixed_dot_ops(obs["init"], 5)
    return (name, a + (clone(),) + tail, kw, err, rel, fl, by,
            dict(reps=3, plain_reps=1, plain_warm=0, tensor_flops=tensor))


def ring_payload(ints, bits, flts, T, chips=4, bucket=2048, B=7):
    """The leaves of one shard's migration-out payload at full width: a
    stage-2 carry of ``chips`` 100x100 chips at the ``bucket``-lane bucket
    (route 0's loop state, result buffers and residents, the permutation),
    its designs and its donation mask, each drawn by ``ints(hi, shape,
    dtype)``, ``bits(shape)`` or ``flts(shape)``."""
    C, P, S = chips, bucket, kernel.MAX_SEGMENTS
    resident = dict(vario=lambda: flts((C, P, B)),
                    Yt=lambda: ints(8000, (C, B, T, P), np.int16),
                    Yd=lambda: ints(8000, (C, 5, T, P), np.int16))
    return [ints(3, (C, P)), ints(T, (C, P)), ints(T, (C, P)),
            bits((C, T, P)), bits((C, T, P)), flts((C, P, B, 8)),
            flts((C, P, B)), ints(T, (C, P)), bits((C, P)),
            ints(S + 1, (C, P)),
            *(flts((C, P, S) + k) for k in ((6,), (B,), (B,), (B, 8))),
            *(resident[k]() for k in kernel.resident_keys(0)),
            ints(P, (C, P), np.int64), ints(P, (C,)),
            flts((C, T, 8)), flts((C, T, 5)), flts((C, T)), bits((C, P))]


def ring_row(seed, T, dev, report, chips=4, bucket=2048):
    """``ring_remote_copy`` at full width: the migration-out hop of the
    sharded path's two shards of ``chips`` chips on the card, each
    shard's payload a stage-2 carry at the 2048-lane bucket of 100x100
    chips (:func:`ring_payload`), drawn from the seed.  Byte-equal to the
    plain per-tensor copy and to the sources; the library call is one
    ``torch._foreach_copy_`` over the same tensors."""
    rng = np.random.default_rng(seed + 2)
    g = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    ints = lambda hi, shape, dt=np.int32: g(rng.integers(0, hi, shape)
                                            .astype(dt))
    bits = lambda shape: g(rng.random(shape) < 0.5)
    flts = lambda shape: g(rng.standard_normal(shape).astype(np.float32))

    def payload():
        return ring_payload(ints, bits, flts, T, chips, bucket)

    payloads = [payload() for _ in range(SHARDS)]
    raw = lambda t: t.reshape(-1).view(torch.uint8)
    got = cuda_ops.ring_remote_copy(payloads, 1)
    want = cuda_ops.ring_remote_copy_plain(payloads, 1)
    torch.cuda.synchronize()
    for i in range(SHARDS):
        j = (i + 1) % SHARDS
        for k, (a, b, src) in enumerate(zip(got[j], want[j], payloads[i])):
            check(a.device == src.device and a.data_ptr() != src.data_ptr(),
                  f"ring_remote_copy shard {i} tensor {k}: not a new buffer")
            check(torch.equal(raw(a), raw(b)) and torch.equal(raw(a), raw(src)),
                  f"ring_remote_copy shard {i} tensor {k} differs")
    total = sum(nbytes(*p) for p in payloads)
    report["ring_remote_copy"] = dict(shards=SHARDS, chips=chips,
                                      bucket=bucket,
                                      tensors=len(payloads[0]),
                                      payload_bytes=total)
    print(f"ring_remote_copy: {SHARDS} shards x {len(payloads[0])} tensors, "
          f"{total / 1e6:.1f} MB a hop, byte-equal to its plain version",
          flush=True)
    dsts = [torch.empty_like(t) for p in payloads for t in p]
    srcs = [t for p in payloads for t in p]
    return ("ring_remote_copy", (payloads, 1), {}, 0.0, 0.0, 0.0, 2 * total,
            dict(library=lambda: torch._foreach_copy_(dsts, srcs)))


# ---------------------------------------------------------------------------
# Main paths
# ---------------------------------------------------------------------------

def agreeing(a, b):
    """The pixels [C,P] whose decision fields agree in two batched results:
    segment count, procedure, processing mask, and every meta column of
    the closed segments."""
    S = min(a.seg_meta.shape[2], b.seg_meta.shape[2])
    n = a.n_segments
    slot = torch.arange(S, device=n.device) < n[..., None].clamp_max(S)
    meta_eq = ((a.seg_meta[:, :, :S] == b.seg_meta[:, :, :S]).all(-1)
               | ~slot).all(-1)
    return ((a.n_segments == b.n_segments) & (a.procedure == b.procedure)
            & (a.mask == b.mask).all(-1) & meta_eq)


def decision_agreement(a, b):
    """The fraction of pixels whose decision fields agree (:func:`agreeing`)
    and the count of those that do not."""
    agree = agreeing(a, b)
    return float(agree.float().mean()), int((~agree).sum())


def check_result(seg, C, P, T):
    check(seg.n_segments.shape == (C, P), "n_segments shape")
    check(seg.mask.shape == (C, P, T), "mask shape")
    check(seg.seg_meta.shape[:2] == (C, P), "seg_meta shape")
    for f in ("seg_meta", "seg_rmse", "seg_mag", "seg_coef", "vario"):
        check(bool(torch.isfinite(getattr(seg, f)).all()), f"{f} not finite")
    check(int(seg.n_segments.min()) >= 0, "negative segment count")


def make_chips(src, cids, acquired=None):
    """``src.chip`` of each id, made by a thread a core (the synthetic
    source's numpy releases the GIL; a chip depends on its id alone)."""
    import concurrent.futures as cf

    with cf.ThreadPoolExecutor(os.cpu_count() or 1) as ex:
        return list(ex.map(lambda c: src.chip(c[0], c[1], acquired), cids))


def make_batch(seed, n_chips, dev):
    """``n_chips`` full-size Landsat ARD chips of a 1985-2017 archive,
    packed and staged on the card."""
    src = SyntheticSource(seed, start=START, end=END)
    t0 = time.perf_counter()
    packed = pack(make_chips(src, [(1000 * c, 2000)
                                   for c in range(n_chips)]), bucket=64)
    gen_s = time.perf_counter() - t0
    staged = kernel.stage_packed(packed, dev)
    torch.cuda.synchronize()
    return packed, staged, gen_s


def route_path(packed, staged, smi, name, label=""):
    """One route's main path: ``detect_packed`` on the card with the launch
    counters read around it, then the same route through the plain
    versions on the card.  ``label`` prefixes the printed lines."""
    C, B, P, T = packed.spectra.shape
    kw, expect = ROUTES[name]
    torch.cuda.reset_peak_memory_stats()
    cuda_ops.reset_launches()
    t0 = time.perf_counter()
    seg = kernel.detect_packed(packed, staged=staged, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(cuda_ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    # Again, with the allocator's cache warm from the first run (the first
    # route pays the cold start after the kernel phase).
    t0 = time.perf_counter()
    kernel.detect_packed(packed, staged=staged, **kw)
    torch.cuda.synchronize()
    warm_secs = time.perf_counter() - t0
    launched = {k for k, n in launches.items() if n > 0}
    check(launched == expect,
          f"route {name!r} launched {sorted(launched)}, expected "
          f"{sorted(expect)}")
    refused = dict(cuda_ops.REFUSED)
    if kw["pallas"] == "mega":
        # The shape is the card's (cuda_ops.mega_fits): no dispatch fell
        # back to the round loop; one prologue lasso_fit and one
        # detect_mega a dispatch.
        check(cuda_ops.mega_fits(T, kernel.window_cap(packed))
              and refused["detect_mega"] == 0,
              f"mega route: T={T}, W={kernel.window_cap(packed)} refused "
              f"({refused})")
        mega, fit = (cuda_ops.unit_of(k, kw["mixed"])
                     for k in ("detect_mega", "lasso_fit"))
        check(launches[mega] == launches[fit],
              f"route {name!r}: {launches[mega]} {mega} launches for "
              f"{launches[fit]} dispatches")
    check_result(seg, C, P, T)
    occ = occupancy_summary(seg, P) if kw.get("compact") else None
    if occ is not None:
        print(f"route {name!r}: {occ}", flush=True)

    t0 = time.perf_counter()
    ref = kernel.detect_packed(packed, staged=staged, ops=cuda_ops.PLAIN,
                               **kw)
    torch.cuda.synchronize()
    plain_secs = time.perf_counter() - t0
    agree, n_dis = decision_agreement(seg, ref)
    print(f"{label}main path, route {name!r}: {C} chips x {P} px, T={T}: "
          f"{secs:.3f} s, {C * P / secs:.1f} px/s on {smi} (again: "
          f"{warm_secs:.3f} s), rounds {seg.rounds.tolist()}, launches "
          f"{launches}, peak {peak / 2**30:.2f} GiB; plain route "
          f"{plain_secs:.3f} s; decision agreement {agree} ({n_dis} pixels "
          f"differ)", flush=True)
    check(agree >= 0.999, f"route {name!r}: decision agreement {agree} "
          f"< 0.999")
    return seg, dict(route=name, chips=C, pixels=C * P, T=T,
                     seconds=secs, pixels_per_s=C * P / secs,
                     seconds_again=warm_secs,
                     rounds=seg.rounds.tolist(),
                     round_counts=seg.round_counts.tolist(),
                     segments=int(seg.n_segments.sum()), launches=launches,
                     refused=refused, peak_bytes=peak,
                     plain_seconds=plain_secs, decision_agreement=agree,
                     pixels_disagreeing=n_dis, occupancy=occ)


def compact_path(packed, staged, smi, name, base):
    """A compacted route (COMPACT_OF): ``detect_packed`` once on the card
    with the launch counters read around it (every kernel of the route
    runs its skip guard), its occupancy, and every result field against
    the same route with compaction off (``base``, from :func:`route_path`):
    equal, and the float fields equal bit for bit."""
    C, B, P, T = packed.spectra.shape
    kw, expect = ROUTES[name]
    cuda_ops.reset_launches()
    t0 = time.perf_counter()
    seg = kernel.detect_packed(packed, staged=staged, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(cuda_ops.LAUNCHES)
    launched = {k for k, n in launches.items() if n > 0}
    check(launched == expect, f"route {name!r} launched {sorted(launched)}, "
          f"expected {sorted(expect)}")
    check_result(seg, C, P, T)
    occ = occupancy_summary(seg, P)
    label = f"route {name!r} vs route {COMPACT_OF[name]!r}"
    vs = compare_routes(seg, base, label, ())
    n_bits = sum(int((bits(getattr(seg, f)) != bits(getattr(base, f))).sum())
                 for f in SEGMENT_FIELDS)
    check(n_bits == 0, f"{label}: {n_bits} elements differ in their bits")
    print(f"main path, route {name!r}: {C} chips x {P} px, T={T}: "
          f"{secs:.3f} s on {smi}, rounds {seg.rounds.tolist()}, launches "
          f"{launches}; {occ}", flush=True)
    return dict(route=name, chips=C, pixels=C * P, T=T, seconds=secs,
                pixels_per_s=C * P / secs, rounds=seg.rounds.tolist(),
                round_counts=seg.round_counts.tolist(),
                segments=int(seg.n_segments.sum()), launches=launches,
                occupancy=occ, **{f"vs_route_{COMPACT_OF[name]}": vs},
                bits_differing=n_bits)


def occupancy_summary(seg, P):
    """A compacted run's compactions and occupancy: the lane-rounds that
    entered a round still working, those the JAX package's per-block
    (512-lane) guards would pay for (compact.paid_lanes: this port's
    kernels skip per 32-pixel tile, so an upper bound on what they pay),
    the padded width's, and per chip the rounds whose paid lanes fit the
    stage-2 bucket (the bucketed tail's rounds)."""
    occ = seg.occupancy.double()
    bucket = kernel.tail_bucket(P, kernel.compact_floor())
    ran = (torch.arange(occ.shape[1], device=occ.device)[None, :]
           < seg.rounds[:, None])
    return dict(compactions=int(seg.compactions.sum()),
                rounds=seg.rounds.tolist(), bucket=bucket,
                rounds_within_bucket=((occ[..., 1] <= bucket) & ran).sum(
                    1).tolist(),
                active_lane_rounds=float(occ[..., 0].sum()),
                paid_lane_rounds=float(occ[..., 1].sum()),
                padded_lane_rounds=float(P * seg.rounds.sum()))


def ragged_batch(packed):
    """The sharded path's batch: the main path's chips, the second shard's
    chips keeping a strip of land a tenth of the chip high (10 rows, 1000
    pixels of a 100x100 chip) with the other rows QA fill, as coastal and
    CONUS-border chips are mostly water or no data.  It leaves the shards
    a gap in working lanes at the tail."""
    qas = packed.qas.copy()
    qas[packed.n_chips // SHARDS:, qas.shape[1] // 10:, :] = \
        1 << params.QA_FILL_BIT
    return dataclasses.replace(packed, qas=qas)


def n_dispatches(seg, packed):
    """The dispatches capacity_retry made to reach ``seg``'s capacity."""
    S, n, bound = kernel.MAX_SEGMENTS, 1, kernel.capacity_bound(packed)
    while S < seg.seg_meta.shape[2]:
        S, n = min(2 * S, bound), n + 1
    return n


def store_diff(seg, base):
    return [f for f in STORE_FIELDS
            if not torch.equal(getattr(seg, f), getattr(base, f))]


def sharded_path(packed, smi, keep=None):
    """The sharded main path: ``detect_sharded`` over two shards on the
    card (route 0, compaction and the rebalancing ring on), the launch
    counters set to 0 just before and read just after.  The ring must
    migrate lanes, with three ``ring_remote_copy`` hops of one launch per
    shard a dispatch; the store fields must equal the ring-off dispatch
    and the unsharded "0+compact" route on the same batch, and the same
    dispatch through the plain versions must agree in the decisions of
    at least 0.999 of the pixels.  ``keep`` (a dict) receives the store
    fields and ``lanes_migrated`` as numpy arrays."""
    C, B, P, T = packed.spectra.shape
    devices = ["cuda:0"] * SHARDS
    torch.cuda.reset_peak_memory_stats()
    cuda_ops.reset_launches()
    t0 = time.perf_counter()
    seg = detect_sharded(packed, devices, rebalance=True, **SHARDED)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(cuda_ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    launched = {k for k, n in launches.items() if n > 0}
    expect = ROUTE_0 | {"ring_remote_copy"}
    check(launched == expect, f"sharded path launched {sorted(launched)}, "
          f"expected {sorted(expect)}")
    hops = 3 * SHARDS * n_dispatches(seg, packed)
    check(launches["ring_remote_copy"] == hops,
          f"sharded path: {launches['ring_remote_copy']} ring_remote_copy "
          f"launches, expected {hops}")
    migrated = seg.lanes_migrated.tolist()
    check(sum(migrated) > 0, f"the ring migrated no lanes: {migrated}")
    check_result(seg, C, P, T)
    occ = occupancy_summary(seg, P)
    if keep is not None:
        # The store fields and migrated lanes, for mp_ring_phase's (a).
        keep.update({f: getattr(seg, f).cpu().numpy()
                     for f in STORE_FIELDS + ("lanes_migrated",)},
                    T=T, dispatches=n_dispatches(seg, packed))

    t0 = time.perf_counter()
    off = detect_sharded(packed, devices, rebalance=False, **SHARDED)
    torch.cuda.synchronize()
    off_secs = time.perf_counter() - t0
    t0 = time.perf_counter()
    whole = kernel.detect_packed(packed, **SHARDED)
    torch.cuda.synchronize()
    whole_secs = time.perf_counter() - t0
    vs = {}
    for label, base in (("ring_off", off), ("unsharded_0+compact", whole)):
        vs[label] = store_diff(seg, base)
        print(f"sharded vs {label}: store fields differing {vs[label]}",
              flush=True)
        check(not vs[label], f"sharded path vs {label}: {vs[label]} differ")
    del off, whole
    t0 = time.perf_counter()
    ref = detect_sharded(packed, devices, rebalance=True, ops=cuda_ops.PLAIN,
                         **SHARDED)
    torch.cuda.synchronize()
    plain_secs = time.perf_counter() - t0
    agree, n_dis = decision_agreement(seg, ref)
    print(f"main path 'sharded': {SHARDS} shards on {devices[0]}, {C} chips x "
          f"{P} px ({int(((packed.qas & 1) == 0).any(-1).sum())} not fill), "
          f"T={T}: {secs:.3f} s, {C * P / secs:.1f} px/s on {smi}, rounds "
          f"{seg.rounds.tolist()}, lanes migrated {migrated}, launches "
          f"{launches}, peak {peak / 2**30:.2f} GiB, {occ}; ring off "
          f"{off_secs:.3f} s, unsharded {whole_secs:.3f} s; plain route "
          f"{plain_secs:.3f} s; decision agreement {agree} ({n_dis} pixels "
          f"differ)", flush=True)
    check(agree >= 0.999, f"sharded path: decision agreement {agree} < 0.999")
    return dict(route="sharded", shards=SHARDS, devices=devices, chips=C,
                pixels=C * P, T=T, seconds=secs, pixels_per_s=C * P / secs,
                rounds=seg.rounds.tolist(),
                round_counts=seg.round_counts.tolist(),
                segments=int(seg.n_segments.sum()), launches=launches,
                lanes_migrated=migrated, peak_bytes=peak,
                ring_off_seconds=off_secs, unsharded_seconds=whole_secs,
                plain_seconds=plain_secs, decision_agreement=agree,
                pixels_disagreeing=n_dis, store_fields_differing=vs,
                occupancy=occ)


def compare_routes(seg, base, label, allowed):
    """A route against another on the card: every field equal but those
    in ``allowed``; seg_mag, where allowed to differ, within rtol 5e-3,
    atol 1e-2 (the in-kernel median).  Returns the fields that differ and
    the count of pixels that differ in any per-pixel field."""
    C, P = base.n_segments.shape
    differ = torch.zeros(C, P, dtype=torch.bool, device=base.n_segments.device)
    fields = []
    for f in SEGMENT_FIELDS:
        a, b = getattr(seg, f), getattr(base, f)
        if not torch.equal(a, b):
            fields.append(f)
            if a.shape[:2] == (C, P):
                differ |= (a != b).reshape(C, P, -1).any(-1)
    n_px = int(differ.sum())
    print(f"{label}: fields differing {fields}, {n_px} pixels differ",
          flush=True)
    check(set(fields) <= set(allowed), f"{label}: differs in {fields}")
    out = dict(fields_differing=fields, pixels_differing=n_px)
    if "seg_mag" in fields:
        mag_px = (seg.seg_mag != base.seg_mag).reshape(C, P, -1).any(-1)
        out["seg_mag_pixels"] = torch.nonzero(mag_px)[:20].tolist()
        print(f"{label}: seg_mag differs on {int(mag_px.sum())} pixels, "
              f"first (chip, pixel): {out['seg_mag_pixels']}", flush=True)
        torch.testing.assert_close(seg.seg_mag, base.seg_mag, rtol=5e-3,
                                   atol=1e-2)
    return out


def egress(seg, packed):
    """Egress packing and decoding and the store's table frames of one
    chip."""
    T = packed.spectra.shape[-1]
    P = packed.spectra.shape[2]
    worst = int(seg.n_segments.max())
    s_eff = kernel.egress_bucket(worst, seg.seg_meta.shape[2])
    tables = kernel.pack_egress(seg, s_eff)
    dec = fmt.decode_egress(tables, T)
    host = kernel.segments_to_numpy(seg)
    check(np.array_equal(dec.seg_meta, host.seg_meta[:, :, :s_eff]),
          "egress meta round trip")
    check(np.array_equal(dec.mask, host.mask), "egress mask round trip")
    frames = fmt.batch_frames(packed, dec, n_real=1)
    n_rows = len(frames[0][1]["segment"]["sday"])
    check(n_rows >= P, "segment frame rows")
    return dict(egress_s_eff=s_eff, segment_rows_chip0=n_rows)


def small_input(seed, dev):
    """Two 10x10 chips through the kernels on the card and through the
    plain versions on the CPU (the route the tests hold to the JAX
    package)."""
    src = SyntheticSource(seed, start="1995-01-01", end="1999-06-01",
                          sensor=LANDSAT_ARD_TINY, n_changes=2)
    packed = pack([src.chip(100, 200), src.chip(3100, 200)], bucket=32)
    a = kernel.detect_packed(packed, device=dev)
    b = kernel.detect_packed(packed, device="cpu")
    b = kernel.ChipSegments(*[None if v is None else v.to(dev)
                              for v in vars(b).values()])
    agree, n_dis = decision_agreement(a, b)
    print(f"small input: decision agreement card vs cpu {agree} "
          f"({n_dis} of {a.n_segments.numel()} pixels differ)", flush=True)
    check(agree >= 0.99, f"small-input agreement {agree}")
    return dict(agreement=agree, pixels_disagreeing=n_dis)


def ptxas_summary(name):
    """Registers, stack and spill bytes of each entry function of a
    kernel's source (each template instance: the band count, the window
    instance) from its build's ``-Xptxas -v`` report, keyed by the kernel's
    name and template arguments."""
    text = (cuda_ops.BUILD_DIR / f"{name}.ptxas.txt").read_text()
    out = {}
    for chunk in text.split("Compiling entry function '")[1:]:
        fn = chunk.split("'", 1)[0]
        m = re.search(r"([a-z][a-z_]*_kernel)(I(?:Li\d+E)+E)?", fn)
        targs = re.findall(r"Li(\d+)E", m.group(2) or "") if m else []
        key = fn if m is None else m.group(1) + (
            f"<{','.join(targs)}>" if targs else "")
        grab = lambda pat: int((re.search(pat, chunk) or [0, 0])[1])
        out[key] = dict(registers=grab(r"Used (\d+) registers"),
                        stack_bytes=grab(r"(\d+) bytes stack frame"),
                        spill_stores=grab(r"(\d+) bytes spill stores"),
                        spill_loads=grab(r"(\d+) bytes spill loads"))
    return out


# The tile kernels' dynamic shared memory a block at T (csrc/tile.cuh).
TILE_SMEM = {"lasso_fit": cuda_ops.lasso_fit_smem_bytes,
             "monitor_chain_scored": cuda_ops.monitor_chain_scored_smem_bytes,
             "fused_round": cuda_ops.fused_round_smem_bytes,
             "fused_fit_close": cuda_ops.fused_fit_close_smem_bytes,
             "detect_mega": cuda_ops.detect_mega_smem_bytes,
             "monitor_chain": cuda_ops.monitor_chain_smem_bytes}


def ptxas_report(T, smi):
    """Every kernel instance's registers, stack and spills, and the tile
    kernels' shared memory at ``T`` (printed; returned by source)."""
    out = {}
    for name in cuda_ops.UNITS:
        out[name] = ptxas_summary(name)
        smem = TILE_SMEM.get(cuda_ops.source_of(name))
        for key, v in out[name].items():
            if smem is not None:
                v["dynamic_smem_bytes_at_T"] = smem(T)
            print(f"ptxas {name} {key} on {smi}: {v}", flush=True)
    return out


def redesign_report(kernels, paths, T, smi, nb=7):
    """What the redesigned kernels are judged by: registers, shared memory,
    spills and resident blocks an SM of fused_round, fused_fit_close and
    each window instance of detect_mega (``nb`` bands, at ``T``), of
    init_window (at ``T``), of tmask_bad, of lasso_cd (``nb`` bands) and of
    monitor_chain (at ``T``), those of lasso_fit and monitor_chain_scored;
    each kernel's time beside its bound; the ring's achieved rate; the
    walls of routes "mon", 1 and mega beside route 0's."""
    geo = cuda_ops.kernel_geometry(T, nb)
    out = {}
    for name in ("fused_round", "fused_fit_close", "detect_mega",
                 "init_window", "tmask_bad", "ring_remote_copy"):
        out[name] = dict(instances=ptxas_summary(name), geometry=geo[name])
        if name in kernels:
            out[name].update(ms=kernels[name]["ms"],
                             bound_ms=kernels[name]["bound_ms"])
        print(f"{name} ({nb} bands) on {smi}: {out[name]}", flush=True)
    for name in ("lasso_fit", "monitor_chain_scored"):
        row = kernels[name]
        out[name] = dict(instances=ptxas_summary(name),
                         smem_bytes=TILE_SMEM[name](T), ms=row["ms"],
                         bound_ms=row["bound_ms"])
        print(f"{name} (redesigned) on {smi}: {out[name]}", flush=True)
    for name in ("lasso_cd", "monitor_chain"):
        row = kernels[name]
        out[name] = dict(instances=ptxas_summary(name), geometry=geo[name],
                         ms=row["ms"], bound_ms=row["bound_ms"],
                         bound_by=row["bound_by"])
        print(f"{name} ({nb} bands, redesigned) on {smi}: {out[name]}",
              flush=True)
    # The mixed instances (their shared memory is the f32 instances').
    geo = cuda_ops.kernel_geometry(T, nb, mixed=True)
    geo["lasso_fit"] = dict(smem_bytes=TILE_SMEM["lasso_fit"](T))
    for name in cuda_ops.MIXED_SOURCES:
        unit = cuda_ops.unit_of(name, True)
        out[unit] = dict(instances=ptxas_summary(unit), geometry=geo[name])
        if unit in kernels:
            out[unit].update(ms=kernels[unit]["ms"],
                             bound_ms=kernels[unit]["bound_ms"],
                             f32_ms=kernels[name]["ms"])
        print(f"{unit} ({nb} bands) on {smi}: {out[unit]}", flush=True)
    ring = kernels.get("ring_remote_copy")
    if ring is not None:
        rate = out["ring_remote_copy"]
        rate["tb_per_s"] = ring["bytes"] / ring["ms"] / 1e9
        rate["library_tb_per_s"] = ring["bytes"] / ring["library_ms"] / 1e9
        print(f"ring_remote_copy: {rate['tb_per_s']:.3f} TB/s "
              f"({ring['ms']:.3f} ms), torch._foreach_copy_ "
              f"{rate['library_tb_per_s']:.3f} TB/s "
              f"({ring['library_ms']:.3f} ms), peak {HBM_BYTES_S / 1e12} "
              f"TB/s", flush=True)
    walls = {r: (paths[r]["seconds"], paths[r]["seconds_again"])
             for r in ("0", "1", "mon", "mega") + tuple(
                 r + MIXED for r in ("0", "1", "mon", "mega"))
             if r in paths}
    out["walls"] = walls
    print(f"walls (first run, again) on {smi}: " + ", ".join(
        f"route {r!r} {a:.3f} / {b:.3f} s" for r, (a, b) in walls.items()),
        flush=True)
    return out


def mixed_vs_f32(mx, f32, label=""):
    """A mixed route's result against the same route's f32 result: the
    fraction of pixels whose decisions agree (at least 0.999), the count
    that do not, and the largest scaled-ulp drift of the agreeing pixels'
    segment coefficients and RMSE (printed)."""
    same = agreeing(mx, f32)
    agree, n_dis = float(same.float().mean()), int((~same).sum())
    coef = float(scaled_ulps(mx.seg_coef, f32.seg_coef, vector=True)[same]
                 .max())
    rmse = float(scaled_ulps(mx.seg_rmse, f32.seg_rmse)[same].max())
    # The pixels that decide differently, as [chip, pixel] (at most 64).
    named = (~same).nonzero().tolist()[:64]
    print(f"{label}mixed route '0' vs f32 route '0': decision agreement "
          f"{agree} ({n_dis} pixels differ: [chip, pixel] {named}), largest "
          f"drift {coef} coef / {rmse} rmse scaled ulps (budget "
          f"{params.MIXED_ULP_BUDGET})", flush=True)
    check(agree >= 0.999, f"{label}mixed vs f32: decision agreement {agree}")
    return dict(decision_agreement=agree, pixels_disagreeing=n_dis,
                disagreeing_pixels=named, max_coef_ulps=coef,
                max_rmse_ulps=rmse)


# The threshold-fuzz chip of tests/test_precision.py: 32 pixels of a
# 1995-1997 archive whose change scores sit at the detection threshold.
FUZZ_SEED = 11
FUZZ_P = 32


def fuzz_packed(seed=FUZZ_SEED):
    """tests/test_precision.py's threshold-fuzz chip, from the port's copy
    of the synthetic series: breaks, spikes, a ladder of marginal steps
    bracketing the detection threshold, an init-starved pixel and fill
    (tests/test_torch_mixed_routes.py holds it to the JAX package's)."""
    rng = np.random.default_rng(seed)
    t = synthetic.acquisition_dates("1995-01-01", "1997-06-01", 16)
    T = t.shape[0]
    px = []
    for i in range(8):
        Y = synthetic.harmonic_series(t, rng)
        if i % 2 == 0:
            Y[:, T // 2:] += 800.0
        if i % 3 == 0:
            Y[:, rng.integers(0, T)] += 2500
        px.append((Y, np.full(T, synthetic.QA_CLEAR, np.uint16)))
    for i in range(8):
        Y = synthetic.harmonic_series(t, rng)
        Y[:, T // 2:] += 85.0 + 6.0 * i
        px.append((Y, np.full(T, synthetic.QA_CLEAR, np.uint16)))
    qs = np.full(T, synthetic.QA_CLOUD, np.uint16)
    qs[:: max(T // 5, 1)] = synthetic.QA_CLEAR
    px.append((synthetic.harmonic_series(t, rng), qs))
    while len(px) < FUZZ_P:
        px.append((np.full((7, T), params.FILL_VALUE, np.float64),
                   np.full(T, synthetic.QA_FILL, np.uint16)))
    px = [px[i] for i in rng.permutation(FUZZ_P)]
    Ys, qas = zip(*px)
    spectra = np.stack([np.asarray(Y, np.int16) for Y in Ys])
    return PackedChips(cids=np.zeros((1, 2), np.int64),
                       dates=t[None].astype(np.int32),
                       spectra=spectra.transpose(1, 0, 2)[None],
                       qas=np.stack(qas)[None],
                       n_obs=np.array([T], np.int32))


def fuzz_phase(dev):
    """The threshold-fuzz chip on the card (tools/precision_smoke.py's
    contract): on routes 0, 1, "mon" and mega, mixed against f32 with
    identical decisions (segment counts, masks, procedures, rounds, meta
    columns 0, 1, 2, 4, 5) and the coefficients and RMSE within
    MIXED_ULP_BUDGET scaled ulps."""
    packed = fuzz_packed()
    out = {}
    for name in ("0", "1", "mon", "mega"):
        kw = {k: v for k, v in ROUTES[name][0].items() if k != "mixed"}
        f32 = kernel.detect_packed(packed, device=dev, mixed=False, **kw)
        mx = kernel.detect_packed(packed, device=dev, mixed=True, **kw)
        for f in ("n_segments", "mask", "procedure", "rounds"):
            check(torch.equal(getattr(mx, f), getattr(f32, f)),
                  f"fuzz chip route {name!r}: mixed {f} differs from f32")
        cols = list(DECISION_META_COLS)
        check(torch.equal(mx.seg_meta[..., cols], f32.seg_meta[..., cols]),
              f"fuzz chip route {name!r}: mixed meta differs from f32")
        coef = float(scaled_ulps(mx.seg_coef, f32.seg_coef, True).max())
        rmse = float(scaled_ulps(mx.seg_rmse, f32.seg_rmse).max())
        out[name] = dict(max_coef_ulps=coef, max_rmse_ulps=rmse,
                         segments=int(mx.n_segments.sum()))
        print(f"fuzz chip route {name!r}: mixed decisions identical to f32, "
              f"drift {coef} coef / {rmse} rmse scaled ulps (budget "
              f"{params.MIXED_ULP_BUDGET})", flush=True)
        check(max(coef, rmse) <= params.MIXED_ULP_BUDGET,
              f"fuzz chip route {name!r}: drift over the budget")
    return out


# The tensor-core instruction the mixed instances' split dots compile to.
HMMA = "HMMA"


def sass_report(libs):
    """The count of HMMA (tensor-core mma) instructions in each fitting
    kernel's built library (``cuobjdump -sass``): at least one in every
    mixed instance, none in the f32 instances."""
    exe = next((p for p in (shutil.which("cuobjdump"),
                            "/usr/local/cuda/bin/cuobjdump") if p
                and Path(p).exists()), None)
    check(exe is not None, "cuobjdump not found: the SASS check needs it")
    out = {}
    for unit, path in libs.items():
        if cuda_ops.source_of(unit) not in cuda_ops.MIXED_SOURCES:
            continue
        sass = subprocess.run([exe, "-sass", str(path)], capture_output=True,
                              text=True, check=True).stdout
        out[unit] = sass.count(HMMA)
        mixed = unit != cuda_ops.source_of(unit)
        check((out[unit] > 0) == mixed,
              f"{unit}: {out[unit]} {HMMA} instructions in its SASS")
    print(f"SASS {HMMA} counts: {out}", flush=True)
    return out


# The Sentinel-2 path: bench.py's Sentinel-2 rung (BASELINE.json config
# #5), one 300 x 300-pixel chip of 12 bands at full width, T = 64.
S2_SOURCE = dict(seed=11, start="2019-01-01", end="2021-01-01",
                 cloud_frac=0.15, sensor=SENTINEL2)
S2_ROUTES = ("0", "1", "mon", "mega", COMPONENTS, "0" + MIXED, "mon" + MIXED)
# The kernels whose band layout is the sensor's (their 12-band instances).
S2_KERNELS = ("lasso_fit", "init_window", "fused_fit_close", "fused_round",
              "lasso_cd", "detect_mega")


def sentinel2_phase(smi, reps, dev):
    """The Sentinel-2 path: every kernel (and the fitting kernels' mixed
    instances) on the chip's round states at 12 bands, held to its plain
    version (the count of disagreeing pixels printed) and timed; then
    routes 0, 1, "mon", mega, the component route, "0+mixed" and
    "mon+mixed" through the card, each with its launches read around it
    and against its plain route, held to the Landsat paths' rules (route 1
    = route 0, "mon" = route 0 but seg_mag, mega = "mon" but the per-chip
    rounds, the component route >= 0.999 of route 0's decisions, "mon+mixed"
    = "0+mixed" but seg_mag, "0+mixed" >= 0.999 of route 0's)."""
    t0 = time.perf_counter()
    src = SyntheticSource(**S2_SOURCE)
    packed = pack([src.chip(100, 200)], bucket=64)
    staged = kernel.stage_packed(packed, dev)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    print(f"sentinel2: batch {packed.spectra.shape} int16 made in "
          f"{gen_s:.1f} s", flush=True)
    inp = kernel_inputs(S2_SOURCE["seed"], staged, kernel.window_cap(packed),
                        SENTINEL2)
    kernels, kreport = kernel_phase(inp, staged, reps, S2_SOURCE["seed"],
                                    ring=False, mixed=True, guards="bits")
    del inp
    torch.cuda.empty_cache()
    paths, segs = {}, {}
    for name in S2_ROUTES:
        segs[name], paths[name] = route_path(packed, staged, smi, name,
                                             "sentinel2 ")
    for name, base, allowed in (
            ("1", "0", ()), ("mon", "0", ("seg_mag",)),
            ("mega", "mon", ("rounds", "round_counts", "seg_mag")),
            ("mon" + MIXED, "0" + MIXED, ("seg_mag",))):
        paths[name][f"vs_route_{base}"] = compare_routes(
            segs[name], segs[base],
            f"sentinel2 route {name!r} vs route {base!r}", allowed)
    paths["0" + MIXED]["vs_route_0"] = mixed_vs_f32(
        segs["0" + MIXED], segs["0"], "sentinel2 ")
    check(int(segs["mega"].rounds.max()) == int(segs["0"].rounds[0]),
          f"sentinel2 mega rounds {segs['mega'].rounds.tolist()} against "
          f"route 0's {int(segs['0'].rounds[0])}")
    agree, n_dis = decision_agreement(segs[COMPONENTS], segs["0"])
    print(f"sentinel2 route {COMPONENTS!r} vs route '0': decision agreement "
          f"{agree} ({n_dis} pixels differ)", flush=True)
    check(agree >= 0.999, f"sentinel2 component route vs route 0: decision "
          f"agreement {agree} < 0.999")
    paths[COMPONENTS]["vs_route_0"] = dict(decision_agreement=agree,
                                          pixels_disagreeing=n_dis)
    for name, row in kernels.items():
        row["launches"] = {r: paths[r]["launches"][name] for r in paths}
    redesign = redesign_report(kernels, paths, packed.spectra.shape[-1], smi,
                               nb=SENTINEL2.n_bands)
    return dict(chips=packed.n_chips, pixels=int(packed.spectra.shape[2]),
                T=int(packed.spectra.shape[-1]), bands=SENTINEL2.n_bands,
                generation_seconds=gen_s, kernels=kernels,
                kernel_report=kreport, main_paths=paths, redesign=redesign)


# ---------------------------------------------------------------------------
# The batch driver and the float64 route
# ---------------------------------------------------------------------------

DRIVER_CHIPS, DRIVER_BATCH, DRIVER_DEPTH = 24, 8, 3
DRIVER_POINT = (542000, 1650000)            # CONUS Albers, tile h=20 v=11
ACQUIRED = f"{START}/{END}"


class MemorySource:
    """Chips made beforehand, served by id; ``fail`` names chips whose
    fetch raises (``None``: every fetch raises)."""

    def __init__(self, chips, fail=()):
        self.chips, self.fail = chips, fail
        self.fetched = []

    def chip(self, cx, cy, acquired=None):
        self.fetched.append((cx, cy))
        if self.fail is None or (cx, cy) in self.fail:
            raise IOError(f"chip ({cx},{cy}) unavailable")
        return self.chips[(cx, cy)]


def _rows(store, table):
    from firebird_tpu_torch.store.schema import primary_key

    d = store.read(table)
    key = primary_key(table)
    return {tuple(d[k][i] for k in key): {c: d[c][i] for c in d}
            for i in range(len(d[key[0]]))}


def tile_chips(seed, n):
    """The first ``n`` chips of the driver's tile, 1985-2017, made from the
    seed (keyed by chip id, in the tile's order), and the seconds taken."""
    src = SyntheticSource(seed, start=START, end=END)
    cids = [tuple(int(v) for v in c) for c in
            grid.chips(grid.tile(*DRIVER_POINT))[:n]]
    t0 = time.perf_counter()
    chips = dict(zip(cids, make_chips(src, cids, ACQUIRED)))
    return chips, time.perf_counter() - t0


def driver_phase(smi, chips, gen_s, dev, tmp):
    """The batch driver on the card (the module docstring's item 9), on
    the tile's first DRIVER_CHIPS ``chips``, into a sqlite store in the
    directory ``tmp``.  Returns the report and the run's config."""
    cids = list(chips)[:DRIVER_CHIPS]
    lost = cids[DRIVER_CHIPS // 2]
    cfg = Config(chips_per_batch=DRIVER_BATCH, pipeline_depth=DRIVER_DEPTH,
                 store_backend="sqlite", max_obs=0, fetch_retries=0,
                 store_path=str(Path(tmp) / "fb.db"))
    run = lambda source, resume, counters: driver.changedetection(
        *DRIVER_POINT, acquired=ACQUIRED, number=DRIVER_CHIPS,
        chunk_size=DRIVER_CHIPS, cfg=cfg, source=source, resume=resume,
        device=dev, counters=counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = Counters()
    cuda_ops.reset_launches()
    done = run(MemorySource(chips, fail={lost}), False, counters)
    launches = dict(cuda_ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    snap = counters.snapshot()
    stages = driver.stage_seconds()
    launched = {k for k, n in launches.items() if n > 0}
    check(launched == ROUTE_0, f"driver launched {sorted(launched)}, "
          f"expected {sorted(ROUTE_0)}")
    check(set(done) == set(cids) - {lost},
          f"driver: {len(done)} chips done")
    q = qlib.Quarantine.load(qlib.quarantine_path(cfg))
    check(q.chip_ids() == {lost}, f"quarantine {q.chip_ids()}")
    # The resumed run drains the dead letter first.
    redo = MemorySource(chips)
    done = run(redo, True, Counters())
    check(redo.fetched == [lost] and set(done) == set(cids),
          f"resume fetched {redo.fetched}")
    check(len(qlib.Quarantine.load(qlib.quarantine_path(cfg))) == 0,
          "quarantine not drained")
    store = SqliteStore(cfg.store_path, cfg.keyspace())
    counts = {t: store.count(t) for t in ("chip", "pixel", "segment")}
    # A resume with every chip stored fetches, writes and launches
    # nothing.
    cuda_ops.reset_launches()
    idle = Counters()
    done = run(MemorySource(chips, fail=None), True, idle)
    check(set(done) == set(cids) and idle.get("chips") == 0
          and not any(cuda_ops.LAUNCHES.values())
          and {t: store.count(t) for t in counts} == counts,
          "the second resume fetched, wrote or launched")
    # Every stored row against detect_packed + batch_frames on the same
    # batches, packed as the driver packs them (NumPy).  The native data
    # plane packs the same chips in a thread meanwhile, and its arrays must
    # equal the packer's, byte for byte.
    check(native.available(), "native.available() is false on the card")
    batches = [[chips[c] for c in cids[i:i + DRIVER_BATCH]]
               for i in range(0, DRIVER_CHIPS, DRIVER_BATCH)]
    t0 = time.perf_counter()
    packs = [pack(b, bucket=cfg.obs_bucket, max_obs=cfg.max_obs)
             for b in batches]
    native_pack = dict(numpy_seconds=time.perf_counter() - t0,
                       chips=DRIVER_CHIPS)
    want = MemoryStore("want")
    with ThreadPoolExecutor(1) as ex:
        natives = ex.submit(native_packed, batches, packs)
        for packed in packs:
            seg = kernel.segments_to_numpy(kernel.detect_packed(
                packed, device=dev))
            for _, frames in fmt.batch_frames(packed, seg):
                for table in ("chip", "pixel", "segment"):
                    want.write(table, frames[table])
        native_pack["native_seconds"] = natives.result()
    del packs
    for table in ("chip", "pixel", "segment"):
        check(_rows(store, table) == _rows(want, table),
              f"driver's {table} rows differ from detect_packed's")
    store.close()
    T = int(max(c.dates.shape[0] for c in chips.values()))
    T = -64 * (-T // 64)
    per_batch = peak / DRIVER_DEPTH
    ws = kernel.working_set_bytes(T) * DRIVER_BATCH
    res = kernel.result_bytes(T) * DRIVER_BATCH
    auto = driver.auto_chips_per_batch(
        dataclasses.replace(cfg, chips_per_batch=0), ACQUIRED, dev)
    out = dict(chips=DRIVER_CHIPS, batch=DRIVER_BATCH, depth=DRIVER_DEPTH,
               T=T, chip_generation_seconds=gen_s,
               pixels=snap.get("pixels", 0), wall=snap["elapsed_sec"],
               pixels_per_s=snap.get("pixels_per_sec", 0.0),
               stage_seconds=stages, launches=launches, peak_bytes=peak,
               working_set_bytes_batch=ws, result_bytes_batch=res,
               auto_chips_per_batch=auto, store_rows=counts,
               native_pack=native_pack)
    print(f"driver: {snap.get('chips', 0)} of {DRIVER_CHIPS} chips (one "
          f"quarantined, drained on resume), {snap.get('pixels', 0)} px in "
          f"{snap['elapsed_sec']:.3f} s: {out['pixels_per_s']:.1f} px/s on "
          f"{smi}; stages (s) "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
          + f"; launches {launches}; peak {peak / 2**30:.2f} GiB "
          f"({per_batch / 2**30:.2f} GiB a batch of {DRIVER_BATCH} at depth "
          f"{DRIVER_DEPTH}) beside working_set_bytes {ws / 2**30:.2f} GiB "
          f"and result_bytes {res / 2**30:.2f} GiB a batch; "
          f"auto_chips_per_batch {auto}; chips made in {gen_s:.1f} s; "
          f"rows {counts}", flush=True)
    print(f"driver: pipeline_pack {stages.get('pack', 0.0):.3f} s (NumPy); "
          f"the {DRIVER_CHIPS} chips packed by the packer in "
          f"{native_pack['numpy_seconds']:.3f} s, natively in "
          f"{native_pack['native_seconds']:.3f} s (beside the rows' check), "
          f"byte-equal", flush=True)
    return out, cfg


def native_packed(batches, packs):
    """Each batch's chips packed by the native data plane
    (``native.pack_spectra`` and ``native.pack_qa``), held to the packer's
    arrays in ``packs`` byte for byte; returns the native calls' seconds."""
    secs = 0.0
    for chips, p in zip(batches, packs):
        B, npix, cap = p.spectra.shape[1:]
        for i, c in enumerate(chips):
            T = int(p.n_obs[i])
            t0 = time.perf_counter()
            spectra = native.pack_spectra(
                c.spectra[:, :T].reshape(B, T, npix), cap, params.FILL_VALUE)
            qas = native.pack_qa(c.qas[:T].reshape(T, npix), cap,
                                 int(QA_FILL_PACKED))
            secs += time.perf_counter() - t0
            check(np.array_equal(spectra.view(np.uint8),
                                 p.spectra[i].view(np.uint8))
                  and np.array_equal(qas.view(np.uint8),
                                     p.qas[i].view(np.uint8)),
                  f"the native pack of chip {i} differs from the packer's")
    return secs


# ---------------------------------------------------------------------------
# One process per card and the ops surface
# ---------------------------------------------------------------------------

OPS_CHIPS, OPS_PROCS, OPS_PROFILE_S, OPS_STALL_S = 8, 2, 2, 600
OPS_PATHS = ("/healthz", "/readyz", "/metrics", "/progress")
# The kernels of the default run that a profile window must see by name.
OPS_KERNEL_SYMBOLS = ("lasso_fit_kernel", "monitor_kernel", "init_kernel")
# torchrun starts each process through sh so that each gets its own ops
# port: FB_OPS_BASE + LOCAL_RANK.
OPS_WRAPPER = ('FIREBIRD_OPS_PORT=$((FB_OPS_BASE + LOCAL_RANK)) exec "$0" '
               '-m firebird_tpu_torch changedetection "$@" '
               '> "$FB_OPS_LOGS/rank$LOCAL_RANK.out" '
               '2> "$FB_OPS_LOGS/rank$LOCAL_RANK.err"')


def _free_ports(n):
    """A base port whose next ``n`` ports are free on localhost, below the
    ephemeral range: a client polling a port that nobody listens on yet
    can be handed that very port as its own source port (a TCP
    self-connect) and so keep the server from binding it."""
    import random
    import socket

    rng = random.Random()
    for _ in range(200):
        base = rng.randrange(20000, 30000)
        socks = []
        try:
            for p in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no free ports")


def _get(url):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=2) as r:
            r.read()
            return r.status
    except urllib.error.HTTPError as e:
        return e.code
    except OSError:
        return None


def _get_json(url):
    """(status, parsed body) of a GET, (None, None) when nothing answers."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, None
    except (OSError, ValueError):
        return None, None


def ops_phase(smi, chips, ref_cfg, tmp):
    """One process per card and the run's ops surface (the module
    docstring's item 10): the first OPS_CHIPS chips of the driver's tile
    through ``torchrun --nproc-per-node 2 -m firebird_tpu_torch
    changedetection`` on the one card, both processes on cuda:0, with the
    trace, a profile window, the watchdog and an ops port each; held to
    ``driver_phase``'s store (``ref_cfg``).  Returns the report."""
    import sqlite3

    from firebird_tpu_torch.obs import report as obs_report
    from firebird_tpu_torch.store.schema import columns, primary_key

    t_phase = time.perf_counter()
    cids = list(chips)[:OPS_CHIPS]
    P = int(np.prod(chips[cids[0]].spectra.shape[-2:]))
    root = Path(tmp) / "ops"
    src_dir, logs = root / "chips", root / "logs"
    for d in (src_dir, logs):
        d.mkdir(parents=True)
    t0 = time.perf_counter()
    for c in cids:
        ch = chips[c]
        np.savez(src_dir / f"chip_{c[0]}_{c[1]}.npz", dates=ch.dates,
                 spectra=ch.spectra, qas=ch.qas)
    write_s = time.perf_counter() - t0
    store_path = root / "fb.db"
    base = _free_ports(OPS_PROCS)
    env = dict(os.environ, FIREBIRD_SOURCE="file",
               FIREBIRD_SOURCE_PATH=str(src_dir),
               FIREBIRD_STORE_BACKEND="sqlite",
               FIREBIRD_STORE_PATH=str(store_path),
               FIREBIRD_CHIPS_PER_BATCH=str(DRIVER_BATCH),
               FIREBIRD_PIPELINE_DEPTH=str(DRIVER_DEPTH),
               FIREBIRD_MAX_OBS="0", FIREBIRD_FETCH_RETRIES="0",
               FIREBIRD_STALL_SEC=str(OPS_STALL_S),
               FB_OPS_BASE=str(base), FB_OPS_LOGS=str(logs))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(OPS_PROCS), "--no-python", "sh", "-c",
           OPS_WRAPPER, sys.executable, "-x", str(DRIVER_POINT[0]), "-y",
           str(DRIVER_POINT[1]), "-a", ACQUIRED, "-n", str(OPS_CHIPS),
           "-c", str(OPS_CHIPS), "--trace", "1", "--profile",
           str(OPS_PROFILE_S)]
    ports = [base + i for i in range(OPS_PROCS)]
    answers = {p: {path: [] for path in OPS_PATHS} for p in ports}
    import threading

    def poll(p, path):
        """(b) one endpoint polled while the run lasts: each change of
        its answer recorded."""
        seen = answers[p][path]
        while proc.poll() is None:
            code = _get(f"http://127.0.0.1:{p}{path}")
            if code is not None and (not seen or seen[-1] != code):
                seen.append(code)
            time.sleep(0.01)

    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    pollers = [threading.Thread(target=poll, args=(p, path), daemon=True)
               for p in ports for path in OPS_PATHS]
    for t in pollers:
        t.start()
    try:
        out, _ = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
    wall = time.perf_counter() - t0
    for t in pollers:
        t.join(timeout=5)
    rank_out = [(logs / f"rank{i}.out").read_text() for i in range(OPS_PROCS)]
    rank_err = [(logs / f"rank{i}.err").read_text() for i in range(OPS_PROCS)]
    check(proc.returncode == 0,
          f"ops: torchrun exited {proc.returncode}: {out[-3000:]}\n"
          + "\n".join(e[-3000:] for e in rank_err))
    print(f"ops: endpoint answers (codes in the order seen) "
          f"{json.dumps(answers)}", flush=True)
    for p in ports:
        for path in OPS_PATHS:
            check(200 in answers[p][path],
                  f"ops: {path} on port {p} never answered 200: "
                  f"{answers[p][path]}")
    # (c) the two processes share the chips, half each
    lines = [json.loads(o.strip().splitlines()[-1]) for o in rank_out]
    per = OPS_CHIPS // OPS_PROCS
    for i, (line, err) in enumerate(zip(lines, rank_err)):
        check(f"process {i}/{OPS_PROCS} takes {per} of {OPS_CHIPS} chips"
              in err, f"ops: process {i} did not log its share")
        check(line["process_index"] == i
              and line["process_count"] == OPS_PROCS
              and line["chips_done"] == per,
              f"ops: process {i}'s line {line}")
    # (d) every stored row equals driver_phase's row for the same chip,
    # in every column (the stored values, blobs byte for byte), both
    # stores read in primary-key order
    t_d = time.perf_counter()
    dbs = [SqliteStore(p, ref_cfg.keyspace())
           for p in (str(store_path), ref_cfg.store_path)]
    got_db, ref_db = (db.path for db in dbs)
    for db in dbs:
        db.close()
    con = sqlite3.connect(got_db)
    con.execute("ATTACH DATABASE ? AS ref", (ref_db,))
    mine = " OR ".join(f"(cx = {c[0]} AND cy = {c[1]})" for c in cids)
    rows = {}
    for table in ("chip", "pixel", "segment"):
        cols = ", ".join(f'"{c}"' for c in columns(table))
        order = ", ".join(f'"{c}"' for c in primary_key(table))
        have = con.execute(f'SELECT {cols} FROM main."{table}" '
                           f"ORDER BY {order}").fetchall()
        want = con.execute(f'SELECT {cols} FROM ref."{table}" WHERE {mine} '
                           f"ORDER BY {order}").fetchall()
        rows[table] = len(have)
        check(have == want and len(have) > 0,
              f"ops: {table} rows differ from driver_phase's ({len(have)} "
              f"against {len(want)}; "
              f"{sum(a != b for a, b in zip(have, want))} differ)")
    con.close()
    check_s = dict(rows=time.perf_counter() - t_d)
    # (e) one run id; the fleet report merges both shards, counters summed
    shards = [json.loads((root / f"obs_report.host{i}.json").read_text())
              for i in range(OPS_PROCS)]
    fleet = json.loads((root / "obs_report.json").read_text())
    run_ids = {sh["run"]["run_id"] for sh in shards} | {
        line["run_id"] for line in lines}
    check(len(run_ids) == 1, f"ops: run ids {run_ids}")
    check(fleet["fleet"]["hosts"] == OPS_PROCS
          and "missing" not in fleet["fleet"]
          and fleet["run_counters"]["chips"] == OPS_CHIPS
          and fleet["run_counters"]["pixels"] == OPS_CHIPS * P,
          f"ops: fleet report {fleet['fleet']} {fleet['run_counters']}")
    for name, v in fleet["metrics"]["counters"].items():
        check(v == sum(sh["metrics"]["counters"].get(name, 0)
                       for sh in shards), f"ops: fleet counter {name}")
    # (f) one profile window a process, the default run's kernels in it
    busy = []
    for i, sh in enumerate(shards):
        wins = sh["profile"]["windows"]
        check(len(wins) == 1, f"ops: process {i} has {len(wins)} windows")
        w = wins[0]
        a = w.get("attribution", {})
        names = " ".join(w.get("device_kernels", {}))
        check(a.get("source") == "trace" and a.get("total_ms", 0) > 0,
              f"ops: process {i}'s window recorded no device time: {a} "
              f"{w.get('error')}")
        missing = [k for k in OPS_KERNEL_SYMBOLS if k not in names]
        check(not missing, f"ops: process {i}'s window lacks {missing}: "
              f"{sorted(w.get('device_kernels', {}))[:20]}")
        busy.append(a["device_busy_ms"] / a["window_ms"])
        print(f"ops: process {i} profile window {a['window_ms']:.1f} ms: "
              f"device busy {a['device_busy_ms']:.3f} ms "
              f"({busy[-1]:.4f} of the window), kernels+copies "
              f"{a['total_ms']:.3f} ms over {a['events']} events (fit "
              f"{a['fit_ms']:.3f}, monitor {a['monitor_ms']:.3f}, "
              f"compaction {a['compaction_ms']:.3f}, other "
              f"{a['other_ms']:.3f}) on {smi}", flush=True)
    # (g) each process's trace against its own shard
    for i, sh in enumerate(shards):
        trace = json.loads((root / f"trace.host{i}.json").read_text())
        obs_report.validate_driver_artifacts(trace, sh)
    # (h) no postmortem
    check(not (root / "postmortem.json").exists(),
          "ops: a postmortem bundle was written")
    rc = fleet["run_counters"]
    out_rep = dict(
        processes=OPS_PROCS, chips=OPS_CHIPS, run_id=run_ids.pop(),
        endpoint_answers={str(p): a for p, a in answers.items()},
        wall_s=wall, launch_px_per_s=OPS_CHIPS * P / wall,
        pipeline_elapsed_s=rc["elapsed_sec"],
        pipeline_px_per_s=rc["pixels_per_sec"], rows=rows,
        device_busy_share=busy, chip_files_s=write_s,
        check_seconds=check_s,
        shards=[dict(run=sh["run"], profile=sh["profile"],
                     spans=sh["spans"], device=sh.get("device"))
                for sh in shards],
        fleet=dict(fleet=fleet["fleet"], run_counters=rc,
                   spans=fleet["spans"]),
        seconds=time.perf_counter() - t_phase)
    print(f"ops: {OPS_PROCS} processes on one card, {OPS_CHIPS} chips "
          f"({OPS_CHIPS * P} px): launch to exit {wall:.3f} s, "
          f"{out_rep['launch_px_per_s']:.1f} px/s; the pipelines' wall "
          f"{rc['elapsed_sec']:.3f} s, {rc['pixels_per_sec']:.1f} px/s; "
          f"rows {rows}; chip files {write_s:.1f} s, row check "
          f"{check_s['rows']:.1f} s, phase {out_rep['seconds']:.1f} s on "
          f"{smi}",
          flush=True)
    return out_rep


# ---------------------------------------------------------------------------
# Classification and the product rasters
# ---------------------------------------------------------------------------

RF_SAMPLE_ROWS, RF_SAMPLE_TREES = 20000, 32
PRODUCT_DATE = "2010-06-01"


def _decided(raw, gap=1e-3):
    """Rows whose top two votes are more than ``gap`` apart (every row
    when there is one class)."""
    if raw.shape[1] < 2:
        return np.ones(raw.shape[0], bool)
    top2 = np.sort(raw, axis=1)[:, -2:]
    return (top2[:, 1] - top2[:, 0]) > gap


def forest_diff(a, b):
    """(trees, nodes) of forest ``a`` whose split or leaf differs from
    ``b``'s."""
    node = (a.feature != b.feature) | ~(
        (a.threshold == b.threshold)
        | (np.isinf(a.threshold) & np.isinf(b.threshold)))
    leaf = (a.leaf_proba != b.leaf_proba).any(axis=2)
    trees = node.any(axis=1) | leaf.any(axis=1)
    return int(trees.sum()), int(node.sum() + leaf.sum())


def classify_phase(smi, cfg, seed, dev):
    """Classification on the card over the driver phase's store (the module
    docstring's item 17)."""
    from firebird_tpu_torch import products
    from firebird_tpu_torch.rf import features, forest, pipeline

    t_phase = time.perf_counter()
    src = SyntheticSource(seed, start=START, end=END)
    store = SqliteStore(cfg.store_path, cfg.keyspace())
    msday, meday = dt.to_ordinal(START), dt.to_ordinal(END)
    counters = Counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_ops.reset_launches()
    t0 = time.perf_counter()
    model = driver.classification(
        *DRIVER_POINT, msday=msday, meday=meday, acquired=ACQUIRED, cfg=cfg,
        aux_source=src, store=store, device=dev, counters=counters)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    stages = pipeline.classification_stage_seconds()
    snap = counters.snapshot()
    check(not any(cuda_ops.LAUNCHES.values()),
          f"classification launched {dict(cuda_ops.LAUNCHES)}")
    # The forest's width is the JAX package's: 500 trees, depth 8, 64 bins.
    width = {"n_trees": forest.NUM_TREES, "max_depth": forest.DEFAULT_DEPTH,
             "n_bins": forest.DEFAULT_BINS}
    check(model is not None and (model.n_trees, model.depth, width["n_bins"])
          == (500, 8, 64), "the forest's width")
    # Seconds of each check, beside the call's: what the phase spends on
    # checking rather than classifying.
    check_s = {}

    # (a) The stored model.
    t1 = time.perf_counter()
    t = grid.tile(*DRIVER_POINT)
    stored = pipeline.load_model(store, t["x"], t["y"])
    check(stored is not None and stored.dumps() == model.dumps(),
          "the stored model differs from the model returned")
    check(set(model.classes.tolist()) <= set(range(1, 9)),
          f"classes {model.classes.tolist()} outside the trends alphabet")
    check_s["a"] = time.perf_counter() - t1

    # (b) Every real segment row's votes against raw_predict on the card.
    t1 = time.perf_counter()
    cids = sorted(store.chip_ids("segment"))
    check(len(cids) == DRIVER_CHIPS, f"{len(cids)} chips in the store")
    xs, labels, votes, segs = [], [], [], {}
    for cx, cy in cids:
        seg = store.read("segment", {"cx": cx, "cy": cy})
        segs[(cx, cy)] = seg
        real = features.real_rows(seg)
        X, meta = features.assemble(seg, src.aux(cx, cy), cx, cy,
                                    row_mask=real)
        got = [seg["rfrawp"][i] for i in np.flatnonzero(real)]
        check(all(v is not None and len(v) == model.n_classes for v in got),
              f"chip ({cx},{cy}): a real segment without {model.n_classes} "
              f"votes")
        got = np.asarray(got, np.float64)
        want = model.raw_predict(X, device=dev)
        check(np.array_equal(got, want.astype(np.float64)),
              f"chip ({cx},{cy}): rfrawp differs from raw_predict by "
              f"{np.abs(got - want).max()}")
        xs.append(X)
        labels.append(np.asarray(meta["label"]))
        votes.append(want)
    X_all, y_all, raw = (np.concatenate(xs), np.concatenate(labels),
                         np.concatenate(votes))
    n_rows = X_all.shape[0]
    check(n_rows == snap["segments_scored"],
          f"{n_rows} real rows, {snap['segments_scored']} scored")
    check(np.allclose(raw.sum(axis=1), model.n_trees, rtol=1e-4, atol=0),
          "a row's votes do not sum to the trees")
    check_s["b"] = time.perf_counter() - t1

    # (c) The dense form against the walk on the card, each over all the
    # rows at once (host clock, ending in the copy to the host).
    t_c = t1 = time.perf_counter()
    dense = model.raw_predict(X_all, dense=True, device=dev)
    dense_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    walk = model.raw_predict(X_all, dense=False, device=dev)
    walk_s = time.perf_counter() - t1
    check(np.array_equal(dense, raw), "dense votes depend on the batch")
    decided = _decided(walk)
    walk_err = float(np.abs(walk - dense).max())
    check(walk_err <= 1e-4, f"dense vs walk: {walk_err}")
    check((walk.argmax(1) == dense.argmax(1))[decided].all(),
          "dense and walk disagree on a decided row")
    check_s["c"] = time.perf_counter() - t_c

    # (d) A sample of the training rows: the card's forest against the
    # port's forest trained on the CPU, from the same seed.
    t_d = time.perf_counter()
    keep = ~np.isin(y_all, features.TRENDS_EXCLUDE) \
        & np.isfinite(X_all).all(axis=1)
    check(int(keep.sum()) == snap["training_rows"],
          f"{int(keep.sum())} training rows, {snap['training_rows']} trained")
    X_tr, y_tr = X_all[keep], y_all[keep]
    pick = np.sort(np.random.default_rng(seed).choice(
        X_tr.shape[0], min(RF_SAMPLE_ROWS, X_tr.shape[0]), replace=False))
    Xs, ys = X_tr[pick], y_tr[pick]
    sample_kw = dict(width, n_trees=RF_SAMPLE_TREES, seed=seed)
    card = forest.train(Xs, ys, device=dev, **sample_kw)
    t1 = time.perf_counter()
    host = forest.train(Xs, ys, device="cpu", **sample_kw)
    host_s = time.perf_counter() - t1
    keys = range(RF_SAMPLE_TREES)
    w_card = forest.bootstrap_weights(forest.tree_keys(seed, keys, dev),
                                      Xs.shape[0]).cpu()
    w_host = forest.bootstrap_weights(forest.tree_keys(seed, keys, "cpu"),
                                      Xs.shape[0])
    lanes = int((w_card != w_host).sum())
    trees_differ, nodes_differ = forest_diff(card, host)
    raw_card = card.raw_predict(X_all, device=dev)
    raw_host = host.raw_predict(X_all, device=dev)
    sample_decided = _decided(raw_host)
    flips = int((raw_card.argmax(1) != raw_host.argmax(1))[
        sample_decided].sum())
    print(f"classify sample: {Xs.shape[0]} rows x {RF_SAMPLE_TREES} trees, "
          f"card vs CPU: {lanes} of {w_card.numel()} bootstrap lanes differ, "
          f"{trees_differ} trees ({nodes_differ} nodes and leaves) differ, "
          f"{flips} decided rows of {int(sample_decided.sum())} predict "
          f"otherwise (CPU training {host_s:.1f} s)", flush=True)
    check(flips == 0, f"the sample forests disagree on {flips} decided rows")
    check(trees_differ <= 0.01 * RF_SAMPLE_TREES,
          f"{trees_differ} of {RF_SAMPLE_TREES} sample trees differ")
    check_s["d"] = time.perf_counter() - t_d

    # (e) The product rasters at one date over the chips (``save`` itself
    # is the product path; its seconds are kept apart from the check's).
    t_e = time.perf_counter()
    (x0, y0), (x1, y1) = cids[0], cids[-1]
    bounds = [(min(x0, x1) + 1.0, max(y0, y1) - 1.0),
              (max(x0, x1) + 2999.0, min(y0, y1) - 2999.0)]
    check(set(products.covering_chips(bounds)) == set(cids),
          "the bounds cover other chips than the store's")
    t1 = time.perf_counter()
    written = products.save(bounds, list(products.PRODUCTS), [PRODUCT_DATE],
                            cfg=cfg, store=store, device=dev)
    save_s = time.perf_counter() - t1
    check(len(written) == len(products.PRODUCTS) * len(cids),
          f"save wrote {len(written)} rasters")
    d = dt.to_ordinal(PRODUCT_DATE)
    rasters = store.read("product", {"date": PRODUCT_DATE})
    cells = {(n, cx, cy): np.asarray(v) for n, cx, cy, v in zip(
        rasters["name"], rasters["cx"], rasters["cy"], rasters["cells"])}
    n_cover = 0
    for (cx, cy), seg in segs.items():
        # The chip's rows parsed once for its four rasters, as ``save``
        # parses them (``chip_product`` takes the parsed rows or a frame).
        arrays = products.ChipSegmentArrays(cx, cy, seg)
        for name in products.PRODUCTS:
            want = products.chip_product(name, d, cx, cy, arrays,
                                         classes=model.classes)
            check(np.array_equal(cells[(name, cx, cy)], want),
                  f"{name} raster of chip ({cx},{cy}) differs")
        # cover: the vote argmax of the segment holding the date, mapped
        # through the stored classes (one pixel_index call a chip; where
        # two rows held one pixel, the later row's label stands, as a
        # row-by-row assignment leaves it).
        cover = np.zeros(products.PIXELS, np.int32)
        sday, eday = np.asarray(seg["sday"]), np.asarray(seg["eday"])
        rows = np.flatnonzero((sday != "0001-01-01")
                              & (sday <= PRODUCT_DATE)
                              & (eday >= PRODUCT_DATE))
        if rows.size:
            r, c = features.pixel_index(cx, cy,
                                        np.asarray(seg["px"])[rows],
                                        np.asarray(seg["py"])[rows])
            pix = r * products.CHIP_SIDE + c
            labels = stored.classes[np.argmax(np.asarray(
                [seg["rfrawp"][i] for i in rows]), axis=1)]
            _, first_rev = np.unique(pix[::-1], return_index=True)
            last = pix.size - 1 - first_rev
            cover[pix[last]] = labels[last]
        check(np.array_equal(cells[("cover", cx, cy)], cover),
              f"cover raster of chip ({cx},{cy}) differs")
        n_cover += int((cover > 0).sum())
    store.close()
    check(n_cover > 0, f"no pixel has a cover label at {PRODUCT_DATE}")
    check_s["e"] = time.perf_counter() - t_e - save_s

    classes, counts = np.unique(y_tr, return_counts=True)
    device_s = stages["draw"] + stages["grow"] + stages["predict_device"]
    out = dict(chips=len(cids), training_rows=snap["training_rows"],
               classes=dict(zip(map(int, classes), map(int, counts))),
               segments=snap["segments"],
               segments_scored=snap["segments_scored"],
               width=width, wall=wall, stage_seconds=stages,
               rows_per_s_trained=snap["training_rows"] / stages["train"],
               rows_per_s_classified=snap["segments_scored"]
               / stages["predict"],
               card_span_share=device_s / wall, peak_bytes=peak,
               dense_seconds=dense_s, walk_seconds=walk_s,
               walk_max_abs_err=walk_err,
               sample=dict(rows=int(Xs.shape[0]), trees=RF_SAMPLE_TREES,
                           bootstrap_lanes_differing=lanes,
                           lanes=int(w_card.numel()),
                           trees_differing=trees_differ,
                           nodes_differing=nodes_differ,
                           decided_rows=int(sample_decided.sum()),
                           decided_rows_flipped=flips,
                           cpu_train_seconds=host_s),
               products=dict(rasters=len(written), date=PRODUCT_DATE,
                             seconds=save_s, cover_pixels=n_cover),
               check_seconds=check_s,
               phase_seconds=time.perf_counter() - t_phase)
    print(f"classify: {len(cids)} chips, {snap['training_rows']} training "
          f"rows, classes {out['classes']}, {snap['segments_scored']} "
          f"segments scored ({snap['segments']} rows written) by "
          f"{model.n_trees} trees of depth {model.depth} in {wall:.3f} s on "
          f"{smi}; stages (s) "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
          + f"; {out['rows_per_s_trained']:.1f} rows/s trained, "
          f"{out['rows_per_s_classified']:.1f} rows/s classified; the card's "
          f"spans (draw, grow, predict) {device_s:.3f} s, "
          f"{out['card_span_share']:.3f} of the wall; peak "
          f"{peak / 2**30:.2f} GiB; all rows: dense {dense_s:.3f} s, walk "
          f"{walk_s:.3f} s, max |dense - walk| {walk_err:.2e}; products: {len(written)} rasters at "
          f"{PRODUCT_DATE} in {save_s:.3f} s; checks (s) "
          + ", ".join(f"{k} {v:.3f}" for k, v in check_s.items())
          + f"; phase {out['phase_seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# Serving: two replicas over the card's results
# ---------------------------------------------------------------------------

SERVE_REPLICAS, SERVE_POLL_S, SERVE_APPLY_S = 2, 0.5, 1.0
SERVE_COLD_DATE, SERVE_COLD_N = "2012-06-01", 16
SERVE_POINTS, SERVE_THREADS, SERVE_GETS = 8, 8, 100
SERVE_LEVELS = 2


def _prom_value(text, name):
    """A counter's value in a Prometheus exposition (0 when absent)."""
    prom = f"firebird_{name}_total "
    return sum(float(line.split()[-1]) for line in text.splitlines()
               if line.startswith(prom))


def _http(base, path, headers=None):
    """(status, body, headers) of a GET."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(base + path, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _npy(cells):
    import io

    buf = io.BytesIO()
    np.save(buf, np.asarray(cells, np.int32).reshape(100, 100))
    return buf.getvalue()


def serve_phase(smi, cfg, tmp, seed):
    """Serving over the card's results (the module docstring's item 18):
    two ``serve`` replicas over ``driver_phase``'s store after
    ``classify_phase`` wrote its rows.  Returns the report."""
    import http.client
    import signal
    import threading

    from firebird_tpu_torch import products
    from firebird_tpu_torch.rf.tilemodel import model_classes
    from firebird_tpu_torch.serve import pyramid as pyrlib

    t_phase = time.perf_counter()
    home = Path(tmp)
    store = SqliteStore(cfg.store_path, cfg.keyspace())
    rasters = store.read("product", {"date": PRODUCT_DATE})
    cells = {(n, cx, cy): np.asarray(v, np.int32) for n, cx, cy, v in zip(
        rasters["name"], rasters["cx"], rasters["cy"], rasters["cells"])}
    cids = sorted(store.chip_ids("segment"))
    check(len(cells) == len(products.PRODUCTS) * len(cids),
          f"serve: {len(cells)} stored rasters for {len(cids)} chips")
    (x0, y0), (x1, y1) = cids[0], cids[-1]
    bounds = [(min(x0, x1) + 1.0, max(y0, y1) - 1.0),
              (max(x0, x1) + 2999.0, min(y0, y1) - 2999.0)]
    env = dict(os.environ, FIREBIRD_STORE_BACKEND="sqlite",
               FIREBIRD_STORE_PATH=cfg.store_path,
               FIREBIRD_CHANGEFEED_DB=str(home / "changefeed.db"),
               FIREBIRD_SERVE_PYRAMID_DIR=str(home / "pyramid"),
               FIREBIRD_SERVE_FEED_POLL=str(SERVE_POLL_S))
    feed_cfg = dataclasses.replace(
        cfg, changefeed_db=env["FIREBIRD_CHANGEFEED_DB"])
    apps0 = len(_gpu_apps())
    apps_most, done = [apps0], threading.Event()

    def sample():
        while not done.is_set():
            apps_most[0] = max(apps_most[0], len(_gpu_apps()))
            time.sleep(0.25)

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    check_s, procs, bases = {}, [], []
    t0 = time.perf_counter()
    for i in range(SERVE_REPLICAS):
        log = open(home / f"serve_{i}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "firebird_tpu_torch", "serve", "--port",
             "0", "--host", "127.0.0.1", "--replica-id", f"replica-{i}"],
            env=env, stdout=log, stderr=subprocess.STDOUT, text=True), log))
    try:
        for i, (proc, _) in enumerate(procs):
            path = home / f"serve_{i}.log"
            while True:
                m = re.search(r" on port (\d+) ", path.read_text())
                if m:
                    bases.append(f"http://127.0.0.1:{m.group(1)}")
                    break
                check(proc.poll() is None and
                      time.perf_counter() - t0 < 60,
                      f"serve: replica {i} did not come up: "
                      f"{path.read_text()[-3000:]}")
                time.sleep(0.02)
        # The first product request loads the product math (numpy, scipy
        # through the detector's parameters): warm both replicas at once.
        with ThreadPoolExecutor(len(bases)) as ex:
            check(list(ex.map(lambda b: _http(b, "/v1/products")[0], bases))
                  == [200] * len(bases), "serve: /v1/products")
        startup_s = time.perf_counter() - t0

        # (a) every stored raster served equal, byte for byte, by both
        # replicas; /v1/pixel at seeded points; nothing computed
        t1 = time.perf_counter()
        for (name, cx, cy), want in cells.items():
            for base in bases:
                code, body, h = _http(
                    base, f"/v1/product/{name}?cx={cx}&cy={cy}"
                          f"&date={PRODUCT_DATE}&format=npy")
                check(code == 200 and body == _npy(want),
                      f"serve: {name} of chip ({cx},{cy}) from {base}: "
                      f"{code}")
        rng = np.random.default_rng(seed)
        points = []
        for k in range(SERVE_POINTS):
            cx, cy = cids[int(rng.integers(len(cids)))]
            row, col = (int(v) for v in rng.integers(0, 100, 2))
            x, y = cx + 30 * col + 15.0, cy - 30 * row - 15.0
            code, body, _ = _http(bases[k % len(bases)],
                                  f"/v1/pixel?x={x}&y={y}"
                                  f"&date={PRODUCT_DATE}")
            doc = json.loads(body)
            check(code == 200 and doc["pixel"] == {"row": row, "col": col}
                  and doc["products"] == {
                      n: int(cells[(n, cx, cy)][row * 100 + col])
                      for n in products.PRODUCTS},
                  f"serve: /v1/pixel at ({x}, {y}): {code} {doc}")
            points.append([x, y])
        computes = [_prom_value(_http(b, "/metrics")[1].decode(),
                                "serve_product_computes") for b in bases]
        check(computes == [0] * len(bases),
              f"serve: stored rasters were computed: {computes}")
        check_s["a"] = time.perf_counter() - t1

        # (b) concurrent identical cold misses compute once, and persist
        # chip_product of the stored rows
        t1 = time.perf_counter()
        cx, cy = cids[len(cids) // 3]
        t = grid.tile(cx, cy)
        classes = model_classes(store, t["x"], t["y"])
        seg = store.read("segment", {"cx": cx, "cy": cy})
        want_cold = products.chip_product(
            "cover", dt.to_ordinal(SERVE_COLD_DATE), cx, cy, seg,
            classes=classes)
        path = (f"/v1/product/cover?cx={cx}&cy={cy}"
                f"&date={SERVE_COLD_DATE}&format=npy")
        with ThreadPoolExecutor(SERVE_COLD_N) as ex:
            res = list(ex.map(lambda _: _http(bases[0], path),
                              range(SERVE_COLD_N)))
        check(all(c == 200 and b == _npy(want_cold) for c, b, _ in res),
              f"serve: cold cover answers {[c for c, _, _ in res]}")
        computes = [_prom_value(_http(b, "/metrics")[1].decode(),
                                "serve_product_computes") for b in bases]
        check(computes == [1] + [0] * (len(bases) - 1),
              f"serve: {SERVE_COLD_N} identical cold misses computed "
              f"{computes}")
        row = store.read("product", {"name": "cover", "date": SERVE_COLD_DATE,
                                     "cx": cx, "cy": cy})["cells"]
        check(len(row) == 1 and np.array_equal(row[0], want_cold)
              and (want_cold > 0).any(),
              "serve: the persisted cold row is not chip_product's")
        check_s["b"] = time.perf_counter() - t1

        # (c) pyramid build over the chips: base tiles are the rasters,
        # parents the 2x selection of their children; /v1/pyramid 200,
        # then 304 on its ETag
        t1 = time.perf_counter()
        argv = ["pyramid", "build", "-l", str(SERVE_LEVELS)]
        for x, y in bounds:
            argv += ["-b", f"{x},{y}"]
        for name in products.PRODUCTS:
            argv += ["-p", name]
        code, out = _command(argv + ["-d", PRODUCT_DATE], env)
        built = json.loads(out)
        check(code == 0 and built["chips"] == len(cids),
              f"serve: pyramid build exited {code}: {out[-2000:]}")
        tiles = pyramid_census(home / "pyramid", cells, cids,
                               products.PRODUCTS, SERVE_LEVELS, "serve")
        pyr = pyrlib.TilePyramid(str(home / "pyramid"))
        bx, by = pyrlib.tile_of_chip(*cids[0])
        for z, x, y in pyrlib.ancestors(pyrlib.Z_BASE, bx, by)[:2]:
            p = f"/v1/pyramid/ccd/{z}/{x}/{y}?date={PRODUCT_DATE}"
            code, body, h = _http(bases[1], p)
            npy, _ = pyr.tile_paths("ccd", PRODUCT_DATE, z, x, y)
            check(code == 200 and body == Path(npy).read_bytes(),
                  f"serve: {p} answered {code}")
            code, body, _ = _http(bases[0], p, {"If-None-Match": h["ETag"]})
            check((code, body) == (304, b""),
                  f"serve: {p} with its ETag answered {code}")
        check_s["c"] = time.perf_counter() - t1

        # (d) a clipped products.save of one chip in this process reaches
        # both replicas within one poll and one apply: new bytes, new
        # ETag, the chip's tile stale-stamped and rebuilt
        t1 = time.perf_counter()
        cx, cy = cids[-1]
        p_prod = (f"/v1/product/curveqa?cx={cx}&cy={cy}"
                  f"&date={PRODUCT_DATE}&format=npy")
        tags = [_http(b, p_prod)[2]["ETag"] for b in bases]
        tile = (pyrlib.Z_BASE, *pyrlib.tile_of_chip(cx, cy))
        version = pyr.peek_meta("curveqa", PRODUCT_DATE, *tile)["version"]
        clip = [(cx + 300.0, cy - 300.0), (cx + 2400.0, cy - 1800.0)]
        products.save(clip, ["curveqa"], [PRODUCT_DATE], clip=True,
                      cfg=feed_cfg, store=store, device="cpu")
        # From the feed's append (save's last step) to each replica's
        # first answer with the new bytes.
        t_save = time.perf_counter()
        new = np.asarray(store.read("product", {
            "name": "curveqa", "date": PRODUCT_DATE, "cx": cx,
            "cy": cy})["cells"][0], np.int32)
        check(not np.array_equal(new, cells[("curveqa", cx, cy)])
              and (new == params.FILL_VALUE).any(),
              "serve: the clipped save changed nothing")
        seen = [None] * len(bases)
        while None in seen and time.perf_counter() - t_save < 30:
            for i, b in enumerate(bases):
                if seen[i] is None:
                    code, body, h = _http(b, p_prod,
                                          {"If-None-Match": tags[i]})
                    if code == 200:
                        check(body == _npy(new) and h["ETag"] != tags[i],
                              f"serve: replica {i} served the old bytes "
                              "under a new ETag")
                        seen[i] = time.perf_counter() - t_save
            time.sleep(0.01)
        check(None not in seen and max(seen) <= SERVE_POLL_S + SERVE_APPLY_S,
              f"serve: the clipped save reached the replicas after {seen} s"
              f" (one poll {SERVE_POLL_S} s and one apply {SERVE_APPLY_S} s)")
        meta = pyr.peek_meta("curveqa", PRODUCT_DATE, *tile)
        check(meta["stale"], "serve: the chip's base tile was not stamped")
        p_tile = f"/v1/pyramid/curveqa/{tile[0]}/{tile[1]}/{tile[2]}" \
                 f"?date={PRODUCT_DATE}&format=npy"
        code, body, h = _http(bases[0], p_tile)
        check(code == 200 and body == _npy(new)
              and h["X-Firebird-Tile-Version"] == str(version + 1),
              f"serve: the stale tile answered {code}, version "
              f"{h.get('X-Firebird-Tile-Version')} after {version}")
        code, out = _command(["status"], env)
        feed = json.loads(out)["serving"]["changefeed"]
        check(code == 0 and feed["replicas_seen"] == SERVE_REPLICAS
              and all(r["writes_behind"] == 0 for r in feed["replicas"]),
              f"serve: status shows {feed}")
        cells[("curveqa", cx, cy)] = new
        check_s["d"] = time.perf_counter() - t1

        # (e) export of one product over the area: the mosaic of the
        # stored rows
        t1 = time.perf_counter()
        argv = ["export", "-p", "curveqa", "-d", PRODUCT_DATE, "-f", "npy",
                "-o", str(home / "export")]
        for x, y in bounds:
            argv += ["-b", f"{x},{y}"]
        code, out = _command(argv, env)
        check(code == 0, f"serve: export exited {code}")
        got = np.load(home / "export" / f"curveqa_{PRODUCT_DATE}.npy")
        side = json.loads((home / "export" /
                           f"curveqa_{PRODUCT_DATE}.json").read_text())
        ulx = min(c[0] for c in cids)
        uly = max(c[1] for c in cids)
        want = np.full(got.shape, params.FILL_VALUE, np.int32)
        for c in cids:
            r0, c0 = (uly - c[1]) // 30, (c[0] - ulx) // 30
            want[r0:r0 + 100, c0:c0 + 100] = \
                cells[("curveqa", *c)].reshape(100, 100)
        check(np.array_equal(got, want) and (side["ulx"], side["uly"])
              == (ulx, uly), "serve: the export differs from the mosaic "
              "of the stored rows")
        check_s["e"] = time.perf_counter() - t1

        # (f) warm GETs from 8 threads, kept-alive connections: every
        # body the stored raster's
        t1 = time.perf_counter()
        keys = sorted(cells)
        lat = [[] for _ in range(SERVE_THREADS)]
        bad = []

        def client(k):
            conns = [http.client.HTTPConnection(b[len("http://"):],
                                                timeout=30) for b in bases]
            try:
                for j in range(SERVE_GETS):
                    name, cx, cy = keys[(k * SERVE_GETS + j) % len(keys)]
                    conn = conns[j % len(conns)]
                    t2 = time.perf_counter()
                    conn.request("GET", f"/v1/product/{name}?cx={cx}&cy={cy}"
                                        f"&date={PRODUCT_DATE}&format=npy")
                    r = conn.getresponse()
                    body = r.read()
                    lat[k].append(time.perf_counter() - t2)
                    if r.status != 200 or body != _npy(cells[(name, cx, cy)]):
                        bad.append((name, cx, cy, r.status))
            finally:
                for conn in conns:
                    conn.close()

        t2 = time.perf_counter()
        with ThreadPoolExecutor(SERVE_THREADS) as ex:
            list(ex.map(client, range(SERVE_THREADS)))
        load_s = time.perf_counter() - t2
        check(not bad, f"serve: {len(bad)} warm GETs wrong: {bad[:4]}")
        all_lat = np.sort(np.concatenate([np.asarray(v) for v in lat]))
        n_get = SERVE_THREADS * SERVE_GETS
        warm = dict(requests=n_get, seconds=load_s, rps=n_get / load_s,
                    p50_ms=1e3 * float(np.percentile(all_lat, 50)),
                    p99_ms=1e3 * float(np.percentile(all_lat, 99)))
        check_s["f"] = time.perf_counter() - t1
    finally:
        done.set()
        for proc, log in procs:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        codes = []
        for proc, log in procs:
            try:
                codes.append(proc.wait(timeout=30))
            except subprocess.TimeoutExpired:
                proc.kill()
                codes.append(proc.wait())
            log.close()
        sampler.join(timeout=5)
        store.close()
    check(codes == [0] * SERVE_REPLICAS, f"serve: replicas exited {codes}")
    check(apps_most[0] <= apps0,
          f"serve: {apps_most[0]} compute apps on the card while the "
          f"replicas ran, {apps0} before")
    out = dict(replicas=SERVE_REPLICAS, chips=len(cids),
               rasters=len(cells), points=points, cold_date=SERVE_COLD_DATE,
               cold_requests=SERVE_COLD_N, pyramid_build=built,
               pyramid_tiles=tiles, coherence_seconds=seen,
               poll_sec=SERVE_POLL_S, gpu_apps_before=apps0,
               gpu_apps_most=apps_most[0], warm=warm,
               startup_seconds=startup_s, check_seconds=check_s,
               seconds=time.perf_counter() - t_phase)
    print(f"serve: {SERVE_REPLICAS} replicas up in {startup_s:.2f} s over "
          f"{len(cids)} chips; {len(cells)} stored rasters served byte for "
          f"byte; {SERVE_COLD_N} cold cover misses computed once; pyramid "
          f"tiles {tiles}; a clipped save reached the replicas after "
          + ", ".join(f"{v:.3f}" for v in seen)
          + f" s; warm: {n_get} GETs from {SERVE_THREADS} threads, "
          f"{warm['rps']:.1f} req/s, p50 {warm['p50_ms']:.2f} ms, p99 "
          f"{warm['p99_ms']:.2f} ms; compute apps {apps0} before, at most "
          f"{apps_most[0]} during; checks (s) "
          + ", ".join(f"{k} {v:.2f}" for k, v in check_s.items())
          + f"; phase {out['seconds']:.1f} s on {smi}", flush=True)
    return out


# ---------------------------------------------------------------------------
# The fleet: lease queue, supervisor, workers, zombie drill, telemetry
# ---------------------------------------------------------------------------

FLEET_CHIPS, FLEET_CHUNK, FLEET_WORKERS, FLEET_LEASE_S = 8, 2, 2, 10
# A worker's auto window opens at its first dispatch and closes on the wall
# clock.  The freeze may land after the frozen worker's window opened (the
# drill only sees the claim mark, and the claim is the dispatch's by well
# under a second): the window then has to outlast the hold (at most the
# lease) and still catch the rest of the first round's kernels.
FLEET_PROFILE_S, FLEET_TICK_S = FLEET_LEASE_S + 5, 0.5
FLEET_PYRAMID_LEVELS = 2


def pyramid_census(root, cells, cids, names, levels, what):
    """Hold a pyramid directory built over chips ``cids`` at
    PRODUCT_DATE to the rasters ``cells`` ({(name, cx, cy): flat cells}):
    every base tile of a chip is its raster, and every parent tile up to
    ``levels`` levels holds the 2x selection of its four children's
    persisted tiles.  Returns the tiles checked by level."""
    from firebird_tpu_torch.serve import pyramid as pyrlib

    pyr = pyrlib.TilePyramid(str(root))
    zb, half = pyrlib.Z_BASE, pyrlib.TILE_SIDE // 2
    counted = {}

    def load(name, z, x, y):
        npy, _ = pyr.tile_paths(name, PRODUCT_DATE, z, x, y)
        meta = pyr.peek_meta(name, PRODUCT_DATE, z, x, y)
        check(meta is not None and not meta["stale"] and os.path.exists(npy),
              f"{what}: pyramid tile {name} z{z}/{x}/{y} missing or stale")
        return np.load(npy)

    for name in names:
        level = sorted({pyrlib.tile_of_chip(cx, cy) for cx, cy in cids})
        for cx, cy in cids:
            got = load(name, zb, *pyrlib.tile_of_chip(cx, cy))
            check(np.array_equal(got.ravel(), cells[(name, cx, cy)]),
                  f"{what}: base tile of {name} chip ({cx},{cy}) differs "
                  f"from its raster")
        counted[str(zb)] = counted.get(str(zb), 0) + len(level)
        for z in range(zb - 1, zb - levels, -1):
            level = sorted({(x >> 1, y >> 1) for x, y in level})
            for x, y in level:
                got = load(name, z, x, y)
                for cz, kx, ky in pyrlib.children(z, x, y):
                    dx, dy = kx - 2 * x, ky - 2 * y
                    check(np.array_equal(
                        got[dy * half:(dy + 1) * half,
                            dx * half:(dx + 1) * half],
                        pyrlib.downsample2x(load(name, cz, kx, ky))),
                        f"{what}: {name} tile z{z}/{x}/{y} is not the 2x "
                        f"selection of its child z{cz}/{kx}/{ky}")
            counted[str(z)] = counted.get(str(z), 0) + len(level)
    return counted


def _spool_marks(directory):
    """The marks under a spool directory, each with its process's role and
    pid (read as ``trace collect`` reads them)."""
    from firebird_tpu_torch.obs import collect as obs_collect

    return [ev for ev in obs_collect.read_events(str(directory))
            if ev.get("kind") == "mark"]


def _gpu_apps():
    """The pid of each compute app (CUDA context) nvidia-smi lists on the
    card, one entry a context.  In a sandbox with its own pid namespace
    every entry may read as one pid (1): then only their count tells
    the contexts apart."""
    r = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                        "--format=csv,noheader"], capture_output=True,
                       text=True)
    return [int(t) for t in r.stdout.split() if t.strip().isdigit()]


def fleet_phase(smi, chips, ref_cfg, tmp, seed):
    """The fleet on the card (the module docstring's item 11): the tile's
    first FLEET_CHIPS chips as a queue plan, drained by ``fleet
    supervise`` with two ``fleet work`` processes on cuda:0 while one of
    them is frozen past its lease; held to ``driver_phase``'s rows
    (``ref_cfg``).  Returns the report."""
    import gzip
    import signal
    import sqlite3
    import threading

    from firebird_tpu_torch import products
    from firebird_tpu_torch.fleet import FleetQueue
    from firebird_tpu_torch.obs import profiling as obs_profiling
    from firebird_tpu_torch.rf import features, pipeline
    from firebird_tpu_torch.store.schema import columns, primary_key

    t_phase = time.perf_counter()
    cids = list(chips)[:FLEET_CHIPS]
    root = Path(tmp) / "fleet"
    src_dir = root / "chips"
    src_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    aux_src = SyntheticSource(seed, start=START, end=END)
    for c in cids:
        ch = chips[c]
        # uncompressed, as ops_phase writes them (FileSource's own
        # save_chip compresses: ~10 s a full chip)
        np.savez(src_dir / f"chip_{c[0]}_{c[1]}.npz", dates=ch.dates,
                 spectra=ch.spectra, qas=ch.qas)
        np.savez(src_dir / f"aux_{c[0]}_{c[1]}.npz",
                 **aux_src.aux(c[0], c[1]))
    setup_s = time.perf_counter() - t0
    store_path, spool = root / "fb.db", root / "telemetry"
    port = _free_ports(1)
    env = dict(os.environ, FIREBIRD_SOURCE="file",
               FIREBIRD_SOURCE_PATH=str(src_dir),
               FIREBIRD_STORE_BACKEND="sqlite",
               FIREBIRD_STORE_PATH=str(store_path),
               FIREBIRD_CHIPS_PER_BATCH=str(FLEET_CHUNK),
               FIREBIRD_MAX_OBS="0", FIREBIRD_FETCH_RETRIES="0",
               FIREBIRD_FLEET_MIN_WORKERS=str(FLEET_WORKERS),
               FIREBIRD_FLEET_MAX_WORKERS=str(FLEET_WORKERS),
               FIREBIRD_FLEET_LEASE_SEC=str(FLEET_LEASE_S),
               FIREBIRD_PROFILE=str(FLEET_PROFILE_S),
               FIREBIRD_STALL_SEC=str(OPS_STALL_S))
    cli = [sys.executable, "-m", "firebird_tpu_torch"]
    msday, meday = dt.to_ordinal(START), dt.to_ordinal(END)
    t0 = time.perf_counter()
    enq = subprocess.run(
        cli + ["fleet", "enqueue", "-t",
               f"{DRIVER_POINT[0]},{DRIVER_POINT[1]}", "-a", ACQUIRED,
               "-n", str(FLEET_CHIPS), "-c", str(FLEET_CHUNK)],
        env=env, capture_output=True, text=True)
    check(enq.returncode == 0, f"fleet: enqueue exited {enq.returncode}: "
          f"{enq.stderr[-3000:]}")
    plan = json.loads(enq.stdout.strip().splitlines()[-1])
    n_detect = FLEET_CHIPS // FLEET_CHUNK
    check(len(plan["detect"]) == n_detect and plan["jobs"] == n_detect,
          f"fleet: plan {plan}")
    # The classify and product jobs, on the plan's edges.  Not through
    # the plan's -s/-e: its classify payload carries -n, which limits the
    # training neighbourhood to the first -n chips of the 3x3 tiles, none
    # of them this tile's (the JAX package's plan does the same).
    q = FleetQueue(plan["queue"])
    plan["classify"] = [q.enqueue(
        "classify", {"x": DRIVER_POINT[0], "y": DRIVER_POINT[1],
                     "acquired": ACQUIRED, "msday": msday, "meday": meday},
        depends_on=plan["detect"])]
    xs, ys = [c[0] for c in cids], [c[1] for c in cids]
    plan["product"] = [q.enqueue(
        "product", {"bounds": [[min(xs), max(ys)], [max(xs), min(ys)]],
                    "products": list(products.PRODUCTS),
                    "product_dates": [PRODUCT_DATE], "acquired": ACQUIRED},
        depends_on=plan["classify"])]
    # The serving pyramid's tiles over the product rasters (pyramid/ next
    # to the fleet's store), built by a worker that holds cuda:0.
    plan["pyramid"] = [q.enqueue(
        "pyramid", {"bounds": [[min(xs), max(ys)], [max(xs), min(ys)]],
                    "products": list(products.PRODUCTS),
                    "product_dates": [PRODUCT_DATE],
                    "levels": FLEET_PYRAMID_LEVELS},
        depends_on=plan["product"])]
    q.close()
    enqueue_s = time.perf_counter() - t0

    # The drill: freeze the first worker seen claiming a detect job, hold
    # it until its lease has lapsed, then let it go on as a zombie.
    drill, history = {}, {}
    gpu_seen, gpu_most, answers = set(), [0], []
    done = threading.Event()

    def freeze():
        while not done.is_set():
            marks = _spool_marks(spool) if spool.exists() else []
            claim = next((m for m in marks if m["name"] == "job_claimed"
                          and m.get("attrs", {}).get("type") == "detect"),
                         None)
            if claim is None:
                time.sleep(0.02)
                continue
            pid, job = claim["pid"], claim["attrs"]["job"]
            os.kill(pid, signal.SIGSTOP)
            t_stop, stop_wall = time.perf_counter(), time.time()
            drill.update(pid=pid, job=job, trace=claim["trace"],
                         fence=claim["attrs"]["fence"],
                         stop_wall=stop_wall,
                         stop_after_claim_s=stop_wall - claim["t"])
            q = FleetQueue(str(root / "fleet.db"))
            while not done.is_set():
                j = q.job(job)
                if j["fence"] != drill["fence"] or \
                        (j["lease_expires"] or 0) < time.time():
                    break
                time.sleep(0.05)
            os.kill(pid, signal.SIGCONT)
            drill["hold_s"] = time.perf_counter() - t_stop
            drill["cont_wall"] = time.time()
            q.close()
            return

    def sample():
        """(e) the card's compute apps, and (the ops port) the
        supervisor's /progress while the drain lasts; its
        /metrics/history and /slo until each has answered with the
        workers' history (``history_phase`` holds what they said)."""
        n = 0
        while not done.is_set():
            apps = _gpu_apps()
            gpu_seen.update(apps)
            gpu_most[0] = max(gpu_most[0], len(apps))
            code = _get(f"http://127.0.0.1:{port}/progress")
            if code is not None and (not answers or answers[-1] != code):
                answers.append(code)
            if n % 4 == 3:
                read_history()
            n += 1
            time.sleep(0.5)

    def read_history():
        base = f"http://127.0.0.1:{port}"
        if "metrics_history" not in history:
            t1 = time.perf_counter()
            code, doc = _get_json(f"{base}/metrics/history?res=10"
                                  f"&window=3600")
            if code == 200 and any(s.startswith("worker:")
                                   for s in doc["sources"]):
                history["metrics_history"] = dict(
                    code=code, points=len(doc["points"]),
                    sources=doc["sources"], res_sec=doc["res_sec"],
                    seconds=time.perf_counter() - t1)
        if "slo" not in history:
            t1 = time.perf_counter()
            code, doc = _get_json(f"{base}/slo")
            b = (doc or {}).get("budgets") or {}
            if code == 200 and b.get("budgets") and "error" not in b:
                history["slo"] = dict(
                    code=code, spec=b["spec"], ok=b["ok"],
                    sources=b["sources"],
                    verdicts={x["name"]: x["ok"] for x in b["budgets"]},
                    seconds=time.perf_counter() - t1)

    threads = [threading.Thread(target=f, daemon=True)
               for f in (freeze, sample)]
    t0, t0_wall = time.perf_counter(), time.time()
    sup = subprocess.Popen(
        cli + ["fleet", "supervise", "--until-drained", "--tick",
               str(FLEET_TICK_S), "--ops-port", str(port), "--log-dir",
               str(root / "worker_logs")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for t in threads:
        t.start()
    try:
        out, _ = sup.communicate(timeout=600)
    finally:
        done.set()
        if sup.poll() is None:
            sup.kill()
        if drill.get("pid") and "hold_s" not in drill:
            os.kill(drill["pid"], signal.SIGCONT)
    drain_s = time.perf_counter() - t0
    for t in threads:
        t.join(timeout=10)
    logs = "\n".join(p.read_text()[-2000:] for p in sorted(
        (root / "worker_logs").glob("*.log")))
    check(sup.returncode == 0, f"fleet: supervise exited {sup.returncode}: "
          f"{out[-3000:]}\n{logs}")
    summary, _ = json.JSONDecoder().raw_decode(
        out[out.rindex('{\n "supervisor":'):])
    check_s = {}

    # (a) every job done, none dead
    t1 = time.perf_counter()
    q = FleetQueue(str(root / "fleet.db"))
    counts = q.counts()
    jobs = {j: q.job(j) for j in plan["detect"] + plan["classify"]
            + plan["product"] + plan["pyramid"]}
    check(counts == {"pending": 0, "leased": 0, "done": len(jobs),
                     "dead": 0}, f"fleet: queue {counts}")
    check_s["a"] = time.perf_counter() - t1

    # (b) the frozen worker's job went round again, and no stale write
    # landed: the 8 chips' rows are driver_phase's, key for key (rfrawp,
    # which the classify job wrote, is (c)'s)
    t1 = time.perf_counter()
    check("pid" in drill, "fleet: no detect claim seen to freeze")
    frozen_job = jobs[drill["job"]]
    events = [h["event"] for h in frozen_job["history"]]
    rejects = q.fence_rejects()
    check(frozen_job["attempts"] >= 2 and
          ("lease_expired" in events or rejects > 0),
          f"fleet: frozen job {drill['job']} history {events}, fence "
          f"rejects {rejects}")
    q.close()
    dbs = [SqliteStore(p, ref_cfg.keyspace())
           for p in (str(store_path), ref_cfg.store_path)]
    got_db, ref_db = (db.path for db in dbs)
    for db in dbs:
        db.close()
    con = sqlite3.connect(got_db)
    con.execute("ATTACH DATABASE ? AS ref", (ref_db,))
    mine = " OR ".join(f"(cx = {c[0]} AND cy = {c[1]})" for c in cids)
    rows = {}
    for table in ("chip", "pixel", "segment"):
        cols = ", ".join(f'"{c}"' for c in columns(table) if c != "rfrawp")
        order = ", ".join(f'"{c}"' for c in primary_key(table))
        have = con.execute(f'SELECT {cols} FROM main."{table}" '
                           f"ORDER BY {order}").fetchall()
        want = con.execute(f'SELECT {cols} FROM ref."{table}" WHERE {mine} '
                           f"ORDER BY {order}").fetchall()
        rows[table] = len(have)
        check(have == want and len(have) > 0,
              f"fleet: {table} rows differ from driver_phase's ({len(have)} "
              f"against {len(want)}; "
              f"{sum(a != b for a, b in zip(have, want))} differ)")
    con.close()
    check_s["b"] = time.perf_counter() - t1

    # (c) the model, every real segment's votes, each product raster
    t1 = time.perf_counter()
    store = SqliteStore(str(store_path), ref_cfg.keyspace())
    t = grid.tile(*DRIVER_POINT)
    model = pipeline.load_model(store, t["x"], t["y"])
    check(model is not None and model.n_trees == 500,
          "fleet: no full-width model stored")
    d = dt.to_ordinal(PRODUCT_DATE)
    rasters = store.read("product", {"date": PRODUCT_DATE})
    cells = {(n, cx, cy): np.asarray(v) for n, cx, cy, v in zip(
        rasters["name"], rasters["cx"], rasters["cy"], rasters["cells"])}
    check(len(cells) == len(products.PRODUCTS) * len(cids),
          f"fleet: {len(cells)} product rasters")
    n_scored = 0
    for cx, cy in cids:
        seg = store.read("segment", {"cx": cx, "cy": cy})
        real = features.real_rows(seg)
        votes = [seg["rfrawp"][i] for i in np.flatnonzero(real)]
        check(all(v is not None and len(v) == model.n_classes
                  for v in votes), f"fleet: chip ({cx},{cy}) lacks votes")
        n_scored += len(votes)
        for name in products.PRODUCTS:
            want = products.chip_product(name, d, cx, cy, seg,
                                         classes=model.classes)
            check(np.array_equal(cells[(name, cx, cy)], want),
                  f"fleet: {name} raster of chip ({cx},{cy}) differs")
    store.close()
    # ... and the pyramid job's tiles: each base tile is its chip's
    # stored raster, each parent the 2x selection of its four children.
    pyramid_tiles = pyramid_census(root / "pyramid", cells, cids,
                                   products.PRODUCTS,
                                   FLEET_PYRAMID_LEVELS, "fleet")
    check_s["c"] = time.perf_counter() - t1

    # (d) trace collect over the spool
    t1 = time.perf_counter()
    col = subprocess.run(cli + ["trace", "collect", "-d", str(spool)],
                         env=env, capture_output=True, text=True)
    collect_s = time.perf_counter() - t1
    check(col.returncode == 0, f"fleet: trace collect exited "
          f"{col.returncode}: {col.stderr[-3000:]}")
    line = json.loads(col.stdout.strip().splitlines()[-1])
    doc = json.loads(Path(line["out"]).read_text())
    procs = {(p["role"], p["pid"]) for p in doc["processes"]}
    workers = {pid for role, pid in procs if role == "worker"}
    check(("supervisor", sup.pid) in procs,
          f"fleet: the supervisor is not among {sorted(procs)}")
    check(len(workers) >= FLEET_WORKERS and drill["pid"] in workers,
          f"fleet: workers {sorted(workers)}, frozen {drill['pid']}")
    evs = doc["trace"]["traceEvents"]
    instants = {(e["name"], e["args"].get("trace"), e["args"].get("job"))
                for e in evs if e.get("ph") == "i"}
    for jid, job in jobs.items():
        acks = [e for e in evs if e.get("ph") == "i"
                and e["name"] == "job_acked" and e["args"].get("job") == jid]
        check(len(acks) == 1, f"fleet: job {jid} has {len(acks)} ack marks")
        tr = acks[0]["args"]["trace"]
        check(("job_claimed", tr, jid) in instants,
              f"fleet: job {jid}'s ack trace {tr} has no claim mark")
    spans = {(e["name"], e["pid"]) for e in evs if e.get("ph") == "X"}
    for name in ("dispatch", "drain"):
        check(any((name, w) in spans for w in workers),
              f"fleet: no {name} span on a worker pid")
    # where the drain went: the jobs' seconds by type (the workers'
    # merged fleet_job_seconds_<type>) and each window's capture, stop
    # and export (its `profile` span)
    job_s = {n[len("fleet_job_seconds_"):]: dict(count=h["count"],
                                                 sum=h["sum"])
             for n, h in doc["metrics"]["histograms"].items()
             if n.startswith("fleet_job_seconds_")}
    profile_s = {e["pid"]: e["dur"] / 1e6 for e in evs
                 if e.get("ph") == "X" and e["name"] == "profile"}
    # each window's span on the wall clock, against the drill's freeze
    epoch = doc["trace"]["otherData"]["epoch_unix"]
    profile_wall = {e["pid"]: (epoch + e["ts"] / 1e6,
                               epoch + (e["ts"] + e["dur"]) / 1e6)
                    for e in evs if e.get("ph") == "X"
                    and e["name"] == "profile"}
    check_s["d"] = time.perf_counter() - t1

    # (e) the workers on the card, the supervisor not: by pid where
    # nvidia-smi shows this namespace's pids, else by the count of
    # contexts (this process's, the workers', and the supervisor's if it
    # took one: at most 1 + FLEET_WORKERS, and that many once both
    # workers ran); route 0's kernels in the workers' profile windows (the
    # device trace file of each is named for its pid)
    t1 = time.perf_counter()
    by_pid = os.getpid() in gpu_seen
    if by_pid:
        check(sup.pid not in gpu_seen, f"fleet: the supervisor ({sup.pid})"
              f" held the card: {sorted(gpu_seen)}")
        check(workers <= gpu_seen, f"fleet: worker pids {sorted(workers)} "
              f"not all among the card's compute apps {sorted(gpu_seen)}")
    else:
        check(gpu_most[0] == 1 + FLEET_WORKERS,
              f"fleet: at most {gpu_most[0]} contexts on the card at once "
              f"(this process, {FLEET_WORKERS} workers: "
              f"{1 + FLEET_WORKERS}; the supervisor would add one)")
    windows = {}
    for path in (root / "device_profile").glob("**/*.trace.json.gz"):
        pid = int(re.match(r".*\.(\d+)\.trace\.json\.gz$",
                           path.name).group(1))
        with gzip.open(path, "rt", errors="replace") as f:
            names = {str(e.get("name", "")) for e in
                     json.load(f).get("traceEvents", ())
                     if isinstance(e, dict) and e.get("ph") == "X"
                     and e.get("cat") in obs_profiling.DEVICE_CATEGORIES}
        windows.setdefault(pid, set()).update(names)
    window_kernels = {}
    for pid in workers:
        names = " ".join(windows.get(pid, ()))
        window_kernels[pid] = [k for k in OPS_KERNEL_SYMBOLS if k in names]
        missing = [k for k in OPS_KERNEL_SYMBOLS if k not in names]
        span = profile_wall.get(pid)
        check(pid in windows and not missing,
              f"fleet: worker {pid}'s profile window lacks {missing} "
              f"(frozen worker {drill['pid']}, stopped at "
              f"{drill.get('stop_wall')}, continued at "
              f"{drill.get('cont_wall')}; this window's profile span "
              f"{span}; {len(windows.get(pid, ()))} device event names)")
    check_s["e"] = time.perf_counter() - t1

    # (f) no postmortem, no watchdog stall in any spooled snapshot
    snaps = doc["snapshots"]
    stalls = {k: s["metrics"].get("counters", {}).get("watchdog_stall_total",
                                                      0)
              for k, s in snaps.items()}
    check(not (root / "postmortem.json").exists(),
          "fleet: a postmortem bundle was written")
    check(not any(stalls.values()), f"fleet: watchdog stalls {stalls}")
    check(200 in answers, f"fleet: the supervisor's /progress answered "
          f"{answers}")

    marks = _spool_marks(spool)
    first_claim = min(m["t"] for m in marks if m["name"] == "job_claimed")
    lost = sum(s["metrics"].get("counters", {}).get("fleet_jobs_lost", 0)
               for s in snaps.values())
    out_rep = dict(
        chips=FLEET_CHIPS, jobs=len(jobs), workers=sorted(workers),
        supervisor=sup.pid, queue=counts, fence_rejects=rejects,
        jobs_lost=lost, drill=drill, frozen_job_history=events,
        supervisor_summary={k: v for k, v in summary.items()
                            if k != "decisions"},
        decisions=summary.get("decisions"), rows=rows,
        pyramid_tiles=pyramid_tiles,
        gpu_pids=sorted(gpu_seen), gpu_contexts_most=gpu_most[0],
        gpu_checked_by="pid" if by_pid else "context count",
        progress_answers=answers,
        processes=sorted(f"{r}:{p}" for r, p in procs),
        trace_events=len(evs), job_seconds=job_s,
        profile_span_seconds=profile_s,
        profile_span_wall=profile_wall, window_kernels=window_kernels,
        ops_history=history, home=str(root),
        split=dict(setup_s=setup_s, enqueue_s=enqueue_s,
                   startup_s=first_claim - t0_wall, drain_s=drain_s,
                   hold_s=drill.get("hold_s"), collect_s=collect_s),
        check_seconds=check_s, seconds=time.perf_counter() - t_phase)
    print(f"fleet: {len(jobs)} jobs ({n_detect} detect of {FLEET_CHUNK} "
          f"chips, classify, product, pyramid) drained by {len(workers)} workers on "
          f"one card under a supervisor in {drain_s:.1f} s; worker "
          f"{drill['pid']} frozen {drill.get('hold_s', 0):.1f} s on job "
          f"{drill['job']} (history {events}, {rejects} fence rejects, "
          f"{lost} jobs lost); first claim {first_claim - t0_wall:.1f} s "
          f"after launch; job seconds by type (count, sum) "
          + ", ".join(f"{k} {v['count']} {v['sum']:.1f}"
                      for k, v in sorted(job_s.items()))
          + "; profile windows (s) "
          + ", ".join(f"{v:.1f}" for v in profile_s.values())
          + f"; rows {rows}; collect {collect_s:.1f} s; "
          f"checks (s) " + ", ".join(f"{k} {v:.2f}" for k, v in
                                     check_s.items())
          + f"; phase {out_rep['seconds']:.1f} s on {smi}", flush=True)
    return out_rep, env


HISTORY_BURN = "batch_p95<0.001@99/1h"   # every drained batch a bad one
HISTORY_HOLD = "batch_p95<30@99/1h"      # the fleet's batches all good


def history_phase(smi, fleet, env):
    """The read side over the fleet's telemetry home (the module
    docstring's item 12): the supervisor's /metrics/history and /slo as
    ``fleet_phase`` read them while its ops port was up, then ``slo``,
    ``status`` and ``top`` as commands.  Returns the report."""
    from firebird_tpu_torch.obs import slo as obs_slo

    t_phase = time.perf_counter()
    cli = [sys.executable, "-m", "firebird_tpu_torch"]
    seconds = {}

    def run(*argv, codes=(0,)):
        t1 = time.perf_counter()
        r = subprocess.run(cli + list(argv), env=env, capture_output=True,
                           text=True, timeout=120)
        seconds[" ".join(argv)] = time.perf_counter() - t1
        check(r.returncode in codes, f"history: {' '.join(argv)} exited "
              f"{r.returncode}: {r.stderr[-3000:]}")
        return r.returncode, r.stdout

    hist, slo_doc = (fleet["ops_history"].get(k)
                     for k in ("metrics_history", "slo"))
    check(hist is not None and hist["points"] > 0,
          f"history: /metrics/history never answered 200 with a worker's "
          f"points during the drain ({fleet['ops_history']})")
    check(slo_doc is not None, "history: /slo never carried a budgets block "
          f"during the drain ({fleet['ops_history']})")
    names = [b["name"] for b in obs_slo.parse_budget_spec(
        obs_slo.DEFAULT_BUDGET_SPEC)]
    check(sorted(slo_doc["verdicts"]) == sorted(names),
          f"history: /slo's budgets {slo_doc['verdicts']}")
    series = Path(fleet["home"]) / "telemetry" / "series"
    events = series / obs_slo.BUDGET_EVENTS_FILE
    before = events.read_bytes() if events.exists() else b""
    # a pure read: a verdict for every objective of the default spec, and
    # no event recorded
    code, out = run("slo", "--no-record", codes=(0, 1))
    read = json.loads(out)
    check(sorted(b["name"] for b in read["budgets"]) == sorted(names)
          and all("ok" in b for b in read["budgets"]),
          f"history: slo --no-record budgets {read['budgets']}")
    check((events.read_bytes() if events.exists() else b"") == before,
          "history: slo --no-record wrote an event")
    # recording: a budget every drained batch burns is exhausted, exits 1
    # and lands in slo_events.jsonl; one they all keep is ok with data
    code, out = run("slo", "-b", HISTORY_BURN, codes=(1,))
    burnt = json.loads(out)
    check(burnt["events_appended"] and events.exists()
          and obs_slo.read_budget_events(str(series))[-1]["state"]
          in ("exhausted", "burning"),
          f"history: slo -b {HISTORY_BURN} recorded "
          f"{burnt.get('events_appended')}")
    code, out = run("slo", "--no-record", "-b", HISTORY_HOLD)
    held = json.loads(out)
    check(held["ok"] is True and held["budgets"][0]["ok"] is True
          and held["budgets"][0]["total"] > 0,
          f"history: slo -b {HISTORY_HOLD}: {held['budgets']}")
    # status: the drained queue and the budget view
    code, out = run("status")
    st = json.loads(out)
    jobs = st["fleet"]["jobs"]
    check(jobs["pending"] == jobs["leased"] == jobs["dead"] == 0
          and jobs["done"] == fleet["jobs"],
          f"history: status fleet jobs {jobs}")
    check(sorted(st["budgets"]["budgets"]) == sorted(names),
          f"history: status budgets {st.get('budgets')}")
    # top: one frame whose history block has a source
    code, out = run("top", "--iterations", "1")
    lines = out.splitlines()
    check(lines[0].startswith("firebird top") and any(
        ln.startswith("history (10s buckets") for ln in lines)
        and any(ln.startswith("  fleet_") for ln in lines),
        f"history: top rendered {lines}")
    rep = dict(metrics_history=hist, slo_endpoint=slo_doc,
               slo_read={b["name"]: b["ok"] for b in read["budgets"]},
               slo_burn=dict(spec=HISTORY_BURN, ok=burnt["ok"],
                             events=len(burnt["events_appended"])),
               slo_hold=dict(spec=HISTORY_HOLD, total=held["budgets"][0][
                   "total"], bad=held["budgets"][0]["bad"]),
               status_jobs=jobs, status_sections=list(st),
               top_lines=len(lines),
               command_seconds=seconds,
               seconds=time.perf_counter() - t_phase)
    print(f"history: /metrics/history?res=10 {hist['code']} with "
          f"{hist['points']} points from {hist['sources']}; /slo budgets "
          f"{slo_doc['verdicts']}; slo --no-record {rep['slo_read']}; "
          f"slo -b {HISTORY_BURN} exit 1, {rep['slo_burn']['events']} "
          f"event(s) recorded; slo -b {HISTORY_HOLD} ok over "
          f"{rep['slo_hold']['total']:g} batches; status jobs {jobs}; top "
          f"{len(lines)} lines; commands (s) "
          + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
          + f"; phase {rep['seconds']:.1f} s on {smi}", flush=True)
    return rep


# ---------------------------------------------------------------------------
# The stream path
# ---------------------------------------------------------------------------

STREAM_CHIPS = 8
STREAM_BOOT = f"{START}/2015-12-31"
STEP_DAY = "2016-06-01"
STEP_SIZE = 800


class RangeSource:
    """Chips made beforehand, each cut to the asked range on every fetch
    (as tests/test_stream_driver.py's StepSource does), so a chip is the
    same whatever range is asked; ``fetched`` logs (chip, acquisitions
    served)."""

    def __init__(self, chips):
        self.chips = chips
        self.fetched = []

    def chip(self, cx, cy, acquired):
        c = self.chips[(cx, cy)]
        lo, hi = dt.acquired_range(acquired)
        m = (c.dates >= lo) & (c.dates <= hi)
        self.fetched.append(((cx, cy), int(m.sum())))
        return dataclasses.replace(c, dates=c.dates[m], spectra=c.spectra[:, m],
                                   qas=c.qas[m])


def stepped(chip):
    """``chip`` with every pixel stepped +STEP_SIZE on every band from
    STEP_DAY."""
    sp = chip.spectra.astype(np.int32)
    sp[:, chip.dates >= dt.to_ordinal(STEP_DAY)] += STEP_SIZE
    return dataclasses.replace(
        chip, spectra=np.clip(sp, -32768, 32767).astype(np.int16))


def replay_on_cpu(state1, cid, source, any_exceed, vario=None):
    """One chip's update on the CPU: its pass-1 checkpoint (``state1``, a
    statestore of the copy) through the port's ``step`` over the delta
    past its horizon, as the stream driver feeds the card, with the
    checkpoint's variogram replaced by ``vario`` [P, B] where given.  ORs
    into ``any_exceed`` [P] the pixels that exceeded during the window;
    returns the final state as numpy arrays."""
    st, side = state1.load(cid)
    if vario is not None:
        st = dataclasses.replace(st, vario=torch.from_numpy(vario))
    horizon, anchor = float(side["horizon"]), float(side["anchor"])
    chip = source.chip(*cid, f"{dt.to_iso(int(horizon) + 1)}/{END}")
    p = pack([chip], bucket=Config.obs_bucket, max_obs=0)
    T = int(p.n_obs[0])
    t = p.dates[0][:T].astype(np.float64)
    for k in np.nonzero(t > horizon)[0]:
        st = incremental.step(
            st, torch.from_numpy(incremental.design_row(float(t[k]), anchor)),
            torch.from_numpy(np.ascontiguousarray(p.spectra[0][:, :, k].T)),
            torch.from_numpy(p.qas[0][:, k].astype(np.int32)), float(t[k]),
            sensor=p.sensor)
        any_exceed |= st.n_exceed.numpy() > 0
    return {f: getattr(st, f).numpy() for f in incremental.STATE_FIELDS}


def step_profile(state1, cid, source, dev):
    """One chip's update step loop replayed on the card from its pass-1
    checkpoint, under ``torch.profiler``: the kernels' device ms (their own
    time, memcpy and memset included), the kernels launched, and the
    loop's span on the card's timeline (CUDA events), with the steps."""
    from firebird_tpu_torch.driver import stream as sdrv

    st, side = state1.load(cid)
    horizon, anchor = float(side["horizon"]), float(side["anchor"])
    p = pack([source.chip(*cid, f"{dt.to_iso(int(horizon) + 1)}/{END}")],
             bucket=Config.obs_bucket, max_obs=0)
    T = int(p.n_obs[0])
    idx = np.nonzero(p.dates[0][:T] > horizon)[0]
    y, qa, rows, days = sdrv._delta_on_device(p, idx, anchor, st.rmse.dtype,
                                              dev)
    st = st.to(dev)

    def loop():
        s = st
        for j in range(idx.size):
            s = incremental.step(s, rows[j], y[j], qa[j], days[j],
                                 sensor=p.sensor)
        return s

    loop()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    ev = (torch.cuda.Event(enable_timing=True),
          torch.cuda.Event(enable_timing=True))
    with torch.profiler.profile(activities=acts) as prof:
        ev[0].record()
        loop()
        ev[1].record()
        torch.cuda.synchronize()
    rows_ = [e for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and e.self_device_time_total > 0]
    return dict(steps=int(idx.size),
                kernel_ms=sum(e.self_device_time_total for e in rows_) / 1e3,
                kernels=sum(e.count for e in rows_),
                span_ms=ev[0].elapsed_time(ev[1]))


def expected_rows(chips, acquired, dev, rows=True):
    """``detect_packed`` + ``format.batch_frames`` on the card for
    ``chips`` (one batch) cut to ``acquired``: a MemoryStore of the rows
    (None without ``rows``) and the host result."""
    src = RangeSource(chips)
    packed = pack([src.chip(*c, acquired) for c in chips],
                  bucket=Config.obs_bucket, max_obs=0)
    seg = kernel.segments_to_numpy(kernel.detect_packed(packed, device=dev))
    if not rows:
        return None, seg
    want = MemoryStore("want")
    for _, frames in fmt.batch_frames(packed, seg):
        for table in ("chip", "pixel", "segment"):
            want.write(table, frames[table])
    return want, seg


def stream_phase(smi, chips, dev):
    """The stream path on the card (the module docstring's item 13)."""
    from firebird_tpu_torch.alerts import AlertLog, alert_db_path, repair_chip
    from firebird_tpu_torch.driver import stream as sdrv
    from firebird_tpu_torch.fleet import FleetQueue, queue_path
    from firebird_tpu_torch.streamops import TileStateStore

    t_phase = time.perf_counter()
    cids = list(chips)[:STREAM_CHIPS]
    chips = {c: chips[c] for c in cids}
    step_cid = cids[-1]
    chips[step_cid] = stepped(chips[step_cid])
    synth = cids[:-1]
    P = chips[step_cid].qas.shape[1] * chips[step_cid].qas.shape[2]
    cfg = Config(chips_per_batch=STREAM_CHIPS, store_backend="sqlite",
                 max_obs=0, fetch_retries=0)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = dataclasses.replace(cfg, store_path=str(Path(tmp) / "fb.db"))
        source = RangeSource(chips)
        store = SqliteStore(cfg.store_path, cfg.keyspace())
        counts = lambda: {t: store.count(t)
                          for t in ("chip", "pixel", "segment")}

        def run(acquired):
            cuda_ops.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            summary = sdrv.stream(*DRIVER_POINT, acquired=acquired,
                                  number=STREAM_CHIPS, cfg=cfg,
                                  source=source, device=dev)
            torch.cuda.synchronize()
            return (summary, time.perf_counter() - t0,
                    dict(cuda_ops.LAUNCHES), sdrv.stream_stage_seconds())

        # Pass 1: the bootstrap.
        torch.cuda.reset_peak_memory_stats()
        s1, wall1, l1, st1 = run(STREAM_BOOT)
        launched = {k for k, n in l1.items() if n > 0}
        check(launched == ROUTE_0, f"stream bootstrap launched "
              f"{sorted(launched)}, expected {sorted(ROUTE_0)}")
        check(s1["bootstrapped"] == STREAM_CHIPS and s1["updated"] == 0
              and s1["alerts_emitted"] == 0, f"stream pass 1: {s1}")
        sdir = sdrv.sstore_mod.state_dir(cfg)
        live = TileStateStore(sdir)
        check(live.chips() == sorted(cids), "stream pass 1: checkpoints "
              f"{live.chips()}")
        want, boot_seg = expected_rows(chips, STREAM_BOOT, dev)
        for table in ("chip", "pixel", "segment"):
            check(_rows(store, table) == _rows(want, table),
                  f"stream bootstrap's {table} rows differ from "
                  "detect_packed's")
        rows1 = counts()
        # A copy of the pass-1 checkpoints, slot by slot (the tile file is
        # sparse: a plain copy would write out its 2 500 slots' holes).
        state1 = TileStateStore(str(Path(tmp) / "state1"))
        for c in cids:
            state1.save_arrays(c, live.peek_arrays(c))

        # Pass 2: the update over the delta past each horizon.
        s2, wall2, l2, st2 = run(ACQUIRED)
        check(not any(l2.values()), f"the update launched {l2}")
        check(s2["bootstrapped"] == 0 and s2["updated"] == STREAM_CHIPS,
              f"stream pass 2: {s2}")
        # (a) the card's state against the CPU replay of the same delta.
        # An exceed run live at the seed counts as an exceedance in the
        # window: the batch rerun, seeing the later clean data, absorbs
        # that run's observations, the stream does not.
        exceeded = {c: state1.peek_arrays(c)["n_exceed"] > 0 for c in cids}
        n_diff = 0
        for c in cids:
            cpu = replay_on_cpu(state1, c, source, exceeded[c])
            card = live.peek_arrays(c)
            diff = np.zeros(P, bool)
            for f in incremental.STATE_FIELDS:
                a, b = card[f], cpu[f]
                check(a.dtype == b.dtype, f"{f} dtype")
                a = a.reshape(P, -1).view(np.uint8)
                b = b.reshape(P, -1).view(np.uint8)
                diff |= (a != b).any(1)
            n_diff += int(diff.sum())
        state1.close()
        print(f"stream update: card state vs the CPU replay: {n_diff} of "
              f"{len(cids) * P} pixels differ in some field", flush=True)
        check(n_diff == 0, f"stream update: {n_diff} pixels off the CPU "
              "replay")
        # (b) the stream against a batch rerun over the full range, on the
        # synthetic chips: test_incremental.py's comparable pixels (the
        # same last-segment model, no exceedance in the window).  The
        # stream keeps the seed's variogram, the rerun takes it over the
        # longer archive, and a score near the threshold can cross it by
        # that alone: so a comparable pixel's window must also decide
        # alike when replayed with the rerun's variogram.
        _, full_seg = expected_rows({c: chips[c] for c in synth}, ACQUIRED,
                                    dev, rows=False)
        n_comp, n_den, off = 0, 0, {}
        ar = np.arange(P)
        for i, c in enumerate(synth):
            ns_cut, ns_full = boot_seg.n_segments[i], full_seg.n_segments[i]
            last_cut = np.maximum(ns_cut.astype(np.int64) - 1, 0)
            last_full = np.maximum(ns_full.astype(np.int64) - 1, 0)
            cc = boot_seg.seg_coef[i][ar, last_cut]
            cf = full_seg.seg_coef[i][ar, last_full]
            same = ((cc == cf).all(axis=(1, 2)) & (ns_cut == ns_full)
                    & ~exceeded[c])
            state1 = TileStateStore(str(Path(tmp) / "state1"))
            alt_ex = np.zeros(P, bool)
            alt = replay_on_cpu(state1, c, source, alt_ex,
                                vario=full_seg.vario[i])
            state1.close()
            card = live.peek_arrays(c)
            ok = same & ~alt_ex
            for f in ("end_day", "nobs", "n_exceed"):
                ok &= alt[f] == card[f]
            meta = full_seg.seg_meta[i][ar, last_full]
            want = dict(end_day=meta[:, 1], nobs=meta[:, 5].astype(np.int32),
                        n_exceed=np.round(meta[:, 3] * params.PEEK_SIZE)
                        .astype(np.int32))
            for f, w in want.items():
                bad = np.nonzero(ok & (card[f] != w))[0]
                off.update({f"{f} {list(c)} {int(p)}":
                            (float(card[f][p]), float(w[p])) for p in bad[:8]})
            n_comp += int(ok.sum())
            n_den += int((same & ~ok).sum())
        print(f"stream vs batch rerun: {n_comp} of {len(synth) * P} "
              f"synthetic pixels comparable ({n_den} more with the same "
              f"model whose window decides otherwise with the rerun's "
              f"variogram); off the rerun (stream, batch): {off}",
              flush=True)
        check(not off, "stream vs batch rerun: comparable pixels differ")
        check(n_comp >= len(synth) * P // 3,
              f"stream vs batch rerun: only {n_comp} comparable pixels")
        # The step loop's kernels: one synthetic chip's update replayed on
        # the card under the profiler.
        state1 = TileStateStore(str(Path(tmp) / "state1"))
        prof = step_profile(state1, synth[0], source, dev)
        state1.close()
        # (c) one alert per newly broken pixel; one repair job per flagged
        # chip.
        broken = {c: live.peek_arrays(c)["break_day"] > 0 for c in cids}
        n_broken = sum(int(b.sum()) for b in broken.values())
        alog = AlertLog(alert_db_path(cfg))
        recs = []
        while True:
            page = alog.since(recs[-1]["id"] if recs else 0, limit=10_000)
            if not page:
                break
            recs += page
        alog.close()
        keys = {(r["px"], r["py"]) for r in recs}
        check(len(recs) == len(keys) == n_broken == s2["alerts_emitted"],
              f"alerts: {len(recs)} records, {len(keys)} pixels, "
              f"{n_broken} newly broken, {s2['alerts_emitted']} emitted")
        step_recs = [r for r in recs if (r["cx"], r["cy"]) == step_cid]
        check(all(r["break_date"].startswith("2016") for r in step_recs),
              "the step chip's alerts are not all dated 2016")
        years = {}
        for r in recs:
            years[r["break_date"][:4]] = years.get(r["break_date"][:4], 0) + 1
        q = FleetQueue(queue_path(cfg))
        jobs = q.open_jobs("repair")
        flagged = {c for c, b in broken.items() if b.any()}
        check(set(jobs) == flagged
              and len(jobs) == s2["repair_jobs_enqueued"]
              and all(q.job(j)["payload"]["pixels"] == int(broken[c].sum())
                      for c, j in jobs.items()),
              f"repair jobs {sorted(jobs)} for flagged chips "
              f"{sorted(flagged)}")
        # Pass 3: the same range again.
        rows2 = counts()
        source.fetched = []
        s3, wall3, l3, _ = run(ACQUIRED)
        check(not any(n for _, n in source.fetched) and not any(l3.values())
              and counts() == rows2 and s3["updated"] == 0 and s3["alerts_emitted"] == 0
              and s3["alerts_deduped"] == 0
              and s3["repair_jobs_enqueued"] == 0
              and q.open_jobs("repair") == jobs,
              f"stream pass 3 was not a no-op: {s3}, fetched "
              f"{source.fetched}, launches {l3}")
        # repair_chip on the step chip over the full range.
        cuda_ops.reset_launches()
        caught = MemoryStore("repair")
        t0 = time.perf_counter()
        rep = repair_chip(cfg, step_cid, ACQUIRED, source=source,
                          store=caught, device=dev)
        torch.cuda.synchronize()
        repair_s = time.perf_counter() - t0
        lr = {k for k, n in cuda_ops.LAUNCHES.items() if n > 0}
        check(lr == ROUTE_0, f"repair_chip launched {sorted(lr)}")
        want_rep, _ = expected_rows({step_cid: chips[step_cid]}, ACQUIRED,
                                    dev)
        for table in ("chip", "pixel", "segment"):
            check(_rows(caught, table) == _rows(want_rep, table),
                  f"repair_chip's {table} rows differ from detect_packed's")
        check(rep["still_flagged"] == 0
              and not (live.peek_arrays(step_cid)["break_day"] > 0).any(),
              f"repair_chip left flagged pixels: {rep}")
        q.close()
        live.close()
        store.close()
    peak = torch.cuda.max_memory_allocated()
    steps = s2["obs_applied"]
    n = len(cids)
    out = dict(
        chips=n, pixels=n * P, bootstrap_seconds=wall1,
        bootstrap_pixels_per_s=n * P / wall1, bootstrap_stages=st1,
        bootstrap_launches=l1, update_seconds=wall2, chip_steps=steps,
        chip_steps_per_s=steps / wall2, pixel_observations=steps * P,
        pixel_observations_per_s=steps * P / wall2,
        step_device_ms=st2["step_device"] * 1e3,
        step_span_share=st2["step_device"] / wall2,
        step_profile=prof,
        kernel_busy_share=prof["kernel_ms"] / prof["steps"] * steps / 1e3
        / wall2, update_stages=st2,
        statestore_load_ms_per_chip=st2["load"] * 1e3 / n,
        statestore_save_ms_per_chip=st2["save"] * 1e3 / n,
        publish_seconds=st2["publish"], alert_seconds=st2["alert"],
        noop_seconds=wall3, repair_seconds=repair_s, repair=rep,
        summaries=[s1, s2, s3], cpu_replay_pixels_differing=n_diff,
        comparable_pixels=n_comp, other_denominators=n_den,
        alerts=len(recs), alert_years=years,
        repair_jobs=len(jobs), rows_pass1=rows1, rows_after_update=rows2,
        peak_bytes=peak,
        phase_seconds=time.perf_counter() - t_phase)
    print(f"stream on {smi}: bootstrap {n} chips x {P} px in {wall1:.3f} s, "
          f"{out['bootstrap_pixels_per_s']:.1f} px/s (stages "
          + ", ".join(f"{k} {v:.3f}" for k, v in st1.items() if v)
          + f"); update {wall2:.3f} s: {steps} chip-steps "
          f"({out['chip_steps_per_s']:.1f}/s), {steps * P} pixel-observations "
          f"({out['pixel_observations_per_s']:.1f}/s), step loops "
          f"{out['step_device_ms']:.3f} device ms (CUDA events; "
          f"{100 * out['step_span_share']:.2f} % of the update wall; "
          f"profiled on one chip: {prof['kernels']} kernels, "
          f"{prof['kernel_ms']:.3f} kernel ms in a {prof['span_ms']:.3f} ms "
          f"span over {prof['steps']} steps, so the kernels busy "
          f"{100 * out['kernel_busy_share']:.2f} % of the update wall), "
          f"statestore load {out['statestore_load_ms_per_chip']:.3f} / save "
          f"{out['statestore_save_ms_per_chip']:.3f} ms a chip, publish "
          f"{st2['publish']:.3f} s, alerts {st2['alert']:.3f} s (stages "
          + ", ".join(f"{k} {v:.3f}" for k, v in st2.items() if v)
          + f"); {len(recs)} alerts {years}, {len(jobs)} repair jobs; no-op "
          f"pass {wall3:.3f} s; repair_chip {repair_s:.3f} s; peak "
          f"{peak / 2**30:.2f} GiB; phase {out['phase_seconds']:.1f} s",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# Stream ingest: the watcher-fed fleet stream path under the object tier
# ---------------------------------------------------------------------------

INGEST_CHIPS = 2


def _canonical_payload(state_dir, cid):
    """A chip's checkpoint as the canonical ``serialize_state`` bytes of
    its live slot."""
    from firebird_tpu_torch.streamops import statestore as sst

    st = sst.TileStateStore(state_dir)
    try:
        a = st.peek_arrays(cid)
    finally:
        st.close()
    P, B, K = a["coefs"].shape
    return b"".join(sst._canonical(n, a[n], d, sh).tobytes()
                    for n, d, sh in sst._layout(P, B, K))


def _sorted_rows(store, table):
    """``table``'s rows, a tuple each in sorted column order, sorted by the
    primary key: two stores hold the same rows key for key when these are
    equal."""
    from firebird_tpu_torch.store.schema import primary_key

    d = store.read(table)
    cols = sorted(d)
    at = [cols.index(k) for k in primary_key(table)]
    rows = list(zip(*(d[c] for c in cols)))
    rows.sort(key=lambda r: tuple(r[i] for i in at))
    return cols, rows


def _sqlite_diff(a, b, table):
    """(rows of ``table`` in sqlite file ``a``, in ``b``, rows in one of
    them and not the other): every column compared in sqlite, so 0 means
    equal key for key."""
    import sqlite3

    from firebird_tpu_torch.store.schema import columns

    cols = ", ".join(f'"{c}"' for c in columns(table))
    con = sqlite3.connect(a)
    try:
        con.execute("ATTACH DATABASE ? AS other", (b,))
        n = [con.execute(f'SELECT COUNT(*) FROM {db}."{table}"').fetchone()[0]
             for db in ("main", "other")]
        diff = sum(con.execute(
            f'SELECT COUNT(*) FROM (SELECT {cols} FROM {x}."{table}" '
            f'EXCEPT SELECT {cols} FROM {y}."{table}")').fetchone()[0]
            for x, y in (("main", "other"), ("other", "main")))
    finally:
        con.close()
    return n[0], n[1], diff


def _alert_rows(path):
    import sqlite3

    con = sqlite3.connect(path)
    try:
        return sorted(con.execute(
            "SELECT cx, cy, px, py, break_day FROM alerts").fetchall())
    finally:
        con.close()


@contextlib.contextmanager
def _environ(env):
    """The process environment with ``env`` set, restored on exit."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _command(argv, env):
    """(exit code, stdout) of ``python -m firebird_tpu_torch`` ``argv`` run
    in this process under ``env``."""
    import io

    from firebird_tpu_torch import __main__ as tmain

    out = io.StringIO()
    try:
        with _environ(env), contextlib.redirect_stdout(out):
            tmain.main(argv)
        code = 0
    except SystemExit as e:
        code = e.code
    return code, out.getvalue()


def ingest_phase(smi, chips, dev):
    """Stream ingest on the card (the module docstring's item 14), then
    ``alert_phase`` (item 19) over what it left; the two reports."""
    from firebird_tpu_torch.alerts import alert_db_path
    from firebird_tpu_torch.driver import fetch as dfetch
    from firebird_tpu_torch.driver import stream as sdrv
    from firebird_tpu_torch.fleet import FleetWorker, make_queue
    from firebird_tpu_torch.ingest import FileSource
    from firebird_tpu_torch.obs import metrics as obs_metrics
    from firebird_tpu_torch.obs import spool as obs_spool
    from firebird_tpu_torch.store import objectstore as objlib
    from firebird_tpu_torch.streamops import (AcquisitionWatcher,
                                              SceneCursor, TileStateStore,
                                              watch_db_path)

    t_phase = time.perf_counter()
    secs = {}
    cids = list(chips)[:INGEST_CHIPS]
    step_cid = cids[-1]
    data = {c: chips[c] for c in cids}
    data[step_cid] = stepped(data[step_cid])
    days = data[cids[0]].dates
    boot_end = dt.to_ordinal(STREAM_BOOT.split("/")[1])
    boot_last = int(days[days <= boot_end].max())
    full_last = int(days[days <= dt.to_ordinal(END)].max())
    acq = lambda last: f"{START}/{dt.to_iso(last + 1)}"     # noqa: E731
    base = dict(store_backend="sqlite", max_obs=0, fetch_retries=0,
                chips_per_batch=INGEST_CHIPS, alert_repair=False)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        archive, objects = str(tmp / "archive"), str(tmp / "objects")
        # The serial leg: the stream driver alone, no watcher, fleet or
        # object tier, on the same chips from memory.
        t1 = time.perf_counter()
        scfg = Config(store_path=str(tmp / "serial" / "fb.db"), **base)
        serial, serial_stages = [], []
        for last in (boot_last, full_last):
            serial.append(sdrv.stream(
                *DRIVER_POINT, acquired=acq(last), number=INGEST_CHIPS,
                cfg=scfg, source=RangeSource(data), device=dev))
            serial_stages.append(sdrv.stream_stage_seconds())
        torch.cuda.synchronize()
        secs["serial"] = time.perf_counter() - t1

        # The store's mirror follows the environment, the checkpoints'
        # the config: both name the object root.
        with _environ({"FIREBIRD_OBJECT_ROOT": objects}):
            # Land the archive to STREAM_BOOT, then its newest scene.
            t1 = time.perf_counter()
            got = dfetch.fetch(*DRIVER_POINT, archive, STREAM_BOOT,
                               number=INGEST_CHIPS,
                               cfg=Config(store_backend="memory",
                                          input_parallelism=INGEST_CHIPS),
                               source=RangeSource(data))
            check(got == (INGEST_CHIPS, INGEST_CHIPS), f"fetch wrote {got}")
            fs = FileSource(archive)
            fs.append_scene(f"LC08_{dt.to_iso(boot_last)}",
                            date=dt.to_iso(boot_last))
            secs["fetch"] = time.perf_counter() - t1
            cfg = Config(store_path=str(tmp / "fleet" / "fb.db"),
                         source_backend="file", source_path=archive,
                         object_root=objects, **base)
            queue = make_queue(cfg)
            # (a) One bootstrap and one stream job a chip, the stream job
            # dep'd on its chip's bootstrap; a second watcher on the same
            # watcher.db enqueues nothing.
            t1 = time.perf_counter()
            w = AcquisitionWatcher(cfg, *DRIVER_POINT, number=INGEST_CHIPS,
                                   acquired_start=START, queue=queue)
            s1 = w.poll_once()
            boot = queue.open_jobs("detect")
            strm = queue.open_jobs("stream")
            check(s1["scenes_new"] == 1 and s1["jobs"] == 2 * INGEST_CHIPS
                  and set(boot) == set(strm) == set(cids)
                  and all(queue.job(strm[c])["depends_on"] == [boot[c]]
                          and queue.job(boot[c])["payload"]["bootstrap"]
                          for c in cids),
                  f"watcher poll 1: {s1}, bootstraps {boot}, streams {strm}")
            before = queue.counts()
            w2 = AcquisitionWatcher(
                cfg, *DRIVER_POINT, number=INGEST_CHIPS, acquired_start=START,
                queue=queue, cursor=SceneCursor(watch_db_path(cfg)))
            s2 = w2.poll_once()
            w2.cursor.close()
            check(s2["jobs"] == 0 and s2["scenes_new"] == 0
                  and queue.counts() == before,
                  f"a second watcher on the same cursor enqueued: {s2}")
            secs["a"] = time.perf_counter() - t1
            # (b) The drain on the card: the bootstraps launch route 0's
            # kernels; the update's step runs on the card's state.
            seen = []
            real_step = incremental.step

            def step_on(st, *a, **kw):
                seen.append(st.coefs.device.type)
                return real_step(st, *a, **kw)

            t1 = time.perf_counter()
            worker = FleetWorker(cfg, queue, poll_sec=0.05)
            obs_spool.arm(cfg, "worker", worker.run_id)
            try:
                cuda_ops.reset_launches()
                d1 = worker.run(until_drained=True)
                torch.cuda.synchronize()
                l1 = dict(cuda_ops.LAUNCHES)
                secs["drain_bootstrap"] = time.perf_counter() - t1
                live = TileStateStore(sdrv.sstore_mod.state_dir(cfg))
                standard = int(live.peek_arrays(step_cid)["active"].sum())
                live.close()
                t2 = time.perf_counter()
                with ThreadPoolExecutor(INGEST_CHIPS) as ex:
                    list(ex.map(fs.save_chip,
                                [RangeSource(data).chip(*c, ACQUIRED)
                                 for c in cids]))
                fs.append_scene(f"LC08_{dt.to_iso(full_last)}",
                                date=dt.to_iso(full_last))
                secs["land"] = time.perf_counter() - t2
                s3 = w.poll_once()
                check(s3["jobs"] == INGEST_CHIPS
                      and not queue.open_jobs("detect")
                      and set(queue.open_jobs("stream")) == set(cids),
                      f"watcher poll 2: {s3}")
                t2 = time.perf_counter()
                incremental.step = step_on
                try:
                    d2 = worker.run(until_drained=True)
                finally:
                    incremental.step = real_step
                torch.cuda.synchronize()
                secs["drain_update"] = time.perf_counter() - t2
            finally:
                obs_spool.disarm()
            w.close()
            l2 = dict(cuda_ops.LAUNCHES)
            launched = {k for k, n in l2.items() if n > 0}
            counts = queue.counts()
            check(counts == {"pending": 0, "leased": 0,
                             "done": 3 * INGEST_CHIPS, "dead": 0}
                  and not d2["wedged"],
                  f"the drain left {counts} ({d1}, {d2})")
            check(launched == ROUTE_0 and l1 == l2,
                  f"the drains launched {l2} (bootstraps {l1}), expected "
                  f"{sorted(ROUTE_0)} from the bootstraps alone")
            check(seen and set(seen) == {"cuda"},
                  f"the update stepped state on {sorted(set(seen))}")
            secs["b"] = time.perf_counter() - t1
            # (c) The fleet leg against the serial leg.
            t1 = time.perf_counter()
            fleet_alerts = _alert_rows(alert_db_path(cfg))
            keys = [r[2:] for r in fleet_alerts]
            check(fleet_alerts == _alert_rows(alert_db_path(scfg))
                  and len(set(keys)) == len(keys),
                  f"alerts: fleet {len(fleet_alerts)}, serial "
                  f"{len(_alert_rows(alert_db_path(scfg)))}, "
                  f"{len(keys) - len(set(keys))} duplicates")
            sdir, fdir = (sdrv.sstore_mod.state_dir(c) for c in (scfg, cfg))
            payloads = {c: _canonical_payload(fdir, c) for c in cids}
            check(all(payloads[c] == _canonical_payload(sdir, c)
                      for c in cids), "checkpoint bytes differ from the "
                  "serial leg's")
            fstore = SqliteStore(cfg.store_path, cfg.keyspace())
            sstore = SqliteStore(scfg.store_path, scfg.keyspace())
            n_rows = {}
            for table in ("chip", "pixel", "segment"):
                n, m, diff = _sqlite_diff(fstore.path, sstore.path, table)
                n_rows[table] = n
                check(n == m > 0 and diff == 0,
                      f"the fleet's {table} rows ({n}) differ from the "
                      f"serial leg's ({m}) in {diff}")
            sstore.close()
            # The step chip: an alert on every pixel its bootstrap left
            # monitoring a standard-procedure model.
            step_alerts = sum(1 for r in fleet_alerts
                              if (r[0], r[1]) == step_cid)
            check(step_alerts == standard > 0,
                  f"the stepped chip raised {step_alerts} alerts for its "
                  f"{standard} standard pixels")
            secs["c"] = time.perf_counter() - t1
            # (d) The object tier: the checkpoints, the rows, the census,
            # the scrub and status.
            t1 = time.perf_counter()
            ostore = objlib.open_object_root(root=objects)
            scope = objlib.scope_for_path(fdir)
            check(all(ostore.get(f"{scope}/state/chip_{c[0]}_{c[1]}")[0]
                      == payloads[c] for c in cids),
                  "a checkpoint object differs from its packed slot")
            mirror = objlib.ObjectBackedStore(
                ostore, objlib.scope_for_path(cfg.store_path),
                cfg.keyspace(), read_only=True)
            for table in n_rows:
                check(_sorted_rows(mirror, table)
                      == _sorted_rows(fstore, table),
                      f"the object mirror's {table} rows differ")
            fstore.close()
            n_objects = len(ostore.list())
            env = {"FIREBIRD_STORE_BACKEND": "sqlite",
                   "FIREBIRD_STORE_PATH": cfg.store_path,
                   "FIREBIRD_OBJECT_ROOT": objects}
            code, out = _command(["objectstore", "census"], env)
            census = json.loads(out)
            check(code == 0 and census["keys"] == n_objects > 0
                  and census["orphan_chunks"] == 0 and census["junk"] == 0,
                  f"objectstore census: {census} ({n_objects} objects)")
            code, out = _command(["objectstore", "scrub", "--dry-run",
                                  "--grace", "0"], env)
            scrub = json.loads(out)
            check(code == 0 and scrub["removed"] == 0
                  and scrub["referenced"] == census["chunks"],
                  f"objectstore scrub --dry-run: {scrub}")
            code, out = _command(["status"], env)
            status = json.loads(out)
            wstat = status.get("streamops", {}).get("watcher", {})
            check(code == 0 and wstat.get("scenes") == 2
                  and status.get("object", {}).get("keys") == n_objects
                  and not [k for k, v in status.items()
                           if isinstance(v, dict) and "error" in v],
                  f"status: watcher {wstat}, object "
                  f"{status.get('object')}")
            secs["d"] = time.perf_counter() - t1
            # (e) Freshness: publish -> alert observed, and the budget over
            # the phase's home evaluates alert_freshness.
            t1 = time.perf_counter()
            fresh = obs_metrics.histogram(
                "acquisition_to_alert_seconds").snapshot()
            code, out = _command(["slo", "--no-record"], env)
            budgets = {b["name"]: b for b in json.loads(out)["budgets"]}
            af = budgets.get("alert_freshness", {})
            check(fresh["count"] >= 1 and af.get("ok") is not None,
                  f"freshness: {fresh['count']} observations, "
                  f"alert_freshness {af}")
            secs["e"] = time.perf_counter() - t1
            out = dict(chips=len(cids), scenes=2, jobs=dict(counts),
                       rows=n_rows, launches=l2, alerts=len(fleet_alerts),
                       step_chip_alerts=step_alerts, serial=serial,
                       serial_stages=serial_stages, census=census,
                       scrub=scrub, acquisition_to_alert=fresh,
                       alert_freshness=af, seconds=secs,
                       phase_seconds=time.perf_counter() - t_phase)
            print(f"ingest on {smi}: {len(cids)} chips fetched to "
                  f"{STREAM_BOOT}, scene {dt.to_iso(boot_last)} -> "
                  f"{s1['jobs']} jobs (the second watcher {s2['jobs']}), "
                  f"2016-2017 landed, scene {dt.to_iso(full_last)} -> "
                  f"{s3['jobs']} jobs; drained on {dev}: {counts}, launches "
                  f"{l2}; {len(fleet_alerts)} alerts ({step_alerts} on the "
                  f"stepped chip) = the serial leg's, checkpoints and rows "
                  f"equal; {n_objects} objects, census {census['keys']} keys "
                  f"{census['chunks']} chunks, scrub removed "
                  f"{scrub['removed']}; acquisition_to_alert_seconds n="
                  f"{fresh['count']} p95={fresh.get('p95')}, alert_freshness "
                  f"ok {af.get('ok')}; seconds "
                  + ", ".join(f"{k} {v:.1f}" for k, v in secs.items())
                  + "; the serial leg's stages (s) "
                  + " / ".join(", ".join(f"{k} {v:.2f}"
                                         for k, v in st.items() if v)
                               for st in serial_stages)
                  + f"; phase {out['phase_seconds']:.1f} s", flush=True)
            # The alert feed, the fanout plane and the canary over what
            # this phase left: its store and alert log, queue, archive and
            # worker on the card.
            try:
                alert = alert_phase(smi, cfg, queue, worker, archive, tmp,
                                    env)
            finally:
                queue.close()
    return out, alert



ALERT_POLL_S = 0.5          # the replica's rollup and changefeed polls
ALERT_PROBE_TIMEOUT = 30.0  # the prober's per-request timeout
ALERT_PROBE_WAIT = 90.0     # the longest the canary may take to resolve
ALERT_DATE = "2010-01-01"   # the prober's pixel and pyramid date


class _Sink:
    """A local webhook receiver: every POST's record ids, in order."""

    def __init__(self):
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.posts: list = []
        self.lock = threading.Lock()
        sink = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(
                    int(self.headers.get("Content-Length") or 0))
                doc = json.loads(body)
                with sink.lock:
                    sink.posts.append([(int(r["id"]), int(r["cx"]),
                                        int(r["cy"]))
                                       for r in doc.get("alerts", ())])
                self.send_response(200)
                self.end_headers()

            def log_message(self, *a):
                pass

        self.srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}/hook"

    def ids(self):
        """(distinct record ids, records received, POSTs)."""
        with self.lock:
            recs = [r for post in self.posts for r in post]
            return {r[0] for r in recs}, len(recs), len(self.posts)

    def chip_ids(self, cid):
        with self.lock:
            return {r[0] for post in self.posts for r in post
                    if (r[1], r[2]) == tuple(cid)}

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()


def _prober_metrics(directory):
    """The last metric snapshot of the prober's spool (counters and
    histograms), or empty ones before its first."""
    from firebird_tpu_torch.obs import collect as obs_collect

    snaps = [ev for ev in obs_collect.read_events(str(directory))
             if ev.get("kind") == "snap" and ev.get("role") == "prober"]
    if not snaps:
        return {}, {}
    m = max(snaps, key=lambda ev: ev["t"])["metrics"]
    return m.get("counters", {}), m.get("histograms", {})


def _log_after(alog, cursor):
    """Every record of the alert log past ``cursor``, paged."""
    out = []
    while True:
        page = alog.since(out[-1]["id"] if out else cursor, limit=10_000)
        if not page:
            return out
        out += page


def _mean(hist):
    return hist.get("sum", 0.0) / max(hist.get("count", 0), 1)


def alert_phase(smi, cfg, queue, worker, archive, tmp, env):
    """Alert delivery and the canary over ``ingest_phase``'s home (the
    module docstring's item 19).  Returns the report."""
    import collections
    import signal
    import threading
    import urllib.request

    from firebird_tpu_torch.alerts import AlertLog, alert_db_path, rollup
    from firebird_tpu_torch.alerts import subindex
    from firebird_tpu_torch.serve import pyramid as pyrlib
    from firebird_tpu_torch.streamops import AcquisitionWatcher

    t_phase = time.perf_counter()
    secs = {}
    home = Path(tmp)
    apath = alert_db_path(cfg)
    alog = AlertLog(apath)
    latest0 = alog.latest_cursor()
    logged = _log_after(alog, 0)
    check(len(logged) == alog.count() == latest0 > 0,
          f"alert: the log holds {alog.count()} records, paged "
          f"{len(logged)}, latest {latest0}")
    proot = home / "pyramid"
    # The replica reads the store's sqlite file, not the object mirror.
    senv = {k: v for k, v in os.environ.items()
            if k != "FIREBIRD_OBJECT_ROOT"}
    senv.update(FIREBIRD_STORE_BACKEND="sqlite",
                FIREBIRD_STORE_PATH=cfg.store_path, FIREBIRD_ALERT_DB=apath,
                FIREBIRD_FLEET_DB=queue.path,
                FIREBIRD_SERVE_PYRAMID_DIR=str(proot),
                FIREBIRD_FANOUT_POLL=str(ALERT_POLL_S),
                FIREBIRD_SERVE_FEED_POLL=str(ALERT_POLL_S),
                FIREBIRD_TELEMETRY_DIR=str(home / "serve_spool"))
    penv = dict(senv, FIREBIRD_TELEMETRY_DIR=str(home / "probe_spool"))
    apps0 = len(_gpu_apps())
    apps_most, done = [apps0], threading.Event()

    def sample():
        while not done.is_set():
            apps_most[0] = max(apps_most[0], len(_gpu_apps()))
            time.sleep(0.25)

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    procs, sinks = [], {}
    t0 = time.perf_counter()
    slog = open(home / "alert_serve.log", "w")
    procs.append((subprocess.Popen(
        [sys.executable, "-m", "firebird_tpu_torch", "serve", "--port", "0",
         "--host", "127.0.0.1"], env=senv, stdout=slog,
        stderr=subprocess.STDOUT, text=True), slog))
    try:
        while True:
            m = re.search(r" on port (\d+) ",
                          (home / "alert_serve.log").read_text())
            if m:
                base = f"http://127.0.0.1:{m.group(1)}"
                break
            check(procs[0][0].poll() is None
                  and time.perf_counter() - t0 < 60,
                  "alert: the replica did not come up: "
                  + (home / "alert_serve.log").read_text()[-3000:])
            time.sleep(0.02)
        secs["startup"] = time.perf_counter() - t0

        # (a) /v1/alerts paged to the end = AlertLog.since over the whole
        # log; one bbox + t0/t1 query = the brute-force filter.
        t1 = time.perf_counter()
        pulled, cursor, pages = [], 0, 0
        while True:
            code, body, _ = _http(base, f"/v1/alerts?since={cursor}"
                                        "&limit=10000")
            doc = json.loads(body)
            check(code == 200, f"alert: /v1/alerts answered {code}")
            pages += 1
            pulled += doc["alerts"]
            if doc["cursor"] == cursor:
                break
            cursor = doc["cursor"]
        check(pulled == logged and doc["latest"] == latest0,
              f"alert: /v1/alerts paged {len(pulled)} records over {pages} "
              f"pages, the log {len(logged)}")
        # The chip with the most alerts (the stepped one); a box over its
        # upper half, and the earlier half of the break days.
        step = collections.Counter(
            (r["cx"], r["cy"]) for r in logged).most_common(1)[0][0]
        half = (step[0] + 1.0, step[1] - 1499.0, step[0] + 2999.0,
                step[1] - 1.0)
        days = sorted(r["break_day"] for r in logged)
        t0q, t1q = (dt.to_iso(int(d)) for d in (days[0],
                                                 days[len(days) // 2]))
        lo, hi = dt.to_ordinal(t0q), dt.to_ordinal(t1q)
        code, body, _ = _http(
            base, "/v1/alerts?since=0&limit=10000&bbox="
                  + ",".join(str(v) for v in half) + f"&t0={t0q}&t1={t1q}")
        got_q = [r["id"] for r in json.loads(body)["alerts"]]
        want_q = [r["id"] for r in logged
                  if subindex.aoi_contains(half, r["px"], r["py"])
                  and lo <= r["break_day"] <= hi]
        check(code == 200 and got_q == want_q and want_q,
              f"alert: the bbox/t0/t1 query gave {len(got_q)} records, the "
              f"brute-force filter {len(want_q)}")
        secs["a"] = time.perf_counter() - t1

        # (b) Three sinks registered through the endpoint; the
        # coordinator's fanout jobs drained by this process's worker.
        t1 = time.perf_counter()
        far = (half[0] + 600_000.0, half[1], half[2] + 600_000.0, half[3])
        regs = {"all": "", "aoi": "&bbox=" + ",".join(map(str, half))
                + "&mode=batch&max_n=400",
                "far": "&bbox=" + ",".join(map(str, far))
                + "&mode=digest&window=60"}
        for name, extra in regs.items():
            sinks[name] = _Sink()
            req = urllib.request.Request(
                f"{base}/v1/alerts/webhooks?url={sinks[name].url}"
                f"&since={latest0}{extra}", data=b"", method="POST")
            with urllib.request.urlopen(req, timeout=30) as r:
                check(r.status == 200, f"alert: registering {name}")
        while alog.rollup_cursor() < latest0:
            check(time.perf_counter() - t1 < 30,
                  f"alert: rollup at {alog.rollup_cursor()} of {latest0}")
            time.sleep(0.05)
        cuda_ops.reset_launches()
        fan = worker.run(until_drained=True)["acked"]
        torch.cuda.synchronize()
        fan_launches = {k: n for k, n in cuda_ops.LAUNCHES.items() if n}
        want = {"all": {r["id"] for r in logged},
                "aoi": {r["id"] for r in logged
                        if subindex.aoi_contains(half, r["px"], r["py"])},
                "far": set()}
        delivered = {}
        for name, sink in sinks.items():
            ids, n_recs, n_posts = sink.ids()
            delivered[name] = dict(distinct=len(ids), records=n_recs,
                                   posts=n_posts,
                                   duplicates=n_recs - len(ids))
            check(ids == want[name],
                  f"alert: sink {name} holds {len(ids)} distinct records "
                  f"of {len(want[name])} its AOI contains")
        check(not fan_launches,
              f"alert: the fanout drain launched {fan_launches}")
        code, out = _command(["status"], env)
        ablock = json.loads(out).get("alerts", {})
        lags = [s["lag"] for s in ablock.get("subscribers", ())]
        check(code == 0 and lags == [0, 0, 0]
              and ablock.get("fanout", {}).get("open_jobs") == 0,
              f"alert: status's alerts block: lags {lags}, fanout "
              f"{ablock.get('fanout')}")
        again = rollup(alog, queue, cfg)
        check(again == [], f"alert: a second rollup enqueued {again}")
        secs["b"] = time.perf_counter() - t1

        # (c) The canary over one probe chip, the tile's chip
        # INGEST_CHIPS: its scenes drive the watcher, the bootstrap and
        # stream jobs on the card, the alert log, SSE and the webhooks.
        t1 = time.perf_counter()
        (probe_cid,) = [tuple(int(v) for v in c) for c in grid.chips(
            grid.tile(*DRIVER_POINT))[INGEST_CHIPS:INGEST_CHIPS + 1]]
        w = AcquisitionWatcher(cfg, *DRIVER_POINT, number=INGEST_CHIPS + 1,
                               acquired_start=START, queue=queue)
        # The root tile the prober revalidates (/v1/pyramid/ccd/0/0/0), as
        # a CONUS-wide ``pyramid build`` persists it (this one holds no
        # data), once the replica's changefeed has replayed the log: each
        # alert stale-stamps its chip's ancestors, the root among them, so
        # the probe chip's alerts will stale it again.
        t2 = time.perf_counter()
        while _prom_value(_http(base, "/metrics")[1].decode(),
                          "changefeed_records_applied") < latest0:
            check(time.perf_counter() - t2 < 30,
                  "alert: the replica's changefeed did not replay the log")
            time.sleep(0.05)
        pyrlib.TilePyramid(str(proot))._persist(
            "ccd", ALERT_DATE, 0, 0, 0,
            np.full((pyrlib.TILE_SIDE, pyrlib.TILE_SIDE), pyrlib.FILL_VALUE,
                    np.int32))
        root_tile = f"/v1/pyramid/ccd/0/0/0?date={ALERT_DATE}"
        check(_http(base, root_tile)[0] == 200,
              "alert: the replica does not serve the persisted root tile")
        plog = open(home / "alert_probe.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "firebird_tpu_torch", "probe",
             "--serve-url", base, "--landing", archive, "-x",
             str(DRIVER_POINT[0]), "-y", str(DRIVER_POINT[1]),
             "--chip-offset", str(INGEST_CHIPS), "--chips", "1", "-i", "1",
             "--timeout", str(int(ALERT_PROBE_TIMEOUT))], env=penv,
            stdout=plog, stderr=subprocess.STDOUT, text=True), plog))
        cuda_ops.reset_launches()
        drains = 0
        while True:
            w.poll_once()
            drains += worker.run(until_drained=True)["acked"]
            counters, _ = _prober_metrics(home / "probe_spool")
            probe_ids = {r["id"] for r in _log_after(alog, latest0)
                         if (r["cx"], r["cy"]) == probe_cid}
            if counters.get("probe_attempts_alert", 0) >= 1 \
                    and counters.get("probe_attempts_webhook", 0) >= 1 \
                    and probe_ids \
                    and sinks["all"].chip_ids(probe_cid) == probe_ids:
                break
            check(procs[1][0].poll() is None
                  and time.perf_counter() - t1 < ALERT_PROBE_WAIT,
                  f"alert: the canary did not resolve: {counters}; "
                  + (home / "alert_probe.log").read_text()[-2000:])
            time.sleep(0.2)
        torch.cuda.synchronize()
        probe_launches = {k: n for k, n in cuda_ops.LAUNCHES.items() if n}
        procs[1][0].send_signal(signal.SIGTERM)
        check(procs[1][0].wait(timeout=60) == 0,
              "alert: the prober exited "
              + (home / "alert_probe.log").read_text()[-2000:])
        w.close()
        counters, hists = _prober_metrics(home / "probe_spool")
        probe_alerts = [r for r in _log_after(alog, latest0)
                        if (r["cx"], r["cy"]) == probe_cid]
        check(set(probe_launches) == ROUTE_0,
              f"alert: the probe chip's jobs launched {probe_launches}, "
              f"expected {sorted(ROUTE_0)}")
        check(counters.get("probe_failures", 0) == 0
              and all(counters.get(f"probe_attempts_{k}", 0) > 0
                      for k in ("serve", "alert", "webhook"))
              and counters.get("probe_etag_304", 0) >= 1,
              f"alert: the prober's counters {counters}")
        lat = {k: hists.get(f"probe_{k}_seconds", {})
               for k in ("serve", "alert", "webhook")}
        check(all(lat[k].get("count", 0) >= 1 for k in ("alert", "webhook")),
              f"alert: the prober's latencies {lat}")
        n_chip = 100 * 100
        check(len(probe_alerts) == n_chip
              and sinks["all"].chip_ids(probe_cid)
              == {r["id"] for r in probe_alerts},
              f"alert: the probe chip raised {len(probe_alerts)} alerts, "
              f"{len(sinks['all'].chip_ids(probe_cid))} on the all sink")
        secs["c"] = time.perf_counter() - t1
    finally:
        done.set()
        for proc, _ in procs:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        codes = []
        for proc, log in procs:
            try:
                codes.append(proc.wait(timeout=60))
            except subprocess.TimeoutExpired:
                proc.kill()
                codes.append(proc.wait())
            log.close()
        for sink in sinks.values():
            sink.close()
        alog.close()
    sampler.join()
    # (d) Neither the replica nor the prober opened a CUDA context.
    check(codes == [0, 0], f"alert: the replica and the prober exited "
          f"{codes}")
    check(apps_most[0] <= apps0,
          f"alert: the card's compute apps rose from {apps0} to "
          f"{apps_most[0]} while the replica and the prober ran")
    for name, sink in sinks.items():
        ids, n_recs, n_posts = sink.ids()
        delivered[name] = dict(delivered[name], final_distinct=len(ids),
                               final_records=n_recs, final_posts=n_posts,
                               final_duplicates=n_recs - len(ids))
    out = dict(records=len(logged), pages=pages, query=len(want_q),
               delivered=delivered, fanout_drain=fan,
               probe_chip=list(probe_cid), probe_alerts=len(probe_alerts),
               probe_counters=counters,
               probe_seconds={k: {q: v.get(q) for q in
                                  ("count", "sum", "p50", "max")}
                              for k, v in lat.items()},
               launches=probe_launches, jobs_acked=drains,
               compute_apps=[apps0, apps_most[0]], seconds=secs,
               phase_seconds=time.perf_counter() - t_phase)
    print(f"alert on {smi}: /v1/alerts {len(pulled)} records in {pages} "
          f"pages = the log, the bbox/t0/t1 query {len(want_q)}; sinks "
          + ", ".join(f"{k} {v['distinct']} distinct ({v['duplicates']} "
                      f"duplicate records in {v['posts']} POSTs)"
                      for k, v in delivered.items())
          + f", 0 open fanout jobs, no launch; canary: probe chip "
          f"{probe_cid} {len(probe_alerts)} alerts, launches "
          f"{probe_launches}, attempts serve "
          f"{counters.get('probe_attempts_serve')} alert "
          f"{counters.get('probe_attempts_alert')} webhook "
          f"{counters.get('probe_attempts_webhook')}, failures "
          f"{counters.get('probe_failures', 0)}, 304s "
          f"{counters.get('probe_etag_304')}, seconds "
          + ", ".join(f"{k} mean {_mean(lat[k]):.3f} (n="
                      f"{lat[k].get('count', 0)})" for k in lat)
          + f"; all sink at the end: {delivered['all']['final_distinct']} "
          f"distinct of {delivered['all']['final_records']} records; "
          f"compute apps {apps0} -> {apps_most[0]}; seconds "
          + ", ".join(f"{k} {v:.1f}" for k, v in secs.items())
          + f"; phase {out['phase_seconds']:.1f} s", flush=True)
    return out


F64_SAMPLE = 256


def _reference(kw):
    return reference_detect(**kw)


def f64_phase(smi, seed, dev, pool):
    """One full chip on the float64 route (the module docstring's item
    15); the reference runs in ``pool`` (spawned processes)."""
    src = SyntheticSource(seed, start=START, end=END)
    packed = pack([src.chip(1000, 2000)], bucket=64)
    cuda_ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seg = kernel.detect_packed(packed, device=dev, dtype=torch.float64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(not any(cuda_ops.LAUNCHES.values()),
          f"the f64 route launched {cuda_ops.LAUNCHES}")
    check(seg.seg_coef.dtype == torch.float64, "f64 route's dtype")
    C, B, P, T = packed.spectra.shape
    check_result(seg, C, P, T)
    f32 = kernel.detect_packed(packed, device=dev, pallas="1", fused=0,
                               mixed=False)
    seg32 = kernel.ChipSegments(*[
        None if v is None else (v.double() if v.is_floating_point() else v)
        for v in vars(f32).values()])
    agree, n_dis = decision_agreement(seg, seg32)
    host = kernel.chip_slice(seg, 0, to_host=True)
    pix = np.sort(np.random.default_rng(seed).choice(P, F64_SAMPLE,
                                                     replace=False))
    t0 = time.perf_counter()
    refs = list(pool.map(_reference, [pixel_timeseries(packed, 0, int(i))
                                      for i in pix]))
    ref_s = time.perf_counter() - t0
    dates = packed.dates[0][: int(packed.n_obs[0])]
    close = lambda a, b, rel, abs_: abs(a - b) <= max(rel * abs(b), abs_)
    n_models = 0
    for i, o in zip(pix, refs):
        k = kernel.segments_to_records(host, dates, int(i))
        check(len(o["change_models"]) == len(k["change_models"])
              and o["processing_mask"] == k["processing_mask"]
              and o["procedure"] == k["procedure"],
              f"f64 pixel {i}: segments or mask differ from the reference")
        for om, km in zip(o["change_models"], k["change_models"]):
            n_models += 1
            for f in ("start_day", "end_day", "break_day", "curve_qa",
                      "observation_count"):
                check(om[f] == km[f], f"f64 pixel {i}: {f}")
            check(close(km["change_probability"], om["change_probability"],
                        0, 1e-6), f"f64 pixel {i}: change_probability")
            for band in params.BAND_NAMES:
                kb, ob = km[band], om[band]
                check(close(kb["rmse"], ob["rmse"], 1e-6, 1e-6)
                      and close(kb["magnitude"], ob["magnitude"], 1e-6, 1e-6)
                      and close(kb["intercept"], ob["intercept"], 1e-5, 1e-3)
                      and all(close(b, a, 1e-5, 1e-6) for a, b in zip(
                          ob["coefficients"], kb["coefficients"])),
                      f"f64 pixel {i} band {band}: floats off the reference")
    print(f"f64 route: 1 chip x {P} px, T={T} on {smi}: {wall:.3f} s, "
          f"{P / wall:.1f} px/s, no kernel launched; {F64_SAMPLE} pixels "
          f"({n_models} segments) equal reference.detect (reference "
          f"{ref_s:.1f} s in 8 processes); decision agreement with f32 route "
          f"0 {agree} ({n_dis} pixels differ)", flush=True)
    return dict(seconds=wall, pixels=P, T=T, sample=F64_SAMPLE,
                sample_segments=n_models, reference_seconds=ref_s,
                agreement_with_f32_route_0=agree,
                pixels_differing_from_f32=n_dis)


VALIDATE_PIXELS = 100


def validate_phase(smi, dev, kernels, pool):
    """The parity audit on one full chip (the module docstring's item 16):
    ``validate.validate`` on the default synthetic chip in float64, then
    float32, each with the launch counters set to 0 just before and read
    just after, the oracle replayed in ``pool``; then route 0's roofline
    model (``flops.bench_detail``) at that chip's P, T, W and round counts
    beside the kernel phase's bounds (``kernels``).  Returns the
    report."""
    from firebird_tpu_torch import validate

    t_phase = time.perf_counter()
    memo, replayed = {}, {}

    def replay(tasks):
        """The oracle over ``tasks`` in the pool, each distinct pixel
        series once: the float32 audit's pixels are the float64 audit's,
        and the oracle is the same float64 program on the same inputs."""
        keys = [tuple(np.asarray(a).tobytes() for a in t[:3]) for t in tasks]
        new = {k: t for k, t in zip(keys, tasks) if k not in memo}
        memo.update(zip(new, pool.map(validate.oracle, new.values())))
        replayed[dtype] = len(new)
        return [memo[k] for k in keys]

    reports, launches, walls = {}, {}, {}
    for dtype in ("float64", "float32"):
        cuda_ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = validate.validate(acquired=ACQUIRED, n_pixels=VALIDATE_PIXELS,
                                dtype=dtype, device=dev, replay=replay)
        walls[dtype] = time.perf_counter() - t0
        launches[dtype] = {k: v for k, v in cuda_ops.LAUNCHES.items() if v}
        check(rep["pixels_audited"] == VALIDATE_PIXELS
              and rep["chip"] == [100, 200] and rep["dtype"] == dtype,
              f"validate {dtype}: report {rep}")
        reports[dtype] = dict(rep, exit_code=0 if rep["structural_agreement"]
                              else 2)
    check(reports["float64"]["structural_agreement"],
          f"validate float64: structure disagrees with the reference: "
          f"{reports['float64']['mismatches']}")
    check(not launches["float64"],
          f"validate float64 launched {launches['float64']}")
    check(set(launches["float32"]) == ROUTE_0,
          f"validate float32 launched {launches['float32']}, not route 0's "
          f"{sorted(ROUTE_0)}")
    # Route 0's roofline model over the same chip, timed warm.
    cfg = Config.from_env()
    packed = pack([SyntheticSource(seed=0).chip(100, 200, ACQUIRED)],
                  bucket=cfg.obs_bucket, max_obs=cfg.max_obs)
    route = kernel.pallas_components(None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seg = kernel.detect_packed(packed, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    C, B, P, T = packed.spectra.shape
    phases = tuple(float(v) for v in
                   seg.round_counts.reshape(-1, 3).float().mean(0).tolist())
    model = flops_model.bench_detail(
        pixels_per_sec=P / wall, P=P, T=T, W=kernel.window_cap(packed),
        S=int(seg.seg_meta.shape[-2]), rounds=float(seg.rounds.float().mean()),
        device_kind=torch.cuda.get_device_name(0), sensor=packed.sensor,
        phase_rounds=phases,
        pallas=flops_model.modeled_components(route, kernel.fused_mode(None)),
        wire_bytes=2, mixed=route.mixed)
    bounds = {k: dict(bound_ms=kernels[k]["bound_ms"],
                      bound_by=kernels[k]["bound_by"], ms=kernels[k]["ms"])
              for k in sorted(ROUTE_0)}
    out = dict(reports=reports, launches=launches, seconds_by_dtype=walls,
               oracle_replayed=replayed,
               roofline=dict(P=P, T=T, wall_s=wall, model=model,
                             kernel_bounds=bounds),
               seconds=time.perf_counter() - t_phase)
    for dtype, rep in reports.items():
        print(f"validate {dtype}: chip (100, 200), {rep['pixels_audited']} "
              f"of {P} px, T={rep['obs_per_pixel']}: structural agreement "
              f"{rep['structural_agreement']} (exit {rep['exit_code']}), "
              f"break_day_agreement {rep['break_day_agreement']}, mismatches "
              f"{rep['mismatches']}, change_probability max abs err "
              f"{rep['change_probability_max_abs_err']:.3g}, numeric max rel "
              f"err {rep['numeric_max_rel_err']}; launches "
              f"{launches[dtype] or 'none'}; {replayed[dtype]} pixels "
              f"replayed; {walls[dtype]:.1f} s on {smi}",
              flush=True)
    print(f"roofline, route 0 on that chip (P={P}, T={T}, "
          f"{wall * 1e3:.1f} ms, {P / wall:.1f} px/s): "
          + json.dumps(model) + "; the kernel phase's bounds a launch "
          + ", ".join(f"{k} {v['bound_ms']:.4f} ms ({v['bound_by']}; "
                      f"{v['ms']:.3f} ms)" for k, v in bounds.items())
          + f"; phase {out['seconds']:.1f} s on {smi}", flush=True)
    return out


# ---------------------------------------------------------------------------
# The ring across processes
# ---------------------------------------------------------------------------

MP_RING_PROCS = 2
MP_RING_REPS = 20
# Whole hops and agreements timed by the host's clock.
MP_RING_CALLS = 5
MP_RING_TIMEOUT_S = 600
# What a dispatch may leave allocated on the card once its result is gone:
# caches of a few kernels' constants, far below one receive buffer (a
# stage-2 carry, 191 MB a shard at this size).
MP_RING_HELD_BYTES = 64 << 20


def held_bytes(dev, base):
    """The device memory allocated beyond ``base``, once the buffers that
    other processes released by CUDA IPC are freed."""
    torch.cuda.synchronize()
    torch.cuda.ipc_collect()
    return torch.cuda.memory_allocated(dev) - base


def wall_ms(fn, reps):
    """Median milliseconds of ``fn`` (and the card's work it queued) over
    ``reps`` runs, by the host's clock."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _torch_makers(seed, shard, dev):
    """``ring_payload``'s draws on the card from a generator seeded by
    (seed, shard): any process remakes any shard's payload."""
    gen = torch.Generator(device=dev).manual_seed(1000 * seed + shard)
    tdt = lambda dt: torch.from_numpy(np.empty(0, dt)).dtype
    ints = lambda hi, shape, dt=np.int32: torch.randint(
        0, hi, shape, generator=gen, device=dev, dtype=tdt(dt))
    bits = lambda shape: torch.rand(shape, generator=gen, device=dev) < 0.5
    flts = lambda shape: torch.randn(shape, generator=gen, device=dev)
    return ints, bits, flts


def mp_ring_start(seed, chips, T, tmp):
    """Start ``mp_ring_phase``'s two processes (``--mp-ring-child``) on the
    card.  They bring up their gloo group, CUDA contexts, kernels and chips
    and hold the cross-process hop to its plain version, then wait on the
    run's store until :func:`mp_ring_phase` releases them."""
    port = _free_ports(1)
    directory = Path(tmp) / "mp_ring"
    directory.mkdir()
    apps = len(_gpu_apps())
    procs, logs = [], []
    for pid in range(MP_RING_PROCS):
        logs.append(open(directory / f"child{pid}.log", "w"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
             "--chips", str(chips), "--mp-ring-child", str(pid),
             "--mp-ring-coord", f"127.0.0.1:{port}", "--mp-ring-dir",
             str(directory), "--mp-ring-T", str(T)],
            stdout=logs[-1], stderr=subprocess.STDOUT,
            env=dict(os.environ, OMP_NUM_THREADS="2")))
    return dict(procs=procs, logs=logs, port=port, dir=directory,
                apps=apps, t_start=time.perf_counter())


def mp_ring_stop(mp):
    """Kill what is left of :func:`mp_ring_start`'s processes."""
    for p in mp["procs"]:
        if p.poll() is None:
            p.kill()
            p.wait()
    for f in mp["logs"]:
        f.close()


def mp_ring_child(args):
    """One process of ``mp_ring_phase`` (``--mp-ring-child PID``): its half
    of the sharded batch (``--chips`` / 2 chips, the second half keeping
    the ragged strip), one shard on ``cuda:0`` of a global mesh of two.
    Writes ``result.PID.json`` and ``fields.PID.npz`` into
    ``--mp-ring-dir``."""
    from firebird_tpu_torch.parallel import dist, make_mesh

    pid, out = args.mp_ring_child, Path(args.mp_ring_dir)
    check(dist.init_distributed(args.mp_ring_coord, MP_RING_PROCS, pid),
          "the gloo group did not come up")
    dev = dist.local_device()
    torch.zeros(1, device=dev)
    cuda_ops.build()
    store = dist.store()
    store.set(f"mp_ring/up/{pid}", "1")
    # The chips one at a time, on few threads: this runs beside the
    # host-bound classification.
    torch.set_num_threads(2)
    per = args.chips // MP_RING_PROCS
    src = SyntheticSource(args.seed, start=START, end=END)
    packed = pack([src.chip(1000 * c, 2000)
                   for c in range(pid * per, (pid + 1) * per)],
                  bucket=args.mp_ring_T)
    if pid * per >= args.chips // SHARDS:        # ragged_batch's half
        qas = packed.qas.copy()
        qas[:, qas.shape[1] // 10:, :] = 1 << params.QA_FILL_BIT
        packed = dataclasses.replace(packed, qas=qas)
    mesh = make_mesh(timeout_s=MP_RING_TIMEOUT_S)
    check(len(mesh) == MP_RING_PROCS and list(mesh.local) == [pid],
          f"mesh {mesh}")
    # (c) ring_row's payload across the processes: the kernel into the
    # receiver's IPC-mapped buffer and the plain gloo send of the same
    # bytes, each against the sender's source remade here.
    T = packed.spectra.shape[-1]
    mine = ring_payload(*_torch_makers(args.seed, pid, dev), T)
    theirs = ring_payload(*_torch_makers(args.seed, 1 - pid, dev), T)
    got = cuda_ops.ring_remote_copy([mine], +1, mesh=mesh)[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = cuda_ops.ring_remote_copy_plain([mine], +1, mesh=mesh)[0]
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    raw = lambda t: t.reshape(-1).view(torch.uint8)
    for k, (a, b, c) in enumerate(zip(got, want, theirs)):
        check(torch.equal(raw(a), raw(b)) and torch.equal(raw(a), raw(c)),
              f"process {pid}: the cross-process hop's tensor {k} differs")
    del got, want, theirs
    # For (d): a receive buffer for the other process's payload, exported
    # to it, and the other's mapped here.
    plan = cuda_ops.ring_plan(mine)
    recv = torch.empty(plan.total, dtype=torch.uint8, device=dev)
    store.set(f"mp_ring/mem/{pid}",
              pickle.dumps(recv.untyped_storage()._share_cuda_()))
    store.wait([f"mp_ring/mem/{1 - pid}"],
               datetime.timedelta(seconds=MP_RING_TIMEOUT_S))
    dst = cuda_ops.ipc_destination(
        pickle.loads(store.get(f"mp_ring/mem/{1 - pid}")), dev)
    store.set(f"mp_ring/ready/{pid}", "1")
    store.wait(["mp_ring/go"],
               datetime.timedelta(seconds=MP_RING_TIMEOUT_S))
    # (a), (b): the sharded main path over the global mesh.  The device
    # memory allocated before it, and after it once its result is gone.
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    cuda_ops.reset_launches()
    seg = detect_sharded(packed, mesh, rebalance=True, **SHARDED)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(cuda_ops.LAUNCHES)
    np.savez(out / f"fields.{pid}.npz",
             **{f: getattr(seg, f).cpu().numpy()
                for f in STORE_FIELDS + ("lanes_migrated",)})
    # (f) a second dispatch at another segment capacity (another payload
    # signature): the same segment counts, and neither dispatch leaves a
    # receive buffer or a mapping on the card.
    held = [held_bytes(dev, base)]
    dispatches, S1 = n_dispatches(seg, packed), seg.seg_meta.shape[2]
    S = S1 + 2
    n_seg = seg.n_segments
    del seg
    held.append(held_bytes(dev, base))
    seg = detect_sharded(packed, mesh, rebalance=True,
                         **dict(SHARDED, max_segments=S))
    check(seg.seg_meta.shape[2] == S and torch.equal(seg.n_segments, n_seg),
          f"process {pid}: the dispatch at capacity {S} differs")
    del seg, n_seg
    held.append(held_bytes(dev, base))
    check(max(held[1:]) <= MP_RING_HELD_BYTES,
          f"process {pid}: {held} bytes held on the card after the "
          f"dispatches, more than {MP_RING_HELD_BYTES}")
    # (d) the hop into the other process's buffer, each process in turn:
    # MP_RING_REPS launches of the kernel and of torch._foreach_copy_ into
    # the IPC-opened views; then a whole hop, ring_remote_copy over the
    # mesh (the exports, the mappings, the store's messages), and one
    # agreement of the dispatch, both processes together.
    timing = {}
    for turn in range(MP_RING_PROCS):
        if turn == pid:
            views = cuda_ops.ring_views(dst, plan)
            timing = dict(
                ms=cuda_ms(lambda: cuda_ops._ring_launch(mine, plan, dst,
                                                         dev), MP_RING_REPS),
                foreach_ms=cuda_ms(lambda: torch._foreach_copy_(views, mine),
                                   MP_RING_REPS))
            torch.cuda.synchronize()
            del views
            store.set(f"mp_ring/timed/{turn}", "1")
        else:
            store.wait([f"mp_ring/timed/{turn}"],
                       datetime.timedelta(seconds=MP_RING_TIMEOUT_S))
    del dst
    timing["call_ms"] = wall_ms(
        lambda: cuda_ops.ring_remote_copy([mine], +1, mesh=mesh),
        MP_RING_CALLS)
    timing["agree_ms"] = wall_ms(
        lambda: mesh.agree("a timed agreement", "x"), MP_RING_CALLS)
    (out / f"result.{pid}.json").write_text(json.dumps(dict(
        pid=pid, chips=per, seconds=secs, launches=launches,
        dispatches=dispatches, plain_seconds=plain_s,
        payload_bytes=nbytes(*mine), tensors=len(mine), held_bytes=held,
        capacities=[S1, S], **timing)))
    store.set(f"mp_ring/done/{pid}", "1")
    # The group's store lives in process 0: it leaves last.
    store.wait([f"mp_ring/done/{p}" for p in range(MP_RING_PROCS)],
               datetime.timedelta(seconds=60))
    print(f"mp_ring child {pid}: ok", flush=True)
    dist.shutdown()


def mp_ring_phase(smi, mp, ref):
    """The ring between processes on the card (the module docstring's item
    20): releases :func:`mp_ring_start`'s processes and checks what they
    did against ``sharded_path``'s one-process ring (``ref``)."""
    import torch.distributed as tdist

    t0 = time.perf_counter()
    try:
        client = tdist.TCPStore("127.0.0.1", mp["port"], is_master=False,
                                timeout=datetime.timedelta(seconds=120))
        client.wait([f"mp_ring/ready/{p}" for p in range(MP_RING_PROCS)],
                    datetime.timedelta(seconds=MP_RING_TIMEOUT_S))
        waited = time.perf_counter() - t0
        client.set("mp_ring/go", "1")
        # (e) the two processes' contexts are on the card (sampled while
        # they dispatch).
        apps_up = len(_gpu_apps())
        for p in mp["procs"]:
            p.wait(timeout=MP_RING_TIMEOUT_S)
    finally:
        mp_ring_stop(mp)
    logs = [(mp["dir"] / f"child{p}.log").read_text()
            for p in range(MP_RING_PROCS)]
    for p, (proc, log) in enumerate(zip(mp["procs"], logs)):
        check(proc.returncode == 0, f"mp_ring child {p} exited "
              f"{proc.returncode}:\n{log[-4000:]}")
    apps_after = len(_gpu_apps())
    check(apps_up == mp["apps"] + MP_RING_PROCS and apps_after == mp["apps"],
          f"compute apps {mp['apps']} -> {apps_up} -> {apps_after}, "
          f"expected +{MP_RING_PROCS} and back")
    res = [json.loads((mp["dir"] / f"result.{p}.json").read_text())
           for p in range(MP_RING_PROCS)]
    expect = ROUTE_0 | {"ring_remote_copy"}
    per = res[0]["chips"]
    for p, r in enumerate(res):
        # (a) the store fields and migrated lanes of the process's chips.
        got = np.load(mp["dir"] / f"fields.{p}.npz")
        for f in STORE_FIELDS + ("lanes_migrated",):
            check(np.array_equal(got[f], ref[f][p * per:(p + 1) * per]),
                  f"mp_ring process {p}: {f} differs from the one-process "
                  f"ring's")
        # (b) route 0's kernels and three hops a dispatch.
        launched = {k for k, n in r["launches"].items() if n > 0}
        check(launched == expect, f"mp_ring process {p} launched "
              f"{sorted(launched)}, expected {sorted(expect)}")
        check(r["launches"]["ring_remote_copy"] == 3 * r["dispatches"],
              f"mp_ring process {p}: {r['launches']['ring_remote_copy']} "
              f"ring_remote_copy launches for {r['dispatches']} dispatches")
    check(ref["lanes_migrated"].sum() > 0, "the ring migrated no lanes")
    hop_bytes = sum(r["payload_bytes"] for r in res)
    b_ms = 2 * hop_bytes / HBM_BYTES_S * 1e3
    out = dict(processes=MP_RING_PROCS, chips_per_process=per,
               dispatch_seconds=[r["seconds"] for r in res],
               dispatches=res[0]["dispatches"],
               launches=[r["launches"] for r in res],
               lanes_migrated=ref["lanes_migrated"].tolist(),
               hop_bytes=hop_bytes, tensors=res[0]["tensors"],
               sender_ms=[r["ms"] for r in res],
               sender_foreach_ms=[r["foreach_ms"] for r in res],
               ms=sum(r["ms"] for r in res),
               foreach_copy_ms=sum(r["foreach_ms"] for r in res),
               bound_ms=b_ms, plain_seconds=[r["plain_seconds"] for r in res],
               call_ms=[r["call_ms"] for r in res],
               agree_ms=[r["agree_ms"] for r in res],
               held_bytes=[r["held_bytes"] for r in res],
               capacities=res[0]["capacities"],
               compute_apps=[mp["apps"], apps_up, apps_after],
               waited_seconds=waited,
               startup_seconds=t0 - mp["t_start"],
               seconds=time.perf_counter() - t0)
    print(f"mp_ring: {MP_RING_PROCS} processes on cuda:0, {per} chips each, "
          f"one shard each: store fields and lanes migrated "
          f"{out['lanes_migrated']} equal the one-process ring's; launches "
          f"{out['launches']} ({out['dispatches']} dispatches); dispatch "
          f"{', '.join(f'{v:.3f}' for v in out['dispatch_seconds'])} s; "
          f"compute apps {out['compute_apps']}; waited {waited:.3f} s for "
          f"the children started {out['startup_seconds']:.1f} s before; "
          f"phase {out['seconds']:.3f} s on {smi}", flush=True)
    print(f"ring_remote_copy across processes: {hop_bytes / 1e6:.1f} MB a "
          f"hop ({res[0]['tensors']} tensors a process) into IPC-mapped "
          f"buffers, byte-equal to the plain gloo hop and the sources; "
          f"median of {MP_RING_REPS} launches a sender "
          f"{', '.join(f'{v:.4f}' for v in out['sender_ms'])} ms, the hop "
          f"{out['ms']:.4f} ms beside its bound {b_ms:.4f} ms (bytes); "
          f"torch._foreach_copy_ into the IPC-opened views "
          f"{out['foreach_copy_ms']:.4f} ms; the plain hop (host-staged "
          f"gloo) {', '.join(f'{v:.3f}' for v in out['plain_seconds'])} s "
          f"on {smi}", flush=True)
    print(f"ring_remote_copy across processes, whole: a hop over the mesh "
          f"(median of {MP_RING_CALLS}, host clock) "
          f"{', '.join(f'{v:.3f}' for v in out['call_ms'])} ms a process, "
          f"an agreement {', '.join(f'{v:.3f}' for v in out['agree_ms'])} "
          f"ms; capacities {out['capacities']}: bytes held on the card "
          f"after the first dispatch, once its result is gone, after the "
          f"second {out['held_bytes']} (at most {MP_RING_HELD_BYTES})",
          flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chips", type=int, default=8)
    ap.add_argument("--reps", type=int, default=20)
    # One process of mp_ring_phase (the script starts them itself).
    ap.add_argument("--mp-ring-child", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--mp-ring-coord", help=argparse.SUPPRESS)
    ap.add_argument("--mp-ring-dir", help=argparse.SUPPRESS)
    ap.add_argument("--mp-ring-T", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--only-mp-ring", action="store_true",
                    help="build, run the sharded path and mp_ring_phase "
                         "only, and stop (no result lines)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    if args.mp_ring_child is not None:
        return mp_ring_child(args)
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    t_start = t0 = time.perf_counter()
    libs = cuda_ops.build()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.2f} s ({', '.join(p.name for p in libs.values())})",
          flush=True)
    sass = sass_report(libs)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    packed, staged, gen_s = make_batch(args.seed, args.chips, dev)
    print(f"batch: {packed.spectra.shape} int16 made in {gen_s:.1f} s",
          flush=True)
    if args.only_mp_ring:
        sharded_ref = {}
        sharded_path(ragged_batch(packed), smi, sharded_ref)
        del packed, staged
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:
            mp_ring_phase(smi, mp_ring_start(
                args.seed, args.chips, sharded_ref["T"], tmp), sharded_ref)
        print(f"chip_smoke --only-mp-ring: "
              f"{time.perf_counter() - t_start:.1f} s on {smi}", flush=True)
        return
    inp = kernel_inputs(args.seed, staged, kernel.window_cap(packed))
    kernels, kreport = kernel_phase(inp, staged, args.reps, args.seed,
                                    mixed=True, guards="full")
    del inp
    torch.cuda.empty_cache()
    paths, segs = {}, {}
    for name in ROUTES:
        if name not in COMPACT_OF:
            segs[name], paths[name] = route_path(packed, staged, smi, name)
    paths["0"].update(egress(segs["0"], packed),
                      chip_generation_seconds=gen_s)
    for name, base, allowed in (
            ("1", "0", ()), ("mon", "0", ("seg_mag",)),
            ("mega", "mon", ("rounds", "round_counts", "seg_mag"))):
        paths[name][f"vs_route_{base}"] = compare_routes(
            segs[name], segs[base], f"route {name!r} vs route {base!r}",
            allowed)
    # The mega route counts rounds per chip: its deepest chip ran as many
    # rounds as the lockstep loop.
    check(int(segs["mega"].rounds.max()) == int(segs["0"].rounds[0]),
          f"mega rounds {segs['mega'].rounds.tolist()} against route 0's "
          f"{int(segs['0'].rounds[0])}")
    agree, n_dis = decision_agreement(segs[COMPONENTS], segs["0"])
    print(f"route {COMPONENTS!r} vs route '0': decision agreement {agree} "
          f"({n_dis} pixels differ)", flush=True)
    check(agree >= 0.999, f"component route vs route 0: decision agreement "
          f"{agree} < 0.999")
    paths[COMPONENTS]["vs_route_0"] = dict(decision_agreement=agree,
                                          pixels_disagreeing=n_dis)
    # Compaction leaves every result field as it was, with the skip guards
    # of every route's kernels live.
    paths["0+compact"]["vs_route_0"] = compare_routes(
        segs["0+compact"], segs["0"], "route '0+compact' vs route '0'", ())
    # A compacted route that differs from its compaction-off route fails
    # the run at its end, after every other phase has run and printed.
    late = []
    t0 = time.perf_counter()
    for name, base in COMPACT_OF.items():
        try:
            paths[name] = compact_path(packed, staged, smi, name, segs[base])
        except AssertionError as e:
            late.append(str(e))
            print(f"FAILED {e}", flush=True)
    print(f"compacted routes {', '.join(COMPACT_OF)}: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # The mixed routes: the same identities, and route 0's decisions.
    for name, base, allowed in (
            ("1", "0", ()), ("mon", "0", ("seg_mag",)),
            ("mega", "mon", ("rounds", "round_counts", "seg_mag"))):
        paths[name + MIXED][f"vs_route_{base}{MIXED}"] = compare_routes(
            segs[name + MIXED], segs[base + MIXED],
            f"route {name + MIXED!r} vs route {base + MIXED!r}", allowed)
    check(int(segs["mega" + MIXED].rounds.max())
          == int(segs["0" + MIXED].rounds[0]),
          f"mixed mega rounds {segs['mega' + MIXED].rounds.tolist()} against "
          f"mixed route 0's {int(segs['0' + MIXED].rounds[0])}")
    paths["0" + MIXED]["vs_route_0"] = mixed_vs_f32(segs["0" + MIXED],
                                                    segs["0"])
    del segs
    torch.cuda.empty_cache()
    sharded_ref = {}
    paths["sharded"] = sharded_path(ragged_batch(packed), smi, sharded_ref)
    small = small_input(args.seed, dev)
    fuzz = fuzz_phase(dev)
    for name, row in kernels.items():
        home = paths.get(HOME_ROUTE[name])
        row["launches"] = (None if home is None else
                           home["launches"][name.removesuffix(GUARD_SUFFIX)])
    redesign = redesign_report(kernels, paths, packed.spectra.shape[-1], smi)
    del packed, staged
    torch.cuda.empty_cache()
    s2 = sentinel2_phase(smi, args.reps, dev)
    torch.cuda.empty_cache()
    chips, gen_s = tile_chips(args.seed, max(DRIVER_CHIPS, STREAM_CHIPS))
    with tempfile.TemporaryDirectory() as tmp:
        drv, drv_cfg = driver_phase(smi, chips, gen_s, dev, tmp)
        torch.cuda.empty_cache()
        ops = ops_phase(smi, chips, drv_cfg, tmp)
        fleet, fleet_env = fleet_phase(smi, chips, drv_cfg, tmp, args.seed)
        history = history_phase(smi, fleet, fleet_env)
        # mp_ring_phase's processes come up behind the host-bound
        # classification.
        mp = mp_ring_start(args.seed, args.chips, sharded_ref["T"], tmp)
        try:
            rf = classify_phase(smi, drv_cfg, args.seed, dev)
        except BaseException:
            mp_ring_stop(mp)
            raise
        mp_ring = mp_ring_phase(smi, mp, sharded_ref)
        serve = serve_phase(smi, drv_cfg, tmp, args.seed)
    torch.cuda.empty_cache()
    strm = stream_phase(smi, chips, dev)
    torch.cuda.empty_cache()
    ingest, alert = ingest_phase(smi, chips, dev)
    del chips
    torch.cuda.empty_cache()
    # One pool of spawned processes for the reference replays: each
    # spawned process imports this script and the port once.
    with ProcessPoolExecutor(8, mp_context=multiprocessing.get_context(
            "spawn")) as pool:
        f64 = f64_phase(smi, args.seed, dev, pool)
        audit = validate_phase(smi, dev, kernels, pool)
    instances = ptxas_report(paths["0"]["T"], smi)

    ptxas = {n: (cuda_ops.BUILD_DIR / f"{n}.ptxas.txt").read_text()
             for n in cuda_ops.UNITS
             if (cuda_ops.BUILD_DIR / f"{n}.ptxas.txt").exists()}
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(dict(
        device=smi, torch=torch.__version__, cuda=torch.version.cuda,
        build_seconds=build_s, sass_hmma=sass, kernels=kernels,
        kernel_report=kreport, main_paths=paths, small_input=small,
        fuzz_chip=fuzz, redesign=redesign,
        sentinel2=s2, driver=drv, ops=ops, fleet=fleet, history=history,
        classify=rf, mp_ring=mp_ring, serve=serve, stream=strm,
        ingest=ingest, alert=alert,
        f64=f64, validate=audit,
        ptxas_instances=instances,
        ptxas=ptxas,
        seconds=time.perf_counter() - t_start), indent=1))

    check(not late, f"failed earlier in the run: {late}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "max_rel_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all on "
          f"{smi}", flush=True)
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in kernels.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
