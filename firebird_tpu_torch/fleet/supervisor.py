"""Fleet supervisor: make the worker count the policy asked for exist.

The port's own copy of the JAX package's ``fleet/supervisor.py``, whole:
a host-side loop that spawns ``python -m firebird_tpu_torch fleet work``
children and never touches the card itself (the workers need it).  Once
per tick it

1. **reaps** its spawned workers (exit codes feed the policy's
   crash-loop circuit) and **prunes/adopts** from the queue's worker
   registry: a row whose pid is dead is an abnormal exit; a LIVE pid it
   did not spawn is an orphan left by a previous supervisor incarnation
   and is adopted — signalled and counted like any spawned worker,
   never double-spawned over;
2. takes one atomic queue pressure reading
   (``FleetQueue.scale_snapshot``) and asks the
   :class:`~firebird_tpu_torch.fleet.policy.ScalePolicy` for a target;
3. **reconciles**: spawns ``fleet work --drain-on-term``
   subprocesses up to the target (``--until-drained`` too when the
   floor is 0, so an emptied queue self-drains; a min_workers floor
   spawns ``--hold-idle`` workers that poll through an empty queue —
   self-exiting floor workers would respawn-churn forever), or
   retires the newest workers down to it — retirement is
   SIGTERM first (the worker's graceful-drain handler finishes the
   current lease and exits; fencing already rejects a straggler's
   writes), SIGKILL only past ``grace_sec``;
4. **heartbeats** its own liveness + last decision into the queue db
   (``FleetQueue.supervisor_heartbeat``), so ``fleet status`` and
   ``/progress`` show the control plane, and a
   restarted supervisor can see it is succeeding a dead one.

Observability: ``fleet_workers_target`` / ``fleet_workers_live``
gauges, ``fleet_scale_up_total`` / ``fleet_scale_down_total`` /
``fleet_scale_park_total`` counters, and the ``queue_drain_eta_seconds``
gauge the ``drain_eta`` SLO objective (obs/slo.py) judges.  Every
target change lands in a bounded decision log persisted with the
heartbeat.

Everything is injectable (clock, sleep, spawner), so the reconcile /
retire / adopt / park behaviors are deterministic unit tests
(tests/test_torch_supervisor.py).
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time

from firebird_tpu_torch.fleet.policy import ScalePolicy
from firebird_tpu_torch.fleet.queue import FleetQueue
from firebird_tpu_torch.fleet.worker import WEDGED_EXIT
from firebird_tpu_torch.obs import flightrec, jsonlog, logger
from firebird_tpu_torch.obs import metrics as obs_metrics

# Bounded decision log persisted with the supervisor heartbeat: enough
# history to read a run's scaling back, small enough for a meta row.
_DECISION_LOG = 50


class _Spawned:
    """One worker under supervision: a Popen child, or an adopted
    orphan (pid only — exit codes unknowable, liveness by
    :func:`pid_alive`)."""

    def __init__(self, pid: int, proc=None, *, adopted: bool = False,
                 seq: int = 0):
        self.pid = int(pid)
        self.proc = proc
        self.adopted = adopted
        self.seq = seq                # supervision order, for _retire
        self.retiring_since: float | None = None
        self.killed = False

    def alive(self) -> bool:
        if self.proc is not None:
            return self.proc.poll() is None
        return pid_alive(self.pid)

    def signal(self, sig: int) -> None:
        try:
            if self.proc is not None:
                self.proc.send_signal(sig)
            else:
                os.kill(self.pid, sig)
        except OSError:
            pass                      # already gone — the reap will see


def proc_start_wall(pid: int) -> float | None:
    """The wall-clock time a pid's process started (Linux: boot time +
    /proc/<pid>/stat starttime ticks), or None when unknowable.  The
    adoption guard compares it against a registry row's registration
    stamp: a process that started AFTER the row was written is a
    RECYCLED pid — some unrelated process the OS handed the number to —
    and must never be adopted or signalled."""
    try:
        with open(f"/proc/{int(pid)}/stat") as f:
            # starttime is field 22; after the parenthesized comm the
            # remaining fields start at 3, so index 19.
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(float(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, StopIteration, IndexError, ValueError):
        return None


def pid_alive(pid: int) -> bool:
    """True while the pid names a RUNNING process.  A defunct (exited
    but unreaped — its parent never wait()ed) process still answers
    kill(pid, 0), and an adopted orphan in that state would read as an
    immortal worker the supervisor retires forever; /proc state 'Z'
    filters it (best-effort — absent /proc falls back to the signal
    probe)."""
    try:
        os.kill(int(pid), 0)
    except PermissionError:
        pass          # EPERM: the process EXISTS, another user owns it
    except OSError:
        return False
    try:
        with open(f"/proc/{int(pid)}/stat") as f:
            # Field 3, after the parenthesized comm (which may itself
            # contain spaces/parens): split at the LAST ')'.
            if f.read().rsplit(")", 1)[1].split()[0] == "Z":
                return False
    except (OSError, IndexError):
        pass
    return True


class Supervisor:
    """The autoscaling control loop over one fleet queue.

    ``spawn`` is injectable: a zero-arg callable returning a
    Popen-compatible object (``pid``, ``poll()``, ``send_signal()``).
    The default spawns ``fleet work`` (:meth:`_worker_cmd`)
    in this config's environment, logging to ``log_dir``.
    """

    def __init__(self, cfg, queue: FleetQueue, *,
                 policy: ScalePolicy | None = None,
                 spawn=None, tick_sec: float = 1.0,
                 grace_sec: float = 30.0, log_dir: str | None = None,
                 clock=time.monotonic, sleep=time.sleep,
                 proc_start=proc_start_wall):
        self.cfg = cfg
        self.queue = queue
        self.policy = policy if policy is not None else ScalePolicy(
            cfg.fleet_min_workers, cfg.fleet_max_workers, clock=clock)
        self.tick_sec = float(tick_sec)
        self.grace_sec = float(grace_sec)
        self.log_dir = log_dir
        self._spawn = spawn if spawn is not None else self._spawn_worker
        self._proc_start = proc_start
        self._clock = clock
        self._sleep = sleep
        self.log = logger("fleet")
        self.run_id = jsonlog.new_run_id()
        self.workers: dict[int, _Spawned] = {}   # pid -> worker
        self.decisions: list[dict] = []          # bounded, newest last
        self.adopted_total = 0
        self.tallies = {k: 0 for k in
                        ("spawned", "retired", "killed", "crashed",
                         "clean_exits", "parked")}
        self._seq = 0                            # worker log numbering
        self._spawn_seq = 0                      # supervision order
        self._last_target: int | None = None
        self._last_decision: dict | None = None
        self._last_snap = None                   # newest scale_snapshot
        self._last_eta: float | None = None

    # -- default spawner ---------------------------------------------------

    def _worker_cmd(self) -> list[str]:
        """The spawn argv.  --drain-on-term always (retirement is
        graceful); --until-drained (exit by yourself on an empty queue)
        only when the floor is 0 — a min_workers floor held by
        self-exiting workers would be an infinite spawn/exit churn loop
        on an idle queue, so floor fleets spawn --hold-idle workers
        (poll through an empty queue, still kind=batch) and rely on the
        supervisor's scale-down to retire surplus."""
        cmd = [sys.executable, "-m", "firebird_tpu_torch", "fleet", "work",
               "--drain-on-term"]
        cmd.append("--until-drained" if self.policy.min_workers == 0
                   else "--hold-idle")
        return cmd

    def _spawn_worker(self):
        """One `fleet work` child (:meth:`_worker_cmd`) in
        this process's environment."""
        self._seq += 1
        stdout = subprocess.DEVNULL
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
            stdout = open(os.path.join(
                self.log_dir, f"worker_{os.getpid()}_{self._seq}.log"), "w")
        env = dict(os.environ)
        # The SUPERVISOR owns this host's ops surface: a worker
        # inheriting FIREBIRD_OPS_PORT would EADDRINUSE against it (or
        # against its siblings) at bring-up and crash-loop the whole
        # fleet — the stream-job nested-driver rule, process-level.
        env["FIREBIRD_OPS_PORT"] = "0"
        proc = subprocess.Popen(
            self._worker_cmd(),
            stdout=stdout, stderr=subprocess.STDOUT, env=env,
            start_new_session=True)
        if stdout is not subprocess.DEVNULL:
            proc._fb_log = stdout     # keep the handle with the proc
        return proc

    # -- one tick ----------------------------------------------------------

    def _reap_and_adopt(self) -> None:
        """Collect exits (feeding the crash-loop circuit), prune dead
        registry rows, adopt orphaned live workers."""
        now = self._clock()
        rows = {int(r["pid"]): r for r in self._registry_rows()}
        reaped = set()                # exits already counted this pass
        for pid, w in list(self.workers.items()):
            if w.alive():
                continue
            del self.workers[pid]
            reaped.add(pid)
            if w.retiring_since is not None:
                # WE asked this worker to go (SIGTERM, or our own
                # SIGKILL past grace): however it ended, a deliberate
                # retirement is not crash-loop-circuit food.
                if pid in rows:
                    self.queue.worker_deregister(rows[pid]["worker_id"])
                continue
            code = w.proc.returncode if w.proc is not None else None
            # An adopted worker's exit code is unknowable; its registry
            # row is the verdict: deregistered row = clean exit, row
            # left behind = it died without saying goodbye.
            if code is None:
                code = None if pid in rows else 0
            if code == WEDGED_EXIT:
                # A deliberate self-report (`fleet work` exits 4 when
                # every pending job is blocked behind dead deps): not a
                # crash, not circuit food — backoff cannot fix a wedge,
                # and the policy reads the same verdict from its
                # snapshot and stops demanding workers.
                self.tallies["clean_exits"] += 1
                self.log.warning(
                    "worker pid %d exited: queue wedged (pending work "
                    "blocked behind dead deps — operator requeue "
                    "needed)", pid)
                continue
            clean = code == 0
            self.tallies["clean_exits" if clean else "crashed"] += 1
            if self.policy.record_exit(code, now=now):
                self.tallies["parked"] += 1
                obs_metrics.counter(
                    "fleet_scale_park_total",
                    help="worker slots parked by the crash-loop "
                         "circuit (abnormal-exit bursts)").inc()
                flightrec.mark("fleet_park", pid=pid)
                self.log.warning(
                    "crash-loop circuit tripped (worker pid %d exit %s):"
                    " slot parked", pid, code)
            elif not clean:
                self.log.warning("worker pid %d exited abnormally (%s)",
                                 pid, code)
        # Registry hygiene + adoption.
        for pid, row in rows.items():
            if pid in self.workers:
                continue
            if not pid_alive(pid):
                # Died without deregistering (SIGKILL, partition):
                # prune the row.  If it was ours, the reap above already
                # counted it; a never-supervised row (spawned by a dead
                # predecessor, died before adoption) feeds the circuit
                # only when its beat is RECENT — a crash storm that
                # spans a supervisor restart must keep tripping the
                # circuit, but a cold start over hours-stale rows (host
                # reboot) is ancient history, not a current burst.
                self.queue.worker_deregister(row["worker_id"])
                if pid not in reaped \
                        and row.get("beat_age_sec", float("inf")) \
                        <= self.policy.crash_window_sec:
                    self.tallies["crashed"] += 1
                    if self.policy.record_exit(None, now=now):
                        self.tallies["parked"] += 1
                        obs_metrics.counter(
                            "fleet_scale_park_total",
                            help="worker slots parked by the crash-loop "
                                 "circuit (abnormal-exit bursts)").inc()
                        flightrec.mark("fleet_park", pid=pid)
                        self.log.warning(
                            "crash-loop circuit tripped (unadopted "
                            "worker pid %d died): slot parked", pid)
                continue
            # Recycled-pid guard: a process that started AFTER the row
            # registered is an unrelated process wearing a dead
            # worker's number — prune the row, never adopt/signal it.
            # (2 s of skew: registration happens moments after exec.)
            started = self._proc_start(pid)
            if started is not None and row.get("started") is not None \
                    and started > row["started"] + 2.0:
                self.queue.worker_deregister(row["worker_id"])
                self.log.warning(
                    "registry row %s names pid %d, but that pid started "
                    "after the row was written (recycled) — pruned, not "
                    "adopted", row["worker_id"], pid)
                continue
            self._spawn_seq += 1
            self.workers[pid] = _Spawned(pid, adopted=True,
                                         seq=self._spawn_seq)
            self.adopted_total += 1
            flightrec.mark("fleet_adopt", pid=pid)
            self.log.info(
                "adopted orphaned worker pid %d (%s) from the registry "
                "— a previous supervisor spawned it", pid,
                row["worker_id"])

    def _registry_rows(self) -> list[dict]:
        """THIS host's batch worker rows.  Rows registered from other
        hosts (the queue db can be shared) are another supervisor's to
        adopt or prune — their pid numbers mean nothing here, and
        signaling them would hit unrelated local processes."""
        try:
            return [r for r in self.queue.workers(kind="batch")
                    if r.get("host") in (None, jsonlog.HOST)]
        except Exception as e:
            self.log.warning("worker registry read failed (%s: %s)",
                             type(e).__name__, e)
            return []

    def _live(self) -> list[_Spawned]:
        return [w for w in self.workers.values()
                if w.retiring_since is None]

    def _retire(self, n: int) -> None:
        """SIGTERM the newest n non-retiring workers (graceful drain —
        newest by supervision order: pids wrap and adopted orphans can
        carry numerically high pids despite predating every local
        spawn); the deadline sweep SIGKILLs past grace_sec."""
        now = self._clock()
        for w in sorted(self._live(), key=lambda w: -w.seq)[:n]:
            w.retiring_since = now
            w.signal(signal.SIGTERM)
            self.tallies["retired"] += 1
            flightrec.mark("fleet_retire", pid=w.pid)
            self.log.info("retiring worker pid %d (SIGTERM, grace %.0fs)",
                          w.pid, self.grace_sec)

    def _sweep_retiring(self) -> None:
        now = self._clock()
        for w in list(self.workers.values()):
            if w.retiring_since is not None and not w.killed \
                    and now - w.retiring_since > self.grace_sec:
                w.signal(signal.SIGKILL)
                w.killed = True       # one escalation, not one per tick
                self.tallies["killed"] += 1
                self.log.warning(
                    "worker pid %d ignored SIGTERM for %.0fs — SIGKILL "
                    "(fencing already rejects its stale writes)",
                    w.pid, self.grace_sec)

    def tick(self) -> dict:
        """One control-loop pass; returns the persisted state block."""
        self._reap_and_adopt()
        self._sweep_retiring()
        snap = self.queue.scale_snapshot()
        live = len(self._live())
        decision = self.policy.decide(snap, live)
        if decision.target > live:
            # Retiring workers are still PROCESSES on this host until
            # their drain finishes: cap total concurrency (live +
            # retiring + adopted) at max_workers, or a retire-then-
            # burst cycle would transiently run ~2x the fleet the host
            # was sized for.
            n = min(decision.target - live,
                    max(0, self.policy.max_workers - len(self.workers)))
            ok = 0
            for _ in range(n):
                try:
                    proc = self._spawn()
                except Exception as e:
                    self.log.error("worker spawn failed (%s: %s)",
                                   type(e).__name__, e)
                    break
                self._spawn_seq += 1
                self.workers[int(proc.pid)] = _Spawned(
                    proc.pid, proc, seq=self._spawn_seq)
                self.tallies["spawned"] += 1
                ok += 1
            if ok:
                obs_metrics.counter(
                    "fleet_scale_up_total",
                    help="supervisor scale-up decisions acted on").inc()
        elif decision.target < live:
            self._retire(live - decision.target)
            obs_metrics.counter(
                "fleet_scale_down_total",
                help="supervisor scale-down decisions acted on").inc()
        now_live = len(self._live())
        obs_metrics.gauge(
            "fleet_workers_target",
            help="supervisor's current target batch worker count").set(
            decision.target)
        obs_metrics.gauge(
            "fleet_workers_live",
            help="live (non-retiring) batch workers under "
                 "supervision").set(now_live)
        eta = snap.drain_eta_sec()
        self._last_snap, self._last_eta = snap, eta
        if eta is not None:
            obs_metrics.gauge(
                "queue_drain_eta_seconds",
                help="open batch work / trailing ack rate — the "
                     "drain_eta SLO objective's gauge").set(round(eta, 3))
        if decision.target != self._last_target:
            self._last_target = decision.target
            self._last_decision = {
                "at": round(self._clock(), 3), "target": decision.target,
                "live": now_live, "want": decision.want,
                "reason": decision.reason, "parked": decision.parked,
            }
            self.decisions.append(self._last_decision)
            del self.decisions[:-_DECISION_LOG]
            flightrec.mark("fleet_scale", target=decision.target,
                           live=now_live, reason=decision.reason)
            self.log.info("scale decision: target %d (live %d) — %s",
                          decision.target, now_live, decision.reason)
        state = self.status_block(snap=snap, decision=decision,
                                  live=now_live, eta=eta)
        try:
            self.queue.supervisor_heartbeat(state)
        except Exception as e:
            self.log.warning("supervisor heartbeat failed (%s: %s)",
                             type(e).__name__, e)
        return state

    def _record_scale_to_zero(self) -> None:
        """Terminal bookkeeping for the until_drained drain-out exit:
        the decision log, gauges, and persisted state must all read
        target 0 / live 0, exactly as a policy-decided scale-to-zero
        would have left them."""
        self._last_target = 0
        self._last_decision = {
            "at": round(self._clock(), 3), "target": 0, "live": 0,
            "want": 0, "parked": len(self.policy.parks()),
            "reason": "drained: every worker retired -> scale to zero",
        }
        self.decisions.append(self._last_decision)
        del self.decisions[:-_DECISION_LOG]
        obs_metrics.gauge(
            "fleet_workers_target",
            help="supervisor's current target batch worker count").set(0)
        obs_metrics.gauge(
            "fleet_workers_live",
            help="live (non-retiring) batch workers under "
                 "supervision").set(0)
        flightrec.mark("fleet_scale", target=0, live=0,
                       reason="drained-out")

    def status_block(self, *, snap=None, decision=None, live=None,
                     eta=None) -> dict:
        """The supervisor sub-document persisted with each heartbeat
        and rendered by /progress and `fleet status`.  Callers
        outside tick() (the live /progress fleet_block) fall back to
        the newest tick's snapshot so backlog/eta don't render None
        mid-run."""
        if snap is None:
            snap, eta = self._last_snap, self._last_eta
        # One C-level snapshot of the worker table: the ops HTTP thread
        # renders this concurrently with tick()'s reap deletions, and a
        # generator over .values() yields between items (RuntimeError
        # on a resize mid-iteration); list() does not.
        ws = list(self.workers.values())
        return {
            "pid": os.getpid(), "host": jsonlog.HOST,
            "run_id": self.run_id,
            "target": decision.target if decision is not None
            else self._last_target,
            "live": live if live is not None else sum(
                1 for w in ws if w.retiring_since is None),
            "retiring": sum(1 for w in ws
                            if w.retiring_since is not None),
            "min": self.policy.min_workers, "max": self.policy.max_workers,
            "adopted_total": self.adopted_total,
            "parks": self.policy.parks(),
            "drain_eta_sec": None if eta is None else round(eta, 3),
            "backlog": snap.backlog if snap is not None else None,
            "stream_open": snap.stream_open if snap is not None else None,
            "last_decision": self._last_decision,
            "decisions": list(self.decisions),
            "tallies": dict(self.tallies),
        }

    def fleet_block(self) -> dict:
        """The /progress ``fleet`` sub-document for a supervisor run:
        the shared queue status plus the control-plane block."""
        s = self.queue.status()
        s["supervisor"] = self.status_block()
        return s

    # -- the loop ----------------------------------------------------------

    def run(self, *, until_drained: bool = False, stop=None) -> dict:
        """Supervise until ``stop`` is set — or, with ``until_drained``,
        until the queue has no open BATCH work left AND every worker
        has been retired (the scale-to-zero exit).  Stream jobs don't
        gate the exit: the policy provisions no batch capacity for
        them, so a watcher continuously feeding stream jobs would
        otherwise pin this loop open forever at target 0.  Returns a
        summary dict."""
        self._refuse_live_predecessor()
        wedged = False
        draining_out = False          # exits when batch work is gone
        wedging_out = False           # exits when the queue is wedged

        def batch_drained():
            return self.queue.drained(batch_only=True)

        def safe(fn, default):
            # One transient queue-db error (sqlite 'database is locked'
            # past its timeout under a 30-worker WAL stampede) must not
            # kill the control plane and orphan the fleet: log, assume
            # the conservative default, read again next tick.
            try:
                return fn()
            except Exception as e:
                self.log.warning("queue read failed (%s: %s) — "
                                 "retrying next tick",
                                 type(e).__name__, e)
                return default

        try:
            while not (stop is not None and stop.is_set()):
                if draining_out and not safe(batch_drained, True):
                    draining_out = False     # late work arrived: resume
                if wedging_out and not safe(self.queue.wedged, True):
                    wedging_out = False      # operator requeued: resume
                if draining_out or wedging_out:
                    # Reap/escalate only — a full tick would respawn
                    # toward the min_workers floor and spawn/retire
                    # churn against our own retirements.
                    self._reap_and_adopt()
                    self._sweep_retiring()
                    self.shutdown()          # cover fresh adoptions
                    try:
                        self.queue.supervisor_heartbeat(
                            self.status_block())
                    except Exception:
                        pass
                else:
                    safe(self.tick, None)
                if until_drained and safe(batch_drained, False):
                    if not self.workers:
                        if draining_out:
                            # Reap-only passes ran no decide: record
                            # the terminal scale-to-zero explicitly (a
                            # tick here could respawn toward a min>0
                            # floor and leak the worker at break).
                            self._record_scale_to_zero()
                        break
                    # The operator asked to exit at drain: the
                    # min_workers floor does not hold past a fully
                    # drained queue (floor workers spawn without
                    # --until-drained and would otherwise idle forever).
                    draining_out = True
                    self._retire(len(self._live()))
                if until_drained and safe(self.queue.wedged, False):
                    # Nothing leased and nothing claimable: spawning
                    # more workers cannot unwedge a DAG blocked behind
                    # dead letters — an operator must requeue.  A
                    # min_workers floor never self-exits (--hold-idle),
                    # so retire it too or this loop would spin forever
                    # holding a floor that can claim nothing.
                    if not self.workers:
                        self.log.error(
                            "fleet wedged under supervision: %s",
                            self.queue.counts())
                        wedged = True
                        break
                    wedging_out = True
                    self._retire(len(self._live()))
                self._sleep(self.tick_sec)
        finally:
            summary = {
                "supervisor": os.getpid(), "wedged": wedged,
                "adopted": self.adopted_total, **self.tallies,
                "queue": self.queue.counts(),
                "decisions": list(self.decisions),
            }
            # Final heartbeat so scale-to-zero is visible in the db.
            try:
                self.queue.supervisor_heartbeat(self.status_block())
            except Exception:
                pass
        self.log.info("supervisor done: %s",
                      {k: v for k, v in summary.items()
                       if k != "decisions"})
        return summary

    def _refuse_live_predecessor(self) -> None:
        """The succession guard supervisor_heartbeat exists for: TWO
        live supervisors on one queue would each adopt the other's
        workers, retire each other's 'surplus', and jointly run ~2x
        max_workers (each caps only its own view).  A same-host
        heartbeat that is FRESH and whose pid is a live process is a
        racing supervisor, not a dead predecessor — refuse to start.
        A stale beat (SIGKILLed predecessor) or a foreign host's
        supervisor (registries are host-filtered; one supervisor per
        host is the supported shared-queue shape) passes."""
        try:
            st = self.queue.supervisor_state()
        except Exception:
            return                    # corrupt/locked meta: proceed
        if not st or st.get("host") != jsonlog.HOST:
            return
        pid = st.get("pid")
        fresh = st.get("beat_age_sec", float("inf")) \
            <= max(10.0, 5 * self.tick_sec)
        if fresh and pid not in (None, os.getpid()) and pid_alive(pid):
            raise RuntimeError(
                f"another supervisor (pid {pid}, beat "
                f"{st.get('beat_age_sec')}s ago) is live on this queue "
                "— refusing to race it; stop it first")

    def shutdown(self, *, kill: bool = False) -> None:
        """Retire everything (used on operator stop): SIGTERM all live
        workers; ``kill`` escalates immediately."""
        for w in self.workers.values():
            if kill:
                w.signal(signal.SIGKILL)
            elif w.retiring_since is None:
                w.retiring_since = self._clock()
                w.signal(signal.SIGTERM)

    def drain_out(self, *, timeout: float | None = None) -> bool:
        """Operator-stop teardown: retire every worker and WAIT the
        retirements out, so the grace_sec SIGTERM->SIGKILL escalation
        actually runs before the supervisor process exits — without
        this, a worker wedged in a hung handler would outlive its
        supervisor as an invisible orphan until some future supervisor
        adopts it.  Returns True when every worker is gone."""
        deadline = None if timeout is None else self._clock() + timeout
        while True:
            # Re-issue each pass: _reap_and_adopt may have adopted a
            # fresh orphan since the last SIGTERM round.
            self.shutdown()
            self._reap_and_adopt()
            self._sweep_retiring()
            if not self.workers:
                return True
            if deadline is not None and self._clock() >= deadline:
                return False
            self._sleep(min(self.tick_sec, 0.5))
