"""Multi-process ingest workers: the patient fleet partitioned across OS
processes, each feeding its own engine on the card — with crash failover.
The counterpart of ``repro.ingest.workers``.

The single-process server has a structural ceiling: the asyncio reader
coroutines and the engine's dispatch contend for one GIL, so past a few
thousand frames/sec the socket reads starve while the kernels run.  The
worker pool retires that by partitioning the fleet:

* each **worker process** owns a disjoint patient subset and runs the full
  single-process stack — ``IngestServer`` → ``SessionManager`` →
  ``StreamEngine`` → ``Supervisor`` — on its own GIL and, on the card, its
  own CUDA context;
* clients connect to the worker that owns their patient (the pool publishes
  a live ``{patient: (host, port)}`` lookup); the wire protocol is
  unchanged — a worker IS an ingest server, just one of many;
* when every client is done the pool asks each worker to drain (sessions
  close via BYE or the stall reaper), then collects one telemetry payload
  per worker and merges them into a single fleet rollup:
  per-(task, format) ledger rows are summed field-wise, transport counters
  summed per patient (patient sets are disjoint), and latency percentiles
  recomputed from the CONCATENATED reservoirs — never averaged percentiles.

**Failover** (the fault-tolerance layer): a per-worker supervisor task
health-checks the process — liveness, a heartbeat thread over the mp pipe
(catches hangs, not just deaths), a ready timeout, and a drain-barrier
deadline (a worker that hangs mid-drain is killed and surfaced instead of
blocking the pool forever).  A dead worker is respawned under a
``distributed.fault_tolerance.RestartPolicy`` (bounded restarts,
exponential backoff), its new port republished through the lookup, and the
clients — ``ReplayingClient``s holding every unacked frame (and, within
budget, the acked history too) — re-deliver from the fresh worker's zero
frontier; the session layer dedupes, so failed-over patients are
exactly-once end to end.  A worker that exhausts its restart budget is
marked failed and its patients surfaced in ``failed_workers``; the pool
raises only when *every* worker failed.  Recovery is observable:
``worker_restarts_total`` (parent registry, merged into the rollup),
per-restart recovery latency, and the clients' replay/reconnect counters
under ``recovery``.

**The device.**  ``WorkerConfig.device`` names the device each worker's
engine runs on (``None``: the card; the CPU only when asked for).  Workers
are spawned, never forked: a forked child would inherit the parent's CUDA
context, which CUDA does not allow.  Each worker therefore holds a CUDA
context of its own on the one card.  A worker that cannot reach the card
fails (and is surfaced in ``failed_workers``); it never runs on the CPU
instead.  ``run_worker_fleet`` builds the CUDA kernels in the parent before
it spawns, so the workers load the built libraries instead of each running
``nvcc`` inside their start timeout.  ``devices = n > 1`` shards each
worker's dispatch over ``n`` data slabs of its device
(``launch.mesh.split_mesh_info``), as the reference's worker shards it over
a forced ``n``-way host device split.

Determinism: a worker builds its pipelines from the same seeds as the
parent (the reference forest is retrained per process on the worker's
device, bit-identically), so the windows a worker scores match what the
single-process engine would have produced for the same patients: the
window functions are row-independent, and the rounded matmul's split over
K follows K and N alone, so a row's bits do not depend on its batch.  Each
worker ships a per-patient sha256 ``digest`` over its delivered results so
a chaos run can assert bit-identity and exactly-once against the
fault-free run, and its process's kernel launch counts (``kernel_calls``)
so a run can show its workers went through the kernels.
"""
from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import multiprocessing as mp
import os
import signal
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.distributed.fault_tolerance import RestartPolicy
from repro_torch.launch.mesh import split_mesh_info

from .simulator import ChaosPlan, FleetSimulator, PatientPlan

_PCTS = (50, 90, 99)


@dataclasses.dataclass(frozen=True)
class WorkerConfig:
    """Everything a worker process needs to build its stack (picklable —
    crosses the spawn boundary)."""

    worker_id: int
    tasks: Tuple[str, ...]              # pipelines to build
    pins: Tuple[Tuple[str, str], ...]   # (patient, fmt) router pins
    n_patients: int = 0                 # sessions to expect before draining
    devices: int = 0                    # > 1: data slabs of the device
    max_batch: int = 32
    pad_policy: str = "max"
    stall_timeout_s: float = 1.5
    high_watermark: int = 4096
    supervisor_capacity: int = 4096
    scrape: bool = False                # per-worker localhost /metrics port
    # reference-forest recipe (cough pipelines only) — retrained per
    # process from the same seed, so every worker holds identical trees
    forest_train: Tuple[int, int, int, int] = (96, 123, 10, 5)
    # fault-tolerance plumbing
    epoch: int = 0                      # respawn generation (0 = first)
    ack: bool = True                    # server→client flow-control plane
    auth_secret: Optional[str] = None   # HELLO HMAC gate
    spill_dir: Optional[str] = None     # result-queue overflow → disk
    spill_budget_bytes: int = 256 << 20
    pump_stall_s: float = 0.0           # chaos: freeze the result consumer
    heartbeat_s: float = 0.25           # liveness beacon over the mp pipe
    device: Optional[str] = None        # the engine's device (None: card)


def _build_engine(cfg: WorkerConfig):
    from repro_torch.stream import (PrecisionRouter, StreamEngine,
                                    cough_pipeline, rpeak_pipeline)

    device = resolve_device(cfg.device)
    pipelines = {}
    if "cough" in cfg.tasks:
        from repro_torch.apps.cough import train_reference_forest
        n_ref, seed, n_trees, depth = cfg.forest_train
        pipelines["cough"] = cough_pipeline(train_reference_forest(
            n_ref, seed, n_trees=n_trees, depth=depth, device=device))
    if "rpeak" in cfg.tasks:
        pipelines["rpeak"] = rpeak_pipeline()
    return StreamEngine(
        pipelines,
        router=PrecisionRouter(patient_formats=dict(cfg.pins)),
        max_batch=cfg.max_batch, pad_policy=cfg.pad_policy, device=device,
        mesh_info=(split_mesh_info(device, cfg.devices) if cfg.devices > 1
                   else None))


def _host(v) -> np.ndarray:
    """A result output as a host array (a tensor on the card is copied)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _result_digests(supervisor) -> Dict[str, str]:
    """Per-patient sha256 over every retained result, in (task, widx)
    order, covering provenance + raw output bytes (with numpy's dtype
    string, as the reference hashes them).  Duplicate or missing windows
    change the digest — the chaos bit-identity/exactly-once assertion
    compares these between a faulted and a fault-free run."""
    by_patient: Dict[str, List] = {}
    for r in supervisor.queue:
        by_patient.setdefault(r.patient, []).append(r)
    out: Dict[str, str] = {}
    for pid, rows in sorted(by_patient.items()):
        h = hashlib.sha256()
        for r in sorted(rows, key=lambda r: (r.task, r.widx)):
            h.update(f"{r.task}|{r.widx}|{r.fmt}".encode())
            for k in sorted(r.outputs):
                arr = np.ascontiguousarray(_host(r.outputs[k]))
                h.update(f"{k}|{arr.dtype.str}|{arr.shape}".encode())
                h.update(arr.tobytes())
        out[pid] = h.hexdigest()
    return out


def _worker_payload(engine, supervisor, server,
                    kernel_calls) -> Dict[str, object]:
    tele = supervisor.telemetry()
    return {
        "groups": engine.ledger.rows(),
        "transport": engine.ledger.transport_summary(),
        "escalation": engine.ledger.escalation_summary(),
        "patients": tele["patients"],
        "latency_s": supervisor.latency_samples(),
        "queue": tele["queue"],
        "server": {"connections_total": server.connections_total,
                   "protocol_errors": server.protocol_errors,
                   "session_errors": server.session_errors,
                   "auth_failures": server.auth_failures},
        "windows": supervisor.total_windows,
        "devices": engine.dp_size,
        # full registry snapshot (counters/gauges + RAW histogram samples)
        # — the aggregator merges these the same way as latency_s: sums
        # and concatenations, never precomputed percentiles
        "metrics": supervisor.metrics.snapshot(),
        "scrape_port": getattr(server, "scrape_port", None),
        # queue-retained results only: spilled results live in the spill
        # segment (recoverable, counted separately)
        "digests": _result_digests(supervisor),
        # the port's own entry: this process's kernel launches while it
        # served, by wrapper
        "kernel_calls": kernel_calls,
    }


def worker_main(cfg: WorkerConfig, conn) -> None:
    """Worker process entry point: serve, drain on request, report, exit.

    Conn protocol (parent → worker): ``("drain", deadline_s)`` once every
    client is done.  Worker → parent: ``("ready", port)`` after bind,
    ``("hb", wall_time)`` every ``cfg.heartbeat_s`` from a dedicated
    thread (it beats through engine builds and kernel warm-ups, when the
    event loop is blocked — a silent pipe means *hung*, not just busy),
    then ``("result", payload)`` or ``("error", repr)`` before exit.
    """
    # The reference sets its forced host device split here, before jax's
    # first import; the port splits its one device in _build_engine
    # (split_mesh_info) and needs no such setting.  The pool's parallelism
    # is its processes: torch's default of one CPU thread per core in every
    # worker oversubscribes the host (two CPU workers of a 16-patient mixed
    # fleet on 8 cores took 74 s instead of 1.1 s, and stalled sessions
    # out).
    torch.set_num_threads(1)
    send_lock = threading.Lock()

    def send(msg) -> None:
        with send_lock:
            conn.send(msg)

    stop_hb = threading.Event()

    def heartbeat() -> None:
        while not stop_hb.wait(cfg.heartbeat_s):
            try:
                send(("hb", time.time()))
            except (OSError, ValueError):
                return      # parent gone; the process is about to exit

    hb_thread = threading.Thread(target=heartbeat, daemon=True)
    hb_thread.start()
    try:
        from repro_torch.ingest import IngestServer, SessionManager, Supervisor
        from repro_torch.ingest.spill import ResultSpill
        from repro_torch.kernels.counts import (launch_counts,
                                                reset_launch_counts)

        engine = _build_engine(cfg)
        sessions = SessionManager(engine,
                                  stall_timeout_s=cfg.stall_timeout_s)
        spill = None
        if cfg.spill_dir:
            spill = ResultSpill(
                os.path.join(cfg.spill_dir,
                             f"worker{cfg.worker_id:02d}-e{cfg.epoch}.seg"),
                budget_bytes=cfg.spill_budget_bytes)
        supervisor = Supervisor(engine, capacity=cfg.supervisor_capacity,
                                spill=spill)

        async def serve() -> Dict[str, object]:
            async with IngestServer(
                    sessions, port=0, high_watermark=cfg.high_watermark,
                    reap_interval_s=cfg.stall_timeout_s / 4,
                    supervisor=supervisor,
                    scrape_port=0 if cfg.scrape else None,
                    ack=cfg.ack, auth_secret=cfg.auth_secret) as srv:
                send(("ready", srv.port))
                done = [False]

                async def pump() -> None:
                    if cfg.pump_stall_s > 0:
                        # chaos: the consumer freezes while ingest keeps
                        # scoring — the bounded queue overflows into the
                        # spill instead of dropping results
                        await asyncio.sleep(cfg.pump_stall_s)
                    await supervisor.run_async(0.005, stop=lambda: done[0])

                pump_task = asyncio.ensure_future(pump())
                # wait for the parent's drain request without blocking the
                # event loop (Pipe.poll is cheap)
                while not conn.poll():
                    await asyncio.sleep(0.02)
                _, deadline_s = conn.recv()
                deadline = time.perf_counter() + deadline_s
                # the drain request races the kernel socket buffers: the
                # clients have WRITTEN everything, but this loop may not
                # have PARSED it yet — so wait until every assigned patient
                # has shown up AND closed (BYE or the stall reaper), not
                # merely until the current session set looks closed
                def drained() -> bool:
                    return (len(sessions.sessions) >= cfg.n_patients
                            and (not sessions.sessions
                                 or sessions.all_closed()))
                while not drained():
                    if time.perf_counter() > deadline:
                        break
                    await asyncio.sleep(0.02)
                done[0] = True
                await pump_task
                payload = _worker_payload(engine, supervisor, srv,
                                          launch_counts())
                if spill is not None:
                    spill.close()
                return payload

        # the launches counted are the serving run's, not the engine
        # build's (the forest's training runs on the device too)
        reset_launch_counts()
        payload = asyncio.run(serve())
        send(("result", payload))
    except BaseException as e:  # noqa: BLE001 — must cross the pipe
        try:
            send(("error", repr(e)))
        finally:
            raise
    finally:
        stop_hb.set()
        conn.close()


# ---------------------------------------------------------------------------
# fleet rollup: merge per-worker payloads into one telemetry document
# ---------------------------------------------------------------------------

def _percentiles_ms(lat_s: List[float]) -> Dict[str, float]:
    if not lat_s:
        return {f"p{p}": 0.0 for p in _PCTS}
    ms = np.asarray(lat_s) * 1e3
    return {f"p{p}": float(np.percentile(ms, p)) for p in _PCTS}


def aggregate_rollup(payloads: Sequence[Dict[str, object]]
                     ) -> Dict[str, object]:
    """Merge worker payloads into the single-process telemetry shape:
    ``groups`` mirrors ``StreamEngine.fleet_summary()`` (with a fleet
    rollup row), ``transport``/``latency_ms``/``result_queue`` mirror the
    supervisor's blocks.  Ledger rows sum field-wise; percentiles are
    recomputed from concatenated samples.  Each worker's ``kernel_calls``
    (the port's own payload entry) is passed through under ``workers``."""
    raw: Dict[str, Dict[str, float]] = {}
    for p in payloads:
        for key, row in p["groups"].items():
            acc = raw.setdefault(key, {k: 0 for k in row})
            for k, v in row.items():
                acc[k] += v
    groups: Dict[str, Dict[str, float]] = {}
    tot = {"windows": 0, "batches": 0, "padded_windows": 0,
           "energy_nj": 0.0, "latency_s": 0.0,
           "escalated_windows": 0, "escalation_nj": 0.0}
    for key, g in sorted(raw.items()):
        groups[key] = {
            "windows": g["windows"],
            "batches": g["batches"],
            "padded_windows": g["padded_windows"],
            "windows_per_s": (g["windows"] / g["latency_s"]
                              if g["latency_s"] else 0.0),
            "nj_per_window": (g["energy_nj"] / g["windows"]
                              if g["windows"] else 0.0),
            "total_nj": g["energy_nj"],
            "escalated_windows": g["escalated_windows"],
            "escalation_nj": g["escalation_nj"],
        }
        for k in tot:
            tot[k] += g[k]
    # schema-complete fleet row: key-parity with every per-group row (and
    # with EnergyLedger.summary()'s fleet row)
    groups["fleet"] = {
        "windows": tot["windows"],
        "batches": tot["batches"],
        "padded_windows": tot["padded_windows"],
        "windows_per_s": (tot["windows"] / tot["latency_s"]
                          if tot["latency_s"] else 0.0),
        "nj_per_window": (tot["energy_nj"] / tot["windows"]
                          if tot["windows"] else 0.0),
        "total_nj": tot["energy_nj"],
        "escalated_windows": tot["escalated_windows"],
        "escalation_nj": tot["escalation_nj"],
    }

    # transport: patient sets are disjoint, so per-patient rows concatenate
    # and the fleet row is the sum of the workers' fleet rows
    transport: Dict[str, Dict[str, int]] = {}
    fleet_t: Dict[str, int] = {}
    for p in payloads:
        for pid, row in p["transport"].items():
            if pid == "fleet":
                for k, v in row.items():
                    fleet_t[k] = fleet_t.get(k, 0) + v
            else:
                transport[pid] = dict(row)
    transport["fleet"] = fleet_t

    lat: List[float] = []
    queue = {"capacity": 0, "depth": 0, "dropped": 0, "total_windows": 0,
             "spilled": 0, "spill_rejected": 0, "spill_bytes": 0}
    dropped_by_patient: Dict[str, int] = {}
    spilled_by_patient: Dict[str, int] = {}
    patients: Dict[str, object] = {}
    servers = {"connections_total": 0, "protocol_errors": 0,
               "session_errors": 0, "auth_failures": 0}
    escalation: Dict[str, Dict[str, float]] = {}
    digests: Dict[str, str] = {}
    for p in payloads:
        lat.extend(p["latency_s"])
        for k in queue:
            queue[k] += p["queue"].get(k, 0)
        for pid, n in p["queue"].get("dropped_by_patient", {}).items():
            dropped_by_patient[pid] = dropped_by_patient.get(pid, 0) + n
        for pid, n in p["queue"].get("spilled_by_patient", {}).items():
            spilled_by_patient[pid] = spilled_by_patient.get(pid, 0) + n
        patients.update(p["patients"])
        for k in servers:
            servers[k] += p["server"].get(k, 0)
        escalation.update(p["escalation"])
        digests.update(p.get("digests", {}))
    queue["dropped_by_patient"] = dropped_by_patient
    queue["spilled_by_patient"] = spilled_by_patient

    # metric registries merge like everything above: counters/gauges sum,
    # histogram reservoirs concatenate (raw samples, percentiles at render)
    from repro_torch.obs import merge_snapshots
    metrics = merge_snapshots([p.get("metrics") or {} for p in payloads])
    return {
        "groups": groups,
        "transport": transport,
        "latency_ms": _percentiles_ms(lat),
        "result_queue": queue,
        "patients": patients,
        "servers": servers,
        "escalation": escalation,
        "windows": sum(p["windows"] for p in payloads),
        "metrics": metrics,
        "digests": digests,
        "workers": [{"worker_id": i, "windows": p["windows"],
                     "devices": p["devices"],
                     "scrape_port": p.get("scrape_port"),
                     "kernel_calls": p.get("kernel_calls")}
                    for i, p in enumerate(payloads)],
    }


# ---------------------------------------------------------------------------
# the pool: spawn workers, route clients, fail over, drain, aggregate
# ---------------------------------------------------------------------------

def partition_plans(plans: Sequence[PatientPlan], n_workers: int
                    ) -> List[List[PatientPlan]]:
    """Round-robin by plan index: keeps each worker's task mix close to the
    fleet's (the simulator orders cough patients before ECG)."""
    out: List[List[PatientPlan]] = [[] for _ in range(n_workers)]
    for i, plan in enumerate(plans):
        out[i % n_workers].append(plan)
    return out


@dataclasses.dataclass
class _Worker:
    """Parent-side state for one pool member across respawns."""

    wid: int
    cfg: WorkerConfig
    plans: List[PatientPlan]
    proc: Optional[object] = None
    conn: Optional[object] = None
    port: Optional[int] = None
    epoch: int = 0                  # respawn generation
    restarts: int = 0
    phase: str = "starting"         # starting | serving | draining | done
    last_hb: float = 0.0
    drain_deadline: Optional[float] = None
    recover_t0: Optional[float] = None
    recovery_s: List[float] = dataclasses.field(default_factory=list)
    result: Optional[Dict[str, object]] = None
    failed: Optional[str] = None

    def patients(self) -> List[str]:
        return [p.patient for p in self.plans]


def _spawn(ctx, w: _Worker) -> None:
    cfg = dataclasses.replace(w.cfg, epoch=w.epoch)
    parent, child = ctx.Pipe()
    proc = ctx.Process(target=worker_main, args=(cfg, child), daemon=True)
    proc.start()
    child.close()
    w.proc, w.conn = proc, parent
    w.port = None
    w.phase = "starting"
    w.last_hb = time.perf_counter()
    w.drain_deadline = None


def _reap(w: _Worker) -> None:
    """Put a dead/hung worker process fully down and close its pipe."""
    if w.proc is not None:
        if w.proc.is_alive():
            w.proc.terminate()
            w.proc.join(timeout=5.0)
        if w.proc.is_alive():
            w.proc.kill()
            w.proc.join(timeout=5.0)
    if w.conn is not None:
        try:
            w.conn.close()
        except OSError:
            pass
    w.port = None


async def _supervise(w: _Worker, ctx, policy: RestartPolicy,
                     restarts_c, start_timeout_s: float,
                     hb_timeout_s: Optional[float]) -> None:
    """Health-check one worker and fail it over: drains the pipe (ready /
    heartbeat / result / error), detects death (process exit, heartbeat
    silence, ready timeout, drain-barrier timeout), and respawns under
    ``policy`` — republishing the port via ``w.port`` so the clients'
    ``lookup`` follows — until a result arrives or the budget is spent."""
    loop = asyncio.get_event_loop()
    start_deadline = loop.time() + start_timeout_s
    while True:
        if w.result is not None or w.failed is not None:
            return
        died, reason = False, ""
        try:
            while w.conn.poll():
                kind, val = w.conn.recv()
                if kind == "ready":
                    w.port = val
                    w.phase = "serving"
                    w.last_hb = time.perf_counter()
                    if w.recover_t0 is not None:
                        w.recovery_s.append(
                            time.perf_counter() - w.recover_t0)
                        w.recover_t0 = None
                elif kind == "hb":
                    w.last_hb = time.perf_counter()
                elif kind == "result":
                    w.result = val
                    w.phase = "done"
                    return
                elif kind == "error":
                    died, reason = True, f"worker error: {val}"
                    break
        except (EOFError, OSError):
            died, reason = True, "pipe closed"
        if not died and w.proc is not None and not w.proc.is_alive():
            died = True
            reason = f"process died (exitcode {w.proc.exitcode})"
        if (not died and w.phase == "starting"
                and loop.time() > start_deadline):
            died, reason = True, f"no ready within {start_timeout_s}s"
        if (not died and hb_timeout_s is not None
                and w.phase in ("serving", "draining")
                and time.perf_counter() - w.last_hb > hb_timeout_s):
            died, reason = True, f"heartbeat silent for {hb_timeout_s}s"
        if (not died and w.phase == "draining"
                and w.drain_deadline is not None
                and loop.time() > w.drain_deadline):
            # the drain-barrier hang: a worker that never reports results
            # is killed and restarted (or failed), never waited on forever
            died, reason = True, "drain barrier timed out"
        if died:
            _reap(w)
            if not policy.allows(w.restarts):
                w.failed = reason
                return
            w.restarts += 1
            if restarts_c is not None:
                restarts_c.inc(worker=str(w.wid))
            w.recover_t0 = time.perf_counter()
            await asyncio.sleep(policy.delay(w.restarts))
            w.epoch += 1
            _spawn(ctx, w)
            start_deadline = loop.time() + start_timeout_s
        await asyncio.sleep(0.01)


def _make_lookup(w: _Worker) -> Callable[[str], Optional[Tuple[str, int]]]:
    def find(_patient: str) -> Optional[Tuple[str, int]]:
        if w.failed is not None:
            raise ConnectionError(
                f"worker {w.wid} failed permanently: {w.failed}")
        if w.port is None:
            return None       # respawning: back off and ask again
        return ("127.0.0.1", w.port)
    return find


async def _collect(w: _Worker, clients: Dict[str, object],
                   drain_timeout_s: float) -> Optional[Dict[str, object]]:
    """Post-drive phase for one worker: request the drain barrier and wait
    for the result — re-delivering the whole partition (``replay_all``)
    and re-draining after every respawn, so a worker killed at ANY point
    (mid-drive, post-delivery, mid-drain) converges to a complete
    result or a surfaced failure."""
    loop = asyncio.get_event_loop()
    synced_epoch = -1
    while True:
        if w.result is not None:
            return w.result
        if w.failed is not None:
            return None
        if w.phase == "serving" and w.port is not None \
                and w.epoch != synced_epoch:
            if synced_epoch >= 0 or w.restarts > 0:
                # a respawn happened (before or during this loop): every
                # client re-delivers; the fresh worker's zero frontier
                # pulls the full stream, a surviving worker's current
                # frontier reduces it to a no-op handshake
                await asyncio.gather(
                    *(c.replay_all() for c in clients.values()),
                    return_exceptions=True)
                if w.failed is not None or w.result is not None:
                    continue
            synced_epoch = w.epoch
            try:
                w.conn.send(("drain", drain_timeout_s))
                w.phase = "draining"
                w.drain_deadline = loop.time() + drain_timeout_s + 30.0
            except (OSError, ValueError):
                pass     # dying mid-send: the supervisor will respawn
        await asyncio.sleep(0.02)


async def _chaos_kill(w: _Worker, after_s: float) -> None:
    """SIGKILL the target worker ``after_s`` seconds after it first
    reports ready — mid-stream when the drive is long enough, post-drive
    otherwise (both paths must recover)."""
    while w.phase == "starting" and w.failed is None:
        await asyncio.sleep(0.01)
    await asyncio.sleep(after_s)
    if (w.proc is not None and w.proc.is_alive() and w.epoch == 0
            and w.result is None):
        os.kill(w.proc.pid, signal.SIGKILL)


def run_worker_fleet(sim: FleetSimulator, n_workers: int, *,
                     devices: int = 0, max_batch: int = 32,
                     pad_policy: str = "max", stall_timeout_s: float = 1.5,
                     arrival_seed: int = 1, drain_timeout_s: float = 60.0,
                     start_timeout_s: float = 300.0,
                     scrape: bool = False,
                     supervisor_capacity: int = 4096,
                     ack: bool = True, flow_control: Optional[bool] = None,
                     auth_secret: Optional[str] = None,
                     spill_dir: Optional[str] = None,
                     spill_budget_bytes: int = 256 << 20,
                     chaos: Optional[ChaosPlan] = None,
                     restart_policy: Optional[RestartPolicy] = None,
                     hb_timeout_s: Optional[float] = 60.0,
                     realtime_factor: float = 0.0,
                     device=None) -> Dict[str, object]:
    """Drive one ``FleetSimulator`` replay through ``n_workers`` worker
    processes with crash failover, and return the aggregated fleet rollup
    (plus ``wall_s``, ``recovery``, ``digests``, ``failed_workers``).

    Each worker gets a disjoint patient subset; ``ReplayingClient``s
    connect to the worker owning their patient through a live lookup that
    follows failover respawns.  ``device`` is where every worker's engine
    runs (``None``: the card, whose kernels are built here before the
    spawn; ``"cpu"`` on a machine without one); ``devices`` of 0 or 1 is
    that one device, ``n > 1`` shards each worker's dispatch over ``n``
    data slabs of it.  ``chaos`` injects the fault schedule (worker kill,
    connection partitions, frame corruption, consumer stall); recovery
    events are counted in the parent registry (``worker_restarts_total``)
    and merged into the rollup ``metrics``.
    Raises only if EVERY worker failed; partial failures are surfaced in
    ``failed_workers`` (worker id, reason, affected patients).
    """
    if n_workers < 1:
        raise ValueError(f"need ≥ 1 worker, got {n_workers}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        from repro_torch.kernels import build
        build.build()
    from repro_torch.obs import MetricsRegistry, merge_snapshots
    policy = restart_policy or RestartPolicy()
    chaos = chaos or ChaosPlan()
    if flow_control is None:
        flow_control = ack
    parent_metrics = MetricsRegistry()
    restarts_c = parent_metrics.counter(
        "worker_restarts_total",
        "pool worker respawns after crash/hang detection, by worker")
    parts = partition_plans(sim.plans, n_workers)
    ctx = mp.get_context("spawn")
    workers: List[_Worker] = []
    for wid, plans in enumerate(parts):
        tasks = tuple(sorted({p.task for p in plans}))
        pins = tuple(sorted((p.patient, p.fmt) for p in plans
                            if p.fmt is not None))
        cfg = WorkerConfig(
            worker_id=wid, tasks=tasks, pins=pins, n_patients=len(plans),
            devices=devices, max_batch=max_batch, pad_policy=pad_policy,
            stall_timeout_s=stall_timeout_s, scrape=scrape,
            supervisor_capacity=supervisor_capacity, ack=ack,
            auth_secret=auth_secret, spill_dir=spill_dir,
            spill_budget_bytes=spill_budget_bytes,
            pump_stall_s=chaos.stall_pump_s, device=str(dev))
        workers.append(_Worker(wid=wid, cfg=cfg, plans=list(plans)))

    stats_all: Dict[str, object] = {}
    wall_box = [0.0]

    async def main() -> List[Optional[Dict[str, object]]]:
        for w in workers:
            _spawn(ctx, w)
        sup_tasks = [asyncio.ensure_future(_supervise(
            w, ctx, policy, restarts_c, start_timeout_s, hb_timeout_s))
            for w in workers]
        kill_task = None
        if chaos.kill_worker is not None:
            if not 0 <= chaos.kill_worker < n_workers:
                raise ValueError(
                    f"chaos.kill_worker={chaos.kill_worker} out of range")
            kill_task = asyncio.ensure_future(
                _chaos_kill(workers[chaos.kill_worker],
                            chaos.kill_after_s))
        try:
            # wait for the first ready (or failure) of every worker
            while any(w.phase == "starting" and w.failed is None
                      for w in workers):
                await asyncio.sleep(0.01)
            t0 = time.perf_counter()

            async def flow(w: _Worker) -> Optional[Dict[str, object]]:
                clients: Dict[str, object] = {}
                stats: Dict[str, object] = {}
                if w.plans:
                    try:
                        await sim.run_tcp(
                            "127.0.0.1", 0,
                            arrival_seed=arrival_seed + w.wid,
                            realtime_factor=realtime_factor,
                            plans=w.plans, lookup=_make_lookup(w),
                            flow_control=flow_control,
                            auth_secret=auth_secret, chaos=chaos,
                            stats_out=stats, clients_out=clients)
                    except (ConnectionError, OSError):
                        pass    # worker failed permanently mid-drive:
                                # surfaced via failed_workers below
                stats_all.update(stats)
                payload = await _collect(w, clients, drain_timeout_s)
                for c in clients.values():
                    await c.close()
                return payload

            payloads = list(await asyncio.gather(
                *(flow(w) for w in workers)))
            wall_box[0] = time.perf_counter() - t0
            return payloads
        finally:
            if kill_task is not None:
                kill_task.cancel()
            for t in sup_tasks:
                t.cancel()
            await asyncio.gather(*sup_tasks, return_exceptions=True)
            for w in workers:
                if w.result is None and w.proc is not None:
                    _reap(w)
                elif w.proc is not None:
                    w.proc.join(timeout=30.0)
                    if w.conn is not None:
                        try:
                            w.conn.close()
                        except OSError:
                            pass

    payloads = asyncio.run(main())
    good = [p for p in payloads if p is not None]
    failed = [{"worker_id": w.wid, "reason": w.failed,
               "patients": w.patients()}
              for w in workers if w.failed is not None]
    if not good:
        raise RuntimeError(
            "every worker failed: "
            + "; ".join(f"w{f['worker_id']}: {f['reason']}"
                        for f in failed))
    doc = aggregate_rollup(good)

    # fold the client-side delivery stats into the rollup: replayed frames
    # join the ledger's transport column (per patient + fleet), the raw
    # counters ride under recovery.client
    client_rows = {pid: s.as_dict() for pid, s in stats_all.items()}
    for pid, row in client_rows.items():
        n = row.get("replayed_frames", 0)
        if not n:
            continue
        t = doc["transport"].setdefault(pid, {})
        t["replayed_frames"] = t.get("replayed_frames", 0) + n
        fleet = doc["transport"].setdefault("fleet", {})
        fleet["replayed_frames"] = fleet.get("replayed_frames", 0) + n
    agg = {k: sum(r[k] for r in client_rows.values())
           for k in next(iter(client_rows.values()))} if client_rows else {}
    doc["recovery"] = {
        "worker_restarts": sum(w.restarts for w in workers),
        "recovery_s": [x for w in workers for x in w.recovery_s],
        "client": agg,
    }
    doc["failed_workers"] = failed
    doc["metrics"] = merge_snapshots(
        [doc.get("metrics") or {}, parent_metrics.snapshot()])
    doc["wall_s"] = wall_box[0]
    doc["n_workers"] = n_workers
    return doc
