"""Supervisor: bounded result drain + per-patient fleet telemetry.

``StreamEngine.pop_results`` used to be a foot-gun: forget to call it and
results accumulate one entry per window for the life of the stream.  The
supervisor owns the drain loop — every ``poll()`` moves freshly dispatched
``WindowResult``s into a **bounded** queue (drop-oldest, with a counted
warning the first time and at every doubling, so a soak run's log shows the
loss without scrolling it off) and folds each window into per-patient
telemetry:

* windows and windows/sec per patient (monotonic counters — queue drops
  never lose the count);
* end-to-end latency percentiles (window ready → its batch materialized),
  from a bounded per-patient reservoir of recent windows;
* the ledger's transport column (frames/bytes/dups/gaps/evictions per
  patient, maintained by the ``SessionManager``).

The counters and reservoirs live in the engine's ``MetricsRegistry``
(``stream_windows_total{patient}``, ``result_queue_dropped_total{patient}``,
the ``stream_e2e_latency_seconds`` histogram) so the same numbers are
scrapeable at ``/metrics``; ``telemetry()`` is a *view* over the registry
that preserves the original dict shape.  Queue overflow is attributed per
patient (which streams lost results, not just how many) and the
rate-limited warning names the top offenders.
"""
from __future__ import annotations

import asyncio
import collections
import time
from typing import Callable, Deque, Dict, List, Optional

import numpy as np

from repro_torch.obs import MetricsRegistry
from repro_torch.stream.engine import StreamEngine, WindowResult, bounded_admit

_PCTS = (50, 90, 99)


def _percentiles(lat_s: List[float]) -> Dict[str, float]:
    """{p50, p90, p99} in milliseconds; zeros when no samples."""
    if not lat_s:
        return {f"p{p}": 0.0 for p in _PCTS}
    ms = np.asarray(lat_s) * 1e3
    return {f"p{p}": float(np.percentile(ms, p)) for p in _PCTS}


class Supervisor:
    def __init__(self, engine: StreamEngine, capacity: int = 1024,
                 latency_reservoir: int = 512,
                 clock: Callable[[], float] = time.perf_counter,
                 spill=None):
        """``spill`` (a ``repro_torch.ingest.spill.ResultSpill``) turns queue
        overflow from drop-oldest into an on-disk append: the evicted
        result is written to the CRC-framed segment file and counted in
        ``spilled_results_total{patient}``; only results the spill
        *refuses* (disk budget exhausted) fall back to the counted drop.
        ``recover_spill()`` re-admits a previous incarnation's segment."""
        self.engine = engine
        self.capacity = int(capacity)
        self.queue: Deque[WindowResult] = collections.deque()
        self.spill = spill
        self.dropped = 0          # queue evictions (incl. spilled)
        self.spilled = 0          # evictions persisted by the spill
        self.total_windows = 0
        self.clock = clock
        self._warn_at = 1
        self._reservoir = int(latency_reservoir)
        # first/last wall stamps per patient (windows_per_s denominators);
        # the counts/latencies themselves live in the registry
        self._patients: Dict[str, Dict[str, float]] = {}
        # telemetry() must be able to read values back, so a disabled
        # engine registry gets a private live one — the scrape plane is
        # off, the supervisor still works
        base = engine.metrics
        self.metrics: MetricsRegistry = (
            base if getattr(base, "enabled", False) else MetricsRegistry())
        self._windows_c = self.metrics.counter(
            "stream_windows_total", "results drained, by patient")
        self._dropped_c = self.metrics.counter(
            "result_queue_dropped_total",
            "results evicted from the supervisor queue, by patient")
        self._spilled_c = self.metrics.counter(
            "spilled_results_total",
            "results persisted to the spill segment on queue overflow, "
            "by patient")
        self._lat_h = self.metrics.histogram(
            "stream_e2e_latency_seconds",
            "window ready -> batch materialized, raw-sample reservoir",
            reservoir=self._reservoir)
        self._depth_g = self.metrics.gauge(
            "result_queue_depth", "supervisor queue occupancy")

    # -- drain ----------------------------------------------------------------
    def _attribute_drop(self, victim: WindowResult) -> None:
        if self.spill is not None and self.spill.append(victim):
            self._spilled_c.inc(patient=victim.patient)
            self.spilled += 1
            return          # persisted, not lost — attributed separately
        self._dropped_c.inc(patient=victim.patient)

    def recover_spill(self) -> int:
        """Re-admit a previous incarnation's spilled results (restart
        recovery): everything intact in the spill file at ``self.spill.
        path`` rejoins the queue, oldest first; returns how many."""
        if self.spill is None:
            return 0
        rows = type(self.spill).recover(self.spill.path)
        for r in rows:
            self.total_windows += 1
            self._windows_c.inc(patient=r.patient)
            self.dropped, self._warn_at = bounded_admit(
                self.queue, r, self.capacity, self.dropped, self._warn_at,
                self._drop_label, on_drop=self._attribute_drop)
        self._depth_g.set(len(self.queue))
        return len(rows)

    def _drop_label(self) -> str:
        worst = sorted(self._dropped_c.items(),
                       key=lambda kv: -kv[1])[:3]
        blame = ", ".join(f"{d.get('patient', '?')}={int(v)}"
                          for d, v in worst)
        return (f"supervisor result queue full (capacity={self.capacity}; "
                f"most-dropped: {blame})")

    def poll(self) -> int:
        """Move every dispatched result out of the engine; returns how many."""
        tr = self.engine.tracer
        t_drain = tr.now() if tr is not None else 0.0
        rows = self.engine.pop_results()
        now = self.clock()
        for r in rows:
            self.total_windows += 1
            self._windows_c.inc(patient=r.patient)
            st = self._patients.get(r.patient)
            if st is None:
                st = self._patients[r.patient] = {"first": now}
            st["last"] = now
            if r.ready_wall:
                # ready → batch materialized (done_wall); poll-time fallback
                # only for results produced before the stamps existed
                lat = (r.done_wall or now) - r.ready_wall
                self._lat_h.observe(lat, patient=r.patient)
            self.dropped, self._warn_at = bounded_admit(
                self.queue, r, self.capacity, self.dropped, self._warn_at,
                self._drop_label, on_drop=self._attribute_drop)
        self._depth_g.set(len(self.queue))
        if tr is not None and rows:
            tr.complete("drain", "supervisor.poll", t_drain, tr.now(),
                        track="drain", args={"results": len(rows)})
        return len(rows)

    def pop(self, max_n: Optional[int] = None) -> List[WindowResult]:
        """Consume up to ``max_n`` results (all, when None) in FIFO order."""
        n = len(self.queue) if max_n is None else min(max_n, len(self.queue))
        return [self.queue.popleft() for _ in range(n)]

    def results_for(self, patient: str, task: str) -> List[WindowResult]:
        """Retained (not yet popped/dropped) results for one stream, in
        window order — the demo/debug view; soak consumers should ``pop``."""
        return sorted((r for r in self.queue
                       if r.patient == patient and r.task == task),
                      key=lambda r: r.widx)

    # -- telemetry ------------------------------------------------------------
    def latency_samples(self) -> List[float]:
        """The fleet-wide ready→result latency samples (seconds) — the
        concatenation of the per-patient reservoirs, raw, so a multi-worker
        aggregator can compute TRUE fleet percentiles from the concatenation
        instead of averaging per-worker percentiles (which has no
        statistical meaning)."""
        return self._lat_h.samples()

    def dropped_by_patient(self) -> Dict[str, int]:
        """{patient: results lost to queue overflow} — the attribution
        behind the ``result_queue_dropped_total`` metric."""
        return {d.get("patient", "?"): int(v)
                for d, v in self._dropped_c.items()}

    def telemetry(self) -> Dict[str, object]:
        """The original dict shape, derived from the metrics registry."""
        pats: Dict[str, Dict[str, float]] = {}
        for pid, st in sorted(self._patients.items()):
            dt = max(st.get("last", st["first"]) - st["first"], 0.0)
            windows = int(self._windows_c.value(patient=pid))
            pats[pid] = {
                "windows": windows,
                "windows_per_s": windows / dt if dt else 0.0,
                "latency_ms": _percentiles(self._lat_h.samples(patient=pid)),
            }
        self._depth_g.set(len(self.queue))
        spill = (self.spill.counters() if self.spill is not None
                 else {"spilled": 0, "spill_rejected": 0, "spill_bytes": 0,
                       "spilled_by_patient": {}})
        return {
            # "dropped" means LOST: spilled results are persisted, so they
            # are reported under the spill keys, not as drops
            "queue": {"capacity": self.capacity, "depth": len(self.queue),
                      "dropped": self.dropped - self.spilled,
                      "dropped_by_patient": self.dropped_by_patient(),
                      "total_windows": self.total_windows, **spill},
            "latency_ms": _percentiles(self.latency_samples()),
            "patients": pats,
            "per_patient": self.engine.ledger.transport_summary(),
        }

    # -- soak loop ------------------------------------------------------------
    async def run_async(self, interval_s: float = 0.02,
                        stop: Optional[Callable[[], bool]] = None) -> None:
        """Periodic poll loop for transport-driven runs: keeps the bounded
        queue fed while the asyncio server ingests, until ``stop()``."""
        while not (stop() if stop is not None else False):
            self.poll()
            await asyncio.sleep(interval_s)
        self.poll()
