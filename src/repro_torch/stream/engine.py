"""StreamEngine: continuous multi-patient windowed inference on the card.

The counterpart of ``repro.stream.engine``.  Chunks from a fleet of
wearables flow in (any interleaving across patients; in order within one
stream).  Each patient's dispatcher emits fixed-size windows exactly once;
ready windows are kept grouped per (patient, task) with per-(task, format)
counts maintained incrementally.  The engine pads each dispatch group to a
batch bucket, copies it to the device once, runs the pipeline's batched
callable, and copies the outputs back once per batch.  Per-dispatch
wall-clock and per-window model energy land in the ledger.

Pipelines that declare ``make_tracker`` (the R-peak pipeline does) get a
per-patient stateful tracker; its confirmed R-peaks come back on the
``WindowResult`` (``outputs["peaks"]``), and its quality signal drives the
router's precision escalation, with the extra energy of escalated windows
attributed in the ledger.

Not in this slice: mesh sharding, the observability plane (metrics,
tracer), and stream eviction with the ingest layer's hooks.
"""
from __future__ import annotations

import collections
import dataclasses
import time
import warnings
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.arith import fusion_cache_key
from repro_torch.core.device import resolve_device

from .accounting import EnergyLedger, window_energy_nj
from .pipelines import Pipeline
from .ring import Window, WindowDispatcher
from .router import PrecisionRouter


def bounded_admit(queue: Deque, item, capacity: Optional[int],
                  dropped: int, warn_at: int, label: str
                  ) -> Tuple[int, int]:
    """Append ``item`` to a bounded deque, dropping the OLDEST entry past
    ``capacity`` with a rate-limited (doubling) warning.  Returns the
    updated ``(dropped, warn_at)`` counters.  Shared by the engine's result
    backlog and the serving scheduler's completion queue, so the overflow
    policy has one implementation."""
    if capacity is not None and len(queue) >= capacity:
        queue.popleft()
        dropped += 1
        if dropped >= warn_at:
            warnings.warn(f"{label}: dropped oldest — {dropped} drops so "
                          f"far", RuntimeWarning, stacklevel=3)
            warn_at = max(warn_at * 2, 1)
    queue.append(item)
    return dropped, warn_at


def bucket_size(n: int, max_batch: int) -> int:
    """Smallest power of two ≥ n (capped at ``max_batch``)."""
    if n <= 1:
        return 1
    return min(1 << (n - 1).bit_length(), max_batch)


@dataclasses.dataclass
class WindowResult:
    """One window's inference output with full provenance.

    ``outputs`` holds row views into the batch's host arrays — the batch is
    copied from the device once per dispatch, not once per window.
    """

    patient: str
    task: str
    widx: int
    fmt: str
    t0_s: float
    outputs: Dict[str, np.ndarray]
    ready_wall: float = 0.0         # wall clock when the window became ready
    done_wall: float = 0.0          # wall clock when its batch materialized


class StreamEngine:
    def __init__(self, pipelines: Dict[str, Pipeline],
                 router: Optional[PrecisionRouter] = None,
                 max_batch: int = 64, pad_to_max: bool = False,
                 pad_policy: Optional[str] = None,
                 autotune_horizon: int = 256,
                 pad_auto_threshold: float = 0.25,
                 result_capacity: Optional[int] = 4096,
                 device=None):
        """``device``: where windows are scored (default: the card; without
        CUDA this raises unless ``device="cpu"`` is given).

        ``pad_to_max``: always pad dispatches to ``max_batch``.
        ``pad_policy`` supersedes it: ``"pow2"`` / ``"max"`` force a
        strategy; ``"auto"`` pads to max until ``autotune_horizon`` windows
        are on the ledger, then stays there iff the observed padding ratio
        padded/(windows+padded) is ≤ ``pad_auto_threshold``, else falls back
        to pow2 buckets.

        ``result_capacity`` bounds the ``results`` backlog: past the cap the
        OLDEST results are dropped (counted in ``dropped_results``, with a
        rate-limited warning).  ``None`` leaves it unbounded.
        """
        self.device = resolve_device(device)
        self.pipelines = dict(pipelines)
        self.router = router or PrecisionRouter()
        self.max_batch = int(max_batch)
        if pad_policy is None:
            pad_policy = "max" if pad_to_max else "pow2"
        if pad_policy not in ("pow2", "max", "auto"):
            raise ValueError(f"pad_policy {pad_policy!r} not in "
                             f"('pow2', 'max', 'auto')")
        self.pad_policy = pad_policy
        self.autotune_horizon = int(autotune_horizon)
        self.pad_auto_threshold = float(pad_auto_threshold)
        self._pad_decision: Optional[bool] = None  # auto: None until decided
        self.result_capacity = (None if result_capacity is None
                                else int(result_capacity))
        self.dropped_results = 0
        self._drop_warn_at = 1
        self.ledger = EnergyLedger()
        self.results: Deque[WindowResult] = collections.deque()
        self._dispatchers: Dict[Tuple[str, str], WindowDispatcher] = {}
        # pending windows grouped per (patient, task) in arrival order;
        # routed per group at pump time, so a re-pinned patient picks up
        # the new format on the next pump
        self._pending: Dict[Tuple[str, str], List[Window]] = {}
        self._pending_counts: Dict[Tuple[str, str], int] = {}
        self._fns: Dict[Tuple, object] = {}
        self._trackers: Dict[Tuple[str, str], object] = {}

    # -- ingest ---------------------------------------------------------------
    def register_patient(self, patient: str, task: str,
                         fmt: Optional[str] = None) -> None:
        key = (patient, task)
        if key in self._dispatchers:
            raise KeyError(f"{patient!r} already registered for {task!r}")
        self._dispatchers[key] = WindowDispatcher(
            patient, self.pipelines[task].spec)
        if fmt is not None:
            self.router.pin(patient, fmt)

    def _group_key(self, patient: str, task: str) -> Tuple[str, str]:
        try:
            return (task, self.router.route(patient, task).fmt)
        except KeyError:
            return (task, "?")  # unroutable: the error surfaces at pump()

    def ingest(self, patient: str, task: str, modality: str,
               chunk: np.ndarray) -> None:
        """Feed one in-order chunk; dispatches automatically once a full
        batch of windows is ready somewhere in the fleet."""
        key = (patient, task)
        if key not in self._dispatchers:
            self.register_patient(patient, task)
        for w in self._dispatchers[key].push(modality, chunk):
            self._pending.setdefault(key, []).append(w)
            gkey = self._group_key(patient, task)
            cnt = self._pending_counts.get(gkey, 0) + 1
            self._pending_counts[gkey] = cnt
            if cnt >= self.max_batch:
                self.pump(include_partial=False)

    # -- dispatch -------------------------------------------------------------
    def pump(self, include_partial: bool = True) -> int:
        """Dispatch pending windows now; returns the number processed.

        ``include_partial=False`` only dispatches groups that fill a whole
        ``max_batch``.  A failing dispatch leaves every unprocessed window
        pending before the exception propagates.
        """
        groups: Dict[Tuple[str, str], List[Tuple[str, str]]] = {}
        first_err: Optional[BaseException] = None
        for (patient, task), ws in self._pending.items():
            if not ws:
                continue
            try:
                fmt = self.router.route(patient, task).fmt
            except KeyError as e:           # stays pending, surfaces below
                first_err = first_err or e
                continue
            groups.setdefault((task, fmt), []).append((patient, task))
        n = 0
        for (task, fmt), members in groups.items():
            total = sum(len(self._pending[k]) for k in members)
            try:
                while total >= self.max_batch or (include_partial
                                                  and total > 0):
                    batch: List[Window] = []
                    take: List[Tuple[Tuple[str, str], int]] = []
                    for k in members:
                        if len(batch) == self.max_batch:
                            break
                        ws = self._pending[k]
                        t = min(len(ws), self.max_batch - len(batch))
                        if t:
                            batch.extend(ws[:t])
                            take.append((k, t))
                    self._dispatch(task, fmt, batch)
                    for k, t in take:       # consume only after success
                        del self._pending[k][:t]
                    total -= len(batch)
                    n += len(batch)
            except Exception as e:  # noqa: BLE001 — re-raised after the loop
                first_err = first_err or e
        self._recount_pending()
        if first_err is not None:
            raise first_err
        return n

    def _recount_pending(self) -> None:
        self._pending = {k: ws for k, ws in self._pending.items() if ws}
        self._pending_counts = {}
        for (patient, task), ws in self._pending.items():
            gkey = self._group_key(patient, task)
            self._pending_counts[gkey] = \
                self._pending_counts.get(gkey, 0) + len(ws)

    def drain(self) -> int:
        """End-of-stream flush: dispatch everything still pending."""
        return self.pump(include_partial=True)

    def _effective_pad_to_max(self) -> bool:
        if self.pad_policy == "max":
            return True
        if self.pad_policy == "pow2":
            return False
        if self._pad_decision is None:
            tot_w = sum(g.windows for g in self.ledger.stats.values())
            if tot_w < self.autotune_horizon:
                return True
            tot_p = sum(g.padded_windows
                        for g in self.ledger.stats.values())
            self._pad_decision = (
                tot_p / (tot_w + tot_p) <= self.pad_auto_threshold)
        return self._pad_decision

    def pad_strategy(self) -> str:
        """The strategy dispatches use right now: "pow2" or "max"."""
        return "max" if self._effective_pad_to_max() else "pow2"

    def _fn(self, task: str, fmt: str):
        key = (task, fmt, fusion_cache_key())
        fn = self._fns.get(key)
        if fn is None:
            fn = self._fns[key] = self.pipelines[task].make_fn(fmt,
                                                               self.device)
        return fn

    def _dispatch(self, task: str, fmt: str, windows: List[Window]) -> None:
        pipe = self.pipelines[task]
        B = len(windows)
        Bpad = self.max_batch if self._effective_pad_to_max() \
            else bucket_size(B, self.max_batch)
        stacks: Dict[str, np.ndarray] = {}
        for m in pipe.spec.modalities:
            stack = np.zeros((Bpad, m.channels, pipe.spec.window_samples(m)),
                             np.float32)
            for i, w in enumerate(windows):
                stack[i] = w.arrays[m.name]
            stacks[m.name] = stack
        t0 = time.perf_counter()
        arrays = {k: torch.from_numpy(v).to(self.device)
                  for k, v in stacks.items()}
        # one device→host copy per output per batch; WindowResult rows are
        # views into these arrays
        outs = {k: v.cpu().numpy()
                for k, v in self._fn(task, fmt)(arrays).items()}
        dt = time.perf_counter() - t0
        rows = [{k: v[i] for k, v in outs.items()} for i in range(B)]
        n_esc, esc_nj = self._track(pipe, task, fmt, windows, rows)
        self.ledger.record(task, fmt, B, Bpad - B, dt, pipe.ops_per_window,
                           n_escalated=n_esc, escalation_extra_nj=esc_nj)
        done = time.perf_counter()
        for w, row in zip(windows, rows):
            self._append_result(WindowResult(
                w.patient, task, w.widx, fmt, w.t0_s, row,
                ready_wall=w.ready_wall, done_wall=done))

    def _append_result(self, r: WindowResult) -> None:
        """Retain one result, dropping the oldest past ``result_capacity``."""
        self.dropped_results, self._drop_warn_at = bounded_admit(
            self.results, r, self.result_capacity, self.dropped_results,
            self._drop_warn_at,
            f"engine results backlog full (result_capacity="
            f"{self.result_capacity}); drain with pop_results()")

    def _track(self, pipe: Pipeline, task: str, fmt: str,
               windows: List[Window], rows: List[Dict[str, np.ndarray]]
               ) -> Tuple[int, float]:
        """Run the per-patient stateful trackers over a dispatched batch (in
        ``widx`` order per patient); windows that ran above the patient's
        static format are billed to the escalation column."""
        if pipe.make_tracker is None:
            return 0, 0.0
        n_esc, esc_nj = 0, 0.0
        base_fmts: Dict[str, str] = {}
        extra_by_base: Dict[str, float] = {}
        for w, row in zip(windows, rows):
            key = (w.patient, task)
            tr = self._trackers.get(key)
            if tr is None:
                tr = self._trackers[key] = pipe.make_tracker(w.patient,
                                                             self.device)
            upd = tr.update(w.widx, row, fmt)
            row["peaks"] = upd.new_peaks
            base_fmt = base_fmts.get(w.patient)
            if base_fmt is None:
                base_fmt = base_fmts[w.patient] = \
                    self.router.base_route(w.patient, task).fmt
            if fmt != base_fmt:
                extra = extra_by_base.get(base_fmt)
                if extra is None:
                    extra = extra_by_base[base_fmt] = (
                        window_energy_nj(pipe.ops_per_window, fmt)
                        - window_energy_nj(pipe.ops_per_window, base_fmt))
                n_esc += 1
                esc_nj += extra
                self.ledger.record_escalation(w.patient, extra)
            self.router.observe(w.patient, task, upd.boundary_gap,
                                upd.mid_refractory)
        return n_esc, esc_nj

    # -- stateful trackers ----------------------------------------------------
    def tracker_for(self, patient: str, task: str):
        """The per-patient tracker (None until its first window dispatches)."""
        return self._trackers.get((patient, task))

    def finalize_patient(self, patient: str, task: str) -> np.ndarray:
        """End-of-stream flush for one tracked stream; returns its tail
        peaks."""
        tr = self._trackers.get((patient, task))
        if tr is None:
            return np.zeros(0, np.int64)
        return tr.finalize(self.router.route(patient, task).fmt)

    def finalize_all(self) -> Dict[Tuple[str, str], np.ndarray]:
        """Flush every tracked stream; {(patient, task): tail peaks}."""
        return {key: self.finalize_patient(*key)
                for key in sorted(self._trackers)}

    # -- reporting ------------------------------------------------------------
    def fleet_summary(self) -> Dict[str, Dict[str, float]]:
        return self.ledger.summary()

    def results_for(self, patient: str, task: str) -> List[WindowResult]:
        out = [r for r in self.results
               if r.patient == patient and r.task == task]
        return sorted(out, key=lambda r: r.widx)

    def pop_results(self, max_n: Optional[int] = None) -> List[WindowResult]:
        """Consume up to ``max_n`` results (all, when None) in FIFO order."""
        if max_n is None:
            out = list(self.results)
            self.results.clear()
            return out
        n = min(int(max_n), len(self.results))
        return [self.results.popleft() for _ in range(n)]
