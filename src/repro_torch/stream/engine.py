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

The observability plane (``repro_torch.obs``) watches from the host: a
metrics registry mirrors the ledger and counts built pipeline callables,
and an optional tracer records the engine's span tree (``obs/trace.py``):
each ``ingest``, ``pump`` (``drain``), ``finalize_patient`` and
``evict_patient`` call with the batch staging, the dispatch over the
ledger's own stamps, and each window's tracker update inside it.  The
ingest layer's hooks (``pending_windows``, ``release_patient``,
``evict_patient``, ``reset``) close streams and free their state.  With
a ``mesh_info``, each dispatch is sharded over the mesh's data axis
(``repro_torch.distributed.make_fleet_batch_fn``), bit for bit the
single-device dispatch.
"""
from __future__ import annotations

import collections
import dataclasses
import time
import warnings
from typing import Deque, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core.arith import fusion_cache_key
from repro_torch.core.device import resolve_device
from repro_torch.distributed.sharding import fleet_pad, make_fleet_batch_fn
from repro_torch.obs import MetricsRegistry, bind_stream_engine
from repro_torch.obs.trace import span, traced

from .accounting import EnergyLedger, window_energy_nj
from .pipelines import Pipeline
from .ring import Window, WindowDispatcher
from .router import PrecisionRouter


def bounded_admit(queue: Deque, item, capacity: Optional[int],
                  dropped: int, warn_at: int, label,
                  on_drop=None) -> Tuple[int, int]:
    """Append ``item`` to a bounded deque, dropping the OLDEST entry past
    ``capacity`` with a rate-limited (doubling) warning.  Returns the
    updated ``(dropped, warn_at)`` counters.  Shared by the engine's result
    backlog, the ingest supervisor's queue and the serving scheduler's
    completion queue, so the overflow policy has one implementation.

    ``on_drop(victim)`` runs for every evicted entry BEFORE the warning
    fires, so callers can attribute drops (per patient, into a metrics
    counter); ``label`` may be a callable producing the message lazily —
    it is only formatted on the rate-limited path, never per admit."""
    if capacity is not None and len(queue) >= capacity:
        victim = queue.popleft()
        dropped += 1
        if on_drop is not None:
            on_drop(victim)
        if dropped >= warn_at:
            msg = label() if callable(label) else label
            warnings.warn(f"{msg}: dropped oldest — {dropped} drops so "
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
                 device=None, metrics=None, tracer=None, mesh_info=None):
        """``device``: where windows are scored (default: the card, or the
        mesh's first device; without CUDA this raises unless
        ``device="cpu"`` is given).  Trackers live there.

        ``pad_to_max``: always pad dispatches to ``max_batch``.
        ``pad_policy`` supersedes it: ``"pow2"`` / ``"max"`` force a
        strategy; ``"auto"`` pads to max until ``autotune_horizon`` windows
        are on the ledger, then stays there iff the observed padding ratio
        padded/(windows+padded) is ≤ ``pad_auto_threshold``, else falls back
        to pow2 buckets.

        ``result_capacity`` bounds the ``results`` backlog: past the cap the
        OLDEST results are dropped (counted in ``dropped_results``, with a
        rate-limited warning).  ``None`` leaves it unbounded.

        ``metrics`` is the engine's observability registry (a
        ``repro_torch.obs.MetricsRegistry``; ``None`` creates a private
        one, ``repro_torch.obs.NULL_METRICS`` turns the plane off).  The
        session, supervisor and server layers share it.  ``tracer`` (a
        ``repro_torch.obs.Tracer``, default off) records the engine's span
        tree and per-window lifecycle spans; it is current
        (``obs.trace.use``) inside the entry points, so the window cores
        and the tracker record into it too.  Both live on the host: they
        read host clocks only and add no device synchronization.

        The program-cache probes keep the reference's series names
        (``jit_programs_total``, ``jit_cache_hits_total``,
        ``jit_fusion_key_changes_total``) so a scraped page has the same
        series; here they count the pipeline callables built, and reused,
        per ``(task, fmt, fusion_cache_key())``, and flips of that key
        between dispatches.

        ``mesh_info`` (a ``repro_torch.distributed.MeshInfo``, e.g. from
        ``launch.mesh.make_fleet_mesh_info`` or ``split_mesh_info``) shards
        every dispatch over the mesh's data axis: the batch is padded to a
        multiple of the data-parallel size (``fleet_pad``), each slab runs
        the pipeline's callable built for its device, and the slabs'
        ``[real, padded]`` rows are reduced through
        ``distributed.collectives.ledger_psum`` and checked against the
        host's staged count.  Outputs are bit-identical to the
        single-device path.  A 1-device mesh (or ``None``) takes the plain
        path.
        """
        if device is None and mesh_info is not None:
            device = mesh_info.devices[0]
        self.device = resolve_device(device)
        self.mesh_info = mesh_info
        self.dp_size = int(mesh_info.dp_size) if mesh_info is not None else 1
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
        self.metrics = MetricsRegistry() if metrics is None else metrics
        self.tracer = tracer
        bind_stream_engine(self.metrics, self)
        self._jit_programs = self.metrics.counter(
            "jit_programs_total", "compiled programs by site")
        self._jit_hits = self.metrics.counter(
            "jit_cache_hits_total", "compiled-program cache hits by site")
        self._fusion_changes = self.metrics.counter(
            "jit_fusion_key_changes_total",
            "fusion_cache_key() flips observed between dispatches — "
            "each flip builds every live (task, fmt) callable anew")
        self._last_fusion_key = None
        self.results: Deque[WindowResult] = collections.deque()
        self._evicted: Set[Tuple[str, str]] = set()
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
        if key in self._evicted:
            raise KeyError(f"{patient!r}'s {task!r} stream was closed "
                           f"(BYE or stall eviction); reset() starts fresh")
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

    @traced("stream", "stream.ingest")
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
    @traced("stream", "stream.pump")
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

    def pending_windows(self) -> int:
        """Ready-but-undispatched window count across the fleet — the
        transport layer's backpressure signal."""
        return sum(len(ws) for ws in self._pending.values())

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

    def _fn(self, task: str, fmt: str, device=None):
        # keyed on the live fusion_cache_key so a backend/quire toggle
        # mid-flight builds a fresh callable instead of serving the stale
        # one — and so the probes see every rebuild it causes
        device = self.device if device is None else device
        fkey = fusion_cache_key()
        if self._last_fusion_key is None:
            self._last_fusion_key = fkey
        elif fkey != self._last_fusion_key:
            self._fusion_changes.inc(site="stream")
            self._last_fusion_key = fkey
        key = (task, fmt, fkey, device)
        fn = self._fns.get(key)
        if fn is None:
            fn = self._fns[key] = self.pipelines[task].make_fn(fmt, device)
            self._jit_programs.inc(site="stream", task=task, fmt=fmt)
        else:
            self._jit_hits.inc(site="stream", task=task, fmt=fmt)
        return fn

    def _sharded_fn(self, task: str, fmt: str):
        """The dispatch over the mesh's data axis: one pipeline callable
        per distinct device of the mesh, each slab on its own."""
        devices = self.mesh_info.dp_devices
        fns = {d: self._fn(task, fmt, d) for d in dict.fromkeys(devices)}
        return make_fleet_batch_fn(tuple(fns[d] for d in devices),
                                   self.mesh_info)

    def _dispatch(self, task: str, fmt: str, windows: List[Window]) -> None:
        pipe = self.pipelines[task]
        B = len(windows)
        Bpad = self.max_batch if self._effective_pad_to_max() \
            else bucket_size(B, self.max_batch)
        if self.dp_size > 1:
            # every slab the same size; the extra rows are ordinary padding
            Bpad = fleet_pad(Bpad, self.dp_size)
        with span("stream", "stream.stage", task=task, B=B, Bpad=Bpad):
            stacks: Dict[str, np.ndarray] = {}
            for m in pipe.spec.modalities:
                stack = np.zeros((Bpad, m.channels,
                                  pipe.spec.window_samples(m)), np.float32)
                for i, w in enumerate(windows):
                    stack[i] = w.arrays[m.name]
                stacks[m.name] = stack
        with span("dispatch", "stream.dispatch", task=task, fmt=fmt, B=B,
                  Bpad=Bpad) as sp:
            t0 = time.perf_counter()
            outs, n_real, n_padded = self._score(task, fmt, stacks, B, Bpad)
            dt = time.perf_counter() - t0
            # the span is the ledger's latency_s, to the outputs' host copy
            sp.at(t0, t0 + dt)
        rows = [{k: v[i] for k, v in outs.items()} for i in range(B)]
        n_esc, esc_nj = self._track(pipe, task, fmt, windows, rows)
        self.ledger.record(task, fmt, n_real, n_padded, dt,
                           pipe.ops_per_window,
                           n_escalated=n_esc, escalation_extra_nj=esc_nj)
        done = time.perf_counter()
        tr = self.tracer
        if tr is not None:
            # host stamps only: ready_wall/t0 already exist for the ledger
            for w in windows:
                if w.ready_wall:
                    tr.complete("stage", "ready->dispatch", w.ready_wall,
                                t0, track=w.patient,
                                args={"widx": w.widx, "task": task})
        for w, row in zip(windows, rows):
            self._append_result(WindowResult(
                w.patient, task, w.widx, fmt, w.t0_s, row,
                ready_wall=w.ready_wall, done_wall=done))

    def _score(self, task: str, fmt: str, stacks: Dict[str, np.ndarray],
               B: int, Bpad: int) -> Tuple[Dict[str, np.ndarray], int, int]:
        """The staged batch to the device, through the pipeline's callable,
        and its outputs back to the host: (outputs, real rows, padded)."""
        if self.dp_size > 1:
            mask = np.zeros((Bpad,), np.int32)
            mask[:B] = 1
            host, ledger_row = self._sharded_fn(task, fmt)(stacks, mask)
            outs = {k: v.numpy() for k, v in host.items()}
            # the reduced slab counts ARE the ledger's row; a mismatch with
            # the host's view means the sharding dropped rows
            n_real, n_padded = (int(v) for v in ledger_row)
            if n_real != B:
                raise RuntimeError(
                    f"sharded dispatch accounted {n_real} real windows, "
                    f"host staged {B} (task={task!r}, fmt={fmt!r})")
            return outs, n_real, n_padded
        arrays = {k: torch.from_numpy(v).to(self.device)
                  for k, v in stacks.items()}
        # one device→host copy per output per batch; WindowResult rows are
        # views into these arrays
        outs = {k: v.cpu().numpy()
                for k, v in self._fn(task, fmt)(arrays).items()}
        return outs, B, Bpad - B

    def _append_result(self, r: WindowResult) -> None:
        """Retain one result, dropping the oldest past ``result_capacity``."""
        self.dropped_results, self._drop_warn_at = bounded_admit(
            self.results, r, self.result_capacity, self.dropped_results,
            self._drop_warn_at,
            f"engine results backlog full (result_capacity="
            f"{self.result_capacity}); drain with pop_results() or run a "
            f"repro_torch.ingest.Supervisor",
            on_drop=lambda v: self.metrics.counter(
                "engine_results_dropped_total",
                "WindowResults evicted from the engine backlog"
            ).inc(patient=v.patient))

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
            with span("stream", "stream.track", patient=w.patient,
                      widx=w.widx, fmt=fmt):
                key = (w.patient, task)
                tr = self._trackers.get(key)
                if tr is None:
                    tr = self._trackers[key] = pipe.make_tracker(
                        w.patient, self.device)
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
                            - window_energy_nj(pipe.ops_per_window,
                                               base_fmt))
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

    @traced("stream", "stream.finalize")
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

    # -- stream close / stall eviction ----------------------------------------
    def release_patient(self, patient: str, task: str) -> Tuple[int, int]:
        """Free a closed stream's dispatcher — ring buffers, partially
        staged slices, window-grid state — and refuse further ingest for
        it.  The tracker (the stream's peak history) and any undrained
        results are kept.  Returns the (slices, bytes) freed."""
        key = (patient, task)
        self._evicted.add(key)
        disp = self._dispatchers.pop(key, None)
        return disp.staged_cost() if disp is not None else (0, 0)

    @traced("stream", "stream.evict")
    def evict_patient(self, patient: str, task: str) -> Dict[str, int]:
        """Close one stream — clean BYE or stall eviction: dispatch its
        complete pending windows (so the delivered prefix is fully scored),
        finalize its tracker, and free its dispatcher.  Further ingest for
        the stream raises.  Returns what was flushed/dropped/freed, for the
        ledger's transport column.

        This path never raises (a close that wedges the session layer is
        worse than a lossy close): a failing dispatch drops the stream's
        remaining windows and counts them in ``windows_dropped``, batches
        dispatched before the failure still count as flushed, and a
        finalize failure is swallowed after the state is freed.  A caller
        on the card that must see a failing launch checks that count.

        After eviction the tracker's ``peaks`` equal the offline
        detector's output on exactly the window prefix that fully arrived.
        """
        key = (patient, task)
        flushed = dropped = 0
        ws = self._pending.pop(key, [])
        if ws:
            try:
                fmt = self.router.route(patient, task).fmt
                while ws:
                    batch = ws[: self.max_batch]
                    self._dispatch(task, fmt, batch)
                    del ws[: len(batch)]
                    flushed += len(batch)
            except Exception:  # noqa: BLE001 — counted, see the docstring
                dropped = len(ws)   # the un-dispatched remainder is lost
            self._recount_pending()
        staged_slices, staged_bytes = self.release_patient(patient, task)
        if key in self._trackers:
            try:
                self.finalize_patient(patient, task)
            except Exception:  # noqa: BLE001 — state is already freed
                pass
        return {"windows_flushed": flushed, "windows_dropped": dropped,
                "staged_slices": staged_slices,
                "staged_bytes": staged_bytes}

    def reset(self) -> None:
        """Fresh streams and metrics.  The built (task, format) callables
        are kept, so a run can warm up, reset, then measure steady state —
        and so is an ``"auto"`` pad-policy decision learned in warmup."""
        self._dispatchers.clear()
        self._pending.clear()
        self._pending_counts.clear()
        self._trackers.clear()
        self._evicted.clear()
        self.results = collections.deque()
        self.dropped_results = 0
        self._drop_warn_at = 1
        self.ledger = EnergyLedger()
        # metric VALUES reset with the ledger (registrations and collectors
        # survive, like the built callables)
        self.metrics.reset()
        self._last_fusion_key = None

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
