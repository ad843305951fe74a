"""Ring-buffered trace spans with a Chrome trace-event exporter.

The tracer is a host-side, monotonic-clock (``time.perf_counter``, the
same clock that stamps ``Window.ready_wall``/``done_wall``) event log.
It never runs on the device and reads no device value: callers stamp
host timestamps around their work (or record completed spans after the
fact), so a disabled tracer is simply ``None`` and the hot path pays one
attribute load + ``is None`` test, or one global load in ``span``.

Memory is bounded: events land in a ring of ``capacity`` entries and the
oldest are dropped (and counted in ``dropped``) when full — a soak can
run forever with a live tracer without growing.

Span taxonomy (categories, one per pipeline stage):

========== =====================================================
category   span
========== =====================================================
frame      wire bytes → decoded frames (per read, ingest server)
reorder    out-of-order DATA held → released (per held frame)
session    frame accepted by the session layer → samples delivered
stage      window closed by the ring (``ready_wall``) → dispatch start
dispatch   ``stream.dispatch``: the batch's H2D copy → its outputs' host
           copy, the ``EnergyLedger``'s ``latency_s``
stream     the stream engine's tree: ``stream.ingest`` (ring push and
           window assembly), ``stream.pump`` (``drain`` too) ⊃
           ``stream.stage`` (the batch's host stacks), the dispatch,
           ``stream.track`` (one window's tracker update ⊃
           ``rpeak.threshold``, ``rpeak.stitch``); ``stream.finalize``,
           ``stream.evict``
core       window-core stages inside a dispatch: ``cough.fft``,
           ``cough.spectral``, ``cough.mfcc``, ``cough.forest``,
           ``rpeak.scores``
drain      results popped by the supervisor
serve      token serving: ``serve.step`` ⊃ ``serve.admit`` ⊃
           ``serve.prefill``, ``serve.decode`` (⊃ ``serve.sample``),
           ``serve.account`` (the per-row ledger loop); ``serve.retire``
model      inside a prefill or decode: ``model.embed``,
           ``model.attention`` (with the KV append), ``model.moe`` (⊃
           ``moe.route``, ``moe.experts``, ``moe.combine``) or
           ``model.ffn`` per layer, ``model.unembed``
========== =====================================================

Spans opened with ``span`` (the module function, or ``Tracer.span``)
carry an id and their parent's id (the span open around them: the one
that caused them), so ``Tracer.self_times`` can take each span's own
time apart from its children's.  A module-level *current* tracer
(``use(tracer)``, ``current()``) lets model and app code open spans
without a tracer argument; the engines make their own ``tracer``
current for the length of their entry points (``traced``), so the
engine's ``tracer=`` stays the only switch.  With no tracer current,
``span`` returns one shared no-op context: one global load, no clock
read.  The current tracer is one per process, not per thread: the
engines run on one thread.

Export is Chrome trace-event JSON (the ``{"traceEvents": [...]}`` shape)
so ``Tracer.export(path)`` writes a file that opens directly
in Perfetto / ``chrome://tracing``.
"""
from __future__ import annotations

import functools
import json
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["Span", "Tracer", "current", "span", "traced", "use"]

# Chrome trace-event phases used here: "X" complete span, "i" instant.
_COMPLETE = "X"
_INSTANT = "i"
# the track of every span opened with ``span``: one row, nested by time
SPAN_TRACK = "main"


class Span:
    """One span opened on a tracer; leaving its ``with`` records it with
    its id and its parent's (0: a root)."""

    __slots__ = ("_tracer", "cat", "name", "args", "id", "parent", "start",
                 "end")

    def __init__(self, tracer: "Tracer", cat: str, name: str,
                 args: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self.cat = cat
        self.name = name
        self.args = args

    def __enter__(self) -> "Span":
        tr = self._tracer
        tr._last_id += 1
        self.id = tr._last_id
        self.parent = tr._open[-1] if tr._open else 0
        tr._open.append(self.id)
        self.end = None
        self.start = time.perf_counter()
        return self

    def at(self, start_s: float, end_s: float) -> None:
        """Record the span over [start_s, end_s] instead, stamps the caller
        took itself (a ledger's own clock reads): the children opened
        inside must lie inside them."""
        self.start, self.end = start_s, end_s

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter() if self.end is None else self.end
        tr = self._tracer
        tr._open.pop()
        tr._push((_COMPLETE, self.cat, self.name, self.start,
                  max(end, self.start), SPAN_TRACK, self.args, self.id,
                  self.parent))
        return False


class _NoSpan:
    """The shared no-op span ``span`` returns when no tracer is current."""

    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def at(self, start_s: float, end_s: float) -> None:
        pass


_NO_SPAN = _NoSpan()
_current: Optional["Tracer"] = None


def current() -> Optional["Tracer"]:
    """The tracer ``span`` records into (None: tracing is off)."""
    return _current


class use:
    """``with use(tracer):`` makes ``tracer`` current (``None``: none) and
    restores the one before on the way out."""

    __slots__ = ("tracer", "_prev")

    def __init__(self, tracer: Optional["Tracer"]):
        self.tracer = tracer

    def __enter__(self) -> Optional["Tracer"]:
        global _current
        self._prev, _current = _current, self.tracer
        return self.tracer

    def __exit__(self, *exc) -> bool:
        global _current
        _current = self._prev
        return False


def span(cat: str, name: str, **args):
    """A span of the current tracer, its parent the span open around it;
    with no tracer current the shared no-op (no clock read)."""
    tr = _current
    if tr is None:
        return _NO_SPAN
    return Span(tr, cat, name, args or None)


def traced(cat: str, name: str):
    """Decorate an engine's entry point: with the instance's ``tracer``
    current, each call is one span ``name`` holding what it opens.  An
    instance whose ``tracer`` is None runs the call as it is."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(self, *args, **kwargs):
            tr = self.tracer
            if tr is None:
                return fn(self, *args, **kwargs)
            with use(tr), Span(tr, cat, name, None):
                return fn(self, *args, **kwargs)
        return call
    return wrap


class Tracer:
    """Bounded in-memory span log. All times are perf_counter seconds.

    An event is ``(ph, cat, name, start, end, track, args, id, parent)``;
    ``id`` is 0 for spans recorded by ``complete`` and for instants."""

    def __init__(self, capacity: int = 1 << 16):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = int(capacity)
        self._events: deque = deque()
        self.dropped = 0
        self._t0 = time.perf_counter()
        self._last_id = 0
        self._open: List[int] = []      # ids of the spans open, innermost last

    # -- recording ---------------------------------------------------------

    def now(self) -> float:
        return time.perf_counter()

    def _push(self, ev: Tuple) -> None:
        if len(self._events) >= self.capacity:
            self._events.popleft()
            self.dropped += 1
        self._events.append(ev)

    def span(self, cat: str, name: str, **args) -> Span:
        """A span on this tracer, its parent the span open around it."""
        return Span(self, cat, name, args or None)

    def complete(
        self,
        cat: str,
        name: str,
        start_s: float,
        end_s: float,
        track: str = "main",
        args: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Record a completed span [start_s, end_s] (perf_counter seconds)."""
        self._push((_COMPLETE, cat, name, start_s, max(end_s, start_s), track,
                    args, 0, 0))

    def instant(
        self,
        cat: str,
        name: str,
        ts_s: Optional[float] = None,
        track: str = "main",
        args: Optional[Dict[str, Any]] = None,
    ) -> None:
        if ts_s is None:
            ts_s = time.perf_counter()
        self._push((_INSTANT, cat, name, ts_s, ts_s, track, args, 0, 0))

    def reset(self) -> None:
        """Clear recorded events and re-zero the export epoch (a bench
        warmup pass must not leak spans into the measured trace)."""
        self._events.clear()
        self.dropped = 0
        self._t0 = time.perf_counter()

    # -- inspection --------------------------------------------------------

    def __len__(self) -> int:
        return len(self._events)

    def categories(self) -> set:
        return {ev[1] for ev in self._events}

    def events(self) -> List[Tuple]:
        return list(self._events)

    def self_times(self) -> Dict[str, Dict[str, float]]:
        """{name: {"count", "total_s", "self_s"}} over the spans opened with
        ``span``: a span's self time is its length less the part of it that
        its children cover."""
        spans = {ev[7]: ev for ev in self._events
                 if ev[0] == _COMPLETE and ev[7]}
        kids: Dict[int, List[Tuple[float, float]]] = {}
        for ev in spans.values():
            if ev[8] in spans:
                kids.setdefault(ev[8], []).append((ev[3], ev[4]))
        out: Dict[str, Dict[str, float]] = {}
        for sid, ev in spans.items():
            start, end = ev[3], ev[4]
            covered, reach = 0.0, start
            for a, b in sorted(kids.get(sid, ())):
                a, b = max(a, reach), min(b, end)
                if b > a:
                    covered += b - a
                    reach = b
            row = out.setdefault(ev[2], {"count": 0, "total_s": 0.0,
                                         "self_s": 0.0})
            row["count"] += 1
            row["total_s"] += end - start
            row["self_s"] += end - start - covered
        return out

    # -- export ------------------------------------------------------------

    def _ts_us(self, t: float) -> float:
        return max(0.0, (t - self._t0) * 1e6)

    def chrome_trace(self) -> Dict[str, Any]:
        """Render the ring as a Chrome trace-event document; a span opened
        with ``span`` carries ``args.id`` and ``args.parent``."""
        tracks: Dict[str, int] = {}
        events: List[Dict[str, Any]] = []
        for ph, cat, name, start, end, track, args, sid, parent in \
                self._events:
            tid = tracks.setdefault(track, len(tracks))
            ev: Dict[str, Any] = {
                "name": name,
                "cat": cat,
                "ph": ph,
                "ts": self._ts_us(start),
                "pid": 0,
                "tid": tid,
            }
            if ph == _COMPLETE:
                ev["dur"] = max(0.0, (end - start) * 1e6)
            else:
                ev["s"] = "t"
            if sid:
                args = dict(args or {}, id=sid, parent=parent)
            if args:
                ev["args"] = dict(args)
            events.append(ev)
        meta = [
            {
                "name": "thread_name",
                "ph": "M",
                "pid": 0,
                "tid": tid,
                "args": {"name": track},
            }
            for track, tid in sorted(tracks.items(), key=lambda kv: kv[1])
        ]
        return {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped},
        }

    def export(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.chrome_trace(), fh)


def validate_chrome_trace(doc: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Check ``doc`` is a well-formed Chrome trace-event document.

    Returns the non-metadata events. Raises ``ValueError`` on malformed
    input — used by tests and by the CI trace-artifact smoke.
    """
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("not a trace-event document: missing traceEvents")
    out = []
    for ev in doc["traceEvents"]:
        if not isinstance(ev, dict):
            raise ValueError("event is not an object")
        for key in ("ph", "pid", "tid"):
            if key not in ev:
                raise ValueError(f"event missing {key!r}")
        if ev["ph"] == "M":
            continue
        for key in ("name", "cat", "ts"):
            if key not in ev:
                raise ValueError(f"event missing {key!r}")
        if ev["ph"] == _COMPLETE and "dur" not in ev:
            raise ValueError("complete event missing dur")
        out.append(ev)
    return out
