"""Ring-buffered trace spans with a Chrome trace-event exporter.

The tracer is a host-side, monotonic-clock (``time.perf_counter``, the
same clock that stamps ``Window.ready_wall``/``done_wall``) event log.
It never runs on the device: callers stamp timestamps around dispatches and
record completed spans after the fact, so a disabled tracer is simply
``None`` and the hot path pays one attribute load + ``is None`` test.

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
dispatch   batch dispatch (wall until the outputs' host copy)
drain      results popped by the supervisor
serve      token serving: admit / prefill / decode / retire
========== =====================================================

Export is Chrome trace-event JSON (the ``{"traceEvents": [...]}`` shape)
so ``Tracer.export(path)`` writes a file that opens directly
in Perfetto / ``chrome://tracing``.
"""
from __future__ import annotations

import json
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["Tracer"]

# Chrome trace-event phases used here: "X" complete span, "i" instant.
_COMPLETE = "X"
_INSTANT = "i"


class Tracer:
    """Bounded in-memory span log. All times are perf_counter seconds."""

    def __init__(self, capacity: int = 1 << 16):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = int(capacity)
        self._events: deque = deque()
        self.dropped = 0
        self._t0 = time.perf_counter()

    # -- recording ---------------------------------------------------------

    def now(self) -> float:
        return time.perf_counter()

    def _push(self, ev: Tuple) -> None:
        if len(self._events) >= self.capacity:
            self._events.popleft()
            self.dropped += 1
        self._events.append(ev)

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
        self._push((_COMPLETE, cat, name, start_s, max(end_s, start_s), track, args))

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
        self._push((_INSTANT, cat, name, ts_s, ts_s, track, args))

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

    # -- export ------------------------------------------------------------

    def _ts_us(self, t: float) -> float:
        return max(0.0, (t - self._t0) * 1e6)

    def chrome_trace(self) -> Dict[str, Any]:
        """Render the ring as a Chrome trace-event document."""
        tracks: Dict[str, int] = {}
        events: List[Dict[str, Any]] = []
        for ph, cat, name, start, end, track, args in self._events:
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
