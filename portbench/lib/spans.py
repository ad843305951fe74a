"""The program's spans (``repro_torch.obs.trace``) on a traced window's
device clock.

A traced window (``harness.Traced``) takes its host zero ``t0`` just after
its lead spins synchronise, and its device zero ``_origin_us`` is the last
spin's end, so a host time ``s`` (``time.perf_counter``, the spans' clock)
maps to ``_origin_us + (s - t0) * 1e6`` on the profiler's clock.  Only
spans that lie inside the window (from ``t0`` to ``closed_at``) are kept.

A span's device busy time is the union of the device events whose start
lies inside the mapped span.  The spans this is read for
(``stream.dispatch``, ``serve.decode``) end on a host copy of their
outputs, so every kernel they launch has finished inside them.

Nothing here reads a span that the program does not record: where the
tracer dropped spans, or its spans carry no ids (a program without the
span tree), ``map_spans`` gives None and every reader of it nothing.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class Span:
    id: int
    parent: int
    name: str
    start: float                  # host seconds (perf_counter)
    end: float
    args: Dict
    dev_start: float              # device µs
    dev_end: float

    @property
    def dur(self) -> float:
        return self.end - self.start


def union(intervals: Iterable[Tuple[float, float]]) -> float:
    total, reach = 0.0, float("-inf")
    for a, b in sorted(intervals):
        a = max(a, reach)
        if b > a:
            total += b - a
            reach = b
    return total


class Spans:
    """The program's spans inside one traced window, on its device clock."""

    def __init__(self, spans: List[Span], traced):
        self.spans = sorted(spans, key=lambda s: s.start)
        self.by_id = {s.id: s for s in self.spans}
        self.kids: Dict[int, List[Span]] = {}
        for s in self.spans:
            self.kids.setdefault(s.parent, []).append(s)
        self._ev = traced.events
        self._ev_start = [e[1] for e in self._ev]

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def roots(self) -> List[Span]:
        """Spans whose parent is not inside the window."""
        return [s for s in self.spans if s.parent not in self.by_id]

    def children(self, s: Span, names: Sequence[str] = ()) -> List[Span]:
        kids = self.kids.get(s.id, [])
        return [k for k in kids if k.name in names] if names else kids

    def descendants(self, s: Span, name: str) -> List[Span]:
        out, todo = [], list(self.kids.get(s.id, []))
        while todo:
            k = todo.pop()
            if k.name == name:
                out.append(k)
            todo.extend(self.kids.get(k.id, []))
        return out

    def self_s(self, s: Span) -> float:
        """The span's length less what its children cover."""
        return s.dur - union((max(k.start, s.start), min(k.end, s.end))
                              for k in self.kids.get(s.id, []))

    def path(self, s: Span) -> str:
        names = [s.name]
        while s.parent in self.by_id:
            s = self.by_id[s.parent]
            names.append(s.name)
        return "/".join(reversed(names))

    # -- the device side -----------------------------------------------------
    def events_in(self, s: Span) -> List[Tuple]:
        """The device events (name, start µs, dur µs) starting inside the
        mapped span."""
        lo = bisect.bisect_left(self._ev_start, s.dev_start)
        hi = bisect.bisect_right(self._ev_start, s.dev_end)
        return self._ev[lo:hi]

    def busy_s(self, s: Span) -> float:
        return 1e-6 * union((st, st + d) for _, st, d in self.events_in(s))

    def holds_its_events(self, s: Span, margin_us: float = 50.0) -> bool:
        """No device event straddles the mapped start, and each one that
        starts inside ends by the mapped end plus ``margin_us``: the two
        clocks agree on this span."""
        lo = bisect.bisect_left(self._ev_start, s.dev_start)
        if any(st + d > s.dev_start for _, st, d in self._ev[:lo][-64:]):
            return False
        return all(st + d <= s.dev_end + margin_us
                   for _, st, d in self.events_in(s))

    def first_kernel_lag_us(self, s: Span) -> Optional[float]:
        evs = self.events_in(s)
        return evs[0][1] - s.dev_start if evs else None

    def innermost_at(self, t: float) -> Optional[Span]:
        """The innermost span open at host time ``t``: of those holding it,
        the one that opened last, or of two that opened together the one
        that closes first."""
        best = None
        for s in self.spans:
            if s.start > t:
                break
            if s.end > t and (best is None or (s.start, -s.end)
                              >= (best.start, -best.end)):
                best = s
        return best


def map_spans(tracer, traced) -> Optional[Spans]:
    """The tracer's spans inside ``traced``'s window, on its device clock;
    None where the tracer dropped spans, the window recorded no lead spin,
    or no span carries an id."""
    if tracer is None or tracer.dropped or traced is None \
            or getattr(traced, "_origin_us", None) is None:
        return None
    t0, t1, origin = traced.t0, traced.closed_at, traced._origin_us
    spans = []
    for ev in tracer.events():
        if ev[0] != "X" or len(ev) < 9 or not ev[7]:
            continue
        start, end = ev[3], ev[4]
        if start < t0 or end > t1:
            continue
        spans.append(Span(ev[7], ev[8], ev[2], start, end, ev[6] or {},
                          origin + (start - t0) * 1e6,
                          origin + (end - t0) * 1e6))
    return Spans(spans, traced) if spans else None


def name_gaps(traced, spans: Optional[Spans], top: int = 10) -> List:
    """The longest gaps with no device operation, each named by the
    innermost program span open at its start (its path, ``/``-joined), or
    where no span covers it by the driver's last mark before it."""
    if not traced.events or traced._origin_us is None:
        return []
    gaps, end = [], traced.events[0][1]
    for _, s, d in traced.events:
        if s > end:
            gaps.append((end, s))
        end = max(end, s + d)
    out = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        at = (a - traced._origin_us) * 1e-6
        inner = spans.innermost_at(traced.t0 + at) if spans else None
        if inner is not None:
            name = spans.path(inner)
        else:
            name = "window"
            for m, t in traced.marks:
                if t <= at:
                    name = m
        out.append([name, (b - a) * 1e-6])
    return out


def mean(xs: Sequence[float]) -> Optional[float]:
    return sum(xs) / len(xs) if xs else None
