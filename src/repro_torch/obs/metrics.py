"""Process-local metrics registry with a Prometheus text renderer.

Three instrument kinds, all labeled:

- ``Counter`` — monotonic totals (``inc``).
- ``Gauge``   — last-written values (``set``); bridges set these from the
  ledgers at collect time, so scraped values reconcile *exactly* with
  ``EnergyLedger.summary()`` / ``TokenLedger.summary()`` — same floats,
  no second accounting path.
- ``Histogram`` — a bounded raw-sample reservoir per label set.
  Percentiles are computed from raw samples at render/merge time, never
  stored: merging two snapshots concatenates samples and recomputes,
  the same never-average-percentiles rule as ``aggregate_rollup``.

``MetricsRegistry`` is the process-local container. ``NULL_METRICS`` is
a shared no-op registry: every instrument method is a no-op, collectors
are discarded, and render/snapshot return empty — the disabled fast
path asserted by the bench's paired obs A/B.

Snapshots (``registry.snapshot()``) are JSON-able and mergeable across
worker processes via ``merge_snapshots`` (counters/gauges sum, histogram
reservoirs concatenate); ``render_prometheus`` emits the text exposition
format and ``parse_prometheus`` reads it back (tests, CI smoke).
"""
from __future__ import annotations

import math
import threading
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NullRegistry",
    "NULL_METRICS",
    "merge_snapshots",
    "render_snapshot_prometheus",
    "parse_prometheus",
    "percentiles",
]

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def percentiles(samples: Sequence[float], pcts: Sequence[float] = (50.0, 90.0, 99.0)) -> Dict[str, float]:
    """Nearest-rank-style percentiles over raw samples (numpy-free)."""
    out: Dict[str, float] = {}
    if not samples:
        return {f"p{int(p) if float(p).is_integer() else p}": 0.0 for p in pcts}
    xs = sorted(float(s) for s in samples)
    n = len(xs)
    for p in pcts:
        # linear interpolation between closest ranks (matches numpy default)
        rank = (p / 100.0) * (n - 1)
        lo = int(math.floor(rank))
        hi = min(lo + 1, n - 1)
        frac = rank - lo
        val = xs[lo] * (1.0 - frac) + xs[hi] * frac
        key = f"p{int(p) if float(p).is_integer() else p}"
        out[key] = val
    return out


class _Instrument:
    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help

    def series(self) -> List[Tuple[LabelKey, Any]]:  # pragma: no cover - abstract
        raise NotImplementedError


class Counter(_Instrument):
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._values: Dict[LabelKey, float] = {}

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        key = _label_key(labels)
        self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: Any) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def total(self) -> float:
        return sum(self._values.values())

    def items(self) -> List[Tuple[Dict[str, str], float]]:
        return [(dict(k), v) for k, v in sorted(self._values.items())]

    def series(self) -> List[Tuple[LabelKey, float]]:
        return sorted(self._values.items())

    def reset(self) -> None:
        self._values.clear()


class Gauge(Counter):
    kind = "gauge"

    def set(self, value: float, **labels: Any) -> None:
        self._values[_label_key(labels)] = float(value)


class Histogram(_Instrument):
    """Raw-sample reservoir (bounded deque) per label set.

    ``count`` and ``sum`` cover every observation, but the percentiles
    are of the last ``reservoir`` samples only (512 by default): an early
    burst falls out of them, so no tail over a whole run is read here."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", reservoir: int = 512):
        super().__init__(name, help)
        self.reservoir = int(reservoir)
        self._series: Dict[LabelKey, Dict[str, Any]] = {}

    def _bucket(self, key: LabelKey) -> Dict[str, Any]:
        b = self._series.get(key)
        if b is None:
            b = {"count": 0, "sum": 0.0, "samples": deque(maxlen=self.reservoir)}
            self._series[key] = b
        return b

    def observe(self, value: float, **labels: Any) -> None:
        b = self._bucket(_label_key(labels))
        b["count"] += 1
        b["sum"] += float(value)
        b["samples"].append(float(value))

    def samples(self, **labels: Any) -> List[float]:
        """Raw samples for one label set — or concatenated across all."""
        if labels:
            b = self._series.get(_label_key(labels))
            return list(b["samples"]) if b else []
        out: List[float] = []
        for _, b in sorted(self._series.items()):
            out.extend(b["samples"])
        return out

    def count(self, **labels: Any) -> int:
        if labels:
            b = self._series.get(_label_key(labels))
            return int(b["count"]) if b else 0
        return sum(int(b["count"]) for b in self._series.values())

    def items(self) -> List[Tuple[Dict[str, str], Dict[str, Any]]]:
        return [
            (dict(k), {"count": b["count"], "sum": b["sum"], "samples": list(b["samples"])})
            for k, b in sorted(self._series.items())
        ]

    def series(self) -> List[Tuple[LabelKey, Dict[str, Any]]]:
        return sorted(self._series.items())

    def reset(self) -> None:
        self._series.clear()


class _NullInstrument:
    """Accepts every instrument method as a no-op."""

    def inc(self, *a: Any, **k: Any) -> None:
        pass

    def set(self, *a: Any, **k: Any) -> None:
        pass

    def observe(self, *a: Any, **k: Any) -> None:
        pass

    def value(self, **k: Any) -> float:
        return 0.0

    def total(self) -> float:
        return 0.0

    def samples(self, **k: Any) -> List[float]:
        return []

    def count(self, **k: Any) -> int:
        return 0

    def items(self) -> list:
        return []


_NULL_INSTRUMENT = _NullInstrument()


class MetricsRegistry:
    """Named instruments + collector callbacks, one per process/engine."""

    enabled = True

    def __init__(self):
        self._metrics: Dict[str, _Instrument] = {}
        self._collectors: List[Callable[[], None]] = []
        self._lock = threading.Lock()
        self._collecting = False

    # -- instrument factories (idempotent by name) -------------------------

    def _get(self, cls, name: str, help: str, **kwargs: Any):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, **kwargs)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, wanted {cls.kind}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        m = self._get(Counter, name, help)
        if isinstance(m, Gauge):  # Gauge subclasses Counter; keep kinds distinct
            raise TypeError(f"metric {name!r} already registered as gauge")
        return m

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "", reservoir: int = 512) -> Histogram:
        return self._get(Histogram, name, help, reservoir=reservoir)

    def get(self, name: str) -> Optional[_Instrument]:
        return self._metrics.get(name)

    # -- collectors --------------------------------------------------------

    def register_collector(self, fn: Callable[[], None]) -> None:
        """``fn()`` runs before every render/snapshot; it sets gauges."""
        self._collectors.append(fn)

    def collect(self) -> None:
        if self._collecting:  # a collector asked for a render: don't recurse
            return
        self._collecting = True
        try:
            for fn in self._collectors:
                fn()
        finally:
            self._collecting = False

    # -- lifecycle ---------------------------------------------------------

    def reset(self) -> None:
        """Clear all values (registrations and collectors survive)."""
        for m in self._metrics.values():
            m.reset()

    # -- export ------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able dump carrying raw histogram samples (mergeable)."""
        self.collect()
        out: Dict[str, Any] = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, m in sorted(self._metrics.items()):
            if isinstance(m, Histogram):
                out["histograms"][name] = {
                    "help": m.help,
                    "reservoir": m.reservoir,
                    "series": [
                        [list(map(list, k)), {"count": b["count"], "sum": b["sum"],
                                              "samples": list(b["samples"])}]
                        for k, b in m.series()
                    ],
                }
            else:
                section = "gauges" if isinstance(m, Gauge) else "counters"
                out[section][name] = {
                    "help": m.help,
                    "series": [[list(map(list, k)), v] for k, v in m.series()],
                }
        return out

    def render_prometheus(self) -> str:
        self.collect()
        return render_snapshot_prometheus(self.snapshot())


class NullRegistry:
    """Disabled registry: every call is a no-op, costs ~zero."""

    enabled = False

    def counter(self, name: str, help: str = "") -> _NullInstrument:
        return _NULL_INSTRUMENT

    def gauge(self, name: str, help: str = "") -> _NullInstrument:
        return _NULL_INSTRUMENT

    def histogram(self, name: str, help: str = "", reservoir: int = 512) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def get(self, name: str) -> None:
        return None

    def register_collector(self, fn: Callable[[], None]) -> None:
        pass

    def collect(self) -> None:
        pass

    def reset(self) -> None:
        pass

    def snapshot(self) -> Dict[str, Any]:
        return {"counters": {}, "gauges": {}, "histograms": {}}

    def render_prometheus(self) -> str:
        return ""


NULL_METRICS = NullRegistry()


# -- text exposition --------------------------------------------------------


def _escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(pairs: Iterable[Tuple[str, str]], extra: Iterable[Tuple[str, str]] = ()) -> str:
    items = [*pairs, *extra]
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape(str(v))}"' for k, v in items)
    return "{" + body + "}"


def _fmt_value(v: float) -> str:
    # repr round-trips floats exactly; scraped values reconcile bit-for-bit
    return repr(float(v))


def render_snapshot_prometheus(snap: Dict[str, Any]) -> str:
    """Render a snapshot (live or merged) as Prometheus text exposition.

    Histograms render as Prometheus *summaries* — quantile labels computed
    from the raw reservoir at render time, plus ``_count``/``_sum``.
    """
    lines: List[str] = []
    for section, ptype in (("counters", "counter"), ("gauges", "gauge")):
        for name, entry in sorted(snap.get(section, {}).items()):
            if entry.get("help"):
                lines.append(f"# HELP {name} {entry['help']}")
            lines.append(f"# TYPE {name} {ptype}")
            for pairs, value in entry["series"]:
                lines.append(f"{name}{_fmt_labels(pairs)} {_fmt_value(value)}")
    for name, entry in sorted(snap.get("histograms", {}).items()):
        if entry.get("help"):
            lines.append(f"# HELP {name} {entry['help']}")
        lines.append(f"# TYPE {name} summary")
        for pairs, b in entry["series"]:
            pcts = percentiles(b["samples"])
            for q, key in (("0.5", "p50"), ("0.9", "p90"), ("0.99", "p99")):
                lines.append(
                    f"{name}{_fmt_labels(pairs, [('quantile', q)])} {_fmt_value(pcts[key])}"
                )
            lines.append(f"{name}_count{_fmt_labels(pairs)} {_fmt_value(b['count'])}")
            lines.append(f"{name}_sum{_fmt_labels(pairs)} {_fmt_value(b['sum'])}")
    return "\n".join(lines) + ("\n" if lines else "")


def parse_prometheus(text: str) -> Dict[Tuple[str, LabelKey], float]:
    """Parse text exposition back to ``{(name, labelkey): value}``.

    Minimal by design (no multiline label values) — enough to round-trip
    what ``render_snapshot_prometheus`` emits; used by tests and CI.
    """
    out: Dict[Tuple[str, LabelKey], float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if "{" in line:
            name, rest = line.split("{", 1)
            body, tail = rest.rsplit("}", 1)
            labels: List[Tuple[str, str]] = []
            # split on commas outside quotes
            item = ""
            depth = False
            for ch in body:
                if ch == '"':
                    depth = not depth
                if ch == "," and not depth:
                    if item:
                        k, v = item.split("=", 1)
                        labels.append((k, v.strip('"').replace('\\"', '"').replace("\\\\", "\\")))
                    item = ""
                else:
                    item += ch
            if item:
                k, v = item.split("=", 1)
                labels.append((k, v.strip('"').replace('\\"', '"').replace("\\\\", "\\")))
            value = float(tail.strip())
            out[(name, tuple(sorted(labels)))] = value
        else:
            name, value = line.rsplit(None, 1)
            out[(name, ())] = float(value)
    return out


# -- cross-process merge ----------------------------------------------------


def merge_snapshots(snaps: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge per-worker snapshots: counters/gauges sum, reservoirs concat.

    Gauges here are totals bridged from per-worker ledgers, so summing is
    the fleet aggregation; percentile-bearing data only ever travels as
    raw histogram samples, never as precomputed quantiles.
    """
    out: Dict[str, Any] = {"counters": {}, "gauges": {}, "histograms": {}}
    for snap in snaps:
        if not snap:
            continue
        for section in ("counters", "gauges"):
            for name, entry in snap.get(section, {}).items():
                dst = out[section].setdefault(name, {"help": entry.get("help", ""), "series": []})
                acc = {tuple(tuple(p) for p in k): v for k, v in
                       ((tuple(map(tuple, k)), v) for k, v in dst["series"])}
                for pairs, value in entry["series"]:
                    key = tuple(map(tuple, pairs))
                    acc[key] = acc.get(key, 0.0) + value
                dst["series"] = [[list(map(list, k)), v] for k, v in sorted(acc.items())]
        for name, entry in snap.get("histograms", {}).items():
            dst = out["histograms"].setdefault(
                name, {"help": entry.get("help", ""), "reservoir": entry.get("reservoir", 512),
                       "series": []})
            acc = {tuple(map(tuple, k)): b for k, b in
                   ((tuple(map(tuple, k)), b) for k, b in dst["series"])}
            for pairs, b in entry["series"]:
                key = tuple(map(tuple, pairs))
                cur = acc.get(key)
                if cur is None:
                    acc[key] = {"count": b["count"], "sum": b["sum"], "samples": list(b["samples"])}
                else:
                    cur["count"] += b["count"]
                    cur["sum"] += b["sum"]
                    cur["samples"] = list(cur["samples"]) + list(b["samples"])
            dst["series"] = [[list(map(list, k)), b] for k, b in sorted(acc.items())]
    return out
