"""The benchmark's general machinery: finding a cell's files by name,
the statistics every metric uses, the traced window, and the guard that
no JAX module reached the process.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric lives in a file of its own, found by the names in
``BENCHMARK.json``:

* ``portbench/configs/<config>.json``: the configuration as it is run;
* ``portbench/workloads/<cell>.json``: the cell's traffic parameters and
  the driver (``portbench/traffic/<driver>.py``) that runs them;
* ``portbench/metrics/<metric>.py``: a reader of one per-layer metric,
  ``read(ctx) -> float | None`` (None: nothing to read in this run).

So a later change adds a cell, a mix or a metric by adding files.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict:
    return load_json(root / "BENCHMARK.json")


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of ``BENCHMARK.json``'s ``workloads``, with its files."""

    def __init__(self, name: str, bench: Dict, root: Path = ROOT):
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(entries)})")
        self.name = name
        self.entry = entries[name]
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = load_json(root / self.config_entry["file"])
        self.traffic = load_json(root / "portbench" / "workloads"
                                 / f"{name}.json")
        if self.traffic["config"] != self.entry["config"] or \
                self.traffic["traffic"] != self.entry["traffic"]:
            raise ValueError(f"portbench/workloads/{name}.json names "
                             f"{self.traffic['config']}/"
                             f"{self.traffic['traffic']}, BENCHMARK.json "
                             f"{self.entry['config']}/"
                             f"{self.entry['traffic']}")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]
        self.root = root

    def driver(self):
        kind = self.traffic["driver"]
        return _load_module(self.root / "portbench" / "traffic"
                            / f"{kind}.py", f"portbench_traffic_{kind}")

    def reader(self, metric: str):
        path = self.root / "portbench" / "metrics" / f"{metric}.py"
        return _load_module(path, "portbench_metric_"
                            + metric.replace(".", "_").replace("-", "_"))


# ---------------------------------------------------------------------------
# Statistics
# ---------------------------------------------------------------------------

def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile of every sample (linear between order
    statistics, numpy's default); NaN for no samples."""
    xs = sorted(values)
    if not xs:
        return float("nan")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


# ---------------------------------------------------------------------------
# The traced window
# ---------------------------------------------------------------------------

LEAD_PAUSE_S = 0.1
LEAD_SPINS = 64
LEAD_CYCLES = 20_000


class Traced:
    """A window under ``torch.profiler`` (device activity only, so the
    host's overhead stays small): opened by a host pause and spin kernels
    (``torch.cuda._sleep``), so that the events the profiler drops at a
    window's start fall among the spins.  After ``__exit__``: ``events``
    (name, start_us, dur_us) of every device kernel, copy and fill but
    the spins, ``spins`` recorded, ``window_s`` the traced span on the
    host clock, and ``marks``: (name, host seconds since the window
    opened) stamped by the driver with ``mark``."""

    def __init__(self):
        self.events: List = []
        self.spins = 0
        self.marks: List = []
        self._prof = None
        self._origin_us = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        time.sleep(LEAD_PAUSE_S)
        for _ in range(LEAD_SPINS):
            torch.cuda._sleep(LEAD_CYCLES)
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        return self

    def mark(self, name: str) -> None:
        self.marks.append((name, time.perf_counter() - self.t0))

    @property
    def open(self) -> bool:
        return self._prof is not None

    def close(self) -> None:
        """End the traced window now (the driver may go on untraced)."""
        if self._prof is None:
            return
        import torch
        from torch.autograd import DeviceType
        torch.cuda.synchronize()
        self.closed_at = time.perf_counter()
        self.window_s = self.closed_at - self.t0
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        evs, spin_end = [], None
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            if "spin_kernel" in e.name:
                self.spins += 1
                spin_end = max(spin_end or 0, e.time_range.end)
                continue
            evs.append((e.name, e.time_range.start,
                        e.time_range.end - e.time_range.start))
        evs.sort(key=lambda r: r[1])
        self.events = evs
        self._origin_us = spin_end

    def __exit__(self, *exc):
        if exc[0] is not None and self._prof is not None:
            self._prof.__exit__(*exc)
            self._prof = None
            return False
        self.close()
        return False

    # -- readings ------------------------------------------------------------
    def busy_s(self) -> float:
        """Seconds in which some device operation ran (overlaps merged)."""
        busy, end = 0.0, -math.inf
        for _, s, d in self.events:
            e = s + d
            if e <= end:
                continue
            busy += e - max(s, end)
            end = e
        return busy * 1e-6

    def kernel(self, names: Iterable[str]) -> Dict[str, float]:
        """Device seconds and recorded launches of the kernels whose names
        contain one of ``names``."""
        names = tuple(names)
        hit = [(n, d) for n, _, d in self.events
               if any(k in n for k in names)]
        return {"seconds": sum(d for _, d in hit) * 1e-6,
                "count": len(hit)}

    def device_ops(self, top: int = 10) -> List:
        tot: Dict[str, float] = {}
        for n, _, d in self.events:
            tot[n] = tot.get(n, 0.0) + d * 1e-6
        rows = sorted(tot.items(), key=lambda r: -r[1])[:top]
        return [[n[:120], s] for n, s in rows]

    def idle_gaps(self, top: int = 10) -> List:
        """The longest gaps with no device operation, each named by the
        driver's last mark before it (what the host was doing)."""
        if not self.events or self._origin_us is None:
            return []
        gaps, end = [], self.events[0][1]
        for _, s, d in self.events:
            if s > end:
                gaps.append((end, s))
            end = max(end, s + d)
        # the device clock's zero: the window opened when the spins ended
        out = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
            at = (a - self._origin_us) * 1e-6
            name = "window"
            for m, t in self.marks:
                if t <= at:
                    name = m
            out.append([name, (b - a) * 1e-6])
        return out


# ---------------------------------------------------------------------------
# Guards
# ---------------------------------------------------------------------------

def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that are JAX's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def device_info(chips: int) -> Dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips))}


def finite(x: Optional[float]) -> bool:
    return x is not None and math.isfinite(x)
