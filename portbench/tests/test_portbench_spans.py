"""The program's spans on a traced window's device clock
(``portbench/lib/spans.py``) and the readers of the span metrics, on a
synthetic ``Traced`` with planted spans and device events: the clock
mapping, spans cut at the window's close, nothing read where the tracer
dropped spans or its spans carry no ids, and the idle gaps named by the
innermost span open at their start or else by the driver's mark."""
import time

import pytest
import torch

from portbench.lib import harness, spans
from portbench.tests import tiny
from repro_torch.obs import Tracer
from repro_torch.obs import trace as obs_trace

ORIGIN_US = 5_000_000.0
T0 = 100.0


def _traced(events, marks=(), window_s=1.0):
    """A closed ``Traced`` whose host zero is ``T0`` and device zero
    ``ORIGIN_US``; ``events`` (name, start µs, dur µs) relative to it."""
    tr = harness.Traced()
    tr.t0, tr.closed_at, tr.window_s = T0, T0 + window_s, window_s
    tr._origin_us = ORIGIN_US
    tr.spins = 64
    tr.events = sorted(((n, ORIGIN_US + s, d) for n, s, d in events),
                       key=lambda r: r[1])
    tr.marks = list(marks)
    return tr


class _Plant:
    """Open spans at planted host times: ``at(name, a, b)`` is a ``with``
    over [T0 + a ms, T0 + b ms]."""

    def __init__(self, capacity=1 << 12):
        self.tracer = Tracer(capacity=capacity)

    def at(self, name, a_ms, b_ms, **args):
        plant = self

        class _At:
            def __enter__(self):
                with obs_trace.use(plant.tracer):
                    self.sp = obs_trace.span("t", name, **args)
                    self.sp.__enter__()
                self.sp.at(T0 + a_ms * 1e-3, T0 + b_ms * 1e-3)
                return self.sp

            def __exit__(self, *exc):
                self.sp.__exit__(*exc)
                return False

        return _At()


def _fleet_plant():
    p = _Plant()
    with p.at("stream.ingest", 10, 30):
        with p.at("stream.pump", 12, 29):
            with p.at("stream.stage", 12, 13):
                pass
            with p.at("stream.dispatch", 13, 20, B=4):
                with p.at("cough.fft", 14, 15):
                    pass
            with p.at("stream.track", 20, 24, patient="e", widx=0):
                with p.at("rpeak.threshold", 20, 23):
                    pass
            with p.at("stream.track", 24, 29, patient="e", widx=1):
                pass
    with p.at("stream.ingest", 40, 42):
        pass
    with p.at("stream.pump", 50, 60):
        with p.at("stream.dispatch", 51, 58, B=2):
            pass
    # past the window's close (1 s): dropped from every reading
    with p.at("stream.dispatch", 990, 1010, B=100):
        pass
    return p.tracer


FLEET_EVENTS = [("k", 13_200, 1_000), ("k", 13_900, 2_000),
                ("k", 20_500, 100),                   # the tracker's 2-means
                ("k", 51_100, 3_000), ("k", 57_500, 400)]


def test_spans_map_onto_the_device_clock_and_are_cut_at_the_close():
    sp = spans.map_spans(_fleet_plant(), _traced(FLEET_EVENTS))
    disp = sp.named("stream.dispatch")
    assert [s.args["B"] for s in disp] == [4, 2]
    assert disp[0].dev_start == pytest.approx(ORIGIN_US + 13_000)
    assert disp[0].dev_end == pytest.approx(ORIGIN_US + 20_000)
    # merged device events starting inside: [13.2, 15.9] ms
    assert sp.busy_s(disp[0]) == pytest.approx(2.7e-3)
    assert sp.busy_s(disp[1]) == pytest.approx(3.4e-3)
    assert sp.first_kernel_lag_us(disp[0]) == pytest.approx(200.0)
    assert all(sp.holds_its_events(s) for s in disp)
    assert sp.path(sp.named("cough.fft")[0]) == \
        "stream.ingest/stream.pump/stream.dispatch/cough.fft"
    assert {s.name for s in sp.roots()} == {"stream.ingest", "stream.pump"}


def test_a_span_before_the_window_opened_is_left_out():
    p = _Plant()
    with p.at("stream.ingest", -5, 3):
        pass
    with p.at("stream.ingest", 3, 4):
        pass
    sp = spans.map_spans(p.tracer, _traced([]))
    assert [s.start for s in sp.named("stream.ingest")] == \
        [pytest.approx(T0 + 3e-3)]


def test_clock_disagreement_is_seen():
    sp = spans.map_spans(_fleet_plant(), _traced(
        FLEET_EVENTS + [("late", 19_900, 200)]))
    assert not sp.holds_its_events(sp.named("stream.dispatch")[0])
    sp = spans.map_spans(_fleet_plant(), _traced(
        [("early", 12_500, 1_000)] + FLEET_EVENTS))
    assert not sp.holds_its_events(sp.named("stream.dispatch")[0])


def test_fleet_readers():
    tr = _traced(FLEET_EVENTS)
    ctx = {"traced": tr, "spans": spans.map_spans(_fleet_plant(), tr)}
    read = {m: harness.Cell.reader(_CELL, m).read(ctx) for m in (
        "track_ms.backlog", "ingest_ms.backlog", "dispatch_busy_ms.backlog")}
    assert read["track_ms.backlog"] == pytest.approx(4.5)
    # ingest self time: (20 - 17) + 2 ms over 6 windows
    assert read["ingest_ms.backlog"] == pytest.approx(5.0 / 6)
    assert read["dispatch_busy_ms.backlog"] == pytest.approx((2.7 + 3.4) / 2)


def _serve_plant():
    p = _Plant()
    for k, t in enumerate((0, 200)):
        with p.at("serve.step", t, t + 100):
            if k == 0:
                with p.at("serve.admit", t + 1, t + 41):
                    with p.at("serve.prefill", t + 2, t + 40):
                        with p.at("model.moe", t + 10, t + 20):
                            pass
            with p.at("serve.decode", t + 42, t + 90, rows=4):
                with p.at("model.moe", t + 50, t + 60):
                    with p.at("moe.experts", t + 51, t + 59):
                        pass
                with p.at("model.moe", t + 70, t + 76):
                    pass
            with p.at("serve.account", t + 90, t + 97):
                pass
    return p.tracer


def test_serve_readers():
    tr = _traced([("k", 43_000, 10_000), ("k", 50_000, 6_000),
                  ("k", 243_000, 2_000)])
    ctx = {"traced": tr, "spans": spans.map_spans(_serve_plant(), tr)}
    read = {m: harness.Cell.reader(_CELL, m).read(ctx) for m in (
        "decode_busy_ms.serve", "moe_ms.serve", "step_overhead_ms.serve")}
    assert read["decode_busy_ms.serve"] == pytest.approx((13 + 2) / 2)
    # the prefill's MoE block is not the decode's
    assert read["moe_ms.serve"] == pytest.approx(16.0)
    assert read["step_overhead_ms.serve"] == pytest.approx((12 + 52) / 2)


def test_nothing_is_read_from_dropped_or_id_less_spans():
    tr = _traced(FLEET_EVENTS)
    small = Tracer(capacity=4)
    with obs_trace.use(small):
        for _ in range(6):
            with obs_trace.span("t", "stream.track"):
                pass
    assert small.dropped and spans.map_spans(small, tr) is None
    # a program whose spans carry no ids: ``complete`` alone
    flat = Tracer()
    flat.complete("dispatch", "cough/posit16", T0 + 0.013, T0 + 0.020)
    assert spans.map_spans(flat, tr) is None
    for m in ("track_ms.backlog", "ingest_ms.backlog",
              "dispatch_busy_ms.backlog", "decode_busy_ms.serve",
              "moe_ms.serve", "step_overhead_ms.serve"):
        assert harness.Cell.reader(_CELL, m).read(
            {"traced": tr, "spans": None}) is None
        assert harness.Cell.reader(_CELL, m).read({}) is None


def test_gaps_are_named_by_the_innermost_span_or_else_the_mark():
    tr = _traced(FLEET_EVENTS + [("k", 0, 100), ("k", 35_000, 100),
                                 ("k", 900_000, 10)],
                 marks=[("ingest", 0.0), ("drain", 0.034)])
    sp = spans.map_spans(_fleet_plant(), tr)
    gaps = dict((round(d * 1e3, 3), n)
                for n, d in spans.name_gaps(tr, sp, top=20))
    # 15.9 → 20.5 ms opens inside the dispatch, after its last kernel
    assert gaps[4.6] == "stream.ingest/stream.pump/stream.dispatch"
    # 0.1 → 13.2 ms: the first ingest opens at 10 ms, so the gap's start
    # lies in no span: the driver's mark names it
    assert gaps[13.1] == "ingest"
    # 20.6 → 35 ms opens inside the tracker's 2-means
    assert gaps[14.4] == ("stream.ingest/stream.pump/stream.track/"
                          "rpeak.threshold")
    # 35.1 → 51.1 ms: between spans, after the drain mark
    assert gaps[16.0] == "drain"
    # the harness's own naming of the same window reads marks alone
    assert {n for n, _ in tr.idle_gaps(top=20)} <= {"ingest", "drain"}


_CELL = harness.Cell("fleet-backlog", harness.benchmark())


class _HostWindow:
    """Stands in for ``harness.Traced`` on the CPU: the host clock, the
    driver's marks, no device event."""

    def __init__(self):
        self.events, self.marks, self.spins = [], [], 0
        self._origin_us, self.open = 0.0, False

    def __enter__(self):
        self.t0, self.open = time.perf_counter(), True
        return self

    def mark(self, name):
        self.marks.append((name, time.perf_counter() - self.t0))

    def close(self):
        if self.open:
            self.open = False
            self.closed_at = time.perf_counter()
            self.window_s = self.closed_at - self.t0

    def __exit__(self, *exc):
        self.close()
        return False

    def busy_s(self):
        return 0.0

    def idle_gaps(self):
        return []


@pytest.mark.parametrize("kind", ["fleet", "serve"])
def test_span_tool_reads_a_tiny_cell(kind, monkeypatch):
    monkeypatch.setattr(harness, "Traced", _HostWindow)
    cell = (tiny.fleet_cell(trace_seconds=0.0) if kind == "fleet"
            else tiny.serve_cell(trace_steps=4))
    row = tiny.tool("spans").measure(cell, tiny.SEED, torch.device("cpu"),
                                     cost_rounds=1)
    assert [len(v) for v in row["cost"].values()] == [1, 1]
    assert row["dropped"] == 0 and row["spans"] > 0
    m = row["metrics"]
    if kind == "fleet":
        assert m["track_ms.backlog"] > 0 and m["ingest_ms.backlog"] > 0
        assert m["dispatch_busy_ms.backlog"] == 0.0      # no device here
        assert 0.5 < row["roots_cover"] <= 1.0
        assert row["windows"] > 0
    else:
        assert m["moe_ms.serve"] > 0 and m["step_overhead_ms.serve"] > 0
        assert m["decode_busy_ms.serve"] == 0.0
        assert 0.5 < row["step_cover_min"] <= 1.0
    assert row["gaps_by_span"] == []
