"""The fleet cells' comparison at a size a CPU run holds: the program's
engine (its plain versions on the CPU) agrees with the plain reference,
the control (the reference in posit8) fails the configuration's limits,
and each fault a fleet cell can have, planted under the timed path, turns
``correct`` false."""
import time

import numpy as np
import pytest
import torch

from portbench.lib import fleet
from portbench.tests import tiny

CPU = torch.device("cpu")


def run_cell(seconds=0.3, **traffic):
    cell = tiny.fleet_cell(**traffic)
    r = tiny.driver(cell.traffic["driver"]).Run(cell, tiny.SEED, CPU)
    r.setup()
    r.window(seconds)
    return r


def test_program_matches_reference_and_control_fails():
    r = run_cell()
    checks = r.check()
    assert tiny.failed(checks) == [], checks
    assert r.answers and r.attempted > 0 and r.failed == 0
    assert checks["windows_unscored"]["value"] == 0
    ctl = r.control()
    lim = r.cfg["limits"]
    assert [k for k in ctl if ctl[k] > lim[k]], ctl
    control = tiny.tool("control")
    assert control.judge({k: c["value"] for k, c in checks.items()}, lim)
    assert not control.judge(ctl, lim)


def _half_batch(monkeypatch):
    """Half of each batch left out, the mean of the rest in its place."""
    from repro_torch.stream.engine import StreamEngine
    real = StreamEngine._fn

    def fn(self, task, fmt, device=None):
        f = real(self, task, fmt, device)

        def half(arrays):
            B = next(iter(arrays.values())).shape[0]
            keep = max(B // 2, 1)
            out = f({k: v[:keep] for k, v in arrays.items()})
            return {k: torch.cat([v, v.to(torch.float32).mean(0, keepdim=True)
                                  .to(v.dtype).expand(B - keep,
                                                      *v.shape[1:])])
                    for k, v in out.items()}
        return half
    monkeypatch.setattr(StreamEngine, "_fn", fn)


def _answer_altered(monkeypatch):
    """One window's probability altered where the forest produces it."""
    from repro_torch.apps import cough, forest
    real = forest.forest_predict

    def altered(ar, f, X):
        p = real(ar, f, X).clone()
        p[0] = 1.0 - p[0]
        return p
    monkeypatch.setattr(cough, "forest_predict", altered)


def _state_unchanged(monkeypatch):
    """The tracker's fold returns its state unchanged: nothing pushed."""
    from repro_torch.apps.bayeslope import RPeakFold
    monkeypatch.setattr(RPeakFold, "push",
                        lambda self, ar, scores, final=False:
                        np.zeros(0, np.int64))


def _window_dropped(monkeypatch):
    """The last window of each pass's results lost on the way out."""
    from repro_torch.stream.engine import StreamEngine
    real = StreamEngine.pop_results
    monkeypatch.setattr(StreamEngine, "pop_results",
                        lambda self: real(self)[:-1])


def _window_repeated(monkeypatch):
    """The first window of each pass's results handed out twice."""
    from repro_torch.stream.engine import StreamEngine
    real = StreamEngine.pop_results

    def twice(self):
        out = real(self)
        return out[:1] + out
    monkeypatch.setattr(StreamEngine, "pop_results", twice)


@pytest.mark.parametrize("fault", [_half_batch, _answer_altered,
                                   _state_unchanged, _window_dropped,
                                   _window_repeated])
def test_fault_turns_correct_false(fault, monkeypatch):
    fault(monkeypatch)
    r = run_cell()
    monkeypatch.undo()
    assert tiny.failed(r.check())


def test_dispatch_groups_follow_completion_stamps():
    assert fleet.dispatch_groups([1.0, 1.0, 2.0, 3.0, 3.0]) == [
        [0, 1], [2], [3, 4]]


def test_unscored_counts_missing_repeated_and_stray_windows():
    import types
    cell = tiny.fleet_cell(patients=2, windows=2)
    r = tiny.driver("fleet_backlog").Run(cell, tiny.SEED, CPU)
    r.rec = types.SimpleNamespace(n_cough=1, n_ecg=1)

    def res(p, w):
        return types.SimpleNamespace(patient=fleet.pid("p0", p, r.rec),
                                     widx=w)
    every = [res(p, w) for p in (0, 1) for w in (0, 1)]
    assert r._unscored("p0", every) == 0
    assert r._unscored("p0", every[1:]) == 1
    assert r._unscored("p0", every + every[:1]) == 1
    assert r._unscored("p0", every + [res(0, 5)]) == 1
    assert r._unscored("p1", every) == 8


class _Window:
    """Stands in for the traced window: keeps the driver's marks and how
    many had come when it closed."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.open, self.marks, self.events = True, [], []
        self.closed_after = None

    def mark(self, name):
        self.marks.append(name)

    def close(self):
        if self.open:
            self.open = False
            self.closed_after = len(self.marks)
            self.closed_at = time.perf_counter()
            self.window_s = self.closed_at - self.t0


@pytest.mark.parametrize("counted", [False, True])
def test_traced_window_closes_only_once_it_holds_each_timed_kernel(
        counted, monkeypatch):
    """Past ``trace_seconds`` the traced pass closes its window at the
    first mark after it holds an FFT and a rounded-matmul call, and
    without them at no earlier point than the pass's end, however long
    the pass takes."""
    from portbench.lib import kernel_counts

    class Seen(kernel_counts.KernelCounts):
        def __enter__(self):
            super().__enter__()
            for k in ("posit_fft_stages", "posit_matmul_round"):
                self.totals[k]["calls"] = 1
            return self

    if counted:
        monkeypatch.setattr(kernel_counts, "KernelCounts", Seen)
    r = run_cell(trace_seconds=0.0)
    tr = _Window()
    r.traced_window(tr)
    if counted:
        assert tr.closed_after == 1
    else:
        assert tr.marks[-1] == "finalize"
        assert tr.closed_after == len(tr.marks)
