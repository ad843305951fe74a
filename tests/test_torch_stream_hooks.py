"""The port's stream-engine hooks for the ingest layer, on the CPU:
``pending_windows``, ``release_patient``, ``evict_patient`` (its delivered
prefix scored as the offline detector scores it, its counts equal to the
reference engine's, and a failing flush contained) and ``reset`` (built
callables and an ``"auto"`` pad decision kept, metric values cleared).
"""
import numpy as np
import pytest

from repro_torch.apps.bayeslope import detect_rpeaks
from repro_torch.core.arith import Arith
from repro_torch.data.biosignals import ecg_stream_signal, ragged_chunks
from repro_torch.stream import StreamEngine, rpeak_pipeline

W = 500  # samples per 2 s R-peak window


def _engine(**kw):
    return StreamEngine({"rpeak": rpeak_pipeline()}, device="cpu", **kw)


def _feed(eng, patient, sig, seed=0):
    for c in ragged_chunks(sig[None, :], np.random.default_rng(seed), 60,
                           400):
        eng.ingest(patient, "rpeak", "ecg", c)


def test_pending_windows_counts_ready_undispatched_windows():
    eng = _engine(max_batch=8)
    assert eng.pending_windows() == 0
    sig, _ = ecg_stream_signal(7.0, seed=1)    # 3 whole windows + a tail
    _feed(eng, "p", sig)
    assert eng.pending_windows() == 3
    assert eng.pump() == 3
    assert eng.pending_windows() == 0
    assert len(eng.pop_results()) == 3


def test_release_patient_frees_dispatcher_and_refuses_ingest():
    eng = _engine(max_batch=2)
    sig, _ = ecg_stream_signal(5.3, seed=2)
    _feed(eng, "p", sig)
    eng.drain()
    peaks = list(eng.tracker_for("p", "rpeak").peaks)
    # one modality: a window is staged whole or not at all, so nothing
    # partial is left to free (a cough stream's half-staged windows are
    # freed in tests/test_torch_ingest.py)
    assert eng.release_patient("p", "rpeak") == (0, 0)
    with pytest.raises(KeyError, match="closed"):
        eng.ingest("p", "rpeak", "ecg", np.zeros((1, 8)))
    with pytest.raises(KeyError):
        eng.register_patient("p", "rpeak")
    assert eng.tracker_for("p", "rpeak").peaks == peaks    # history kept
    assert len(eng.results_for("p", "rpeak")) == 2


@pytest.mark.parametrize("seconds,fmt", [(6.6, "posit10"), (9.1, "posit8"),
                                         (1.2, "posit10")])
def test_evict_patient_scores_the_delivered_prefix(seconds, fmt):
    from repro.stream import StreamEngine as JEngine
    from repro.stream import rpeak_pipeline as jrpeak
    sig, _ = ecg_stream_signal(seconds, seed=5)
    stats = {}
    peaks = {}
    for name, eng in (("port", _engine(max_batch=2)),
                      ("ref", JEngine({"rpeak": jrpeak()}, max_batch=2))):
        eng.register_patient("p", "rpeak", fmt=fmt)
        _feed(eng, "p", sig)
        stats[name] = eng.evict_patient("p", "rpeak")
        tr = eng.tracker_for("p", "rpeak")
        peaks[name] = tr.peaks if tr is not None else []
        with pytest.raises(KeyError):
            eng.ingest("p", "rpeak", "ecg", np.zeros((1, 8)))
        assert eng.pending_windows() == 0
    n = (len(sig) // W) * W
    assert peaks["port"] == peaks["ref"] == (
        detect_rpeaks(Arith.make(fmt), sig[:n], device="cpu") if n else [])
    assert stats["port"] == stats["ref"]
    assert stats["port"]["windows_dropped"] == 0


def test_evict_patient_never_raises_and_counts_the_lost_windows():
    eng = _engine(max_batch=64)
    eng.register_patient("p", "rpeak", fmt="no-such-format")
    eng.ingest("p", "rpeak", "ecg", np.zeros((1, 1500)))
    assert eng.pending_windows() == 3
    got = eng.evict_patient("p", "rpeak")
    assert got["windows_flushed"] == 0 and got["windows_dropped"] == 3
    assert eng.pending_windows() == 0


def test_reset_keeps_callables_and_pad_decision_clears_values():
    eng = _engine(max_batch=4, pad_policy="auto", autotune_horizon=4)
    programs = eng.metrics.counter("jit_programs_total")
    hits = eng.metrics.counter("jit_cache_hits_total")
    for k in range(6):
        sig, _ = ecg_stream_signal(2.0, seed=k)
        eng.ingest(f"p{k}", "rpeak", "ecg", sig[None, :])
        eng.pump()                             # singles: 75 % padding
    assert eng.pad_strategy() == "pow2"
    # one callable per (task, fmt, fusion key), whatever the batch shape
    assert programs.total() == 1 and hits.total() == 5
    eng.evict_patient("p0", "rpeak")
    eng.reset()
    assert eng.pad_strategy() == "pow2"        # the decision survives
    assert programs.total() == 0 and hits.total() == 0
    assert eng.ledger.summary()["fleet"]["windows"] == 0
    assert eng.results == type(eng.results)() and eng.pending_windows() == 0
    sig, _ = ecg_stream_signal(2.0, seed=0)
    eng.ingest("p0", "rpeak", "ecg", sig[None, :])   # closed set cleared
    eng.drain()
    assert programs.total() == 0 and hits.total() == 1   # callable kept
    assert eng.ledger.summary()["fleet"]["windows"] == 1
