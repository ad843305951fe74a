"""A mixed fleet with an IEEE pin through both ``StreamEngine``s.

Four patients, two windows each, in the same ragged chunks and order: two
cough patients (one pinned to fp16), two ECG patients (one pinned to
posit8), ``max_batch=2``.  Both engines must emit the same (patient,
window, format) results and equal ledger windows and nJ, with the quire off
and on (the ledger bills the live mode).  Both engines pad to ``max_batch``
so the reference compiles one program per (task, format).
"""
import numpy as np
import pytest

from repro.apps.forest import Forest as JForest
from repro.core import arith as jarith
from repro.data.biosignals import (cough_stream_signals, ecg_stream_signal,
                                   ragged_chunks)
from repro.stream import StreamEngine as JEngine
from repro.stream import cough_pipeline as jcough_pipeline
from repro.stream import rpeak_pipeline as jrpeak_pipeline
from repro_torch.apps.cough import train_reference_forest
from repro_torch.apps.forest import forest_from_arrays
from repro_torch.core.arith import backend_overrides
from repro_torch.stream import StreamEngine, cough_pipeline, rpeak_pipeline


def _fleet():
    """Two cough patients (one pinned to fp16) and two ECG patients (one
    pinned to posit8), two windows each, in ragged chunks."""
    rng = np.random.default_rng(3)
    queues, pins = [], {"cough-1": ("cough", "fp16"),
                        "ecg-1": ("rpeak", "posit8")}
    for p in range(2):
        a, i, _ = cough_stream_signals(2, seed=p)
        queues.append((f"cough-{p}", "cough", "audio",
                       list(ragged_chunks(a, rng, 400, 9600))))
        queues.append((f"cough-{p}", "cough", "imu",
                       list(ragged_chunks(i, rng, 4, 60))))
        s, _ = ecg_stream_signal(4.0, seed=1000 + p)
        queues.append((f"ecg-{p}", "rpeak", "ecg",
                       list(ragged_chunks(s[None, :], rng, 50, 1000))))
    order = []
    while queues:
        k = int(rng.integers(len(queues)))
        pid, task, mod, chunks = queues[k]
        order.append((pid, task, mod, chunks.pop(0)))
        if not chunks:
            queues.pop(k)
    return order, pins


def _run(engine, order, pins):
    for pid, (task, fmt) in pins.items():
        engine.register_patient(pid, task, fmt=fmt)
    for pid, task, mod, chunk in order:
        engine.ingest(pid, task, mod, chunk)
    engine.drain()
    engine.finalize_all()
    return ({(r.patient, r.widx, r.fmt) for r in engine.pop_results()},
            engine.fleet_summary())


@pytest.mark.parametrize("quire", ["off", "on"])
def test_fleet_with_an_fp16_pin_matches_reference(quire):
    forest = train_reference_forest(24, 123, n_trees=6, depth=4,
                                    device="cpu")
    jforest = JForest(forest.feat, forest.thresh, forest.value, forest.depth)
    order, pins = _fleet()
    with jarith.backend_overrides(quire=quire):
        ref = _run(JEngine({"cough": jcough_pipeline(jforest),
                            "rpeak": jrpeak_pipeline()},
                           max_batch=2, pad_to_max=True), order, pins)
    with backend_overrides(quire=quire):
        got = _run(StreamEngine({"cough": cough_pipeline(
            forest_from_arrays(forest.feat, forest.thresh, forest.value,
                               forest.depth)), "rpeak": rpeak_pipeline()},
            max_batch=2, pad_to_max=True, device="cpu"), order, pins)
    (ref_keys, ref_sum), (got_keys, got_sum) = ref, got
    assert got_keys == ref_keys and len(got_keys) == 8
    assert {k[2] for k in got_keys} == {"posit16", "fp16", "posit10",
                                        "posit8"}
    assert set(got_sum) == set(ref_sum)
    for key in ref_sum:
        assert got_sum[key]["windows"] == ref_sum[key]["windows"], key
        assert got_sum[key]["total_nj"] == pytest.approx(
            ref_sum[key]["total_nj"], rel=1e-12), key
