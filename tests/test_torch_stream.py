"""The slice as a whole: one mixed fleet through both ``StreamEngine``s.

Six patients (3 cough at posit16, 3 ECG at posit10 with one pinned to
posit8), 2 windows each, streamed in the same ragged chunks in the same
order, ``max_batch=4``.  Both engines must emit the same set of
(patient, widx, fmt) results; p_cough and R-peak scores within one format
ulp (tier 2: they pass through matmuls, sums and exp); equal per-window
candidate counts and confirmed peaks; equal ledger windows and nJ.
Both engines pad to ``max_batch`` so the reference compiles one program per
(task, format).
"""
import numpy as np
import pytest
import torch

from repro.apps.forest import Forest as JForest
from repro.data.biosignals import (cough_stream_signals, ecg_stream_signal,
                                   ragged_chunks)
from repro.stream import StreamEngine as JEngine
from repro.stream import cough_pipeline as jcough_pipeline
from repro.stream import rpeak_pipeline as jrpeak_pipeline
from repro_torch.apps.cough import train_reference_forest
from repro_torch.apps.forest import forest_from_arrays
from repro_torch.core.formats import get_format
from repro_torch.core.posit import encode
from repro_torch.stream import (StreamEngine, bucket_size, cough_pipeline,
                                rpeak_pipeline)

N_WINDOWS = 2


def _fleet():
    rng = np.random.default_rng(11)
    queues, pins = [], {"ecg-2": "posit8"}
    for p in range(3):
        a, i, _ = cough_stream_signals(N_WINDOWS, seed=p)
        queues.append((f"cough-{p}", "cough", "audio",
                       list(ragged_chunks(a, rng, 400, 9600))))
        queues.append((f"cough-{p}", "cough", "imu",
                       list(ragged_chunks(i, rng, 4, 60))))
        s, _ = ecg_stream_signal(N_WINDOWS * 2.0, seed=1000 + p)
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
    for pid, fmt in pins.items():
        engine.register_patient(pid, "rpeak", fmt=fmt)
    for pid, task, mod, chunk in order:
        engine.ingest(pid, task, mod, chunk)
    engine.drain()
    engine.finalize_all()
    return {(r.patient, r.widx, r.fmt): r.outputs
            for r in engine.pop_results()}, engine.fleet_summary()


@pytest.fixture(scope="module")
def runs():
    forest = train_reference_forest(24, 123, n_trees=6, depth=4,
                                    device="cpu")
    jforest = JForest(forest.feat, forest.thresh, forest.value, forest.depth)
    order, pins = _fleet()
    ref = _run(JEngine({"cough": jcough_pipeline(jforest),
                        "rpeak": jrpeak_pipeline()},
                       max_batch=4, pad_to_max=True), order, pins)
    tforest = forest_from_arrays(jforest.feat, jforest.thresh,
                                 jforest.value, jforest.depth)
    got = _run(StreamEngine({"cough": cough_pipeline(tforest),
                             "rpeak": rpeak_pipeline()},
                            max_batch=4, pad_to_max=True, device="cpu"),
               order, pins)
    return ref, got


def _ulp_distance(a, b, name):
    fmt = get_format(name)

    def ordered(v):
        p = encode(torch.from_numpy(np.array(v, np.float32)), fmt)
        p = p.to(torch.int64) & fmt.mask
        return (p ^ fmt.nar_pattern) - fmt.nar_pattern
    return (ordered(a) - ordered(b)).abs()


def test_same_windows_and_formats(runs):
    (ref, _), (got, _) = runs
    assert len(ref) == 6 * N_WINDOWS
    assert set(got) == set(ref)
    assert {k[2] for k in got} == {"posit16", "posit10", "posit8"}


def test_outputs_within_one_ulp_and_peaks_equal(runs):
    (ref, _), (got, _) = runs
    for key, r in ref.items():
        g = got[key]
        assert set(g) == set(r), key
        if "p_cough" in r:
            assert int(_ulp_distance(g["p_cough"], r["p_cough"],
                                     key[2]).max()) <= 1, key
        else:
            assert int(_ulp_distance(g["scores"], r["scores"],
                                     key[2]).max()) <= 1, key
            assert int(g["peak_count"]) == int(r["peak_count"]), key
            np.testing.assert_array_equal(g["peaks"], r["peaks"])


def test_ledger_windows_and_energy_equal(runs):
    (_, ref), (_, got) = runs
    assert set(got) == set(ref)
    for key in ref:
        assert got[key]["windows"] == ref[key]["windows"], key
        assert got[key]["padded_windows"] == ref[key]["padded_windows"], key
        assert got[key]["total_nj"] == pytest.approx(ref[key]["total_nj"],
                                                     rel=1e-12), key


@pytest.mark.parametrize("n,max_batch,want", [
    (0, 8, 1), (1, 8, 1), (3, 8, 4), (8, 8, 8), (9, 8, 8), (5, 64, 8)])
def test_bucket_size(n, max_batch, want):
    assert bucket_size(n, max_batch) == want


@pytest.mark.parametrize("policy", ["pow2", "max", "auto"])
def test_pad_policies_score_every_window_once(policy):
    sig, _ = ecg_stream_signal(10.0, seed=3)
    eng = StreamEngine({"rpeak": rpeak_pipeline()}, max_batch=4,
                       pad_policy=policy, autotune_horizon=2, device="cpu")
    rng = np.random.default_rng(0)
    for p in range(3):
        for chunk in ragged_chunks(sig[None, :], rng, 100, 700):
            eng.ingest(f"p{p}", "rpeak", "ecg", chunk)
    eng.drain()
    res = eng.pop_results()
    assert sorted((r.patient, r.widx) for r in res) == sorted(
        (f"p{p}", w) for p in range(3) for w in range(5))
    assert eng.fleet_summary()["fleet"]["windows"] == 15


def test_pad_policy_rejects_unknown_names():
    with pytest.raises(ValueError):
        StreamEngine({}, pad_policy="nope", device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_router_escalation_matches_reference(seed):
    from repro.stream import EscalationPolicy as JPolicy
    from repro.stream import PrecisionRouter as JRouter
    from repro_torch.stream import EscalationPolicy, PrecisionRouter
    rng = np.random.default_rng(seed)
    ref = JRouter(patient_formats={"p": "posit8"}, escalation=JPolicy())
    got = PrecisionRouter(patient_formats={"p": "posit8"},
                          escalation=EscalationPolicy())
    for gap, mid in zip(rng.uniform(0, 0.2, 40), rng.uniform(0, 1, 40) < 0.2):
        assert (got.observe("p", "rpeak", float(gap), bool(mid))
                == ref.observe("p", "rpeak", float(gap), bool(mid)))


@pytest.mark.parametrize("fmt", ["posit8", "posit10", "posit16", "fp32"])
def test_window_energy_matches_reference(fmt):
    from repro.stream import accounting as jacc
    from repro_torch.stream import accounting as tacc
    for t_ops, j_ops in ((tacc.cough_window_op_counts(n_trees=10, depth=5),
                          jacc.cough_window_op_counts(n_trees=10, depth=5)),
                         (tacc.rpeak_window_op_counts(500),
                          jacc.rpeak_window_op_counts(500))):
        assert vars(t_ops) == vars(j_ops)
        assert tacc.window_energy_nj(t_ops, fmt) == jacc.window_energy_nj(
            j_ops, fmt, quire=False)
