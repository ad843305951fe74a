"""The port's ingest layer against the reference's, on the CPU.

* The wire format: every frame kind encodes to the reference's bytes, and
  each package's decoder reads the other's.
* Sessions: reorder, duplicates and exactly-once delivery; the guards; stall
  eviction with its delivered prefix equal to the offline detector's; a
  failing close contained and counted; per-modality stalls; a TCP
  reconnect mid-window.
* A small fleet through the loopback codec (dups, defers, one stall) on the
  port's engine and on the reference's: the transport counters equal
  exactly, the same (patient, widx, fmt) results with peaks equal and
  scores within one format ulp (tier 2, as ``test_torch_stream.py``), and
  equal ledger windows and nJ.
* A small fleet over localhost TCP bitwise equal to the port's own
  in-process run of the same signals.

The reference's engines are built fresh in this module (see ROADMAP §C on
the reference's stream-parity flake).
"""
import asyncio
import warnings

import numpy as np
import pytest
import torch

from repro_torch.apps.bayeslope import detect_rpeaks
from repro_torch.apps.cough import train_reference_forest
from repro_torch.core.arith import Arith
from repro_torch.core.formats import get_format
from repro_torch.core.posit import encode
from repro_torch.data.biosignals import (cough_stream_signals,
                                         ecg_stream_signal, ragged_chunks)
from repro_torch.ingest import (FleetSimulator, FrameDecoder, IngestServer,
                                ProtocolError, SessionManager, Supervisor,
                                ack, bye, data, encode_frame, evicted, hello,
                                loopback)
from repro_torch.ingest import protocol as tproto
from repro_torch.stream import StreamEngine, cough_pipeline, rpeak_pipeline

W = 500  # samples per 2 s R-peak window


@pytest.fixture(scope="module")
def forest():
    return train_reference_forest(24, 123, n_trees=5, depth=4, device="cpu")


@pytest.fixture(scope="module")
def pipelines(forest):
    return {"cough": cough_pipeline(forest), "rpeak": rpeak_pipeline()}


def _rpeak_engine(**kw):
    return StreamEngine({"rpeak": rpeak_pipeline()}, device="cpu", **kw)


def _offline_prefix(sig_1d, fmt="posit10"):
    n = (len(sig_1d) // W) * W
    return detect_rpeaks(Arith.make(fmt), sig_1d[:n], device="cpu")


# ---------------------------------------------------------------------------
# Wire protocol: the reference's bytes
# ---------------------------------------------------------------------------
def _frames(mod):
    rng = np.random.default_rng(0)
    return {
        "hello": mod.hello("p-0", "rpeak"),
        "hello_auth": mod.hello("p-0", "rpeak",
                                auth=mod.auth_token("s3cret", "p-0",
                                                    "rpeak")),
        "data_f64": mod.data("p-0", "rpeak", "ecg", 7,
                             rng.normal(size=(1, 123)) * 1e3),
        "data_f32": mod.data("cough-001", "cough", "audio", 0,
                             rng.normal(size=(2, 77)).astype(np.float32)),
        "data_empty": mod.data("p-0", "rpeak", "ecg", 1,
                               np.zeros((1, 0), np.float32)),
        "bye": mod.bye("p-0", "rpeak"),
        "ack": mod.ack("p-0", "rpeak", "ecg", 12, 200),
        "barrier_ack": mod.ack("p-0", "rpeak", "", 0, 256),
        "evicted": mod.evicted("ecg-031", "rpeak", "stall"),
    }


KINDS = sorted(_frames(tproto))


@pytest.mark.parametrize("kind", KINDS)
def test_frame_bytes_equal_the_reference(kind):
    from repro.ingest import protocol as jproto
    t, j = _frames(tproto)[kind], _frames(jproto)[kind]
    tb, jb = tproto.encode_frame(t), jproto.encode_frame(j)
    assert tb == jb
    for dec, raw in ((tproto.FrameDecoder(), jb), (jproto.FrameDecoder(), tb)):
        (f,) = dec.feed(raw)
        assert (f.ftype, f.patient, f.task, f.modality, f.seq) == \
            (t.ftype, t.patient, t.task, t.modality, t.seq)
        if t.payload is None:
            assert f.payload is None
        else:
            np.testing.assert_array_equal(f.payload, t.payload)
            assert f.payload.dtype == t.payload.dtype
    assert tproto.check_auth("s3cret", t) == jproto.check_auth("s3cret", j)


def test_frame_roundtrip_under_ragged_byte_splits():
    rng = np.random.default_rng(0)
    frames = [hello("p-0", "rpeak")]
    for s in range(5):
        payload = rng.normal(size=(2, int(rng.integers(1, 300)))) * 1e3
        if s % 2:
            payload = payload.astype(np.float32)
        frames.append(data("p-0", "rpeak", "ecg", s, payload))
    frames.append(bye("p-0", "rpeak"))
    got = list(loopback(frames, chunk_bytes=97, rng=rng))
    assert [f.ftype for f in got] == [f.ftype for f in frames]
    for a, b in zip(got, frames):
        assert (a.patient, a.seq) == (b.patient, b.seq)
        if b.payload is not None:
            np.testing.assert_array_equal(a.payload, b.payload)
            assert a.payload.dtype == b.payload.dtype


def test_decoder_rejects_corruption_and_poisons():
    corrupt = bytearray(encode_frame(data("p", "t", "m", 1,
                                          np.ones((1, 8)))))
    corrupt[30] ^= 0xFF
    dec = FrameDecoder()
    got = dec.feed(encode_frame(data("p", "t", "m", 0, np.ones((1, 4))))
                   + bytes(corrupt))
    assert [f.seq for f in got] == [0] and dec.poisoned
    with pytest.raises(ProtocolError):
        dec.feed(encode_frame(hello("p", "t")))
    dec2 = FrameDecoder()
    assert dec2.feed((tproto.MAX_FRAME_BYTES + 1).to_bytes(4, "big")) == []
    assert dec2.poisoned


# ---------------------------------------------------------------------------
# Sessions
# ---------------------------------------------------------------------------
def test_session_restores_order_drops_dups_exactly_once():
    sig, _ = ecg_stream_signal(8.0, seed=3)
    rng = np.random.default_rng(0)
    chunks = list(ragged_chunks(sig[None, :], rng, 50, 400))
    frames = [hello("e0", "rpeak")] + [
        data("e0", "rpeak", "ecg", i, c) for i, c in enumerate(chunks)]
    frames[2], frames[3] = frames[3], frames[2]   # reorder
    frames.insert(6, frames[5])                   # duplicate
    frames.append(frames[1])                      # late duplicate
    frames.append(bye("e0", "rpeak"))
    eng = _rpeak_engine(max_batch=4)
    sm = SessionManager(eng, stall_timeout_s=60.0, clock=lambda: 0.0)
    for f in loopback(frames, chunk_bytes=251, rng=rng):
        sm.on_frame(f)
    assert eng.tracker_for("e0", "rpeak").peaks == _offline_prefix(sig)
    t = eng.ledger.transport_summary()["e0"]
    assert t["dup_frames"] == 2 and t["reordered_frames"] == 1
    assert t["gap_events"] == 1 and t["connects"] == 1
    assert t["frames"] == len(chunks) + 2


def test_session_guards_task_change_post_bye_and_reorder_cap():
    eng = _rpeak_engine(max_batch=4)
    sm = SessionManager(eng, reorder_cap=2, clock=lambda: 0.0)
    sm.on_frame(hello("p", "rpeak"))
    sm.on_frame(data("p", "rpeak", "ecg", 0, np.zeros((1, 4))))
    with pytest.raises(ProtocolError):
        sm.on_frame(hello("p", "cough"))
    sm.on_frame(data("p", "rpeak", "ecg", 2, np.zeros((1, 4))))
    sm.on_frame(bye("p", "rpeak"))
    assert eng.ledger.transport_summary()["p"]["abandoned_frames"] == 1
    with pytest.raises(ProtocolError):
        sm.on_frame(data("p", "rpeak", "ecg", 1, np.zeros((1, 4))))
    with pytest.raises(KeyError):
        eng.ingest("p", "rpeak", "ecg", np.zeros((1, 4)))
    sm2 = SessionManager(_rpeak_engine(max_batch=4), reorder_cap=2,
                         clock=lambda: 0.0)
    for s in (1, 2):
        sm2.on_frame(data("q", "rpeak", "ecg", s, np.zeros((1, 4))))
    with pytest.raises(ProtocolError):
        sm2.on_frame(data("q", "rpeak", "ecg", 3, np.zeros((1, 4))))
    with pytest.raises(ProtocolError):          # server-originated kinds
        sm2.on_frame(ack("q", "rpeak", "ecg", 0, 1))
    with pytest.raises(ProtocolError):
        sm2.on_frame(evicted("q", "rpeak", "stall"))


def test_stall_eviction_finalizes_prefix_frees_staged_counts_late():
    eng = _rpeak_engine(max_batch=8)
    t = [0.0]
    sm = SessionManager(eng, stall_timeout_s=5.0, clock=lambda: t[0])
    sim = FleetSimulator(n_patients=3, windows=3, seed=7, mixed=False,
                         n_cough=0, stall_after={"ecg-000": 2})
    sim.run_loopback(sm)
    assert sm.reap() == []
    t[0] = 6.0
    assert sm.reap() == ["ecg-000"]
    assert sm.reap() == []
    plan = next(p for p in sim.plans if p.patient == "ecg-000")
    prefix = np.concatenate([c[0] for c in plan.chunks["ecg"][:2]])
    assert eng.tracker_for("ecg-000", "rpeak").peaks == \
        _offline_prefix(prefix)
    tr = eng.ledger.transport_summary()["ecg-000"]
    assert tr["evictions"] == 1
    assert tr["windows_flushed"] == len(prefix) // W
    sm.on_frame(data("ecg-000", "rpeak", "ecg", 2, np.zeros((1, 8))))
    assert eng.ledger.transport_summary()["ecg-000"]["late_frames"] == 1
    with pytest.raises(KeyError):
        eng.ingest("ecg-000", "rpeak", "ecg", np.zeros((1, 8)))
    for p in sim.plans:
        if p.patient != "ecg-000":
            assert eng.tracker_for(p.patient, "rpeak").peaks == \
                _offline_prefix(p.signals["ecg"][0])


def test_bye_on_failing_stream_is_contained_and_counted():
    eng = _rpeak_engine(max_batch=64)
    sm = SessionManager(eng, clock=lambda: 0.0)
    sm.on_frame(hello("p", "rpeak"))
    eng.router.pin("p", "no-such-format")
    sm.on_frame(data("p", "rpeak", "ecg", 0, np.zeros((1, 1000))))
    assert eng.pending_windows() == 2
    sm.on_frame(bye("p", "rpeak"))          # contained: must not raise
    t = eng.ledger.transport_summary()["p"]
    assert t["windows_dropped"] == 2 and t["evictions"] == 0
    assert eng.pending_windows() == 0 and sm.dispatch_backlog() == 0
    with pytest.raises(KeyError):
        eng.ingest("p", "rpeak", "ecg", np.zeros((1, 8)))


def test_eviction_frees_partially_staged_multimodal_slices(pipelines):
    eng = StreamEngine(pipelines, max_batch=8, device="cpu")
    t = [0.0]
    sm = SessionManager(eng, stall_timeout_s=5.0, clock=lambda: t[0])
    audio, _, _ = cough_stream_signals(3, seed=5)
    sm.on_frame(hello("c0", "cough"))
    sm.on_frame(data("c0", "cough", "audio", 0, audio))
    t[0] = 10.0
    assert sm.reap() == ["c0"]
    tr = eng.ledger.transport_summary()["c0"]
    assert tr["windows_flushed"] == 0
    assert tr["staged_freed"] == 3
    assert eng.pending_windows() == 0


def test_modality_stall_counted_without_evicting_live_session(pipelines):
    eng = StreamEngine(pipelines, max_batch=8, device="cpu")
    t = [0.0]
    sm = SessionManager(eng, stall_timeout_s=100.0, clock=lambda: t[0],
                        modality_timeouts={"imu": 2.0})
    sm.on_frame(hello("c0", "cough"))
    sm.on_frame(data("c0", "cough", "audio", 0, np.zeros((2, 100))))
    sm.on_frame(data("c0", "cough", "imu", 0, np.zeros((9, 10))))
    t[0] = 3.0
    sm.on_frame(data("c0", "cough", "audio", 1, np.zeros((2, 100))))
    assert sm.reap() == []
    tr = eng.ledger.transport_summary()["c0"]
    assert tr["modality_stalls"] == 1 and tr["evictions"] == 0
    assert sm.reap() == []
    assert eng.ledger.transport_summary()["c0"]["modality_stalls"] == 1
    t[0] = 4.0
    sm.on_frame(data("c0", "cough", "imu", 1, np.zeros((9, 10))))
    t[0] = 7.0
    sm.on_frame(data("c0", "cough", "audio", 2, np.zeros((2, 100))))
    assert sm.reap() == []
    tr = eng.ledger.transport_summary()["c0"]
    assert tr["modality_stalls"] == 2 and tr["evictions"] == 0
    assert not sm.sessions["c0"].closed


# ---------------------------------------------------------------------------
# Asyncio TCP transport
# ---------------------------------------------------------------------------
def _run_tcp_fleet(engine, sim, stall_timeout_s=30.0, reap_interval_s=None,
                   sup=None):
    async def main():
        sm = SessionManager(engine, stall_timeout_s=stall_timeout_s)
        sim.pin_all(engine)
        async with IngestServer(sm, port=0,
                                reap_interval_s=reap_interval_s) as srv:
            done = [False]
            pump = None
            if sup is not None:
                pump = asyncio.ensure_future(
                    sup.run_async(0.005, stop=lambda: done[0]))
            await sim.run_tcp("127.0.0.1", srv.port)
            deadline = asyncio.get_event_loop().time() + 60.0
            while not sm.all_closed():
                if asyncio.get_event_loop().time() > deadline:
                    raise TimeoutError(
                        f"sessions never closed: {sm.open_sessions()}")
                await asyncio.sleep(0.02)
            done[0] = True
            if pump is not None:
                await pump
            return srv
    srv = asyncio.run(main())
    engine.drain()
    if sup is not None:
        sup.poll()
    return srv


def test_tcp_mid_window_disconnect_reconnect_resumes():
    sim = FleetSimulator(n_patients=2, windows=3, seed=11, mixed=False,
                         n_cough=0, disconnect_every=2,
                         ecg_chunk=(40, 200))
    eng = _rpeak_engine(max_batch=4)
    srv = _run_tcp_fleet(eng, sim)
    ts = eng.ledger.transport_summary()
    for p in sim.plans:
        assert ts[p.patient]["connects"] >= 2
        assert eng.tracker_for(p.patient, "rpeak").peaks == \
            _offline_prefix(p.signals["ecg"][0]), p.patient
    assert srv.connections_total == ts["fleet"]["connects"]


def test_tcp_fleet_bitwise_equal_to_inproc(pipelines):
    """A small mixed fleet (4 cough, one pinned to fp16; 4 ECG, one pinned
    to posit8) with duplicates and deferred frames: every window over TCP
    equals the in-process run bit for bit.  ``pad_policy="max"`` keeps one
    batch shape per (task, fmt), so TCP arrival order cannot change a
    summation order."""
    def build():
        return FleetSimulator(n_patients=8, windows=2, seed=3, mixed=True,
                              n_cough=4, dup_rate=0.1, defer_rate=0.1)
    ref = StreamEngine(pipelines, max_batch=4, pad_policy="max",
                       result_capacity=None, device="cpu")
    build().run_inproc(ref)
    eng = StreamEngine(pipelines, max_batch=4, pad_policy="max",
                       result_capacity=None, device="cpu")
    sup = Supervisor(eng, capacity=1024)
    sim = build()
    _run_tcp_fleet(eng, sim, sup=sup)
    ts = eng.ledger.transport_summary()
    assert ts["fleet"]["dup_frames"] > 0 and ts["fleet"]["connects"] == 8
    ref_rows = {(r.patient, r.widx): r for r in ref.pop_results()}
    got = {(r.patient, r.widx): r for r in sup.pop()}
    assert got.keys() == ref_rows.keys() and len(got) == 16
    assert {r.fmt for r in got.values()} == {"posit16", "fp16", "posit10",
                                             "posit8"}
    for key, r in got.items():
        assert r.fmt == ref_rows[key].fmt
        for k, v in r.outputs.items():
            np.testing.assert_array_equal(v, ref_rows[key].outputs[k],
                                          err_msg=f"{key} {k}")
    for p in sim.plans:
        if p.task == "rpeak":
            assert eng.tracker_for(p.patient, "rpeak").peaks == \
                ref.tracker_for(p.patient, "rpeak").peaks


# ---------------------------------------------------------------------------
# Loopback fleet: the port against the reference
# ---------------------------------------------------------------------------
def _ulp_distance(a, b, name):
    fmt = get_format(name)

    def ordered(v):
        p = encode(torch.from_numpy(np.array(v, np.float32)), fmt)
        p = p.to(torch.int64) & fmt.mask
        return (p ^ fmt.nar_pattern) - fmt.nar_pattern
    return (ordered(a) - ordered(b)).abs()


def _loopback(sim, engine):
    t = [0.0]
    sm = SessionManager(engine, stall_timeout_s=5.0, clock=lambda: t[0])
    sim.run_loopback(sm)
    t[0] = 100.0
    evicted = sm.reap()
    engine.drain()
    return evicted, {(r.patient, r.widx, r.fmt): r.outputs
                     for r in engine.pop_results()}


@pytest.fixture(scope="module")
def loopback_runs(forest):
    from repro.apps.forest import Forest as JForest
    from repro.ingest import FleetSimulator as JSim
    from repro.stream import StreamEngine as JEngine
    from repro.stream import cough_pipeline as jcough
    from repro.stream import rpeak_pipeline as jrpeak
    kw = dict(n_patients=8, windows=2, seed=4, mixed=True, n_cough=2,
              dup_rate=0.1, defer_rate=0.1, stall_after={"ecg-001": 3})
    jforest = JForest(forest.feat, forest.thresh, forest.value, forest.depth)
    ref = JEngine({"cough": jcough(jforest), "rpeak": jrpeak()},
                  max_batch=4, pad_policy="max", result_capacity=None)
    got = StreamEngine({"cough": cough_pipeline(forest),
                        "rpeak": rpeak_pipeline()}, max_batch=4,
                       pad_policy="max", result_capacity=None, device="cpu")
    return (ref, _loopback(JSim(**kw), ref)), (got,
                                               _loopback(FleetSimulator(**kw),
                                                         got))


def test_loopback_transport_counters_equal_the_reference(loopback_runs):
    (ref, (ref_ev, _)), (got, (got_ev, _)) = loopback_runs
    assert got_ev == ref_ev == ["ecg-001"]
    tt = got.ledger.transport_summary()
    assert tt == ref.ledger.transport_summary()
    assert tt["fleet"]["dup_frames"] > 0
    assert tt["fleet"]["reordered_frames"] > 0
    assert tt["ecg-001"]["evictions"] == 1


def test_loopback_results_within_one_ulp_and_peaks_equal(loopback_runs):
    (ref, (_, rres)), (got, (_, gres)) = loopback_runs
    assert set(gres) == set(rres)
    assert {k[2] for k in gres} == {"posit16", "posit10", "posit8"}
    for key, r in rres.items():
        g = gres[key]
        assert set(g) == set(r), key
        out = "p_cough" if "p_cough" in r else "scores"
        assert int(_ulp_distance(g[out], r[out], key[2]).max()) <= 1, key
        if out == "scores":
            assert int(g["peak_count"]) == int(r["peak_count"]), key
            np.testing.assert_array_equal(g["peaks"], r["peaks"])
    for patient in {k[0] for k in rres if k[0].startswith("ecg")}:
        assert got.tracker_for(patient, "rpeak").peaks == \
            ref.tracker_for(patient, "rpeak").peaks, patient


def test_loopback_ledger_windows_and_energy_equal(loopback_runs):
    (ref, _), (got, _) = loopback_runs
    rs, gs = ref.ledger.summary(), got.ledger.summary()
    assert set(gs) == set(rs)
    for key in rs:
        assert gs[key]["windows"] == rs[key]["windows"], key
        assert gs[key]["total_nj"] == pytest.approx(rs[key]["total_nj"],
                                                    rel=1e-12), key


# ---------------------------------------------------------------------------
# Bounded drains
# ---------------------------------------------------------------------------
def test_undrained_engine_results_stay_bounded():
    eng = _rpeak_engine(max_batch=2, result_capacity=5)
    sim = FleetSimulator(n_patients=4, windows=3, seed=1, mixed=False,
                         n_cough=0)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        sim.run_inproc(eng)
    assert len(eng.results) == 5
    assert eng.dropped_results == 12 - 5
    assert any("result_capacity" in str(x.message) for x in w)
    dropped = eng.metrics.counter("engine_results_dropped_total")
    assert dropped.total() == 7
    assert len(eng.pop_results(2)) == 2 and len(eng.results) == 3


def test_supervisor_bounded_queue_drop_oldest_counts():
    eng = _rpeak_engine(max_batch=2)
    sup = Supervisor(eng, capacity=4)
    sim = FleetSimulator(n_patients=2, windows=3, seed=2, mixed=False,
                         n_cough=0)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        sim.run_inproc(eng)
        sup.poll()
    assert len(sup.queue) == 4 and sup.dropped == 2
    assert sup.total_windows == 6
    assert any("supervisor result queue full" in str(x.message) for x in w)
    tele = sup.telemetry()
    assert tele["queue"]["dropped"] == 2
    assert set(tele["latency_ms"]) == {"p50", "p90", "p99"}
    assert tele["latency_ms"]["p50"] > 0
    for pid in ("ecg-000", "ecg-001"):
        assert tele["patients"][pid]["windows"] == 3
