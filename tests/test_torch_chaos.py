"""The port's fault-tolerance pieces that need no worker pool, on the CPU:
the result spill (lossless round-trip, torn tail, disk budget), the
supervisor's overflow into the spill and its restart recovery, HELLO auth,
and connection-level chaos (a partition and a corrupted frame) recovering
to the offline detector's peaks through replay, CRC and dedup.  The pool's
kill/failover tests wait for ``ingest/workers.py`` (ROADMAP A2).
"""
import asyncio
import os

import numpy as np
import pytest

from repro_torch.apps.bayeslope import detect_rpeaks
from repro_torch.core.arith import Arith
from repro_torch.ingest import (ChaosPlan, FleetSimulator, IngestServer,
                                ResultSpill, SessionManager, Supervisor,
                                auth_token, data, encode_frame, hello)
from repro_torch.stream import StreamEngine, rpeak_pipeline
from repro_torch.stream.engine import WindowResult

W = 500  # samples per 2 s R-peak window


def _rpeak_engine(**kw):
    return StreamEngine({"rpeak": rpeak_pipeline()}, device="cpu", **kw)


def _offline_prefix(sig_1d, fmt="posit10"):
    n = (len(sig_1d) // W) * W
    return detect_rpeaks(Arith.make(fmt), sig_1d[:n], device="cpu")


def _result(patient, widx, **outputs):
    return WindowResult(patient=patient, task="rpeak", widx=widx,
                        fmt="posit10", t0_s=2.0 * widx, outputs=outputs,
                        ready_wall=100.0 + widx, done_wall=101.0 + widx)


def _assert_results_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.patient, g.task, g.widx, g.fmt) == \
            (w.patient, w.task, w.widx, w.fmt)
        assert g.t0_s == w.t0_s
        assert g.ready_wall == w.ready_wall and g.done_wall == w.done_wall
        assert set(g.outputs) == set(w.outputs)
        for k in w.outputs:
            a, b = np.asarray(g.outputs[k]), np.asarray(w.outputs[k])
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)


def test_spill_round_trip_is_lossless(tmp_path):
    rng = np.random.default_rng(0)
    rows = [
        _result("p0", 0,
                f32=rng.normal(size=(3, 4)).astype(np.float32),
                f64=rng.normal(size=(7,)),
                big=np.asarray([2**52 + 3, -17], dtype=np.int64)),
        _result("p0", 1, scalar=np.float32(0.5),
                empty=np.zeros((0,), dtype=np.int32)),
        _result("p1", 0, mask=np.asarray([1, 0, 1], dtype=np.uint8)),
    ]
    path = str(tmp_path / "spill.seg")
    with ResultSpill(path) as sp:
        for r in rows:
            assert sp.append(r)
    assert sp.counters()["spilled"] == 3
    assert sp.counters()["spilled_by_patient"] == {"p0": 2, "p1": 1}
    _assert_results_equal(ResultSpill.recover(path), rows)


def test_spill_file_bytes_equal_the_reference(tmp_path):
    """The spill reuses the wire codec, so a segment written by the port
    is the reference's segment, and each package recovers the other's."""
    from repro.ingest import ResultSpill as JSpill
    from repro.stream.engine import WindowResult as JResult
    rng = np.random.default_rng(1)
    outs = [dict(scores=rng.normal(size=(500,)).astype(np.float32),
                 peak_count=np.int32(3), peaks=np.asarray([7, 250, 499])),
            dict(p_cough=np.float32(0.25))]
    paths = {}
    for name, spill, res in (("port", ResultSpill, WindowResult),
                             ("ref", JSpill, JResult)):
        paths[name] = str(tmp_path / f"{name}.seg")
        with spill(paths[name]) as sp:
            for i, o in enumerate(outs):
                assert sp.append(res("p0", "rpeak", i, "posit10", 2.0 * i,
                                     o, ready_wall=1.5, done_wall=2.5))
    with open(paths["port"], "rb") as a, open(paths["ref"], "rb") as b:
        assert a.read() == b.read()
    _assert_results_equal(ResultSpill.recover(paths["ref"]),
                          JSpill.recover(paths["port"]))


def test_spill_torn_tail_loses_only_the_last_record(tmp_path):
    rows = [_result("p0", i, x=np.arange(4, dtype=np.float32) + i)
            for i in range(3)]
    path = str(tmp_path / "spill.seg")
    with ResultSpill(path) as sp:
        for r in rows:
            sp.append(r)
    with open(path, "r+b") as fh:
        fh.truncate(os.path.getsize(path) - 7)
    _assert_results_equal(ResultSpill.recover(path), rows[:2])


def test_spill_refuses_past_disk_budget(tmp_path):
    path = str(tmp_path / "spill.seg")
    r = _result("p0", 0, x=np.ones((64,), dtype=np.float64))
    with ResultSpill(path, budget_bytes=1 << 20) as sp:
        assert sp.append(r)
        first = sp.bytes_written
    with ResultSpill(str(tmp_path / "tiny.seg"),
                     budget_bytes=first - 1) as sp:
        assert not sp.append(r)
        assert sp.rejected == 1 and sp.bytes_written == 0
    assert not os.path.exists(str(tmp_path / "tiny.seg"))
    assert ResultSpill.recover(str(tmp_path / "nope.seg")) == []


def test_supervisor_overflow_spills_then_recovers(tmp_path):
    path = str(tmp_path / "worker.seg")
    eng = _rpeak_engine(max_batch=2)
    sup = Supervisor(eng, capacity=2, spill=ResultSpill(path))
    sim = FleetSimulator(n_patients=2, windows=3, seed=2, mixed=False,
                         n_cough=0)
    sim.run_inproc(eng)
    sup.poll()
    assert sup.total_windows == 6 and len(sup.queue) == 2
    assert sup.spilled == 4
    tele = sup.telemetry()
    assert tele["queue"]["dropped"] == 0
    assert tele["queue"]["spilled"] == 4
    assert tele["queue"]["spill_bytes"] > 0
    assert sum(tele["queue"]["spilled_by_patient"].values()) == 4
    assert sup.metrics.counter("spilled_results_total", "").value(
        patient="ecg-000") > 0
    spilled = ResultSpill.recover(path)
    retained = list(sup.queue)
    sup.spill.close()
    eng2 = _rpeak_engine(max_batch=2)
    sup2 = Supervisor(eng2, capacity=64, spill=ResultSpill(path))
    assert sup2.recover_spill() == 4
    _assert_results_equal(list(sup2.queue), spilled)
    keys = {(r.patient, r.task, r.widx) for r in spilled + retained}
    assert len(keys) == 6


def test_hello_auth_rejects_and_counts():
    async def main():
        eng = _rpeak_engine(max_batch=4)
        sm = SessionManager(eng, stall_timeout_s=60.0)
        async with IngestServer(sm, port=0, auth_secret="s3cret") as srv:
            async def attempt(*frames):
                r, w = await asyncio.open_connection("127.0.0.1", srv.port)
                for f in frames:
                    w.write(encode_frame(f))
                await w.drain()
                got = await r.read()
                w.close()
                await w.wait_closed()
                return got

            await attempt(hello("p0", "rpeak"))
            await attempt(hello("p0", "rpeak", auth="deadbeef"))
            await attempt(hello("p0", "rpeak",
                                auth=auth_token("s3cret", "p1", "rpeak")))
            await attempt(data("p0", "rpeak", "ecg", 0, np.zeros((1, 8))))
            assert srv.auth_failures == 4
            assert "p0" not in sm.sessions
            assert eng.metrics.counter(
                "ingest_auth_failures_total", "").value() == 4
    asyncio.run(main())

    async def authed():
        eng = _rpeak_engine(max_batch=4)
        sm = SessionManager(eng, stall_timeout_s=60.0)
        sim = FleetSimulator(n_patients=2, windows=1, seed=4, mixed=False,
                             n_cough=0, disconnect_every=2,
                             ecg_chunk=(40, 200))
        sim.pin_all(eng)
        async with IngestServer(sm, port=0, auth_secret="s3cret") as srv:
            await sim.run_tcp("127.0.0.1", srv.port, auth_secret="s3cret")
            deadline = asyncio.get_event_loop().time() + 30.0
            while not sm.all_closed():
                assert asyncio.get_event_loop().time() < deadline
                await asyncio.sleep(0.02)
            assert srv.auth_failures == 0
        eng.drain()
        return eng
    eng = asyncio.run(authed())
    assert eng.ledger.transport_summary()["fleet"]["connects"] >= 4


@pytest.mark.parametrize("corrupt_at", [1, 3])
def test_partition_and_corruption_recover_bit_identical(corrupt_at):
    sim = FleetSimulator(n_patients=3, windows=2, seed=9, mixed=False,
                         n_cough=0, ecg_chunk=(40, 200))
    ids = [p.patient for p in sim.plans]
    chaos = ChaosPlan(partition_patients=(ids[1],),
                      partition_after_frames=2,
                      corrupt_patients=(ids[2],), corrupt_at_frame=corrupt_at)
    stats = {}

    async def main():
        eng = _rpeak_engine(max_batch=4)
        sm = SessionManager(eng, stall_timeout_s=30.0)
        sim.pin_all(eng)
        async with IngestServer(sm, port=0, ack=True) as srv:
            await sim.run_tcp("127.0.0.1", srv.port, chaos=chaos,
                              realtime_factor=40.0,
                              stats_out=stats, ledger=eng.ledger)
            deadline = asyncio.get_event_loop().time() + 60.0
            while not sm.all_closed():
                assert asyncio.get_event_loop().time() < deadline, \
                    f"sessions never closed: {sm.open_sessions()}"
                await asyncio.sleep(0.02)
        eng.drain()
        return eng
    eng = asyncio.run(main())
    assert stats[ids[1]].partitions == 1
    assert stats[ids[2]].corrupted_frames == 1
    assert stats[ids[1]].reconnects >= 1
    assert stats[ids[2]].reconnects >= 1
    for p in sim.plans:
        assert eng.tracker_for(p.patient, "rpeak").peaks == \
            _offline_prefix(p.signals["ecg"][0]), p.patient
    ts = eng.ledger.transport_summary()
    assert ts["fleet"]["replayed_frames"] > 0
    assert ts[ids[1]]["replayed_frames"] > 0
    assert ts[ids[2]]["replayed_frames"] > 0
    assert ts[ids[0]]["replayed_frames"] == 0
