"""The port's ingest worker pool and its fault-tolerance layer, on the CPU
(every worker runs with ``device="cpu"``):

* ``RestartPolicy``, ``run_with_restarts`` and ``StepWatchdog`` — the
  reference's tests of ``tests/test_fault_tolerance.py``;
* ``aggregate_rollup`` against the reference's on the same payloads, and
  the rollup and partition tests of ``tests/test_sharded_fleet.py``;
* a fault-free pool whose ledger ``windows`` and ``total_nj`` equal the JAX
  engine's in-process run (``total_nj`` within 1e-12 relative: the energy
  model's float sums in another order);
* the pool chaos tests of ``tests/test_chaos.py``: the drain-barrier
  timeout, a SIGKILLed worker failing over with every patient's digest
  equal to the port's fault-free in-process run, and the 64-patient
  acceptance run (marked ``slow`` as the reference's is).
"""
import asyncio

import numpy as np
import pytest
import torch

from repro_torch.distributed.fault_tolerance import (ElasticConfig,
                                                     RestartPolicy,
                                                     StepWatchdog,
                                                     run_with_restarts)
from repro_torch.ingest import (ChaosPlan, FleetSimulator, Supervisor,
                                aggregate_rollup, partition_plans,
                                run_worker_fleet)
from repro_torch.ingest.workers import (WorkerConfig, _result_digests,
                                        _supervise, _Worker)
from repro_torch.stream import StreamEngine, rpeak_pipeline
from repro_torch.stream.engine import WindowResult


# ---------------------------------------------------------------------------
# RestartPolicy, run_with_restarts, StepWatchdog
# ---------------------------------------------------------------------------
def test_restart_policy_backoff_doubles_and_caps():
    p = RestartPolicy(max_restarts=5, backoff_s=0.05, backoff_factor=2.0,
                      max_backoff_s=0.3)
    assert p.delay(1) == pytest.approx(0.05)
    assert p.delay(2) == pytest.approx(0.10)
    assert p.delay(3) == pytest.approx(0.20)
    assert p.delay(4) == pytest.approx(0.3)      # capped
    assert p.delay(10) == pytest.approx(0.3)


def test_restart_policy_budget():
    p = RestartPolicy(max_restarts=2)
    assert p.allows(0) and p.allows(1)
    assert not p.allows(2) and not p.allows(3)


def test_run_with_restarts_recovers_after_transient_failures():
    calls = []

    def train_once(last_step):
        calls.append(last_step)
        if len(calls) < 3:
            raise RuntimeError("device lost")
        return 42

    slept = []
    out = run_with_restarts(train_once,
                            policy=RestartPolicy(max_restarts=3,
                                                 backoff_s=0.01),
                            sleep=slept.append)
    assert out == 42
    assert len(calls) == 3
    assert slept == [pytest.approx(0.01), pytest.approx(0.02)]


def test_run_with_restarts_exhausts_budget():
    def always_dies(last_step):
        raise OSError("io down")

    with pytest.raises(RuntimeError, match="exceeded 2 restarts"):
        run_with_restarts(always_dies,
                          policy=RestartPolicy(max_restarts=2),
                          sleep=lambda s: None)


def test_run_with_restarts_default_policy_uses_cfg_budget():
    n = [0]

    def always_dies(last_step):
        n[0] += 1
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="exceeded 1 restarts"):
        run_with_restarts(always_dies, cfg=ElasticConfig(max_restarts=1),
                          sleep=lambda s: None)
    assert n[0] == 2      # the budget bounds RE-starts: 1 + 1 attempts


def test_run_with_restarts_non_retryable_propagates():
    def typo(last_step):
        raise ValueError("not a device failure")

    with pytest.raises(ValueError):
        run_with_restarts(typo, sleep=lambda s: None)


def test_step_watchdog_flags_slow_steps_on_cpu_outputs():
    import time
    wd = StepWatchdog(deadline_s=0.05)
    out, dt = wd.run(0, lambda x: {"y": x + 1}, torch.zeros(3))
    assert torch.equal(out["y"], torch.ones(3)) and dt < 0.05
    _, dt = wd.run(1, lambda: time.sleep(0.08) or [torch.zeros(1)])
    assert dt > 0.05 and wd.slow_steps == [1]


# ---------------------------------------------------------------------------
# Rollup and partition: pure helpers
# ---------------------------------------------------------------------------
def _payload(groups, patients, lat, windows, connects):
    transport = {p: {"frames": 2, "bytes": 100, "dup_frames": 0,
                     "reordered_frames": 0, "gap_events": 0,
                     "connects": 1, "late_frames": 0, "abandoned_frames": 0,
                     "evictions": 0, "modality_stalls": 0,
                     "windows_flushed": 0, "windows_dropped": 0,
                     "staged_freed": 0} for p in patients}
    transport["fleet"] = {k: sum(r[k] for r in transport.values())
                          for k in next(iter(transport.values()))}
    return {
        "groups": groups,
        "transport": transport,
        "escalation": {},
        "patients": {p: {"windows": 1, "windows_per_s": 0.0,
                         "latency_ms": {}} for p in patients},
        "latency_s": lat,
        "queue": {"capacity": 8, "depth": 0, "dropped": 0,
                  "total_windows": windows},
        "server": {"connections_total": connects, "protocol_errors": 0,
                   "session_errors": 0},
        "windows": windows,
        "devices": 1,
    }


ROW = dict(windows=4, batches=2, padded_windows=1, latency_s=2.0,
           energy_nj=100.0, escalated_windows=0, escalation_nj=0.0)


def test_aggregate_rollup_sums_rows_and_concatenates_latency():
    a = _payload({"rpeak/posit10": dict(ROW)}, ["e0", "e1"],
                 [0.001] * 3, 4, 2)
    b = _payload({"rpeak/posit10": dict(ROW)}, ["e2"], [0.1], 4, 1)
    out = aggregate_rollup([a, b])
    g = out["groups"]["rpeak/posit10"]
    assert g["windows"] == 8 and g["batches"] == 4
    assert g["total_nj"] == 200.0 and g["nj_per_window"] == 25.0
    assert g["windows_per_s"] == 8 / 4.0
    fleet = out["groups"]["fleet"]
    assert fleet["windows"] == 8 and fleet["total_nj"] == 200.0
    assert set(fleet) == set(g)
    assert fleet["batches"] == 4 and fleet["padded_windows"] == 2
    # percentiles come from the CONCATENATED samples, never averaged
    # per-worker percentiles: the p50 of [1,1,1,100] ms is 1 ms
    assert out["latency_ms"]["p50"] == pytest.approx(1.0)
    assert out["latency_ms"]["p99"] > 50.0
    assert out["transport"]["fleet"]["connects"] == 3
    assert set(out["transport"]) == {"e0", "e1", "e2", "fleet"}
    assert out["servers"]["connections_total"] == 3
    assert out["windows"] == 8
    assert [w["windows"] for w in out["workers"]] == [4, 4]


def test_aggregate_rollup_equals_the_reference():
    """The same payloads through both rollups give the same document; the
    port's one added entry, each worker's ``kernel_calls``, is passed
    through under ``workers`` and nowhere else."""
    from repro.ingest import aggregate_rollup as jaggregate
    from repro.obs import MetricsRegistry as JRegistry

    def payloads(registry):
        out = []
        for i, (pats, lat) in enumerate(((["e0", "e1"], [0.004, 0.02]),
                                         (["c2"], [0.3]))):
            reg = registry()
            reg.counter("stream_windows_total", "w").inc(2, patient=pats[0])
            for x in lat:
                reg.histogram("e2e_latency_seconds", "l").observe(x)
            p = _payload({"rpeak/posit10": dict(ROW),
                          f"cough/posit{16 - 8 * i}": dict(ROW)},
                         pats, lat, 8, len(pats))
            p["escalation"] = {pats[0]: {"windows": 1, "nj": 0.5}}
            p["queue"]["dropped_by_patient"] = {pats[0]: i}
            p["digests"] = {q: f"d-{q}" for q in pats}
            p["metrics"] = reg.snapshot()
            p["scrape_port"] = 9000 + i
            out.append(p)
        return out

    from repro_torch.obs import MetricsRegistry
    got_in = payloads(MetricsRegistry)
    for i, p in enumerate(got_in):
        p["kernel_calls"] = {"posit_round": 7 + i}
    got = aggregate_rollup(got_in)
    want = jaggregate(payloads(JRegistry))
    assert [w.pop("kernel_calls") for w in got["workers"]] == \
        [p["kernel_calls"] for p in got_in]
    assert got == want


def test_partition_plans_round_robin():
    sim = FleetSimulator(n_patients=5, windows=1, mixed=False, n_cough=2)
    parts = partition_plans(sim.plans, 2)
    assert [p.patient for p in parts[0]] == \
        [sim.plans[i].patient for i in (0, 2, 4)]
    assert [p.patient for p in parts[1]] == \
        [sim.plans[i].patient for i in (1, 3)]
    assert {p.task for p in parts[0]} == {"cough", "rpeak"}


def test_sharded_workers_equal_the_inproc_run():
    """A worker with ``devices=2`` shards its dispatch over two data slabs
    of its device (``split_mesh_info``), the counterpart of the
    reference's forced host split: on a mixed fleet (cough and ECG, pinned
    formats) the pool's ledger ``windows`` and ``total_nj`` and every
    patient's digest equal one in-process engine's."""
    from repro_torch.apps.cough import train_reference_forest
    from repro_torch.stream import cough_pipeline

    sim = FleetSimulator(n_patients=4, windows=2, seed=5, mixed=True,
                         n_cough=2)
    forest = train_reference_forest(*WorkerConfig.forest_train[:2],
                                    n_trees=WorkerConfig.forest_train[2],
                                    depth=WorkerConfig.forest_train[3],
                                    device="cpu")
    ref = StreamEngine({"cough": cough_pipeline(forest),
                        "rpeak": rpeak_pipeline()}, max_batch=3,
                       result_capacity=None, device="cpu")
    sim.run_inproc(ref)
    sup = Supervisor(ref, capacity=1 << 16)
    sup.poll()
    want = _result_digests(sup)
    summary = ref.ledger.summary()

    doc = run_worker_fleet(sim, 1, devices=2, max_batch=3, device="cpu")
    assert not doc["failed_workers"]
    assert [w["devices"] for w in doc["workers"]] == [2]
    assert doc["digests"] == want and len(want) == 4
    got = doc["groups"]
    assert set(got) == set(summary)
    for k in summary:
        assert got[k]["windows"] == summary[k]["windows"], k
        assert got[k]["total_nj"] == pytest.approx(summary[k]["total_nj"],
                                                   rel=1e-12), k
    # 3 -> 4 rows over 2 slabs: the pool pads more than the pow2 engine
    assert got["fleet"]["padded_windows"] >= summary["fleet"][
        "padded_windows"]


def test_digests_hash_host_copies_of_tensor_outputs():
    """A result whose outputs are tensors hashes like the same values as
    numpy arrays (host copies with numpy's dtype string)."""
    class _Sup:
        def __init__(self, rows):
            self.queue = rows

    vals = dict(scores=np.arange(5, dtype=np.float32),
                peak_count=np.int32(2))
    as_np = WindowResult("p", "rpeak", 0, "posit10", 0.0, dict(vals))
    as_t = WindowResult("p", "rpeak", 0, "posit10", 0.0,
                        {k: torch.as_tensor(v) for k, v in vals.items()})
    assert _result_digests(_Sup([as_t])) == _result_digests(_Sup([as_np]))


# ---------------------------------------------------------------------------
# The pool: real spawned processes, ECG-only fleets on the CPU
# ---------------------------------------------------------------------------
def test_worker_pool_matches_inproc_reference():
    """Two CPU workers against the JAX engine's in-process run of the same
    fleet: the same windows per group and the same nanojoules."""
    from repro.ingest import FleetSimulator as JSim
    from repro.stream import StreamEngine as JEngine
    from repro.stream import rpeak_pipeline as jrpeak

    kw = dict(n_patients=4, windows=2, seed=5, mixed=True, n_cough=0)
    ref = JEngine({"rpeak": jrpeak()}, max_batch=4)
    JSim(**kw).run_inproc(ref)
    want = ref.ledger.summary()

    sim = FleetSimulator(**kw)
    doc = run_worker_fleet(sim, 2, max_batch=4, device="cpu")
    assert doc["n_workers"] == 2
    assert doc["windows"] == sim.expected_windows() == 8
    got = doc["groups"]
    assert set(got) == set(want)
    for k in want:
        assert got[k]["windows"] == want[k]["windows"], k
        assert got[k]["total_nj"] == pytest.approx(want[k]["total_nj"],
                                                   rel=1e-12), k
    tr = doc["transport"]["fleet"]
    assert tr["connects"] == 4 and tr["evictions"] == 0
    assert doc["servers"]["connections_total"] == 4
    assert doc["servers"]["protocol_errors"] == 0
    assert doc["servers"]["session_errors"] == 0
    assert sum(w["windows"] for w in doc["workers"]) == 8
    assert doc["wall_s"] > 0
    # CPU workers launch no kernel
    for w in doc["workers"]:
        assert set(w["kernel_calls"].values()) == {0}


def test_supervise_drain_barrier_timeout_fails_worker():
    class _StubProc:
        exitcode = None

        def __init__(self):
            self.alive = True

        def is_alive(self):
            return self.alive

        def terminate(self):
            self.alive = False

        def kill(self):
            self.alive = False

        def join(self, timeout=None):
            pass

    class _StubConn:
        closed = False

        def poll(self):
            return False

        def close(self):
            self.closed = True

    w = _Worker(wid=0, cfg=WorkerConfig(worker_id=0, tasks=(), pins=()),
                plans=[], proc=_StubProc(), conn=_StubConn(),
                port=5555, phase="draining", drain_deadline=-1.0)

    async def main():
        await asyncio.wait_for(
            _supervise(w, None, RestartPolicy(max_restarts=0), None,
                       start_timeout_s=60.0, hb_timeout_s=None), 10.0)
    proc, conn = w.proc, w.conn
    asyncio.run(main())
    assert w.failed == "drain barrier timed out"
    assert not proc.is_alive() and conn.closed
    assert w.port is None


def _digest_reference(sim, max_batch=8):
    """Fault-free per-patient digests from the port's in-process driver on
    the CPU — what a chaos pool run must reproduce bit for bit."""
    ref = StreamEngine({"rpeak": rpeak_pipeline()}, max_batch=max_batch,
                       result_capacity=None, device="cpu")
    sim.run_inproc(ref)
    sup = Supervisor(ref, capacity=1 << 16)
    sup.poll()
    return _result_digests(sup)


def test_pool_failover_kill_worker_exactly_once(tmp_path):
    """2 CPU workers, one SIGKILLed mid-stream, auth + spill armed: the
    pool respawns it, the clients replay, and every patient's digest
    matches the fault-free in-process run.  The kill is timed from the
    killed worker's ready, the drive from every worker's, so on a loaded
    host (the workers' ready times up to seconds apart) a kill 0.4 s after
    its ready lands before the drive starts and nothing is replayed.  So
    the drive replays 12 windows at 8x real time (the reference's test: 2
    at 40x), lasting ~3 s, and the kill comes 1.5 s after the ready: mid-
    stream for a spread of ready times up to 1.5 s."""
    sim = FleetSimulator(n_patients=8, windows=12, seed=6, mixed=False,
                         n_cough=0)
    want = _digest_reference(sim)
    doc = run_worker_fleet(
        sim, 2, max_batch=8, realtime_factor=8.0,
        auth_secret="s3cret", spill_dir=str(tmp_path),
        chaos=ChaosPlan(kill_worker=0, kill_after_s=1.5),
        restart_policy=RestartPolicy(max_restarts=3, backoff_s=0.05),
        device="cpu")

    assert doc["failed_workers"] == []
    assert doc["windows"] == sim.expected_windows() == 96
    assert doc["recovery"]["worker_restarts"] >= 1
    assert doc["recovery"]["recovery_s"]
    assert doc["transport"]["fleet"]["replayed_frames"] > 0
    assert doc["servers"]["auth_failures"] == 0
    assert set(doc["digests"]) == set(want)
    for pid, d in want.items():
        assert doc["digests"][pid] == d, pid


@pytest.mark.slow
def test_chaos_acceptance_64_patients(tmp_path):
    """The acceptance run at the reference's sizes: 64 ECG patients across
    2 CPU workers, one worker killed mid-stream, one patient partitioned,
    one corrupted; every digest equal to the fault-free in-process run.
    The drive replays at 8x real time, as in the test above."""
    sim = FleetSimulator(n_patients=64, windows=2, seed=0, mixed=False,
                         n_cough=0)
    want = _digest_reference(sim, max_batch=16)
    ecg = [p.patient for p in sim.plans]
    doc = run_worker_fleet(
        sim, 2, max_batch=16, realtime_factor=8.0,
        auth_secret="s3cret", spill_dir=str(tmp_path),
        chaos=ChaosPlan(kill_worker=0, kill_after_s=0.4,
                        partition_patients=(ecg[-1],),
                        partition_after_frames=2,
                        corrupt_patients=(ecg[-2],), corrupt_at_frame=1),
        restart_policy=RestartPolicy(max_restarts=3, backoff_s=0.05),
        device="cpu")

    assert doc["failed_workers"] == []
    assert doc["windows"] == sim.expected_windows() == 128
    assert doc["recovery"]["worker_restarts"] >= 1
    assert doc["recovery"]["client"]["partitions"] >= 1
    assert doc["recovery"]["client"]["corrupted_frames"] >= 1
    assert doc["transport"]["fleet"]["replayed_frames"] > 0
    assert set(doc["digests"]) == set(want)
    mismatches = [p for p, d in want.items() if doc["digests"][p] != d]
    assert mismatches == []
