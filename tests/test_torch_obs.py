"""The port's observability plane (``repro_torch.obs``) on the CPU.

* The tracer and registry tests of ``tests/test_obs.py`` against the
  port's copies: the bounded span ring, a valid Chrome export, the exact
  Prometheus round-trip, kinds, reset, the null registry, bounded
  reservoirs and snapshot merges.
* One scripted sequence of counter, gauge and histogram operations through
  ``repro.obs`` and ``repro_torch.obs``: byte-equal Prometheus pages.
* The stream engine's probes: identical passes reuse one built callable, a
  fusion-backend flip builds another and is counted.
* ``/metrics`` reconciles exactly with the ledger, the transport column
  and the supervisor's telemetry, in process and scraped over HTTP from a
  live TCP fleet; a traced TCP run equals an untraced one bit for bit.
* The serve engine's series reconcile with its ``TokenLedger``.
"""
import asyncio
import gc
import json
import warnings
import weakref

import numpy as np
import pytest
import torch

from repro_torch.apps.cough import train_reference_forest
from repro_torch.data.biosignals import cough_stream_signals
from repro_torch.ingest import (ACK, EVICTED, FleetSimulator, FrameDecoder,
                                IngestServer, ProtocolError, SessionManager,
                                Supervisor, bye, data, encode_frame, evicted,
                                hello)
from repro_torch.obs import (NULL_METRICS, MetricsRegistry, Tracer, http_get,
                             merge_snapshots, parse_prometheus, percentiles,
                             render_snapshot_prometheus,
                             validate_chrome_trace)
from repro_torch.stream import StreamEngine, cough_pipeline, rpeak_pipeline


@pytest.fixture(scope="module")
def pipelines():
    forest = train_reference_forest(24, 123, n_trees=5, depth=4,
                                    device="cpu")
    return {"cough": cough_pipeline(forest), "rpeak": rpeak_pipeline()}


def _rpeak_engine(**kw):
    return StreamEngine({"rpeak": rpeak_pipeline()}, device="cpu", **kw)


# ---------------------------------------------------------------------------
# Tracer
# ---------------------------------------------------------------------------
def test_tracer_ring_drops_oldest_and_counts():
    tr = Tracer(capacity=4)
    for i in range(7):
        t = tr.now()
        tr.complete("stage", f"s{i}", t, t + 1e-6)
    assert len(tr) == 4 and tr.dropped == 3
    assert [ev[2] for ev in tr.events()] == ["s3", "s4", "s5", "s6"]
    assert tr.chrome_trace()["otherData"]["dropped_events"] == 3
    tr.reset()
    assert len(tr) == 0 and tr.dropped == 0


def test_tracer_chrome_export_is_valid_and_tracked(tmp_path):
    tr = Tracer()
    t0 = tr.now()
    tr.complete("dispatch", "cough/posit16", t0, t0 + 2e-3,
                track="dispatch", args={"B": 4})
    tr.complete("stage", "ready->dispatch", t0, t0 + 1e-3, track="p-0")
    tr.instant("session", "deliver", track="p-0", args={"seq": 3})
    path = tmp_path / "trace.json"
    tr.export(str(path))
    doc = json.loads(path.read_text())
    events = validate_chrome_trace(doc)
    assert len(events) == 3
    assert {e["cat"] for e in events} == {"dispatch", "stage", "session"}
    by_name = {e["name"]: e for e in events}
    assert by_name["ready->dispatch"]["tid"] == by_name["deliver"]["tid"]
    meta = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert {m["args"]["name"] for m in meta} == {"dispatch", "p-0"}
    assert by_name["cough/posit16"]["dur"] == pytest.approx(2e3, rel=1e-6)
    with pytest.raises(ValueError):
        validate_chrome_trace({"traceEvents": [{"ph": "X", "pid": 0}]})
    with pytest.raises(ValueError):
        validate_chrome_trace({})


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------
def test_prometheus_render_parse_roundtrips_exact_floats():
    reg = MetricsRegistry()
    c = reg.counter("frames_total", "frames seen")
    c.inc(3, patient="p-0")
    c.inc(0.1 + 0.2, patient="p-1")
    reg.gauge("nj_per_window", "energy").set(1144.0961538461538, group="fleet")
    h = reg.histogram("latency_seconds", "e2e")
    for v in (0.001, 0.002, 0.004, 0.008):
        h.observe(v, patient="p-0")
    text = reg.render_prometheus()
    assert "# TYPE frames_total counter" in text
    assert "# TYPE nj_per_window gauge" in text
    assert "# TYPE latency_seconds summary" in text
    got = parse_prometheus(text)
    assert got[("frames_total", (("patient", "p-0"),))] == 3.0
    assert got[("frames_total", (("patient", "p-1"),))] == 0.1 + 0.2
    assert got[("nj_per_window", (("group", "fleet"),))] == 1144.0961538461538
    assert got[("latency_seconds_count", (("patient", "p-0"),))] == 4.0
    assert got[("latency_seconds_sum", (("patient", "p-0"),))] == 0.015
    q50 = got[("latency_seconds", (("patient", "p-0"), ("quantile", "0.5")))]
    assert q50 == percentiles([0.001, 0.002, 0.004, 0.008])["p50"]


def test_registry_kind_collisions_and_idempotent_handles():
    reg = MetricsRegistry()
    a = reg.counter("x_total")
    assert reg.counter("x_total") is a
    with pytest.raises(TypeError):
        reg.gauge("x_total")
    reg.gauge("g")
    with pytest.raises(TypeError):
        reg.counter("g")
    with pytest.raises(TypeError):
        reg.histogram("g")


def test_registry_reset_clears_values_keeps_registrations():
    reg = MetricsRegistry()
    c = reg.counter("n_total")
    c.inc(5)
    seen = []
    reg.register_collector(lambda: seen.append(1))
    reg.reset()
    assert c.total() == 0.0
    assert reg.counter("n_total") is c
    reg.snapshot()
    assert seen == [1]


def test_null_registry_is_inert():
    c = NULL_METRICS.counter("anything", "ignored")
    c.inc(5, patient="p")
    NULL_METRICS.histogram("h").observe(1.0)
    NULL_METRICS.register_collector(lambda: 1 / 0)
    assert not NULL_METRICS.enabled
    assert NULL_METRICS.render_prometheus() == ""
    assert NULL_METRICS.snapshot() == {"counters": {}, "gauges": {},
                                       "histograms": {}}
    assert c.value(patient="p") == 0.0 and c.samples() == []


def test_histogram_reservoir_is_bounded():
    h = MetricsRegistry().histogram("lat", reservoir=8)
    for i in range(100):
        h.observe(float(i), patient="p")
    assert h.count(patient="p") == 100
    assert h.samples(patient="p") == [float(i) for i in range(92, 100)]


def test_merged_fleet_p50_is_not_the_mean_of_worker_p50s():
    a, b = MetricsRegistry(), MetricsRegistry()
    for v in (1.0, 2.0, 3.0, 4.0, 5.0):
        a.histogram("lat").observe(v)
    for v in (100.0, 200.0, 300.0):
        b.histogram("lat").observe(v)
    merged = merge_snapshots([a.snapshot(), b.snapshot()])
    samples = merged["histograms"]["lat"]["series"][0][1]["samples"]
    assert sorted(samples) == [1, 2, 3, 4, 5, 100, 200, 300]
    mean_of_p50s = (percentiles([1, 2, 3, 4, 5])["p50"]
                    + percentiles([100, 200, 300])["p50"]) / 2
    assert percentiles(samples)["p50"] != mean_of_p50s


def test_merged_counters_sum_exactly_to_in_process_reference():
    traffic = [("p-0", 3), ("p-1", 5), ("p-0", 2), ("p-2", 7), ("p-1", 1)]
    workers = [MetricsRegistry(), MetricsRegistry()]
    ref = MetricsRegistry()
    for i, (patient, n) in enumerate(traffic):
        workers[i % 2].counter("windows_total").inc(n, patient=patient)
        ref.counter("windows_total").inc(n, patient=patient)
    merged = merge_snapshots([w.snapshot() for w in workers])
    assert merged["counters"]["windows_total"]["series"] == \
        ref.snapshot()["counters"]["windows_total"]["series"]
    got = parse_prometheus(render_snapshot_prometheus(merged))
    for patient, want in (("p-0", 5.0), ("p-1", 6.0), ("p-2", 7.0)):
        assert got[("windows_total", (("patient", patient),))] == want


def _script(obs):
    """One fixed sequence of registry operations, reservoir overflow and a
    collector included, on either package's registry."""
    reg = obs.MetricsRegistry()
    c = reg.counter("frames_total", "frames seen")
    for i in range(20):
        c.inc(0.1 * i, patient=f"p-{i % 3}", kind="data")
    c.inc(7)
    g = reg.gauge("nj_per_window", "energy")
    g.set(1144.0961538461538, group="fleet")
    g.set(-0.0, group="cough/posit16")
    h = reg.histogram("latency_seconds", "e2e", reservoir=5)
    rng = np.random.default_rng(3)
    for v in rng.exponential(1e-3, 17):
        h.observe(float(v), patient=f"p-{int(v * 1e4) % 2}")
    depth = reg.gauge("queue_depth", "collected")
    reg.register_collector(lambda: depth.set(12.5))
    return reg


def test_prometheus_pages_byte_equal_the_reference():
    import repro.obs as jobs

    import repro_torch.obs as tobs
    treg, jreg = _script(tobs), _script(jobs)
    assert treg.render_prometheus() == jreg.render_prometheus()
    assert tobs.render_snapshot_prometheus(treg.snapshot()) == \
        jobs.render_snapshot_prometheus(jreg.snapshot())
    assert tobs.parse_prometheus(jreg.render_prometheus()) == \
        jobs.parse_prometheus(treg.render_prometheus())


# ---------------------------------------------------------------------------
# EVICTED notices
# ---------------------------------------------------------------------------
def test_evicted_frame_roundtrip_and_direction():
    (g,) = FrameDecoder().feed(encode_frame(evicted("ecg-031", "rpeak",
                                                    "stall")))
    assert g.ftype == EVICTED and g.patient == "ecg-031"
    assert g.task == "rpeak" and g.modality == "stall" and g.payload is None
    sm = SessionManager(_rpeak_engine())
    sm.on_frame(hello("p", "rpeak"), now=0.0)
    with pytest.raises(ProtocolError):
        sm.on_frame(evicted("p", "rpeak", "stall"), now=0.0)


def test_evicted_notice_delivery_counted_by_reason():
    eng = _rpeak_engine()
    sm = SessionManager(eng, stall_timeout_s=1.0)
    sent = []
    sm.register_sender("p-0", sent.append)
    sm.on_frame(hello("p-0", "rpeak"), now=0.0)
    sm.on_frame(data("p-0", "rpeak", "ecg", 0, np.zeros((1, 500))), now=0.0)
    sm.on_frame(bye("p-0", "rpeak"), now=0.5)
    assert len(sent) == 1
    f = FrameDecoder().feed(sent[0])[0]
    assert f.ftype == EVICTED and f.modality == "bye"
    sm.on_frame(hello("p-1", "rpeak"), now=1.0)
    sm.on_frame(data("p-1", "rpeak", "ecg", 0, np.zeros((1, 500))), now=1.0)
    assert sm.reap(now=3.0) == ["p-1"]
    c = eng.metrics.counter("ingest_evicted_notices_total")
    assert c.value(reason="bye", delivered="true") == 1
    assert c.value(reason="stall", delivered="false") == 1


def test_evicted_notice_reaches_tcp_client():
    eng = _rpeak_engine()

    async def main():
        sm = SessionManager(eng, stall_timeout_s=0.3)
        async with IngestServer(sm, port=0, reap_interval_s=0.05) as srv:
            reader, writer = await asyncio.open_connection("127.0.0.1",
                                                           srv.port)
            writer.write(encode_frame(hello("p-0", "rpeak")))
            writer.write(encode_frame(
                data("p-0", "rpeak", "ecg", 0, np.zeros((1, 500)))))
            await writer.drain()
            dec, frames = FrameDecoder(), []
            deadline = asyncio.get_event_loop().time() + 5.0
            while not any(f.ftype == EVICTED for f in frames):
                budget = deadline - asyncio.get_event_loop().time()
                raw = await asyncio.wait_for(reader.read(1 << 16),
                                             timeout=max(budget, 0.01))
                frames.extend(dec.feed(raw))
            writer.close()
            return frames

    frames = asyncio.run(main())
    assert frames[-1].ftype == EVICTED
    assert all(f.ftype == ACK for f in frames[:-1])
    assert frames[-1].patient == "p-0" and frames[-1].modality == "stall"
    assert eng.ledger.transport_summary()["p-0"]["evictions"] == 1
    c = eng.metrics.counter("ingest_evicted_notices_total")
    assert c.value(reason="stall", delivered="true") == 1


# ---------------------------------------------------------------------------
# Supervisor attribution and the program-cache probes
# ---------------------------------------------------------------------------
def test_supervisor_attributes_queue_drops_per_patient(pipelines):
    eng = StreamEngine({"cough": pipelines["cough"]}, max_batch=4,
                       result_capacity=None, device="cpu")
    sup = Supervisor(eng, capacity=3)
    a, i, _ = cough_stream_signals(6, seed=3)
    for k in range(2):
        eng.ingest(f"c-{k}", "cough", "audio", a)
        eng.ingest(f"c-{k}", "cough", "imu", i)
    eng.drain()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        sup.poll()
    assert sup.dropped == 9
    by_patient = sup.dropped_by_patient()
    assert sum(by_patient.values()) == 9 and set(by_patient) <= {"c-0", "c-1"}
    c = eng.metrics.counter("result_queue_dropped_total")
    assert {d["patient"]: int(v) for d, v in c.items()} == by_patient
    msgs = [str(x.message) for x in w
            if issubclass(x.category, RuntimeWarning)]
    assert len(msgs) == 4 and "most-dropped" in msgs[-1]
    worst = max(by_patient, key=by_patient.get)
    assert f"{worst}={by_patient[worst]}" in msgs[-1]
    tele = sup.telemetry()
    assert tele["queue"]["dropped_by_patient"] == by_patient
    assert tele["queue"]["dropped"] == 9


def test_retrace_guard_stable_program_count_across_identical_passes():
    from repro_torch.core.arith import backend_overrides
    eng = _rpeak_engine(max_batch=2, result_capacity=None)
    sig = np.random.default_rng(0).normal(size=(1, 1000))
    programs = eng.metrics.counter("jit_programs_total")
    hits = eng.metrics.counter("jit_cache_hits_total")
    eng.ingest("p-0", "rpeak", "ecg", sig)
    eng.drain()
    n0 = programs.total()
    assert n0 == 1
    eng.ingest("p-1", "rpeak", "ecg", sig)
    eng.drain()
    assert programs.total() == n0 and hits.total() >= 1
    changes = eng.metrics.counter("jit_fusion_key_changes_total")
    with backend_overrides(fused="off"):
        eng.ingest("p-2", "rpeak", "ecg", sig)
        eng.drain()
    assert programs.total() == n0 + 1
    assert changes.value(site="stream") == 1


# ---------------------------------------------------------------------------
# Reconciliation: /metrics ≡ the ledgers
# ---------------------------------------------------------------------------
def _assert_page_reconciles(got, eng, sup):
    for group, row in eng.ledger.summary().items():
        for k, v in row.items():
            assert got[(f"stream_{k}", (("group", group),))] == float(v), \
                (group, k)
    for patient, counters in eng.ledger.transport_summary().items():
        for field, v in counters.items():
            key = ("ingest_transport", (("counter", field),
                                        ("patient", patient)))
            assert got[key] == float(v), (patient, field)
    tele = sup.telemetry()
    assert got[("result_queue_depth", ())] == tele["queue"]["depth"]
    windows = {dict(labels)["patient"]: v for (name, labels), v in got.items()
               if name == "stream_windows_total"}
    assert sum(windows.values()) == tele["queue"]["total_windows"]
    for pid, row in tele["patients"].items():
        assert row["windows"] == windows[pid]
    return tele


def test_scraped_metrics_reconcile_exactly_with_ledger_and_telemetry(
        pipelines):
    sim = FleetSimulator(n_patients=6, windows=2, seed=5, mixed=True)
    eng = StreamEngine(pipelines, max_batch=8, pad_policy="max",
                       result_capacity=None, device="cpu")
    sup = Supervisor(eng, capacity=512)
    sim.run_inproc(eng)
    sup.poll()
    got = parse_prometheus(eng.metrics.render_prometheus())
    tele = _assert_page_reconciles(got, eng, sup)
    assert tele["queue"]["total_windows"] == 12


def _run_tcp_fleet(engine, sim, scrape=False):
    sup = Supervisor(engine, capacity=8192)
    scraped = {}

    async def main():
        sm = SessionManager(engine, stall_timeout_s=1.0)
        sim.pin_all(engine)
        async with IngestServer(sm, port=0, reap_interval_s=0.2,
                                supervisor=sup,
                                scrape_port=0 if scrape else None) as srv:
            done = [False]
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
            await pump
            if scrape:
                scraped["metrics"] = await http_get(
                    "127.0.0.1", srv.scrape_port, "/metrics")
                scraped["telemetry"] = json.loads(await http_get(
                    "127.0.0.1", srv.scrape_port, "/telemetry"))
                with pytest.raises(RuntimeError):
                    await http_get("127.0.0.1", srv.scrape_port, "/nope")

    asyncio.run(main())
    engine.drain()
    sup.poll()
    return sup, scraped.get("metrics"), scraped.get("telemetry")


def test_scrape_endpoint_over_live_tcp_fleet():
    """An ECG fleet (no stall timer near a long dispatch) over TCP with the
    scrape plane armed: the page scraped over HTTP reconciles exactly."""
    sim = FleetSimulator(n_patients=4, windows=2, seed=9, mixed=True,
                         n_cough=0)
    eng = _rpeak_engine(max_batch=4, pad_policy="max", result_capacity=None)
    sup, text, tele = _run_tcp_fleet(eng, sim, scrape=True)
    got = parse_prometheus(text)
    _assert_page_reconciles(got, eng, sup)
    assert sup.total_windows == 8 and tele["queue"]["total_windows"] == 8
    assert tele["server"]["connections_total"] >= 4
    assert set(tele["latency_ms"]) == {"p50", "p90", "p99"}


def test_traced_tcp_fleet_bit_identical_to_untraced():
    def build():
        return FleetSimulator(n_patients=8, windows=2, seed=0, mixed=True,
                              n_cough=0, dup_rate=0.1, defer_rate=0.1,
                              stall_after={"ecg-005": 1})
    tracer = Tracer()
    runs = {}
    for arm, kw in (("traced", dict(metrics=MetricsRegistry(),
                                    tracer=tracer)),
                    ("untraced", dict(metrics=NULL_METRICS, tracer=None))):
        eng = _rpeak_engine(max_batch=4, pad_policy="max",
                            result_capacity=None, **kw)
        sup, _, _ = _run_tcp_fleet(eng, build())
        runs[arm] = (eng, {(r.patient, r.widx): r for r in sup.pop()})
    (eng_t, rows_t), (eng_u, rows_u) = runs["traced"], runs["untraced"]
    assert rows_t.keys() == rows_u.keys() and rows_t
    for key, r in rows_t.items():
        assert r.fmt == rows_u[key].fmt
        for k, v in r.outputs.items():
            np.testing.assert_array_equal(v, rows_u[key].outputs[k])
    for patient in {k[0] for k in rows_t}:
        assert eng_t.tracker_for(patient, "rpeak").peaks == \
            eng_u.tracker_for(patient, "rpeak").peaks
    tt = eng_t.ledger.transport_summary()
    tu = eng_u.ledger.transport_summary()
    for patient in tt:
        for col in ("frames", "bytes", "dup_frames", "reordered_frames",
                    "gap_events", "connects", "evictions"):
            assert tt[patient][col] == tu[patient][col], (patient, col)
    assert tt["ecg-005"]["evictions"] == 1
    cats = {e["cat"] for e in validate_chrome_trace(tracer.chrome_trace())}
    assert {"frame", "session", "stage", "dispatch", "drain"} <= cats


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
def test_serving_metrics_reconcile_with_token_ledger():
    from repro_torch.configs import CONFIGS, reduced
    from repro_torch.models import build_model
    from repro_torch.serve import ServeConfig, ServingEngine
    cfg = reduced(CONFIGS["qwen3-8b"])
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tracer = Tracer()
    eng = ServingEngine(model, params,
                        ServeConfig(batch_size=2, max_prompt=8,
                                    max_new_tokens=3, seed=0),
                        device="cpu", tracer=tracer)
    rng = np.random.default_rng(0)
    for n in (5, 6, 3):
        eng.submit(rng.integers(1, cfg.vocab, size=n).astype(np.int32))
    comps = eng.run()
    assert len(comps) == 3
    got = parse_prometheus(eng.metrics.render_prometheus())
    for lane, row in eng.ledger.summary().items():
        for k, v in row.items():
            assert got[(f"serve_{k}", (("lane", lane),))] == float(v), \
                (lane, k)
    assert eng.metrics.counter("serve_completions_total").total() == 3
    programs = eng.metrics.counter("jit_programs_total")
    # one decode callable for the lane, one prefill shape for bucket 8,
    # one for bucket 4; the second length-5..8 prompt reuses bucket 8
    assert programs.value(site="serve.decode", lane=eng.policy.lane) == 1
    assert programs.value(site="serve.prefill", lane=eng.policy.lane) == 2
    assert eng.metrics.counter("jit_cache_hits_total").total() == 1
    names = {e["name"] for e in validate_chrome_trace(tracer.chrome_trace())}
    assert {"admit", "prefill", "decode", "retire"} <= names


def test_bound_engines_are_freed_without_a_collection():
    """The bridges hold their engine weakly: dropping a bound engine frees
    it (and a serve engine's weights) at once, with no cycle left for the
    garbage collector; the registry it shared still renders."""
    from repro_torch.configs import CONFIGS, reduced
    from repro_torch.models import build_model
    from repro_torch.serve import ServeConfig, ServingEngine
    model = build_model(reduced(CONFIGS["qwen3-8b"]), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    registry = MetricsRegistry()
    engines = [StreamEngine({"rpeak": rpeak_pipeline()}, device="cpu",
                            metrics=registry),
               ServingEngine(model, params, ServeConfig(), device="cpu",
                             metrics=registry)]
    assert "stream_windows" in registry.render_prometheus()
    refs = [weakref.ref(e) for e in engines]
    gc.disable()
    try:
        del engines
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()
    assert "stream_windows{" in registry.render_prometheus()
