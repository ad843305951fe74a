"""The port's span tree (``repro_torch.obs.trace``), on the CPU: spans with
parents and self times, the no-op span when no tracer is current, the
stream engine's tree over a tiny mixed fleet and the serve engine's over
a tiny ``moe`` model, each child inside its parent, and the outputs and
tokens bit-identical traced and untraced.
"""
import numpy as np
import pytest
import torch

from repro_torch.apps.cough import train_reference_forest
from repro_torch.ingest import FleetSimulator
from repro_torch.obs import Tracer
from repro_torch.obs import trace as obs_trace
from repro_torch.stream import StreamEngine, cough_pipeline, rpeak_pipeline


def _spans(tracer):
    """{id: event} of the spans opened with ``span``."""
    return {ev[7]: ev for ev in tracer.events() if ev[0] == "X" and ev[7]}


def _children(spans):
    kids = {}
    for ev in spans.values():
        kids.setdefault(ev[8], []).append(ev)
    return kids


def _assert_nested(spans):
    """Every span's parent is recorded and holds it in time."""
    for ev in spans.values():
        if ev[8]:
            parent = spans[ev[8]]
            assert parent[3] <= ev[3] and ev[4] <= parent[4], (ev, parent)


def _tree(spans):
    """{parent name (None: a root): set of its children's names}."""
    out = {}
    for ev in spans.values():
        parent = spans[ev[8]][2] if ev[8] else None
        out.setdefault(parent, set()).add(ev[2])
    return out


# ---------------------------------------------------------------------------
# The tracer
# ---------------------------------------------------------------------------
def test_spans_carry_parents_and_self_times():
    tr = Tracer()
    with obs_trace.use(tr):
        assert obs_trace.current() is tr
        with obs_trace.span("a", "outer", k=1) as outer:
            with obs_trace.span("a", "inner"):
                pass
            with obs_trace.span("a", "inner") as second:
                second.at(outer.start + 1.0, outer.start + 3.0)
            outer.at(outer.start, outer.start + 10.0)
        with obs_trace.span("a", "root"):
            pass
    assert obs_trace.current() is None
    spans = _spans(tr)
    by_name = {}
    for ev in spans.values():
        by_name.setdefault(ev[2], []).append(ev)
    (o,) = by_name["outer"]
    assert o[6] == {"k": 1} and o[8] == 0
    assert [ev[8] for ev in by_name["inner"]] == [o[7], o[7]]
    assert by_name["root"][0][8] == 0
    st = tr.self_times()
    assert st["outer"]["count"] == 1 and st["inner"]["count"] == 2
    assert st["outer"]["total_s"] == pytest.approx(10.0)
    inner_total = st["inner"]["total_s"]
    assert inner_total == pytest.approx(2.0, abs=1e-3)
    assert st["outer"]["self_s"] == pytest.approx(10.0 - inner_total)
    assert st["inner"]["self_s"] == st["inner"]["total_s"]
    doc = tr.chrome_trace()
    events = obs_trace.validate_chrome_trace(doc)
    inner_ev = [e for e in events if e["name"] == "inner"]
    assert all(e["args"]["parent"] == o[7] for e in inner_ev)
    assert {e["tid"] for e in events} == {0}


def test_self_time_merges_overlapping_children():
    tr = Tracer()
    with obs_trace.use(tr):
        with obs_trace.span("a", "p") as p:
            for a, b in ((1.0, 4.0), (2.0, 5.0), (8.0, 12.0)):
                with obs_trace.span("a", "c") as c:
                    c.at(p.start + a, p.start + b)
            p.at(p.start, p.start + 10.0)
    # children cover [1, 5] and [8, 10] of [0, 10]
    assert tr.self_times()["p"]["self_s"] == pytest.approx(4.0)


def test_span_without_a_current_tracer_is_a_shared_no_op():
    assert obs_trace.current() is None
    s = obs_trace.span("a", "x", k=1)
    assert s is obs_trace.span("b", "y")
    assert not isinstance(s, obs_trace.Span)
    with s as inner:
        inner.at(0.0, 1.0)
    with obs_trace.use(None):
        assert obs_trace.span("a", "x") is s


def test_use_restores_the_tracer_before_it_on_an_exception():
    outer, inner = Tracer(), Tracer()
    with obs_trace.use(outer):
        with pytest.raises(RuntimeError):
            with obs_trace.use(inner), obs_trace.span("a", "x"):
                assert obs_trace.current() is inner
                raise RuntimeError("boom")
        assert obs_trace.current() is outer
        assert [ev[2] for ev in inner.events()] == ["x"]
    assert obs_trace.current() is None and not outer.events()


def test_traced_entry_point_makes_its_tracer_current():
    class Engine:
        def __init__(self, tracer):
            self.tracer = tracer

        @obs_trace.traced("e", "e.call")
        def call(self):
            with obs_trace.span("e", "e.inner"):
                return obs_trace.current()

    tr = Tracer()
    assert Engine(tr).call() is tr
    assert Engine(None).call() is None
    assert _tree(_spans(tr)) == {None: {"e.call"}, "e.call": {"e.inner"}}


# ---------------------------------------------------------------------------
# The stream engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def forest():
    return train_reference_forest(24, 123, n_trees=5, depth=4, device="cpu")


def _fleet(forest, tracer):
    eng = StreamEngine({"cough": cough_pipeline(forest),
                        "rpeak": rpeak_pipeline()}, max_batch=4,
                       pad_policy="max", result_capacity=None,
                       device="cpu", tracer=tracer)
    FleetSimulator(n_patients=6, windows=3, seed=0).run_inproc(eng)
    return eng


def test_stream_engine_span_tree_nests_and_matches_the_ledger(forest):
    tracer = Tracer(capacity=1 << 16)
    eng = _fleet(forest, tracer)
    assert tracer.dropped == 0
    spans = _spans(tracer)
    _assert_nested(spans)
    tree = _tree(spans)
    assert tree[None] == {"stream.ingest", "stream.pump", "stream.finalize"}
    assert tree["stream.ingest"] == {"stream.pump"}
    assert tree["stream.pump"] == {"stream.stage", "stream.dispatch",
                                   "stream.track"}
    assert tree["stream.dispatch"] == {"cough.fft", "cough.spectral",
                                       "cough.mfcc", "cough.forest",
                                       "rpeak.scores"}
    assert tree["stream.track"] == {"rpeak.threshold", "rpeak.stitch"}
    assert tree["stream.finalize"] == {"rpeak.stitch"}
    by_name = {}
    for ev in spans.values():
        by_name.setdefault(ev[2], []).append(ev)
    # the dispatch node is the ledger's latency_s, dispatch for dispatch
    stats = eng.ledger.stats.values()
    assert len(by_name["stream.dispatch"]) == sum(g.batches for g in stats)
    assert sum(ev[4] - ev[3] for ev in by_name["stream.dispatch"]) == \
        pytest.approx(sum(g.latency_s for g in stats), rel=1e-9)
    assert all(ev[1] == "dispatch" for ev in by_name["stream.dispatch"])
    assert sum(ev[6]["B"] for ev in by_name["stream.dispatch"]) == \
        sum(g.windows for g in stats)
    # one tracker span a scored ECG window, with its 2-means iterations
    rpeak = [r for r in eng.results if r.task == "rpeak"]
    track = by_name["stream.track"]
    assert sorted((ev[6]["patient"], ev[6]["widx"]) for ev in track) == \
        sorted((r.patient, r.widx) for r in rpeak)
    assert {ev[6]["iters"] for ev in by_name["rpeak.threshold"]} == {12}
    # the CPU takes the 2-means's per-op path (the card its kernel)
    assert {ev[6]["route"] for ev in by_name["rpeak.threshold"]} == {"ops"}
    # the dispatch ends before its windows are tracked, and a result's
    # done_wall comes after its window's tracking
    disp = sorted((ev[3], ev[4]) for ev in by_name["stream.dispatch"])
    track_end = {}
    for ev in track:
        last = max(d for d in disp if d[0] <= ev[3])
        assert last[1] <= ev[3]
        track_end[(ev[6]["patient"], ev[6]["widx"])] = ev[4]
    assert all(track_end[(r.patient, r.widx)] <= r.done_wall for r in rpeak)
    # the lifecycle spans stay for the Perfetto view
    assert {"stage", "dispatch", "stream"} <= tracer.categories()


def test_traced_fleet_bit_identical_to_untraced(forest):
    traced = _fleet(forest, Tracer())
    plain = _fleet(forest, None)
    got = {(r.patient, r.widx): r for r in traced.results}
    want = {(r.patient, r.widx): r for r in plain.results}
    assert got.keys() == want.keys() and got
    for key, r in got.items():
        assert r.fmt == want[key].fmt
        for k, v in r.outputs.items():
            np.testing.assert_array_equal(v, want[key].outputs[k])


# ---------------------------------------------------------------------------
# The serve engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def moe_model():
    from repro_torch.configs import CONFIGS, reduced
    from repro_torch.models import build_model
    cfg = reduced(CONFIGS["granite-moe-3b-a800m"])
    model = build_model(cfg, device="cpu")
    return model, model.init(torch.Generator().manual_seed(0))


def _serve(moe_model, tracer):
    from repro_torch.serve import ServeConfig, ServePolicy, ServingEngine
    model, params = moe_model
    eng = ServingEngine(model, params,
                        ServeConfig(batch_size=2, max_prompt=8,
                                    max_new_tokens=3, seed=0),
                        ServePolicy(weights="posit16", kv="posit8"),
                        device="cpu", tracer=tracer)
    rng = np.random.default_rng(0)
    rids = [eng.submit(rng.integers(1, model.cfg.vocab, size=n)
                       .astype(np.int32)) for n in (5, 7, 3)]
    by_rid = {c.rid: c.tokens for c in eng.run()}
    return eng, [by_rid[r] for r in rids]


def test_serve_engine_span_tree_nests_per_layer(moe_model):
    tracer = Tracer()
    eng, _ = _serve(moe_model, tracer)
    spans = _spans(tracer)
    _assert_nested(spans)
    tree = _tree(spans)
    layer = {"model.embed", "model.attention", "model.moe", "model.unembed"}
    assert tree[None] == {"serve.step"}
    assert tree["serve.step"] == {"serve.admit", "serve.decode",
                                  "serve.account"}
    assert tree["serve.admit"] == {"serve.prefill"}
    assert tree["serve.prefill"] == layer | {"serve.sample"}
    assert tree["serve.decode"] == layer | {"serve.sample"}
    assert tree["model.moe"] == {"moe.route", "moe.experts", "moe.combine"}
    kids = _children(spans)
    n_layers = eng.model.cfg.n_layers
    g = eng.ledger.stats[eng.policy.lane]
    decodes = [ev for ev in spans.values() if ev[2] == "serve.decode"]
    prefills = [ev for ev in spans.values() if ev[2] == "serve.prefill"]
    assert len(decodes) == g.decode_steps and len(prefills) == g.requests
    for ev in decodes + prefills:
        names = [c[2] for c in kids[ev[7]]]
        assert names.count("model.moe") == n_layers
        assert names.count("model.attention") == n_layers
    # the decode and prefill nodes are the ledger's own stamps
    assert sum(ev[4] - ev[3] for ev in decodes) == \
        pytest.approx(g.decode_s, rel=1e-9)
    assert sum(ev[4] - ev[3] for ev in prefills) == \
        pytest.approx(g.prefill_s, rel=1e-9)
    assert sum(ev[6]["rows"] for ev in decodes) == g.decode_tokens


def test_traced_serve_tokens_bit_identical_to_untraced(moe_model):
    _, traced = _serve(moe_model, Tracer())
    _, plain = _serve(moe_model, None)
    assert len(traced) == 3
    for a, b in zip(traced, plain):
        np.testing.assert_array_equal(a, b)
