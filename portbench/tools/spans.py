"""Read the program's span tree in a cell's traced window on the card: the
span metrics, the idle gaps named by the program's spans, how much of the
window and of each step the spans cover, whether the host and device
clocks agree, and what tracing costs.

    python3 portbench/tools/spans.py --workload <name> --seed 11 \
        [--cost-rounds 2]

One seed a process, as a benchmark run has it.  The cell's set-up;
``--cost-rounds`` rounds of an untraced and a traced unit in turns
(untraced, traced, traced, untraced, ...: a fleet pass, or
``trace_steps`` engine steps), the traced one with a ``Tracer`` on the
engine, timed on the host clock (a serve unit also by its decode steps'
mean, from the ledger), the traced units' spans read on the host clock
alone (no profiler); then the cell's traced window (the driver's
``traced_window`` under ``harness.Traced``) with a ``Tracer`` on the
engine, its spans mapped onto the device clock by
``portbench/lib/spans.py`` and read by the readers in
``portbench/metrics`` that take them.  One JSON line on standard output,
also written to ``chiprun_out/spans-<cell>-<seed>.json``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
READERS = {"fleet_backlog": ("track_ms.backlog", "ingest_ms.backlog",
                             "dispatch_busy_ms.backlog"),
           "serve_closed": ("decode_busy_ms.serve", "moe_ms.serve",
                            "step_overhead_ms.serve")}
ROOTS = ("stream.ingest", "stream.pump", "stream.finalize")
STEP_PARTS = ("serve.admit", "serve.decode", "serve.account")
DECODE_PARTS = ("model.embed", "model.attention", "model.moe", "moe.route",
                "moe.experts", "moe.combine", "model.unembed",
                "serve.sample")


def cost(run, kind: str, rounds: int):
    """Each untraced and traced unit, in turns: its host seconds (and a
    serve unit's mean decode step, ms), and the traced units' span
    metrics read with no profiler running."""
    import types

    from portbench.lib import spans
    from repro_torch.obs import Tracer
    out = {"untraced": [], "traced": []}
    order = []
    for r in range(rounds):
        order += ["untraced", "traced"] if r % 2 == 0 else ["traced",
                                                            "untraced"]
    for k, arm in enumerate(order):
        tracer = Tracer(capacity=1 << 20) if arm == "traced" else None
        run.engine.tracer = tracer
        g0 = None if kind == "fleet_backlog" else \
            dict(vars(run.engine.ledger.stats[run.lane]))
        t = time.perf_counter()
        if kind == "fleet_backlog":
            run._pass(f"cost{k}")
        else:
            for _ in range(run.t["trace_steps"]):
                run._step()
        t1 = time.perf_counter()
        run.engine.tracer = None
        unit = {"wall_s": t1 - t}
        if g0 is not None:
            g1 = vars(run.engine.ledger.stats[run.lane])
            steps = g1["decode_steps"] - g0["decode_steps"]
            unit["decode_ms"] = 1e3 * (g1["decode_s"] - g0["decode_s"]) \
                / max(steps, 1)
        if tracer is not None:
            host = types.SimpleNamespace(t0=t, closed_at=t1, events=[],
                                         _origin_us=0.0)
            ctx = {"spans": spans.map_spans(tracer, host)}
            unit["readings"] = {m: reader(m).read(ctx)
                                for m in READERS[kind]}
            unit["spans"] = len(tracer)
        out[arm].append(unit)
    return out


def reader(m: str):
    from portbench.lib import harness
    return harness._load_module(harness.BENCH / "metrics" / f"{m}.py",
                                "portbench_metric_" + m.replace(".", "_"))


def clock(sp, name: str, tr):
    """How the named spans hold their device events; the lags of the
    window's first and last thirds apart, since a drift between the two
    clocks would move them and an offset would not."""
    rows = sp.named(name)
    lags = [x for x in (sp.first_kernel_lag_us(s) for s in rows)
            if x is not None]
    third = tr.window_s / 3

    def lag_median(lo, hi):
        xs = [x for x in (sp.first_kernel_lag_us(s) for s in rows
                          if lo <= s.start - tr.t0 < hi) if x is not None]
        return statistics.median(xs) if xs else None
    held = [sp.holds_its_events(s) for s in rows if sp.events_in(s)]
    over = [max((st + d for _, st, d in sp.events_in(s)),
                default=s.dev_end) - s.dev_end for s in rows]
    return {"spans": len(rows), "with_events": len(held),
            "inside_share": sum(held) / len(held) if held else None,
            "lag_us_median": statistics.median(lags) if lags else None,
            "lag_us_max": max(lags) if lags else None,
            "lag_us_median_thirds": [lag_median(0, third),
                                     lag_median(2 * third, 3 * third)],
            "overrun_us_max": max(over) if over else None,
            "host_ms_mean": 1e3 * statistics.mean(s.dur for s in rows)
            if rows else None}


def split(sp, names, per: float):
    """Total self (``self``) or whole (``whole``) host seconds of each
    named span over ``per``."""
    out = {}
    for n in names:
        rows = sp.named(n)
        out[n] = {"count": len(rows),
                  "whole": sum(s.dur for s in rows) / per,
                  "self": sum(sp.self_s(s) for s in rows) / per}
    return out


def measure(cell, seed: int, dev, cost_rounds: int) -> dict:
    """One seed of a cell: set-up, the cost rounds, the traced window."""
    from portbench.lib import harness, spans
    from repro_torch.obs import Tracer
    kind = cell.traffic["driver"]
    run = harness._load_module(harness.BENCH / "traffic" / f"{kind}.py",
                               f"portbench_traffic_{kind}").Run(cell, seed,
                                                                dev)
    run.setup()
    row = {"seed": seed, "cell": cell.name,
           "cost": cost(run, kind, cost_rounds)}
    tracer = Tracer(capacity=1 << 20)
    run.engine.tracer = tracer
    with harness.Traced() as tr:
        run.traced_window(tr)
    run.engine.tracer = None
    sp = spans.map_spans(tracer, tr)
    ctx = {"traced": tr, "spans": sp}
    row["metrics"] = {m: reader(m).read(ctx) for m in READERS[kind]}
    row.update(window_s=tr.window_s, busy_s=tr.busy_s(),
               events=len(tr.events), dropped=tracer.dropped,
               spans=len(sp.spans) if sp else 0,
               gaps_by_mark=tr.idle_gaps(),
               gaps_by_span=spans.name_gaps(tr, sp))
    if sp is not None and kind == "fleet_backlog":
        roots = [s for s in sp.roots() if s.name in ROOTS]
        row["roots_cover"] = spans.union(
            (s.start, s.end) for s in roots) / tr.window_s
        row["host_split"] = split(sp, (
            "stream.ingest", "stream.pump", "stream.stage",
            "stream.dispatch", "stream.track", "rpeak.threshold",
            "rpeak.stitch", "stream.finalize", "cough.fft",
            "cough.spectral", "cough.mfcc", "cough.forest",
            "rpeak.scores"), tr.window_s)
        row["windows"] = sum(s.args.get("B", 0)
                             for s in sp.named("stream.dispatch"))
        row["clock"] = {n: clock(sp, n, tr)
                        for n in ("stream.dispatch", "stream.track")}
    elif sp is not None:
        steps = sp.named("serve.step")
        shares = [sum(k.dur for k in sp.children(s, STEP_PARTS)) / s.dur
                  for s in steps]
        row["step_cover_min"] = min(shares) if shares else None
        row["step_cover_median"] = statistics.median(shares) \
            if shares else None
        row["host_split"] = split(sp, (
            "serve.step", "serve.admit", "serve.prefill", "serve.decode",
            "serve.account", "serve.sample", "model.embed",
            "model.attention", "model.moe", "moe.route", "moe.experts",
            "moe.combine", "model.unembed"), max(len(steps), 1) * 1e-3)
        decodes = sp.named("serve.decode")
        row["decode_split_ms"] = {n: 1e3 * sum(
            sum(k.dur for k in sp.descendants(s, n)) for s in decodes)
            / max(len(decodes), 1) for n in DECODE_PARTS}
        row["decode_split_ms"]["serve.decode"] = 1e3 * sum(
            s.dur for s in decodes) / max(len(decodes), 1)
        row["clock"] = {n: clock(sp, n, tr)
                        for n in ("serve.decode", "serve.prefill")}
    run.release()
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--cost-rounds", type=int, default=2)
    args = ap.parse_args()
    for p in (ROOT / "src", ROOT):
        sys.path.insert(0, str(p))
    import torch
    from portbench.lib import harness
    if not torch.cuda.is_available():
        print("spans: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    cell = harness.Cell(args.workload, harness.benchmark(ROOT), ROOT)
    row = measure(cell, args.seed, dev, args.cost_rounds)
    row["device"] = torch.cuda.get_device_name(0)
    line = json.dumps(row)
    (out_dir / f"spans-{cell.name}-{args.seed}.json").write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
