"""Run one cell of the port's benchmark once and print one JSON line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  The cell's files are found by name (see
``portbench/lib/harness.py``).  The run makes its inputs and weights from
``--seed``, warms up the cell's own shapes (set-up, ``setup_s``), measures
for ``--seconds`` and, with ``--trace 1``, traces a further window under
``torch.profiler`` for the per-layer metrics.  Then it frees the
program's state, checks a sample of what the timed path produced against
the plain reference (``portbench/reference/``), prints each compared
number beside its limit as the last lines on standard error, and prints
the result as the last line on standard output.  Exit codes: 0 with a
result; 2 without the cards the cell needs; 3 when a JAX module reached
the process.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout:
    the program's kernels build into ``build/kernels`` by themselves."""
    cache = ROOT / "build" / "portbench-cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))

    from portbench.lib import harness
    cell = harness.Cell(args.workload, harness.benchmark(ROOT), ROOT)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    driver = cell.driver()
    dev = torch.device("cuda", 0)
    run = driver.Run(cell, args.seed, dev)
    run.setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START

    torch.cuda.reset_peak_memory_stats()
    t_window = time.perf_counter()
    e2e = run.window(args.seconds)
    t_after = time.perf_counter()
    out = {"correct": False, "attempted": run.attempted,
           "failed": run.failed}
    metrics = {}
    breakdown = None
    device_extra = {}
    if args.trace:
        ctx = run.layer_context()
        with harness.Traced() as tr:
            run.traced_window(tr)
        ctx.update(run.traced_context(tr))
        ctx["traced"] = tr
        for m in cell.per_layer:
            v = cell.reader(m["name"]).read(ctx)
            if harness.finite(v):
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if tr.events:
            device_extra = {"busy_s": tr.busy_s(), "window_s": tr.window_s}
            breakdown = {"device_ops": tr.device_ops(),
                         "idle_gaps": tr.idle_gaps()}
    else:
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            elif harness.finite(e2e.get(m["name"])):
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    device = harness.device_info(cell.chips)
    device.update(device_extra)

    t_check = time.perf_counter()
    run.release()
    gc.collect()
    torch.cuda.empty_cache()
    checks = run.check()
    print(f"portbench: set-up {setup_s:.1f} s, window "
          f"{t_after - t_window:.1f} s, tracing "
          f"{t_check - t_after:.1f} s, check "
          f"{time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: JAX modules reached the process: {bad}",
              file=sys.stderr)
        return 3
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    out.update({"correct": ok, "metrics": metrics, "device": device})
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
