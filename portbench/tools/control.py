"""Read a cell's compared numbers for the program and for its control on
the card: the two readings each limit is set between.

    python3 portbench/tools/control.py --workload <name> --seconds 10 \
        --seeds 11 12 13 [--control '{"weights": "posit8"}']

For each seed: the cell's set-up, one window at the cell's own load, the
program's compared numbers (as a run checks them), then the control's,
the reference in the configuration's lower precision put in the
program's place, on the same sampled answers.  Each side is judged as a
run judges the program, every number against the configuration's limit:
``correct`` has to read true for the program and false for each control.
``--control`` replaces the configuration's control, to compare
candidates.  One JSON line a seed.  The benchmark's own runs never run
the control.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def judge(numbers: dict, limits: dict) -> bool:
    """A run's verdict: every compared number at or under its limit."""
    return all(v <= limits[k] for k, v in numbers.items())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="append", default=[])
    args = ap.parse_args()
    for p in (ROOT / "src", ROOT):
        sys.path.insert(0, str(p))
    import torch
    from portbench.lib import harness
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        cell = harness.Cell(args.workload, harness.benchmark(ROOT), ROOT)
        limits = cell.config["limits"]
        run = cell.driver().Run(cell, seed, dev)
        t0 = time.perf_counter()
        run.setup()
        e2e = run.window(args.seconds)
        run.release()
        gc.collect()
        torch.cuda.empty_cache()
        checks = run.check()
        program = {k: c["value"] for k, c in checks.items()}
        controls = []
        for spec in args.control or [None]:
            if spec is not None:
                cell.config["control"] = json.loads(spec)
            numbers = run.control()
            controls.append({"control": cell.config["control"],
                             "numbers": numbers,
                             "correct": judge(numbers, limits)})
        print(json.dumps({"seed": seed, "e2e": e2e, "program": program,
                          "correct": judge(program, limits),
                          "controls": controls,
                          "seconds": time.perf_counter() - t0}), flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
