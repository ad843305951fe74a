"""Cells at a size a CPU test run holds: the benchmark's own files, with
the sizes cut, driven on the CPU through the program's plain versions."""
from __future__ import annotations

import types

from portbench.lib import harness

SEED = 2 ** 33 + 4242          # wider than 32 bits, as the driver's are


def fleet_cell(**traffic):
    cfg = harness.load_json(harness.BENCH / "configs/paper-fleet.json")
    cfg["forest"]["train_windows"] = 60
    t = harness.load_json(harness.BENCH / "workloads/fleet-backlog.json")
    t.update(patients=8, windows=4, cough_pool=8, max_batch=8, check_cough=4,
             check_ecg=4, check_passes=2)
    t.update(traffic)
    return types.SimpleNamespace(config=cfg, traffic=t, name="fleet-tiny")


def serve_cell(**traffic):
    cfg = harness.load_json(
        harness.BENCH / "configs/granite-moe-3b-a800m.json")
    cfg.update(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
               num_key_value_heads=2, intermediate_size=32,
               num_local_experts=8, num_experts_per_tok=2, vocab_size=500,
               moe_capacity_factor=4.0, attention_multiplier=16 ** -0.5)
    t = harness.load_json(
        harness.BENCH / "workloads/granite-moe-decode.json")
    # four clients' quantiles span about 12-32 prompt tokens, 5-12 served
    t.update(clients=4, batch_size=4, prompt={"median": 20, "sigma": 0.4},
             output={"median": 8, "sigma": 0.35}, check_tokens=40)
    t.update(traffic)
    return types.SimpleNamespace(config=cfg, traffic=t, name="serve-tiny")


def driver(kind: str):
    return harness._load_module(harness.BENCH / "traffic" / f"{kind}.py",
                                f"portbench_traffic_{kind}")


def failed(checks) -> list:
    return [k for k, c in checks.items() if not c["value"] <= c["limit"]]


def tool(name: str):
    return harness._load_module(harness.BENCH / "tools" / f"{name}.py",
                                f"portbench_tool_{name}")
