"""The harness's own arithmetic and plumbing: the counts, the tails, the
lookup of a cell's files by name, and the guard that nothing the harness
imports is JAX's or the JAX package's."""
import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from portbench import counts
from portbench.lib import harness

ROOT = harness.ROOT


def test_posit16_to_bf16_decode_counts_4_bytes_an_element():
    c = counts.posit_decode((40, 1536, 512), 16, 2)
    assert c["bytes"] == 4 * 40 * 1536 * 512 and c["flops"] == 0
    assert counts.posit_decode((7,), 8, 4)["bytes"] == 5 * 7


def test_kv_attention_counts_only_the_filled_rows():
    c = counts.posit_kv_attention(B=2, KV=8, G=3, D=64, kv_nbits=8,
                                  filled=100 + 50)
    assert c["bytes"] == 2 * 150 * 8 * 64 + 2 * 2 * 8 * 3 * 64 * 4
    assert c["flops"] == 4 * 150 * 8 * 3 * 64


def test_bound_takes_the_larger_term():
    assert counts.bound_s(989e12, 0.0, "bf16") == pytest.approx(1.0)
    assert counts.bound_s(0.0, 3.35e12) == pytest.approx(1.0)
    assert counts.bound_s(67e12, 3.35e12 / 2) == pytest.approx(1.0)


def test_moe_decode_step_reads_every_expert_once():
    cfg = harness.load_json(
        harness.BENCH / "configs/granite-moe-3b-a800m.json")
    one = counts.moe_decode_step(cfg, rows=1, filled=0)
    two = counts.moe_decode_step(cfg, rows=2, filled=0)
    # ~3.4 G parameters in posit16, all 40 experts decoded a step
    assert 6.5e9 < one["bytes"] < 7.2e9
    assert two["bytes"] - one["bytes"] == 2 * 8 * 64 * 1 * 32
    assert two["flops"] > one["flops"] > 0


def test_tail_is_taken_over_every_sample():
    rng = np.random.default_rng(1)
    xs = list(rng.exponential(size=5000))
    assert harness.percentile(xs, 95) == pytest.approx(
        float(np.percentile(xs, 95)))
    # a bounded deque of the last 512 would miss an early burst
    xs = [100.0] * 400 + [1.0] * 4600
    assert harness.percentile(xs, 95) == 100.0
    assert harness.percentile([], 95) != harness.percentile([], 95)


def test_an_added_workload_file_is_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.benchmark(ROOT)
    bench["workloads"].append(
        {"name": "fleet-small", "config": "paper-fleet", "traffic": "small",
         "chips": 1, "why": "an added cell"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = harness.load_json(ROOT / "portbench/workloads/fleet-backlog.json")
    spec.update(traffic="small", patients=16)
    (root / "portbench/workloads/fleet-small.json").write_text(
        json.dumps(spec))
    cell = harness.Cell("fleet-small", harness.benchmark(root), root)
    assert cell.traffic["patients"] == 16
    assert cell.driver().Run.__name__ == "Run"
    assert {m["name"] for m in cell.end_to_end} == {"setup_s"}
    (root / "portbench/metrics/extra.py").write_text(
        "def read(ctx):\n    return 1.5\n")
    assert cell.reader("extra").read({}) == 1.5


def test_cell_and_benchmark_must_agree(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.benchmark(ROOT)
    name = bench["workloads"][0]["name"]
    bench["workloads"][0]["traffic"] = "other"
    with pytest.raises(ValueError):
        harness.Cell(name, bench, root)


BLOCKER = textwrap.dedent("""
    import importlib.abc, sys
    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "flax", "repro"):
                raise ImportError("blocked: " + name)
            return None
    sys.meta_path.insert(0, Block())
    sys.path[:0] = [{src!r}, {root!r}]
    import glob, importlib.util, os
    from portbench.lib import harness
    for kind in ("traffic", "metrics"):
        for f in sorted(glob.glob(os.path.join({root!r}, "portbench", kind,
                                               "*.py"))):
            n = "m_" + os.path.basename(f).replace(".", "_")
            harness._load_module(__import__("pathlib").Path(f), n)
    import portbench.lib.fleet, portbench.lib.kernel_counts
    import portbench.reference.granite_moe
    import repro_torch.stream, repro_torch.serve, repro_torch.models
    spec = importlib.util.spec_from_file_location(
        "pb_run", os.path.join({root!r}, "portbench", "run.py"))
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    print("FORBIDDEN", harness.forbidden_modules())
""")


def test_no_harness_module_imports_jax_or_the_jax_package():
    code = BLOCKER.format(src=str(ROOT / "src"), root=str(ROOT))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout


def test_guard_compares_top_level_names_whole(monkeypatch):
    for m in list(sys.modules):       # other tests of the run import JAX
        if m.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.fake", object())
    assert "repro" in harness.forbidden_modules()


@pytest.mark.cuda
def test_each_cell_runs_correct_on_the_card(tmp_path):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for cell in harness.benchmark(ROOT)["workloads"]:
        out = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload", cell["name"],
             "--seed", str(2 ** 33 + 1), "--seconds", "5", "--trace", "0"],
            cwd=ROOT, capture_output=True, text=True, timeout=1200)
        assert out.returncode == 0, out.stderr[-3000:]
        assert json.loads(out.stdout.splitlines()[-1])["correct"]
