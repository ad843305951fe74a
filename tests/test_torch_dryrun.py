"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU, held to
the reference's ``tests/test_system.py::test_dryrun_cell_subprocess`` and
to the reference's CLI and results:

* a multi-pod granite-moe decode cell plans in a subprocess with ``jax``
  and ``repro`` blocked, and returns ``raw``;
* the CLI writes the reference's file tag with the reference's result
  keys, skips a cached cell, and tabulates the cells it wrote;
* long_500k of a quadratic family returns the reference's skip;
* the loop corrections (chunked attention's key blocks, the sLSTM's
  positions, the mLSTM and SSD chunks, counted by difference) equal a
  trace of every trip on reduced configs.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.configs import CONFIGS, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.policy import PAPER_POLICY
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh_info

ROOT = Path(__file__).resolve().parents[1]

DRYRUN = """
import sys
sys.modules['jax'] = None
sys.modules['repro'] = None
from repro_torch.launch.dryrun import lower_cell
res = lower_cell("granite-moe-3b-a800m", "decode_32k", multi_pod=True,
                 corrections=False)
assert "raw" in res, res
assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))
               for k, v in sys.modules.items() if v is not None)
print("DRYRUN_OK", res["raw"]["flops"])
"""

# the reference's result keys (``repro/launch/dryrun.py:204-213, 309-317``)
# and the CLI's ``wall_s``
RESULT_KEYS = {"arch", "shape", "mesh", "policy", "compile_s", "memory",
               "raw", "coll_breakdown", "corrected", "model_flops_global",
               "model_flops_per_chip", "useful_ratio", "terms", "notes",
               "wall_s"}


def test_dryrun_cell_subprocess():
    r = subprocess.run([sys.executable, "-c", DRYRUN], capture_output=True,
                       text=True, timeout=560, cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert "DRYRUN_OK" in r.stdout, r.stdout[-2000:] + r.stderr[-2000:]


def test_cli_writes_the_references_tag_and_keys(tmp_path, capsys):
    args = ["--arch", "gemma2-2b", "--shape", "decode_32k", "--mesh",
            "single", "--out", str(tmp_path)]
    dryrun.main(args)
    path = tmp_path / "gemma2-2b__decode_32k__single__paper.json"
    res = json.loads(path.read_text())
    assert set(res) == RESULT_KEYS
    assert set(res["memory"]) == {"peak_bytes_per_device",
                                  "arg_bytes_per_device",
                                  "temp_bytes_per_device"}
    assert set(res["raw"]) == set(res["corrected"]) == {"flops", "bytes",
                                                        "coll_bytes"}
    assert set(res["terms"]) == {"compute_s", "memory_s", "collective_s",
                                 "dominant", "bound_s", "roofline_fraction"}
    assert res["mesh"] == "16x16" and res["raw"]["flops"] > 0
    assert res["memory"]["peak_bytes_per_device"] == \
        res["memory"]["arg_bytes_per_device"] + \
        res["memory"]["temp_bytes_per_device"]
    assert "-> ok" in capsys.readouterr().out
    dryrun.main(args)
    assert "[skip cached] gemma2-2b__decode_32k__single__paper" in \
        capsys.readouterr().out


def test_long_500k_of_a_quadratic_family_is_the_references_skip():
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref
    finally:    # its import sets a 512-device host; no backend starts here
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    for arch in ("qwen3-8b", "granite-moe-3b-a800m"):
        got = dryrun.lower_cell(arch, "long_500k", multi_pod=False)
        assert got == ref.lower_cell(arch, "long_500k", multi_pod=False)
        assert got["skipped"] is True


@pytest.mark.parametrize("arch,seq,kind", [
    ("granite-moe-3b-a800m", 2048, "train"),     # 4 key blocks
    ("seamless-m4t-large-v2", 4096, "prefill"),
    ("xlstm-1.3b", 768, "prefill"),   # 768 positions, 3 mLSTM chunks
    ("xlstm-1.3b", 256, "train"),     # the sLSTM's backward chain
    ("zamba2-7b", 1024, "prefill"),   # 4 SSD chunks
    ("zamba2-7b", 2048, "train"),     # 4 key blocks and 8 SSD chunks
])
def test_loop_corrections_equal_the_full_trace(arch, seq, kind):
    cfg = reduced(CONFIGS[arch])
    shape = ShapeConfig("probe", seq, 32, kind)
    minfo = make_mesh_info()
    fast = dryrun.plan_cell(cfg, shape, minfo, PAPER_POLICY)
    full = dryrun.plan_cell(cfg, shape, minfo, PAPER_POLICY,
                            corrections=False)
    assert any(n.startswith("loop correction") for n in fast["notes"])
    assert fast["corrected"]["flops"] == full["corrected"]["flops"]
    assert fast["corrected"]["bytes"] == full["corrected"]["bytes"]
    assert full["raw"] == full["corrected"]
