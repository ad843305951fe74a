"""The port stands alone and runs on the card unless told otherwise.

* With ``jax`` and ``repro`` blocked, ``repro_torch`` and every sub-module
  import, and so do the modules ``chip_smoke.py`` imports and the worker
  pool's, the restart policy's, the MoE layer's, the encoder-decoder's,
  the fleet mesh's, the collectives' and the checkpoint manager's public
  names.
* No module of ``src/repro_torch`` and not ``chip_smoke.py`` imports
  ``jax`` or ``repro`` (an AST scan).
* Entry points (the stream engine and window cores, ``build_model``,
  ``ServingEngine``, ``python -m repro_torch.launch.serve``, the
  quickstart, the format study, the worker pool, the fleet meshes and the
  re-mesh) resolve
  ``device=None`` to the card and raise without CUDA; ``device="cpu"``
  runs on the CPU.
* Every registered format makes an ``Arith`` and the quire switch
  round-trips.
* A CPU tensor never reaches the kernel loader, under any backend.
* ``chip_smoke.py`` exits non-zero with no result line without CUDA, and
  alone in a directory.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import quickstart, study
from repro_torch.apps import bayeslope, cough, forest
from repro_torch.configs import CONFIGS, reduced
from repro_torch.core.arith import (Arith, backend_overrides, get_quire,
                                    get_round_backend, set_quire)
from repro_torch.core.formats import ALL_FORMATS, FloatFormat
from repro_torch.kernels import build, ops
from repro_torch.ingest import FleetSimulator, run_worker_fleet
from repro_torch.distributed import ElasticConfig, remesh
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.mesh import make_fleet_mesh_info, split_mesh_info
from repro_torch.models import build_model
from repro_torch.serve import ServeConfig, ServingEngine
from repro_torch.stream import StreamEngine, rpeak_pipeline

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .removesuffix(".__init__")
    for p in PKG.rglob("*.py"))
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _run(code, cwd=ROOT, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               **(env_extra or {}))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=240)


def test_imports_with_jax_and_repro_blocked():
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "sys.path.insert(0, '.')\n"
        "import chip_smoke\n"
        "import ast\n"
        "tree = ast.parse(open('chip_smoke.py').read())\n"
        "for node in ast.walk(tree):\n"
        "    if isinstance(node, ast.ImportFrom) and node.module:\n"
        "        importlib.import_module(node.module)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok', len(sys.modules))\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_slice_names_import_with_jax_and_repro_blocked():
    """The worker pool, the fault-tolerance layer, the MoE module and the
    recurrent blocks by the names the reference exports them under."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "from repro_torch.ingest import (WorkerConfig, aggregate_rollup,\n"
        "                                partition_plans, run_worker_fleet)\n"
        "from repro_torch.ingest.workers import worker_main\n"
        "from repro_torch.distributed import RestartPolicy\n"
        "from repro_torch.distributed.fault_tolerance import (\n"
        "    RestartPolicy, StepWatchdog, run_with_restarts)\n"
        "from repro_torch.models.moe import init_moe, moe_ffn\n"
        "from repro_torch.models.attention import (attention_train,\n"
        "    chunked_attention, cross_attention)\n"
        "from repro_torch.models.encdec import EncDecLM\n"
        "from repro_torch.models import XLSTMLM, ZambaLM\n"
        "from repro_torch.models.ssm import (SSMCache, ssm_decode,\n"
        "    ssm_prefill, ssm_sequential_ref)\n"
        "from repro_torch.models.xlstm import (MLSTMCache, SLSTMCache,\n"
        "    mlstm_forward, mlstm_sequential_ref, slstm_forward)\n"
        "from repro_torch.distributed import (ElasticConfig, MeshInfo,\n"
        "    fleet_pad, largest_valid_mesh, make_fleet_batch_fn, remesh)\n"
        "from repro_torch.distributed.collectives import (ledger_psum,\n"
        "    posit_all_reduce, posit_all_reduce_ef)\n"
        "from repro_torch.launch.mesh import (make_debug_mesh_info,\n"
        "    make_fleet_mesh_info, split_mesh_info)\n"
        "from repro_torch.checkpoint import CheckpointManager\n"
        "from repro_torch.kernels.posit_matmul import round_matmul_sum\n"
        "print('ok')\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax_or_repro_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)


def _serving_engine(dev):
    model = build_model(reduced(CONFIGS["qwen3-8b"]), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    return ServingEngine(model, params, ServeConfig(), device=dev)


@pytest.mark.parametrize("call", [
    lambda dev: StreamEngine({"rpeak": rpeak_pipeline()}, device=dev),
    lambda dev: cough.make_cough_scorer(
        "posit16", forest.forest_from_arrays(
            np.full((1, 3), -1), np.zeros((1, 3)), np.zeros((1, 3)), 1),
        device=dev),
    lambda dev: bayeslope.detect_rpeaks(
        Arith.make("posit10"), np.zeros(600, np.float32), device=dev),
    lambda dev: build_model(reduced(CONFIGS["qwen3-8b"]), device=dev),
    _serving_engine,
    lambda dev: serve_cli.main(
        ["--arch", "qwen3-8b", "--requests", "1", "--new-tokens", "2"]
        + ([] if dev is None else ["--device", dev])),
    lambda dev: quickstart.main([] if dev is None else ["--device", dev]),
    lambda dev: build_model(reduced(CONFIGS["granite-moe-3b-a800m"]),
                            device=dev),
    lambda dev: run_worker_fleet(
        FleetSimulator(n_patients=2, windows=1, mixed=False, n_cough=0), 1,
        max_batch=2, device=dev),
    lambda dev: build_model(reduced(CONFIGS["internvl2-2b"]), device=dev),
    lambda dev: build_model(reduced(CONFIGS["seamless-m4t-large-v2"]),
                            device=dev),
    lambda dev: build_model(reduced(CONFIGS["xlstm-1.3b"]), device=dev),
    lambda dev: build_model(reduced(CONFIGS["zamba2-7b"]), device=dev),
    lambda dev: make_fleet_mesh_info(device=dev),
    lambda dev: StreamEngine({"rpeak": rpeak_pipeline()},
                             mesh_info=split_mesh_info(dev, 2)),
    lambda dev: remesh(None if dev is None else [dev],
                       ElasticConfig(model_parallel=1)),
], ids=["StreamEngine", "make_cough_scorer", "detect_rpeaks", "build_model",
        "ServingEngine", "launch.serve", "quickstart", "build_model_moe",
        "run_worker_fleet", "build_model_vlm", "build_model_encdec",
        "build_model_ssm", "build_model_hybrid", "make_fleet_mesh_info",
        "split_mesh_info", "remesh"])
def test_entry_points_need_the_card_unless_told(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call(None)
    call("cpu")


def test_cpu_tensors_never_reach_the_kernel_loader(monkeypatch):
    def no_loader(name):
        raise AssertionError("a CPU tensor reached the kernel loader")
    monkeypatch.setattr(build, "load", no_loader)
    rng = np.random.default_rng(0)
    audio = rng.standard_normal((2, 2, 4800)).astype(np.float32) * 1e4
    imu = rng.standard_normal((2, 9, 30)).astype(np.float32)
    f = forest.forest_from_arrays(np.full((2, 3), -1), np.zeros((2, 3)),
                                  np.full((2, 3), 0.5), 1)
    for backend in ("auto", "kernel", "torch", "codec"):
        with backend_overrides(round_backend=backend):
            p = cough.make_cough_scorer("posit16", f, device="cpu")(audio,
                                                                    imu)
            assert p.shape == (2,) and torch.all(p == 0.5)
            bayeslope.rpeak_window_scores(Arith.make("posit10"),
                                          torch.from_numpy(audio[:, 0]))
            p16 = Arith.make("posit16")
            v = torch.from_numpy(imu[0])
            p16.fma(v, v, 1.0)
            bits = ops.encode(v[:, :8], p16.fmt)
            ops.matmul(bits, bits.T.contiguous(), p16.fmt)


def test_auto_backend_resolves_per_tensor():
    assert get_round_backend(torch.zeros(1)) == "torch"
    with backend_overrides(round_backend="kernel"):
        assert get_round_backend(torch.zeros(1)) == "kernel"


def test_study_needs_the_card_unless_told(monkeypatch):
    """The study's sizes take minutes on the CPU, so its two sweeps are
    stubbed here: what is checked is where each would run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seen = []
    monkeypatch.setattr(study, "run_cough_detection", lambda fmts, **kw: (
        seen.append(("cough", kw["device"])) or {
            f: {"auc": 1.0, "fpr_at_tpr95": 0.0} for f in fmts}))
    monkeypatch.setattr(study, "run_rpeak_detection", lambda fmts, **kw: (
        seen.append(("rpeak", kw["device"])) or {f: 1.0 for f in fmts}))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        study.main([])
    out = study.main(["--device", "cpu"])
    assert set(out) == {"cough", "rpeak"}
    assert seen == [("cough", torch.device("cpu")),
                    ("rpeak", torch.device("cpu"))]
    study.main(["--device", "cpu", "--task", "rpeak"])
    assert seen[-1] == ("rpeak", torch.device("cpu")) and len(seen) == 3


def test_every_format_constructs_and_quire_round_trips():
    for name, fmt in ALL_FORMATS.items():
        ar = Arith.make(name)
        assert ar.fmt == fmt
        assert ar.exact == (name == "fp32")
        assert ar.is_posit != isinstance(fmt, FloatFormat)
        x = torch.tensor([1.0, 3.0e5, -0.1])
        assert ar.rnd(x).shape == x.shape
    with backend_overrides(quire="off"):
        for mode, on in (("on", True), ("off", False), ("auto", False),
                         ("on", True)):
            set_quire(mode)
            assert get_quire() is on
            assert Arith.make("posit16").quire is on
            assert not Arith.make("fp16").quire
    assert not get_quire()


def test_chip_smoke_fails_without_cuda_or_alone(tmp_path):
    for cwd in (ROOT, tmp_path):
        script = cwd / "chip_smoke.py"
        if cwd is tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        out = subprocess.run(
            [sys.executable, str(script)], cwd=cwd, capture_output=True,
            text=True, timeout=240,
            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
