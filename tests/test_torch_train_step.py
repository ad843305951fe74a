"""The port's train step (``repro_torch.train.step.make_train_step``)
against the JAX package's, from one state carried over by
``train_state_from_jax``, three steps on ``TokenPipeline`` batches (B = 4,
S = 32).  The state is one mid-training: the reference's initial params
and zero moments, then ``WARM`` of its own plain steps (on other batches)
that end at ``START``, the warmup's end, so that every compared step runs
at the peak lr 3e-4 and its update is a smooth function of its gradient
(from zero moments Adam's update is about ±lr an element whatever the
gradient's size, so a gradient that differs near zero flips its weight's
move).

* plain (reduced qwen3-8b), posit16 QAT (reduced gemma2-2b: its stacked
  norm gains are rounded too) and ``microbatches=2`` (qwen3-8b): each
  step's loss within 2e-2 and its ``lr`` and the final ``step`` equal;
  after the third update, what the three steps changed in every leaf of
  the params and of both moments (each weight's update
  ``p_final - p_init``) within a relative L2 error of ``STATE_TOL`` of the
  reference's change.  The params themselves would hold any bound that
  their update does, and pass with no update at all: three steps move a
  weight by about 1e-3 of its size;
* the pod-compressed branch (``QuantPolicy(grad_allreduce="posit16")`` on
  a ``(pod=2, data=1, model=1)`` mesh): two spawned ranks over gloo (a
  file store), each on its half of the batch, its gradients through
  ``posit_all_reduce``, against the reference's ``shard_map`` step on a
  forced 2-device host mesh, to the same bounds plus one posit16 ulp
  (2^-12 relative), both ranks bitwise alike.

The JAX sides run in subprocesses compiled with
``--xla_allow_excess_precision=false`` (see ``test_torch_train_loss.py``).
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as JCONFIGS, reduced as jreduced
from repro.core.policy import QuantPolicy as JQuantPolicy
from repro.data.tokens import (TokenPipeline as JTokenPipeline,
                               TokenPipelineConfig as JTokenPipelineConfig)
from repro.launch.mesh import make_debug_mesh_info as jmesh
from repro.models import build_model as jbuild_model
from repro.train.step import (init_train_state as jinit_train_state,
                              make_train_step as jmake_train_step)
from repro_torch.checkpoint import flatten_state
from repro_torch.configs import CONFIGS, reduced
from repro_torch.core.policy import QuantPolicy
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
from repro_torch.launch.mesh import make_debug_mesh_info
from repro_torch.models import build_model
from repro_torch.models.convert import train_state_from_jax
from repro_torch.train.step import make_train_step

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
LOSS_TOL = 2e-2
STATE_TOL = 5e-2
START = 100             # wsd_schedule's warmup: lr at its peak from here
WARM = 5                # the reference's steps that make the carried state
POSIT16_ULP = 2.0 ** -12
STEPS, B, S = 3, 4, 32
# (name, arch, weights format, microbatches)
VARIANTS = [("plain", "qwen3-8b", None, 1),
            ("qat_posit16", "gemma2-2b", "posit16", 1),
            ("microbatches2", "qwen3-8b", None, 2)]
ARCHS = sorted({v[1] for v in VARIANTS})

REFERENCE_SCRIPT = textwrap.dedent("""
    import os, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import CONFIGS, reduced
    from repro.core.policy import QuantPolicy
    from repro.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro.distributed.sharding import MeshInfo
    from repro.models import build_model
    from repro.train.step import init_train_state, make_train_step

    init, out_path, which = np.load(sys.argv[1]), sys.argv[2], sys.argv[3]
    out = {}
    def put(prefix, tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            name = "/".join(str(k.key) for k in path)
            out[f"{prefix}/{name}"] = np.asarray(leaf)
    def load(tree_like, prefix):
        # tree_like with the saved initial state's leaves
        leaves = [jnp.asarray(init[prefix + "/" + "/".join(
            str(k.key) for k in path)])
            for path, _ in jax.tree_util.tree_flatten_with_path(
                tree_like)[0]]
        return jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(tree_like), leaves)
    if which == "pod":
        from repro.compat import make_mesh
        assert jax.device_count() == 2
        minfo = MeshInfo(make_mesh((2, 1, 1), ("pod", "data", "model")),
                         dp_axes=("pod", "data"))
        runs = [("pod", "qwen3-8b", QuantPolicy(grad_allreduce="posit16"),
                 1)]
    else:
        from repro.launch.mesh import make_debug_mesh_info
        minfo = make_debug_mesh_info()
        runs = [(n, a, QuantPolicy(weights=w), mb) for n, a, w, mb in %r]
    with minfo.mesh:
        for name, arch, policy, mb in runs:
            cfg = reduced(CONFIGS[arch])
            m = build_model(cfg, minfo, policy)
            state = init_train_state(m.init(jax.random.key(0)))
            state = load(state, arch)
            step = jax.jit(make_train_step(m, minfo, policy,
                                           microbatches=mb))
            pipe = TokenPipeline(TokenPipelineConfig(
                vocab=cfg.vocab, seq_len=%d, global_batch=%d))
            for s in range(%d):
                state, met = step(state, pipe.batch_at(s))
                for k, v in met.items():
                    out[f"{name}/{s}/{k}"] = np.asarray(v)
            put(f"{name}/final", state)
    np.savez(out_path, **out)
""" % ([v for v in VARIANTS], S, B, STEPS))

RANKS = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def rank_main(rank, world, store, init_path, out):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        from repro_torch.configs import CONFIGS, reduced
        from repro_torch.core.policy import QuantPolicy
        from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
        from repro_torch.distributed import MeshInfo
        from repro_torch.distributed import collectives
        from repro_torch.models import build_model
        from repro_torch.models.convert import train_state_from_jax
        from repro_torch.train import step as train_step
        calls = []
        real = collectives.posit_all_reduce
        collectives.posit_all_reduce = (
            lambda *a, **k: calls.append(1) or real(*a, **k))
        init = np.load(init_path)
        tree = {}
        for key in init.files:
            if key.startswith("qwen3-8b/"):
                *path, leaf = key.split("/")[1:]
                node = tree
                for p in path:
                    node = node.setdefault(p, {})
                node[leaf] = init[key]
        cfg = reduced(CONFIGS["qwen3-8b"])
        policy = QuantPolicy(grad_allreduce="posit16")
        minfo = MeshInfo((torch.device("cpu"),) * 2, ("pod", "data", "model"),
                         (2, 1, 1), dp_axes=("pod", "data"))
        model = build_model(cfg, policy, device="cpu")
        state = train_state_from_jax(tree, "cpu")
        step = train_step.make_train_step(model, minfo, policy)
        pipe = TokenPipeline(TokenPipelineConfig(
            vocab=cfg.vocab, seq_len=%d, global_batch=%d))
        res = {}
        for s in range(%d):
            state, met = step(state, pipe.batch_at(s))
            for k, v in met.items():
                res[f"{s}/{k}"] = v.numpy()
        from repro_torch.checkpoint import flatten_state
        for i, leaf in enumerate(flatten_state(state)[0]):
            res[f"leaf{i}"] = leaf.numpy()
        res["calls"] = np.asarray(len(calls))
        np.savez(f"{out}/rank{rank}.npz", **res)
        dist.destroy_process_group()

    if __name__ == "__main__":
        out = sys.argv[1]
        mp.start_processes(rank_main, args=(2, f"{out}/store", sys.argv[2],
                                            out),
                           nprocs=2, start_method="spawn")
        print("RANKS_OK")
""" % (S, B, STEPS))


def nested(ref, prefix):
    tree = {}
    for key, v in ref.items():
        if key.startswith(prefix + "/"):
            *path, leaf = key[len(prefix) + 1:].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    return tree


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The carried state for each arch (params from jax.random.key(0),
    ``init_train_state``, the counter at ``START - WARM``, then ``WARM``
    plain reference steps on batches 1000 on), then the reference's three
    steps of each variant and of the pod branch from it, and the port's pod
    branch on two gloo ranks: the three processes at once."""
    d = tmp_path_factory.mktemp("train_step")
    init = {}
    minfo = jmesh()
    with minfo.mesh:
        for arch in ARCHS:
            cfg = jreduced(JCONFIGS[arch])
            m = jbuild_model(cfg, minfo)
            state = jinit_train_state(m.init(jax.random.key(0)))
            state["opt"]["step"] = jax.numpy.asarray(START - WARM,
                                                     jax.numpy.int32)
            step = jax.jit(jmake_train_step(m, minfo, JQuantPolicy()))
            pipe = JTokenPipeline(JTokenPipelineConfig(
                vocab=cfg.vocab, seq_len=S, global_batch=B))
            for s in range(WARM):
                state, _ = step(state, pipe.batch_at(1000 + s))
            for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
                init[f"{arch}/" + "/".join(str(k.key) for k in path)
                     ] = np.asarray(leaf)
            assert int(init[f"{arch}/opt/step"]) == START
    np.savez(d / "init.npz", **init)
    flags = "--xla_allow_excess_precision=false"
    env1 = dict(ENV, XLA_FLAGS=flags)
    env2 = dict(ENV, XLA_FLAGS=flags
                + " --xla_force_host_platform_device_count=2")
    (d / "ranks.py").write_text(RANKS)
    jobs = [subprocess.Popen([sys.executable, "-c", REFERENCE_SCRIPT,
                              str(d / "init.npz"), str(d / "ref.npz"),
                              "variants"], env=env1, text=True,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE),
            subprocess.Popen([sys.executable, "-c", REFERENCE_SCRIPT,
                              str(d / "init.npz"), str(d / "pod.npz"),
                              "pod"], env=env2, text=True,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE),
            subprocess.Popen([sys.executable, str(d / "ranks.py"), str(d),
                              str(d / "init.npz")], env=ENV, text=True,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE)]
    try:
        outs = [j.communicate(timeout=600) for j in jobs]
    finally:
        for j in jobs:
            j.kill()
    for j, (o, e) in zip(jobs, outs):
        assert j.returncode == 0, o + e
    assert "RANKS_OK" in outs[2][0]
    return (init, {**np.load(d / "ref.npz"), **np.load(d / "pod.npz")},
            [dict(np.load(d / f"rank{r}.npz")) for r in range(2)])


def rel_l2(got, want):
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def check_final(final_leaves, init, arch, ref, name, tol):
    """What the steps changed in every leaf of the params and moments
    (its final value less its value in ``arch``'s initial state) within
    ``tol`` (relative L2) of what they changed in the reference's; the
    step counters equal."""
    start = flatten_state(nested(init, arch))[0]
    want = flatten_state(nested(ref, f"{name}/final"))[0]
    assert len(final_leaves) == len(want) == len(start)
    for i, (t, w, t0) in enumerate(zip(final_leaves, want, start)):
        t = np.asarray(t)
        assert t.shape == w.shape and t.dtype == w.dtype, i
        if w.dtype == np.int32:
            assert int(t) == int(w) == START + STEPS
        else:
            assert np.any(w != t0), (name, i)
            err = rel_l2(t - t0, w - t0)
            assert err < tol, (name, i, err)


@pytest.mark.parametrize("name,arch,wfmt,mb", VARIANTS,
                         ids=[v[0] for v in VARIANTS])
def test_three_steps_hold_the_reference(runs, name, arch, wfmt, mb):
    init, ref, _ = runs
    cfg = reduced(CONFIGS[arch])
    policy = QuantPolicy(weights=wfmt)
    model = build_model(cfg, policy, device="cpu")
    state = train_state_from_jax(nested(init, arch), "cpu")
    assert int(state["opt"]["step"]) == START
    step = make_train_step(model, make_debug_mesh_info(device="cpu"), policy,
                           microbatches=mb)
    pipe = TokenPipeline(TokenPipelineConfig(vocab=cfg.vocab, seq_len=S,
                                             global_batch=B))
    for s in range(STEPS):
        state, met = step(state, pipe.batch_at(s))
        want = {k.rsplit("/", 1)[1]: v for k, v in ref.items()
                if k.startswith(f"{name}/{s}/")}
        assert set(met) == set(want)
        assert float(met["lr"]) == float(want["lr"])
        for k in ("loss", "ce", "aux"):
            assert abs(float(met[k]) - float(want[k])) < LOSS_TOL, (s, k)
    check_final(flatten_state(state)[0], init, arch, ref, name, STATE_TOL)


def test_pod_compressed_branch_at_gloo_world_two(runs):
    init, ref, ranks = runs
    for rank in ranks:
        assert int(rank["calls"]) == STEPS * len(
            flatten_state(nested(ref, "pod/final/params"))[0])
        for s in range(STEPS):
            assert float(rank[f"{s}/lr"]) == float(ref[f"pod/{s}/lr"])
            for k in ("loss", "ce", "aux"):
                assert abs(float(rank[f"{s}/{k}"])
                           - float(ref[f"pod/{s}/{k}"])) < LOSS_TOL, (s, k)
        leaves = [rank[f"leaf{i}"] for i in range(len(
            [k for k in rank if k.startswith("leaf")]))]
        check_final(leaves, init, "qwen3-8b", ref, "pod",
                    STATE_TOL + POSIT16_ULP)
    for k in ranks[0]:
        assert ranks[0][k].tobytes() == ranks[1][k].tobytes(), k
