"""Every family's training loss and its gradients in the port against the
JAX package, on the ten ``reduced`` configs (``ARCHS = sorted(CONFIGS)``,
B = 2, S = 32, ``tests/test_models_smoke.py::make_batch``'s inputs), with
the weights carried over by ``params_from_jax``:

* the loss, and each of its metrics, within 2e-2 of
  ``jax.value_and_grad(model.loss)``'s;
* every gradient leaf within a relative L2 error of 2e-2 of JAX's (5e-2
  for xlstm-1.3b, whose loss sits 1.8e-4 from JAX's: its mLSTM's gate
  chain rounds apart in a few places);
* the same set of leaves having a nonzero gradient;
* the port of ``tests/test_models_smoke.py::test_train_step_smoke`` on the
  port's own initializer: finite loss and finite gradients on every leaf;
* ``chunked_attention``'s gradients (q, k, v) at S = 1536, causal and
  with a local window, within 2e-2 of the reference's;
* the MoE layer's Switch aux loss on its own: its value within 1e-6 and
  its router gradient within 2e-2 of the reference's;
* ``DecoderLM`` with ``activations="posit16"`` (the block-boundary round,
  straight-through): loss and gradients at the 2e-2 tier;
* one config of each family with ``remat`` on (``torch.utils.checkpoint``
  around each layer, as the full configs run) giving the loss and every
  gradient bit for bit as with it off.

The JAX side runs in two subprocesses (half of the runs each), compiled
with ``--xla_allow_excess_precision=false``: by default XLA's CPU compiler
skips bf16 roundings between fused operations (the scan bodies'), which
moves zamba2-7b's reduced gradients by 10 % from its op-by-op run.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import flatten_state
from repro_torch.configs import CONFIGS, reduced
from repro_torch.core.policy import QuantPolicy
from repro_torch.models import attention as tattention
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.models.common import tree_map
from repro_torch.models.moe import moe_ffn

ARCHS = sorted(CONFIGS)
LOSS_TOL = 2e-2                       # absolute, on the loss and metrics
GRAD_TOL = {"xlstm-1.3b": 5e-2}       # relative L2 per gradient leaf
GRAD_TOL_DEFAULT = 2e-2
B, S = 2, 32
ATTN_S = 1536                         # chunked_attention: three 512-blocks


def make_batch(cfg, B=B, S=S):
    """``tests/test_models_smoke.py::make_batch`` as numpy."""
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(B, S))
             .astype(np.int32)}
    if cfg.family == "vlm":
        batch["frontend"] = rng.normal(
            size=(B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(size=(B, S, cfg.d_model)).astype(
            np.float32)
    return batch


def attention_inputs():
    rng = np.random.default_rng(5)
    q, k, v, w = (rng.normal(size=shape).astype(np.float32) for shape in (
        (1, ATTN_S, 4, 16), (1, ATTN_S, 2, 16), (1, ATTN_S, 2, 16),
        (1, ATTN_S, 4, 16)))
    return q, k, v, w


REFERENCE_SCRIPT = textwrap.dedent("""
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import CONFIGS, reduced
    from repro.core.policy import QuantPolicy
    from repro.launch.mesh import make_debug_mesh_info
    from repro.models import attention, build_model
    from repro.models.moe import moe_ffn

    inp = np.load(sys.argv[1])
    part = int(sys.argv[3])             # this process's half of the runs
    out = {}
    def put(prefix, tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            name = "/".join(str(k.key) for k in path)
            out[f"{prefix}/{name}"] = np.asarray(leaf, np.float32)
    minfo = make_debug_mesh_info()
    runs = [(a, a, QuantPolicy()) for a in %(archs)r]
    runs.append(("act", "qwen3-8b", QuantPolicy(activations="posit16")))
    with minfo.mesh:
        for tag, arch, policy in runs[part::2]:
            m = build_model(reduced(CONFIGS[arch]), minfo, policy)
            params = m.init(jax.random.key(0))
            batch = {k.split("/", 1)[1]: jnp.asarray(v)
                     for k, v in inp.items() if k.startswith(arch + "/")}
            (loss, metrics), grads = jax.jit(jax.value_and_grad(
                lambda p: m.loss(p, batch), has_aux=True))(params)
            out[f"{tag}/loss"] = np.asarray(loss)
            for k, v in metrics.items():
                out[f"{tag}/metric/{k}"] = np.asarray(v)
            put(f"{tag}/p", params)
            put(f"{tag}/g", grads)
        if part == 0:
            np.savez(sys.argv[2], **out)
            sys.exit(0)
        # the MoE layer's aux loss on its own (layer 0 of reduced granite)
        m = build_model(reduced(CONFIGS["granite-moe-3b-a800m"]), minfo)
        lp = jax.tree_util.tree_map(lambda t: t[0],
                                    m.init(jax.random.key(0))["layers"])
        x = jnp.asarray(inp["moe_x"]).astype(jnp.bfloat16)
        aux, g = jax.jit(jax.value_and_grad(
            lambda p: moe_ffn(p, x, m.cfg, minfo)[1]))(lp["moe"])
        out["moe/aux"] = np.asarray(aux)
        put("moe/g", g)
    # chunked_attention's gradients at S = %(s)d
    q, k, v, w = (jnp.asarray(inp["attn_" + n]) for n in "qkvw")
    for tag, window in (("causal", 1 << 30), ("window", 700)):
        def f(q, k, v):
            o = attention.chunked_attention(
                q.astype(jnp.bfloat16), k.astype(jnp.bfloat16),
                v.astype(jnp.bfloat16), causal=True, window=window, cap=0.0)
            return jnp.sum(o.astype(jnp.float32) * w)
        gs = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(q, k, v)
        for n, gv in zip("qkv", gs):
            out[f"attn/{tag}/{n}"] = np.asarray(gv)
    np.savez(sys.argv[2], **out)
""" % {"archs": ARCHS, "s": ATTN_S})


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_loss_reference")
    inp = {}
    for arch in ARCHS:
        for k, v in make_batch(reduced(CONFIGS[arch])).items():
            inp[f"{arch}/{k}"] = v
    inp["moe_x"] = np.random.default_rng(3).normal(
        size=(B, S, reduced(CONFIGS["granite-moe-3b-a800m"]).d_model)
    ).astype(np.float32)
    for n, a in zip("qkvw", attention_inputs()):
        inp["attn_" + n] = a
    np.savez(d / "in.npz", **inp)
    env = dict(os.environ, PYTHONPATH="src",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    jobs = [subprocess.Popen([sys.executable, "-c", REFERENCE_SCRIPT,
                              str(d / "in.npz"), str(d / f"out{part}.npz"),
                              str(part)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True, env=env) for part in (0, 1)]
    try:
        for j in jobs:
            _, err = j.communicate(timeout=600)
            assert j.returncode == 0, err
    finally:
        for j in jobs:
            j.kill()
    return {**np.load(d / "out0.npz"), **np.load(d / "out1.npz")}


def nested(ref, prefix):
    """The tree of arrays stored under ``prefix/``."""
    tree = {}
    for key, v in ref.items():
        if key.startswith(prefix + "/"):
            *path, leaf = key[len(prefix) + 1:].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    return tree


def loss_and_grads(model, params, batch):
    """(loss, metrics, [(path, gradient)] in JAX's leaf order) of the
    port's ``model.loss``, the gradient of an unused leaf as zeros."""
    leaves, _ = flatten_state(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, metrics = model.loss(params, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    return loss, metrics, grads


def rel_l2(got, want):
    got = got.detach().to(torch.float32).numpy()
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def check_against(ref, tag, arch, policy=QuantPolicy()):
    cfg = reduced(CONFIGS[arch])
    model = build_model(cfg, policy, device="cpu")
    params = params_from_jax(nested(ref, f"{tag}/p"), "cpu")
    loss, metrics, grads = loss_and_grads(model, params, make_batch(cfg))
    assert abs(float(loss.detach()) - float(ref[f"{tag}/loss"])) < LOSS_TOL
    assert set(metrics) == set(nested(ref, f"{tag}/metric"))
    for k, v in metrics.items():
        assert abs(float(v.detach()) - float(ref[f"{tag}/metric/{k}"])
                   ) < LOSS_TOL, k
    want, _ = flatten_state(nested(ref, f"{tag}/g"))
    assert len(want) == len(grads)
    tol = GRAD_TOL.get(arch, GRAD_TOL_DEFAULT)
    names = flatten_state(nested(ref, f"{tag}/g"))[1]
    for i, (g, w) in enumerate(zip(grads, want)):
        assert g.shape == w.shape, (i, names)
        assert bool(torch.any(g != 0)) == bool(np.any(w != 0)), i
        assert rel_l2(g, w) < tol, (arch, i, rel_l2(g, w))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_hold_the_reference(reference, arch):
    check_against(reference, arch, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_smoke(arch):
    """tests/test_models_smoke.py::test_train_step_smoke for the port."""
    cfg = reduced(CONFIGS[arch])
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    loss, _, grads = loss_and_grads(model, params, make_batch(cfg))
    loss = float(loss.detach())
    assert np.isfinite(loss), (arch, loss)
    assert grads
    for g in grads:
        assert torch.all(torch.isfinite(g))


@pytest.mark.parametrize("tag,window", [("causal", 1 << 30),
                                        ("window", 700)])
def test_chunked_attention_gradient_at_1536(reference, tag, window):
    q, k, v, w = (torch.from_numpy(a).requires_grad_(n != "w")
                  for n, a in zip("qkvw", attention_inputs()))
    out = tattention.chunked_attention(
        q.to(torch.bfloat16), k.to(torch.bfloat16), v.to(torch.bfloat16),
        causal=True, window=window, cap=0.0)
    grads = torch.autograd.grad(torch.sum(out.to(torch.float32) * w),
                                (q, k, v))
    for n, g in zip("qkv", grads):
        assert rel_l2(g, reference[f"attn/{tag}/{n}"]) < GRAD_TOL_DEFAULT, n


def test_moe_aux_loss_and_its_router_gradient(reference):
    cfg = reduced(CONFIGS["granite-moe-3b-a800m"])
    lp = params_from_jax(nested(reference, "granite-moe-3b-a800m/p"),
                         "cpu")["layers"]
    p = {k: v[0].clone().requires_grad_() for k, v in lp["moe"].items()}
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    _, aux = moe_ffn(p, x, cfg)
    assert abs(float(aux) - float(reference["moe/aux"])) < 1e-6
    g = torch.autograd.grad(aux, [p["router"]])[0]
    assert rel_l2(g, reference["moe/g/router"]) < GRAD_TOL_DEFAULT
    # the expert weights take no gradient from the aux loss
    for k in ("w_gate", "w_up", "w_down"):
        assert not np.any(reference[f"moe/g/{k}"])


@pytest.mark.parametrize("arch", ["gemma2-2b", "granite-moe-3b-a800m",
                                  "internvl2-2b", "seamless-m4t-large-v2",
                                  "xlstm-1.3b", "zamba2-7b"])
def test_remat_gives_the_same_loss_and_gradients(arch):
    cfg = reduced(CONFIGS[arch])
    weights = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    runs = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        params = tree_map(lambda t: t.clone(), weights)
        loss, _, grads = loss_and_grads(build_model(c, device="cpu"),
                                        params, make_batch(c))
        runs.append((loss.detach(), grads))
    (l0, g0), (l1, g1) = runs
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_activation_round_loss_and_gradients(reference):
    """qwen3-8b with the block-boundary posit16 round: its STE gradient
    passes every layer's round."""
    check_against(reference, "act", "qwen3-8b",
                  QuantPolicy(activations="posit16"))
