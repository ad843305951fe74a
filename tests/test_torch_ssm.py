"""The port's Mamba2 block (``models/ssm.py``) and ``hybrid`` family
(``models/zamba.py::ZambaLM``) against the JAX package, on the reduced
zamba2-7b config (8 layers, every 3: two groups of 3 mamba layers, each
followed by the shared block, then a 2-layer tail; d_model 64, SSD 8 heads
of 16, state 16; shared attention 4 heads over 2 KV heads of 16), with the
weights carried over by ``params_from_jax``:

* the carried tree equal to the reference's, leaf by leaf, and
  ``quantize_params``' posit16 bits of every leaf the reference's;
* ``ssm_forward`` at S = 64, ``chunk=16`` against the reference's (run op
  by op): the output within rtol = atol = 2e-2, the cache's conv window
  (the pre-conv bf16 projection) bit for bit, its state within 2e-2; one
  ``ssm_decode`` step from that cache the same way;
* the port of ``tests/test_substrate.py::test_ssm_chunked_matches_sequential``
  (chunked against the step-by-step oracle, rtol = atol = 5e-2);
* ``ZambaLM`` prefill at S = 512 (two chunks of the default 256) and 3
  forced decode steps: logits within rtol = atol = 2e-2 of JAX's on both
  routes (JAX ``jnp`` vs the port's ``torch``; JAX ``pallas`` + fused vs
  the port's ``kernel`` backend on CPU tensors), greedy argmax equal
  wherever JAX's top-2 margin exceeds 4e-2, the posit-KV attention called
  ``n_groups × steps`` times and the KV append ``n_groups × (1 + steps)``
  on the kernel route;
* the first shared-attention call's posit8 K/V bits: given JAX's input to
  it (JAX's first group run op by op), the port writes JAX's bits, bit for
  bit; from the tokens, the port's first group cache within the 2e-2 tier
  of the reference model's (relative L2 of the dequantized cache) and its
  bits equal on at least 99 % of the patterns (three mamba layers precede
  the call, so bf16 roundings of the two sides differ there);
* the training loss (B = 2, S = 32) on the carried weights within 2e-2 of
  the JAX model's, every gradient leaf within a relative L2 error of 2e-2;
* ``ServingEngine`` refusing the model;
* ``tests/test_models_smoke.py``'s decode smoke (shapes, finite logits)
  and its posit16-KV bound against the bf16 cache (atol 0.15, rtol 0.1).

The model-level JAX side runs in a subprocess compiled with
``--xla_allow_excess_precision=false``: by default XLA's CPU compiler skips
the bf16 roundings between the fused operations of the reference's scan
bodies, which the op-by-op run and the port make.  On this config that
alone moves the reference's decode logits by 0.04 from its op-by-op run.
"""
import functools
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as JCONFIGS, reduced as jreduced
from repro.core.formats import POSIT16 as JPOSIT16
from repro.core.policy import AGGRESSIVE_POLICY as JAGGRESSIVE
from repro.core.quant import PositTensor as JPositTensor
from repro.core.quant import quantize_params as jquantize_params
from repro.launch.mesh import make_debug_mesh_info
from repro.models import attention as jattention
from repro.models import build_model as jbuild_model
from repro.models import common as jcommon
from repro.models import ssm as jssm
from repro.models.common import Builder
from repro_torch.checkpoint import flatten_state
from repro_torch.configs import CONFIGS, reduced
from repro_torch.core.arith import backend_overrides
from repro_torch.core.formats import POSIT16
from repro_torch.core.policy import AGGRESSIVE_POLICY, QuantPolicy
from repro_torch.core.quant import PositTensor, quantize_params
from repro_torch.models import ZambaLM, build_model
from repro_torch.models import attention as tattention
from repro_torch.models import ssm as tssm
from repro_torch.models.common import tree_map, unstack
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import ServeConfig, ServingEngine

ARCH = "zamba2-7b"
TOL = dict(rtol=2e-2, atol=2e-2)            # the serve tests' logit tier
CHUNK_TOL = dict(rtol=5e-2, atol=5e-2)      # test_substrate's chunked tier
SMOKE_TOL = dict(atol=0.15, rtol=0.1)       # test_models_smoke's KV bound
S, STEPS, B = 512, 3, 2                     # two chunks of the default 256


@functools.lru_cache(maxsize=None)
def _build():
    """(mesh info, JAX model, JAX raw and posit16 params, port model, port
    raw and posit16 params) — one set of weights, from jax.random."""
    minfo = make_debug_mesh_info()
    with minfo.mesh:
        jm = jbuild_model(jreduced(JCONFIGS[ARCH]), minfo, JAGGRESSIVE)
        jraw = jm.init(jax.random.key(0))
        jq = jquantize_params(jraw, JPOSIT16, cast_rest=jnp.bfloat16)
    tm = build_model(reduced(CONFIGS[ARCH]), AGGRESSIVE_POLICY, device="cpu")
    traw = params_from_jax(jax.tree_util.tree_map(np.asarray, jraw), "cpu")
    tq = quantize_params(traw, POSIT16, cast_rest=torch.bfloat16)
    return minfo, jm, jraw, jq, tm, traw, tq


@pytest.fixture
def hybrid():
    return _build()


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _inputs(cfg):
    """The prompt (B, S) and the forced decode tokens (STEPS, B, 1), from
    numpy seeds."""
    toks = np.random.default_rng(1).integers(1, cfg.vocab, (B, S))
    forced = np.random.default_rng(2).integers(1, cfg.vocab, (STEPS, B, 1))
    return toks.astype(np.int32), forced.astype(np.int32)


def _check_logits(got, want, what):
    got = got.to(torch.float32).numpy()
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, err_msg=what, **TOL)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 4e-2
    np.testing.assert_array_equal(np.argmax(got, -1)[clear],
                                  np.argmax(want, -1)[clear], err_msg=what)


def _f32(t):
    if isinstance(t, torch.Tensor):
        return t.to(torch.float32).numpy()
    return np.asarray(t, np.float32)


def _bf16_to_torch(a):
    return torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(
        torch.bfloat16)


def test_build_model_is_a_zamba_lm(hybrid):
    tm = hybrid[4]
    assert type(tm) is ZambaLM
    assert (tm.n_groups, tm.every, tm.tail) == (2, 3, 2)
    assert tm.cfg.resolved_head_dim == 16


def test_tree_carried_over_and_quantized_bits_equal(hybrid):
    _, _, jraw, jq, tm, traw, tq = hybrid
    cfg = tm.cfg
    assert set(traw) == {"embed", "groups", "tail", "shared", "final_ln"}
    assert traw["groups"]["mamba"]["ssm"]["in_proj"]["w"].shape[:2] == (2, 3)
    assert traw["groups"]["gate"].shape == (2, cfg.d_model)
    assert traw["tail"]["ssm"]["A_log"].shape[0] == 2
    jleaves, tleaves = dict(_leaves(jraw)), dict(_leaves(traw))
    assert set(jleaves) == set(tleaves)
    for path, t in tleaves.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(jleaves[path]),
                                      err_msg=str(path))
    jleaves, tleaves = dict(_leaves(jq)), dict(_leaves(tq))
    assert set(jleaves) == set(tleaves)
    posit = set()
    for path, t in tleaves.items():
        j = jleaves[path]
        assert isinstance(t, PositTensor) == isinstance(j, JPositTensor), \
            path
        if isinstance(t, PositTensor):
            assert j.scale is None and t.scale is None
            np.testing.assert_array_equal(t.bits.numpy(), np.asarray(j.bits))
            posit.add(path)
        else:
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          np.asarray(j).view(np.int16))
    # the table; in_proj and out_proj of the groups and of the tail; the
    # shared block's wq/wk/wv/wo and three FFN matrices
    assert len(posit) == 1 + 4 + 7


def _layer0(hybrid):
    """The first mamba layer's posit16 parameters on both sides, and the
    reduced configs."""
    _, _, _, jq, tm, _, tq = hybrid
    jp = jax.tree_util.tree_map(lambda a: a[0, 0], jq["groups"]["mamba"])
    tp = tree_map(lambda a: a[0][0], tq["groups"]["mamba"])
    return jp["ssm"], tp["ssm"], jreduced(JCONFIGS[ARCH]), tm.cfg


def test_ssm_forward_and_decode_match_jax(hybrid):
    jp, tp, jcfg, cfg = _layer0(hybrid)
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(B, 64, cfg.d_model)), jnp.bfloat16)
    xt = _bf16_to_torch(x)
    jy, jc = jssm.ssm_forward(jp, x, jcfg, chunk=16)
    ty, tc = tssm.ssm_forward(tp, xt, cfg, chunk=16)
    assert ty.dtype == torch.bfloat16 and ty.shape == jy.shape
    np.testing.assert_allclose(_f32(ty), _f32(jy), **TOL)
    # the conv window is the pre-conv projection: the same bf16 bits
    assert tc.conv.dtype == torch.bfloat16
    np.testing.assert_array_equal(tc.conv.view(torch.int16).numpy(),
                                  np.asarray(jc.conv).view(np.int16))
    assert tc.state.dtype == torch.float32
    np.testing.assert_allclose(tc.state.numpy(), np.asarray(jc.state), **TOL)
    x1 = jnp.asarray(rng.normal(size=(B, 1, cfg.d_model)), jnp.bfloat16)
    jy, jc = jssm.ssm_decode(jp, x1, jcfg, jc)
    ty, tc = tssm.ssm_decode(tp, _bf16_to_torch(x1), cfg, tc)
    np.testing.assert_allclose(_f32(ty), _f32(jy), **TOL)
    assert tc.conv.dtype == torch.bfloat16
    np.testing.assert_array_equal(tc.conv.view(torch.int16).numpy(),
                                  np.asarray(jc.conv).view(np.int16))
    np.testing.assert_allclose(tc.state.numpy(), np.asarray(jc.state), **TOL)


def test_ssm_forward_refuses_a_chunk_that_does_not_divide_s(hybrid):
    _, tp, _, cfg = _layer0(hybrid)
    with pytest.raises(ValueError, match="does not divide"):
        tssm.ssm_forward(tp, torch.zeros((1, 24, cfg.d_model)), cfg,
                         chunk=16)


def test_ssm_chunked_matches_sequential():
    """tests/test_substrate.py::test_ssm_chunked_matches_sequential for the
    port, on the reference's weights and input."""
    jcfg = jreduced(JCONFIGS[ARCH])
    cfg = reduced(CONFIGS[ARCH])
    p = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jssm.init_ssm(Builder(jax.random.key(0)), jcfg)), "cpu")
    x = torch.from_numpy(np.array(jax.random.normal(
        jax.random.key(1), (2, 64, cfg.d_model), jnp.float32) * 0.5))
    got = tssm.ssm_train(p, x, cfg, chunk=16)
    want = tssm.ssm_sequential_ref(p, x, cfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **CHUNK_TOL)


# The JAX model's prefill and decode, both routes, with every bf16
# rounding kept (see the module docstring).
REFERENCE_SCRIPT = textwrap.dedent("""
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import CONFIGS, reduced
    from repro.core.arith import backend_overrides
    from repro.core.formats import POSIT16
    from repro.core.policy import AGGRESSIVE_POLICY
    from repro.core.quant import quantize_params
    from repro.launch.mesh import make_debug_mesh_info
    from repro.models import build_model

    inp = np.load(sys.argv[1])
    out = {}
    minfo = make_debug_mesh_info()
    with minfo.mesh:
        m = build_model(reduced(CONFIGS[%r]), minfo, AGGRESSIVE_POLICY)
        q = quantize_params(m.init(jax.random.key(0)), POSIT16,
                            cast_rest=jnp.bfloat16)
        toks, forced = inp["tokens"], inp["forced"]
        for route, backend in (("plain", "jnp"), ("kernel", "pallas")):
            with backend_overrides(fused="on", round_backend=backend):
                logits, state = m.prefill(q, {"tokens": jnp.asarray(toks)},
                                          toks.shape[1] + len(forced))
                out[f"{route}/logits0"] = np.asarray(logits, np.float32)
                for s, tok in enumerate(forced):
                    logits, state = m.decode_step(q, jnp.asarray(tok), state)
                    out[f"{route}/logits{s + 1}"] = np.asarray(logits,
                                                               np.float32)
                for name, t in (("k", state["kv"].k), ("v", state["kv"].v)):
                    out[f"{route}/{name}_bits"] = np.asarray(t.bits)
                out[f"{route}/length"] = np.asarray(state["kv"].length)
        # the training loss and its gradients on the raw weights
        raw = m.init(jax.random.key(0))
        tb = {"tokens": jnp.asarray(inp["train_tokens"])}
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p: m.loss(p, tb), has_aux=True))(raw)
        out["train/loss"] = np.asarray(loss)
        for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
            out["train/g/" + "/".join(str(k.key) for k in path)] = \
                np.asarray(g)
    np.savez(sys.argv[2], **out)
""" % ARCH)


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """The JAX model's logits at prefill and each forced step and its KV
    caches after them, per route, and its training loss and gradients on
    the raw weights, compiled with every bf16 rounding kept."""
    d = tmp_path_factory.mktemp("zamba_reference")
    toks, forced = _inputs(reduced(CONFIGS[ARCH]))
    np.savez(d / "in.npz", tokens=toks, forced=forced,
             train_tokens=_train_tokens(reduced(CONFIGS[ARCH])))
    env = dict(os.environ, PYTHONPATH="src",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    r = subprocess.run([sys.executable, "-c", REFERENCE_SCRIPT,
                        str(d / "in.npz"), str(d / "out.npz")],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr
    return dict(np.load(d / "out.npz"))


def _counted(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_prefill_and_decode_logits_match_jax(hybrid, reference_runs, route,
                                             monkeypatch):
    tm, tq = hybrid[4], hybrid[6]
    cfg = tm.cfg
    ref = {k.split("/", 1)[1]: v for k, v in reference_runs.items()
           if k.startswith(route + "/")}
    attention = _counted(monkeypatch, tattention, "posit_kv_attention")
    append = _counted(monkeypatch, tattention, "posit_kv_append")
    toks, forced = _inputs(cfg)
    with backend_overrides(round_backend="kernel" if route == "kernel"
                           else "torch"):
        tl, state = tm.prefill(tq, {"tokens": torch.from_numpy(toks)},
                               S + STEPS)
        _check_logits(tl, ref["logits0"], f"{route} prefill")
        assert len(state["ssm"]) == cfg.n_layers
        assert state["kv"].k.bits.shape == (tm.n_groups, B, S + STEPS,
                                             cfg.n_kv_heads,
                                             cfg.resolved_head_dim)
        for s in range(STEPS):
            tl, state = tm.decode_step(tq, torch.from_numpy(forced[s]),
                                       state)
            _check_logits(tl, ref[f"logits{s + 1}"],
                          f"{route} decode step {s}")
    kv = state["kv"]
    assert kv.length.tolist() == [S + STEPS] * tm.n_groups
    np.testing.assert_array_equal(kv.length.numpy(), ref["length"])
    # the first group's cache: three mamba layers before it, so the two
    # sides' bf16 roundings differ there (the bitwise check on identical
    # inputs is the next test); the tier on the whole tensor
    fmt = kv.k.fmt
    for got, name in ((kv.k, "k"), (kv.v, "v")):
        bits, jbits = got.bits[0], ref[f"{name}_bits"][0]
        want = PositTensor(torch.from_numpy(jbits), fmt).dequant().numpy()
        val = got[0].dequant().numpy()
        assert (np.linalg.norm(val - want) / np.linalg.norm(want)
                <= TOL["rtol"]), name
        assert (bits.numpy() == jbits).mean() >= 0.99, name
    want_b6 = tm.n_groups * STEPS if route == "kernel" else 0
    assert len(attention) == want_b6
    assert len(append) == tm.n_groups * (1 + STEPS)


def test_first_shared_attention_writes_jaxs_kv_bits(hybrid):
    """The reference's first group run op by op up to its shared block,
    whose attention prefill fills the first group's cache; the port's
    shared attention, given the same input, writes the same posit8 bits."""
    minfo, jm, _, jq, tm, _, tq = hybrid
    cfg, jcfg = tm.cfg, jreduced(JCONFIGS[ARCH])
    toks, _ = _inputs(cfg)
    fmt = tm.policy.fmt("kv_cache")
    with minfo.mesh:
        x = jcommon.embed(jq["embed"], jnp.asarray(toks))
        for l in range(tm.every):
            lp = jax.tree_util.tree_map(lambda a, l=l: a[0, l],
                                        jq["groups"]["mamba"])
            y, _ = jssm.ssm_prefill(lp["ssm"],
                                    jcommon.rms_norm(x, lp["ln"]), jcfg)
            x = x + y
        h = jcommon.rms_norm(x, jq["shared"]["ln1"])
        jc = jattention.KVCache.create(B, S, cfg.n_kv_heads,
                                       cfg.resolved_head_dim,
                                       fmt=jm.policy.fmt("kv_cache"))
        _, jc = jattention.attention_prefill(jq["shared"]["attn"], h, jcfg,
                                             jc)
    tc = tm._kv_cache(B, S).layer(0)
    _, tc = tattention.attention_prefill(tq["shared"]["attn"],
                                         _bf16_to_torch(h), cfg, tc)
    assert tc.k.fmt == fmt and fmt.name == "posit8"
    for port, ref in ((tc.k, jc.k), (tc.v, jc.v)):
        np.testing.assert_array_equal(port.bits.numpy(),
                                      np.asarray(ref.bits))


def test_zamba_layers_in_order(hybrid):
    """Each group's mamba layers, then its shared block; then the tail."""
    tm, tq = hybrid[4], hybrid[6]
    layers = tm._mamba_layers(tq)
    assert len(layers) == tm.cfg.n_layers
    shared_after = [i for i, (_, g) in enumerate(layers) if g is not None]
    assert shared_after == [2, 5]
    assert [g[0] for _, g in layers if g is not None] == [0, 1]
    tail = unstack(tq["tail"], tm.tail)
    assert torch.equal(layers[-1][0]["ln"], tail[-1]["ln"])


def test_loss_and_gradients_hold_the_reference(hybrid, reference_runs):
    """The training loss of the carried weights (B = 2, S = 32, one
    chunk) within 2e-2 of the JAX model's (the same compiled run as the
    logits above), every gradient leaf within a relative L2 error of 2e-2
    of JAX's, and every leaf given a gradient."""
    tm, traw = hybrid[4], hybrid[5]
    params = tree_map(lambda t: t.detach().clone().requires_grad_(), traw)
    leaves, _ = flatten_state(params)
    loss, metrics = tm.loss(params, {"tokens": torch.from_numpy(
        _train_tokens(tm.cfg))})
    assert set(metrics) == {"ce"} and metrics["ce"] is loss
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(reference_runs["train/loss"])
               ) < TOL["atol"]
    want = {}
    for key, g in reference_runs.items():
        if key.startswith("train/g/"):
            node = want
            *path, leaf = key.split("/")[2:]
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = g
    want, _ = flatten_state(want)
    assert len(want) == len(grads)
    for g, w in zip(grads, want):
        assert g.shape == w.shape and torch.all(torch.isfinite(g))
        rel = float(np.linalg.norm(g.numpy() - w) / np.linalg.norm(w))
        assert rel < 2e-2, rel


def _train_tokens(cfg):
    return np.random.default_rng(7).integers(
        0, cfg.vocab, (2, 32)).astype(np.int32)




def test_serving_engine_refuses_the_hybrid_family(hybrid):
    tm, traw = hybrid[4], hybrid[5]
    with pytest.raises(NotImplementedError, match="'hybrid' family"):
        ServingEngine(tm, traw, ServeConfig(batch_size=2, max_prompt=8,
                                            max_new_tokens=2), device="cpu")


def test_decode_smoke():
    """tests/test_models_smoke.py::test_decode_smoke for the port, and a
    step from ``init_cache``."""
    cfg = reduced(CONFIGS[ARCH])
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(1))
    Bs, Ss = 2, 16
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (Bs, Ss))
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                                  capacity=Ss + 4)
    assert logits.shape == (Bs, 1, cfg.padded_vocab)
    assert torch.isfinite(logits).all()
    tok = torch.argmax(logits[:, -1, :cfg.vocab], dim=-1)[:, None]
    logits2, cache = model.decode_step(params, tok, cache)
    assert logits2.shape == (Bs, 1, cfg.padded_vocab)
    assert torch.isfinite(logits2).all()
    # a step from a fresh state (``init_cache``) runs too
    logits3, _ = model.decode_step(params, tok, model.init_cache(Bs, Ss + 4))
    assert logits3.shape == (Bs, 1, cfg.padded_vocab)
    assert torch.isfinite(logits3).all()


def test_posit_kv_cache_decode_matches_bf16():
    """tests/test_models_smoke.py::test_posit_kv_cache_decode_matches_bf16's
    bound, for the hybrid family's shared attention."""
    cfg = reduced(CONFIGS[ARCH])
    m_plain = build_model(cfg, QuantPolicy(), device="cpu")
    m_quant = build_model(cfg, QuantPolicy(kv_cache="posit16"), device="cpu")
    params = m_plain.init(torch.Generator().manual_seed(2))
    Bs, Ss = 2, 16
    batch = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (Bs, Ss)))}
    lp, cp = m_plain.prefill(params, batch, capacity=Ss + 2)
    lq, cq = m_quant.prefill(params, batch, capacity=Ss + 2)
    assert isinstance(cq["kv"].k, PositTensor)
    assert not isinstance(cp["kv"].k, PositTensor)
    tok = torch.argmax(lp[:, -1, :cfg.vocab], dim=-1)[:, None]
    lp2, _ = m_plain.decode_step(params, tok, cp)
    lq2, _ = m_quant.decode_step(params, tok, cq)
    np.testing.assert_allclose(lp2.float().numpy(), lq2.float().numpy(),
                               **SMOKE_TOL)


def test_init_draws_the_references_initializers():
    """``uniform_pm`` on [1, 16) for ``A_log``, ones for ``D``, zeros for
    ``dt_bias``, and the two-level stack's shapes."""
    cfg = reduced(CONFIGS[ARCH])
    model = build_model(cfg, device="cpu")
    p = model.init(torch.Generator().manual_seed(3))
    ssm = p["groups"]["mamba"]["ssm"]
    H = tssm.ssm_dims(cfg)[1]
    assert ssm["A_log"].shape == (2, 3, H)
    for a in (ssm["A_log"], p["tail"]["ssm"]["A_log"]):
        assert float(a.min()) >= 1.0 and float(a.max()) < 16.0
        assert float(a.std()) > 1.0
    assert torch.equal(ssm["D"], torch.ones_like(ssm["D"]))
    assert not ssm["dt_bias"].any()
    w = ssm["in_proj"]["w"]
    # each layer's 1/sqrt(fan_in), not the stack's
    assert abs(float(w.std()) * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert not torch.equal(w[0, 0], w[0, 1])
