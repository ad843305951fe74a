"""The port's ``vlm`` family against the JAX package, on the reduced
internvl2-2b config (4 layers, 4 heads over 2 KV heads of 16: G = 2, 8
patch rows), with the weights carried over by ``params_from_jax``:

* the carried tree equal to the reference's, leaf by leaf, and
  ``quantize_params``' posit16 bits of every leaf the reference's;
* prefill with 8 numpy-seeded f32 patch rows before the prompt, then 3
  forced decode steps: logits within rtol = atol = 2e-2 of JAX's
  ``DecoderLM`` on both routes (JAX ``jnp`` vs the port's ``torch``; JAX
  ``pallas`` + fused vs the port's ``kernel`` backend on CPU tensors, the
  posit-KV attention kernel's plain version), greedy argmax equal wherever
  JAX's top-2 margin exceeds 4e-2, the cache length ``frontend_len + S``
  plus the steps, and layer 0's posit8 K/V bits equal, bit for bit;
* ``prefill`` with ``lengths`` raising ``NotImplementedError``, as the
  reference's does, and ``ServingEngine`` refusing the model;
* ``tests/test_models_smoke.py``'s decode smoke (shapes, finite logits) and
  its posit16-KV bound against the bf16 cache (atol 0.15, rtol 0.1).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as JCONFIGS, reduced as jreduced
from repro.core.arith import backend_overrides as jbackend
from repro.core.formats import POSIT16 as JPOSIT16
from repro.core.policy import AGGRESSIVE_POLICY as JAGGRESSIVE
from repro.core.quant import PositTensor as JPositTensor
from repro.core.quant import quantize_params as jquantize_params
from repro.launch.mesh import make_debug_mesh_info
from repro.models import build_model as jbuild_model
from repro_torch.configs import CONFIGS, reduced
from repro_torch.core.arith import backend_overrides
from repro_torch.core.formats import POSIT16
from repro_torch.core.policy import AGGRESSIVE_POLICY, QuantPolicy
from repro_torch.core.quant import PositTensor, quantize_params
from repro_torch.models import DecoderLM, build_model
from repro_torch.models import attention as tattention
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import ServeConfig, ServingEngine

ARCH = "internvl2-2b"
TOL = dict(rtol=2e-2, atol=2e-2)            # the serve tests' logit tier
SMOKE_TOL = dict(atol=0.15, rtol=0.1)       # test_models_smoke's KV bound


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
def vlm():
    return _build()


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _batch(cfg, B, S, seed=0):
    """Prompt tokens and f32 patch rows from a numpy seed."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(1, cfg.vocab, (B, S)).astype(np.int32),
            "frontend": rng.normal(size=(B, cfg.frontend_len, cfg.d_model))
            .astype(np.float32)}


def _check_logits(got, want, what):
    got = got.to(torch.float32).numpy()
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, err_msg=what, **TOL)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 4e-2
    np.testing.assert_array_equal(np.argmax(got, -1)[clear],
                                  np.argmax(want, -1)[clear], err_msg=what)


def test_build_model_takes_the_vision_frontend(vlm):
    tm = vlm[4]
    assert type(tm) is DecoderLM
    assert tm.cfg.frontend == "vision_stub" and tm.cfg.frontend_len == 8
    assert tm.cfg.n_heads // tm.cfg.n_kv_heads == 2


def test_tree_carried_over_and_quantized_bits_equal(vlm):
    _, _, jraw, jq, _, traw, tq = vlm
    jleaves, tleaves = dict(_leaves(jraw)), dict(_leaves(traw))
    assert set(jleaves) == set(tleaves)
    for path, t in tleaves.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(jleaves[path]),
                                      err_msg=str(path))
    jleaves, tleaves = dict(_leaves(jq)), dict(_leaves(tq))
    assert set(jleaves) == set(tleaves)
    n_posit = 0
    for path, t in tleaves.items():
        j = jleaves[path]
        assert isinstance(t, PositTensor) == isinstance(j, JPositTensor), \
            path
        if isinstance(t, PositTensor):
            assert j.scale is None and t.scale is None
            np.testing.assert_array_equal(t.bits.numpy(), np.asarray(j.bits))
            n_posit += 1
        else:
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          np.asarray(j).view(np.int16))
    assert n_posit == 8    # table + wq/wk/wv/wo + three ffn matrices


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_prefill_and_decode_logits_match_jax(vlm, route, monkeypatch):
    minfo, jm, _, jq, tm, _, tq = vlm
    cfg = tm.cfg
    calls = []
    kv_attention = tattention.posit_kv_attention
    monkeypatch.setattr(tattention, "posit_kv_attention",
                        lambda *a, **k: calls.append(1) or kv_attention(
                            *a, **k))
    B, S, steps = 3, 9, 3
    batch = _batch(cfg, B, S)
    forced = np.random.default_rng(1).integers(1, cfg.vocab, (steps, B, 1))
    jax_route = dict(fused="on", round_backend="pallas" if route == "kernel"
                     else "jnp")
    with minfo.mesh, jbackend(**jax_route), backend_overrides(
            round_backend="kernel" if route == "kernel" else "torch"):
        jl, jc = jm.prefill(jq, {k: jnp.asarray(v) for k, v in
                                 batch.items()}, S + steps)
        tl, tc = tm.prefill(tq, {k: torch.from_numpy(v) for k, v in
                                 batch.items()}, S + steps)
        _check_logits(tl, jl, f"{route} prefill")
        assert tc.k.bits.shape[2] == cfg.frontend_len + S + steps
        for s in range(steps):
            jl, jc = jm.decode_step(jq, jnp.asarray(forced[s]), jc)
            tl, tc = tm.decode_step(tq, torch.from_numpy(forced[s]), tc)
            _check_logits(tl, jl, f"{route} decode step {s}")
        # layer 0 sees identical inputs, so its posit8 K/V bits agree;
        # deeper layers inherit bf16-level differences (tolerance tier)
        for port, ref in ((tc.k, jc.k), (tc.v, jc.v)):
            np.testing.assert_array_equal(port.bits[0].numpy(),
                                          np.asarray(ref.bits[0]))
    want = cfg.frontend_len + S + steps
    assert tc.length.tolist() == [want] * cfg.n_layers
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    assert len(calls) == (cfg.n_layers * steps if route == "kernel" else 0)


def test_prefill_with_lengths_is_refused_as_in_the_reference(vlm):
    minfo, jm, _, jq, tm, _, tq = vlm
    batch = _batch(tm.cfg, 2, 5)
    lengths = np.array([5, 3], np.int32)
    with minfo.mesh, pytest.raises(NotImplementedError, match="ragged"):
        jm.prefill(jq, {**{k: jnp.asarray(v) for k, v in batch.items()},
                        "lengths": jnp.asarray(lengths)}, 8)
    with pytest.raises(NotImplementedError, match="ragged"):
        tm.prefill(tq, {**{k: torch.from_numpy(v) for k, v in
                           batch.items()},
                        "lengths": torch.from_numpy(lengths)}, 8)


def test_serving_engine_refuses_the_vlm_family(vlm):
    tm, traw = vlm[4], vlm[5]
    with pytest.raises(NotImplementedError, match="'vlm' family"):
        ServingEngine(tm, traw, ServeConfig(batch_size=2, max_prompt=8,
                                            max_new_tokens=2), device="cpu")


def test_decode_smoke():
    """tests/test_models_smoke.py::test_decode_smoke for the port."""
    cfg = reduced(CONFIGS[ARCH])
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(1))
    B, S = 2, 16
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, B, S).items()}
    logits, cache = model.prefill(params, batch, capacity=S + 4)
    assert logits.shape == (B, 1, cfg.padded_vocab)
    assert torch.isfinite(logits).all()
    tok = torch.argmax(logits[:, -1, :cfg.vocab], dim=-1)[:, None]
    logits2, cache = model.decode_step(params, tok, cache)
    assert logits2.shape == (B, 1, cfg.padded_vocab)
    assert torch.isfinite(logits2).all()


def test_posit_kv_cache_decode_matches_bf16():
    """tests/test_models_smoke.py::test_posit_kv_cache_decode_matches_bf16's
    bound, for the vlm family."""
    cfg = reduced(CONFIGS[ARCH])
    m_plain = build_model(cfg, QuantPolicy(), device="cpu")
    m_quant = build_model(cfg, QuantPolicy(kv_cache="posit16"), device="cpu")
    params = m_plain.init(torch.Generator().manual_seed(2))
    B, S = 2, 16
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, B, S).items()}
    lp, cp = m_plain.prefill(params, batch, capacity=S + 2)
    lq, cq = m_quant.prefill(params, batch, capacity=S + 2)
    assert isinstance(cq.k, PositTensor) and not isinstance(cp.k,
                                                            PositTensor)
    tok = torch.argmax(lp[:, -1, :cfg.vocab], dim=-1)[:, None]
    lp2, _ = m_plain.decode_step(params, tok, cp)
    lq2, _ = m_quant.decode_step(params, tok, cq)
    np.testing.assert_allclose(lp2.float().numpy(), lq2.float().numpy(),
                               **SMOKE_TOL)
