"""The port's ``encdec`` family against the JAX package, on the reduced
seamless-m4t-large-v2 config (2 encoder + 2 decoder layers, 4 heads over 4
KV heads of 16: G = 1, a GELU FFN), with the weights carried over by
``params_from_jax``:

* the carried tree (``embed``, ``encoder`` and ``decoder`` stacks,
  ``enc_ln``, ``final_ln``) equal to the reference's, leaf by leaf, and
  ``quantize_params``' posit16 bits of every leaf the reference's;
* ``encode`` within rtol = atol = 2e-2 of the reference's, at 12 frames
  (plain attention) and at 1536 (the non-causal ``chunked_attention``,
  against the reference's chunked path);
* the cross K/V that prefill keeps: posit8 bits equal, bit for bit, to the
  port's own ``posit_encode`` of its own ``_cross_kv`` output (the encode
  is in the bitwise tier), and bf16 tensors under ``QuantPolicy()``;
* prefill with 12 numpy-seeded f32 frames and 9 BOS tokens, then 3 forced
  decode steps: logits within 2e-2 of JAX's ``EncDecLM`` on both routes
  (JAX ``jnp`` vs the port's ``torch``; JAX ``pallas`` + fused vs the
  port's ``kernel`` backend on CPU tensors), greedy argmax equal wherever
  JAX's top-2 margin exceeds 4e-2, the posit-KV attention called
  ``n_layers`` times a decode step on the kernel route and never on the
  plain one, the cache length S plus the steps; each layer's posit8 cross
  K/V against JAX's (dequantized within 2e-2, bits equal wherever the two
  sides' bf16 projections agree) and decoder layer 0's self-attention
  posit8 K/V bits equal to JAX's, bit for bit;
* ``ServingEngine`` refusing the model;
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
from repro_torch.kernels.posit_codec import posit_encode
from repro_torch.models import EncDecLM, build_model
from repro_torch.models import attention as tattention
from repro_torch.models.common import unstack
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import ServeConfig, ServingEngine

ARCH = "seamless-m4t-large-v2"
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
def encdec():
    return _build()


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _frames(cfg, B, S_src, seed=0):
    return np.random.default_rng(seed).normal(
        size=(B, S_src, cfg.d_model)).astype(np.float32)


def _batch(cfg, B, S, S_src=12, seed=0):
    """BOS tokens and f32 source frames from a numpy seed."""
    rng = np.random.default_rng(seed + 1)
    return {"tokens": rng.integers(1, cfg.vocab, (B, S)).astype(np.int32),
            "frames": _frames(cfg, B, S_src, seed)}


def _check_logits(got, want, what):
    got = got.to(torch.float32).numpy()
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, err_msg=what, **TOL)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 4e-2
    np.testing.assert_array_equal(np.argmax(got, -1)[clear],
                                  np.argmax(want, -1)[clear], err_msg=what)


def test_build_model_is_an_encdec_lm(encdec):
    tm = encdec[4]
    assert type(tm) is EncDecLM
    assert (tm.cfg.enc_layers, tm.cfg.n_layers) == (2, 2)
    assert tm.cfg.n_heads == tm.cfg.n_kv_heads       # G = 1


def test_tree_carried_over_and_quantized_bits_equal(encdec):
    _, _, jraw, jq, tm, traw, tq = encdec
    cfg = tm.cfg
    assert set(traw) == {"embed", "encoder", "decoder", "enc_ln",
                         "final_ln"}
    assert traw["encoder"]["attn"]["wq"]["w"].shape[0] == cfg.enc_layers
    assert traw["decoder"]["cross_attn"]["wk"]["w"].shape[0] == cfg.n_layers
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
    # the table; the encoder's 4 projections + 2 FFN matrices; the
    # decoder's 8 projections + 2 FFN matrices
    assert n_posit == 1 + 6 + 10


@pytest.mark.parametrize("S_src", [12, 1536])
def test_encode_matches_jax(encdec, S_src, monkeypatch):
    minfo, jm, _, jq, tm, _, tq = encdec
    calls = []
    chunked = tattention.chunked_attention
    monkeypatch.setattr(tattention, "chunked_attention",
                        lambda *a, **k: calls.append(k["causal"])
                        or chunked(*a, **k))
    frames = _frames(tm.cfg, 2, S_src)
    with minfo.mesh:
        want = jm.encode(jq, jnp.asarray(frames))
    got = tm.encode(tq, torch.from_numpy(frames))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL)
    # past 1024 positions each encoder layer attends through the blocked,
    # non-causal online softmax, as the reference's does
    assert calls == ([False] * tm.cfg.enc_layers if S_src > 1024 else [])


def test_cross_kv_bits_are_the_encode_of_the_cross_projection(encdec):
    _, _, _, _, tm, _, tq = encdec
    batch = {k: torch.from_numpy(v) for k, v in
             _batch(tm.cfg, 2, 4).items()}
    _, (_, cross) = tm.prefill(tq, batch, 6)
    enc_out = tm.encode(tq, batch["frames"])
    fmt = tm.policy.fmt("kv_cache")
    assert len(cross) == tm.cfg.n_layers
    for lp, (ck, cv) in zip(unstack(tq["decoder"], tm.cfg.n_layers), cross):
        k, v = tm._cross_kv(lp, enc_out)
        for got, x in ((ck, k), (cv, v)):
            assert isinstance(got, PositTensor) and got.fmt == fmt
            assert got.scale is None
            assert torch.equal(got.bits, posit_encode(x.float(), fmt))


def test_cross_kv_stay_bf16_without_a_kv_format(encdec):
    tq = encdec[6]
    cfg = reduced(CONFIGS[ARCH])
    model = build_model(cfg, QuantPolicy(), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 2, 4).items()}
    _, (caches, cross) = model.prefill(tq, batch, 6)
    assert not isinstance(caches.k, PositTensor)
    for ck, cv in cross:
        for t in (ck, cv):
            assert isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16
            assert t.shape == (2, 12, cfg.n_kv_heads, cfg.resolved_head_dim)


def _check_cross_kv(encdec, frames, jx, tx, route):
    """Each decoder layer's posit8 cross K/V from prefill against JAX's:
    the bf16 projections they encode within the 2e-2 tier, as a relative
    L2 error of the whole tensor, and the posit bits equal wherever the
    two sides' projections agree (the encode is in the bitwise tier).
    Where the projections differ by a bf16 rounding, the patterns can
    differ too (by a posit8 step, up to 1/8 of the value, or by several
    steps near 0), so the dequantized values are not held to 2e-2 element
    by element."""
    minfo, jm, _, jq, tm, _, tq = encdec
    cfg = tm.cfg
    with minfo.mesh:
        jenc = jm.encode(jq, jnp.asarray(frames))
    tenc = tm.encode(tq, torch.from_numpy(frames))
    jk, jv = jx
    assert len(tx) == cfg.n_layers
    agree = []
    for i, (lp, (ck, cv)) in enumerate(zip(unstack(tq["decoder"],
                                                   cfg.n_layers), tx)):
        with minfo.mesh:
            jproj = jm._cross_kv(jax.tree_util.tree_map(
                lambda a, i=i: a[i], jq["decoder"]), jenc)
        for got, want, x, jxx, what in zip(
                (ck, cv), (jk, jv), tm._cross_kv(lp, tenc), jproj, "KV"):
            what = f"{route} layer {i} cross {what}"
            assert got.fmt.name == want.fmt.name == "posit8", what
            x, jxx = x.float().numpy(), np.asarray(jxx, np.float32)
            # each projection mixes every encoder output, whose bf16
            # roundings differ between the two sides: the tier is held on
            # the whole tensor (a value near 0 can lose all its digits)
            assert (np.linalg.norm(x - jxx) / np.linalg.norm(jxx)
                    <= TOL["rtol"]), what
            bits, jbits = got.bits.numpy(), np.asarray(want.bits[i])
            same = x == jxx
            np.testing.assert_array_equal(bits[same], jbits[same],
                                          err_msg=what)
            agree.append(same.mean())
    # the bitwise check covers a quarter or more of every tensor
    assert min(agree) > 0.25, agree


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_prefill_and_decode_logits_match_jax(encdec, route, monkeypatch):
    minfo, jm, _, jq, tm, _, tq = encdec
    cfg = tm.cfg
    calls = []
    kv_attention = tattention.posit_kv_attention
    monkeypatch.setattr(tattention, "posit_kv_attention",
                        lambda *a, **k: calls.append(1) or kv_attention(
                            *a, **k))
    B, S, steps = 3, 9, 3
    batch = _batch(cfg, B, S)
    forced = np.random.default_rng(2).integers(1, cfg.vocab, (steps, B, 1))
    jax_route = dict(fused="on", round_backend="pallas" if route == "kernel"
                     else "jnp")
    with minfo.mesh, jbackend(**jax_route), backend_overrides(
            round_backend="kernel" if route == "kernel" else "torch"):
        jl, (jc, jx) = jm.prefill(jq, {k: jnp.asarray(v) for k, v in
                                       batch.items()}, S + steps)
        tl, (tc, tx) = tm.prefill(tq, {k: torch.from_numpy(v) for k, v in
                                       batch.items()}, S + steps)
        _check_logits(tl, jl, f"{route} prefill")
        _check_cross_kv(encdec, batch["frames"], jx, tx, route)
        # the BOS prefill takes the plain route (S_new > 1)
        assert calls == []
        jstate, tstate = (jc, jx), (tc, tx)
        for s in range(steps):
            jl, jstate = jm.decode_step(jq, jnp.asarray(forced[s]), jstate)
            tl, tstate = tm.decode_step(tq, torch.from_numpy(forced[s]),
                                        tstate)
            _check_logits(tl, jl, f"{route} decode step {s}")
        # decoder layer 0's self-attention sees identical inputs (the
        # embedded tokens), so its posit8 K/V bits agree; deeper layers
        # inherit bf16-level differences (tolerance tier)
        for port, ref in ((tstate[0].k, jstate[0].k),
                          (tstate[0].v, jstate[0].v)):
            np.testing.assert_array_equal(port.bits[0].numpy(),
                                          np.asarray(ref.bits[0]))
    tc, tx_after = tstate
    assert tx_after is tx
    assert tc.length.tolist() == [S + steps] * cfg.n_layers
    np.testing.assert_array_equal(tc.length.numpy(),
                                  np.asarray(jstate[0].length))
    assert len(calls) == (cfg.n_layers * steps if route == "kernel" else 0)


def test_serving_engine_refuses_the_encdec_family(encdec):
    tm, traw = encdec[4], encdec[5]
    with pytest.raises(NotImplementedError, match="'encdec' family"):
        ServingEngine(tm, traw, ServeConfig(batch_size=2, max_prompt=8,
                                            max_new_tokens=2), device="cpu")


def test_decode_smoke():
    """tests/test_models_smoke.py::test_decode_smoke for the port."""
    cfg = reduced(CONFIGS[ARCH])
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(1))
    B, S = 2, 16
    batch = {k: torch.from_numpy(v) for k, v in
             _batch(cfg, B, S, S_src=S).items()}
    logits, state = model.prefill(params, batch, capacity=S + 4)
    assert logits.shape == (B, 1, cfg.padded_vocab)
    assert torch.isfinite(logits).all()
    tok = torch.argmax(logits[:, -1, :cfg.vocab], dim=-1)[:, None]
    logits2, state = model.decode_step(params, tok, state)
    assert logits2.shape == (B, 1, cfg.padded_vocab)
    assert torch.isfinite(logits2).all()


def test_posit_kv_cache_decode_matches_bf16():
    """tests/test_models_smoke.py::test_posit_kv_cache_decode_matches_bf16's
    bound, for the encdec family: the posit16 self-attention cache and
    cross K/V against bf16 ones."""
    cfg = reduced(CONFIGS[ARCH])
    m_plain = build_model(cfg, QuantPolicy(), device="cpu")
    m_quant = build_model(cfg, QuantPolicy(kv_cache="posit16"), device="cpu")
    params = m_plain.init(torch.Generator().manual_seed(2))
    B, S = 2, 16
    batch = {k: torch.from_numpy(v) for k, v in
             _batch(cfg, B, S, S_src=S).items()}
    lp, sp = m_plain.prefill(params, batch, capacity=S + 2)
    lq, sq = m_quant.prefill(params, batch, capacity=S + 2)
    assert isinstance(sq[1][0][0], PositTensor)
    tok = torch.argmax(lp[:, -1, :cfg.vocab], dim=-1)[:, None]
    lp2, _ = m_plain.decode_step(params, tok, sp)
    lq2, _ = m_quant.decode_step(params, tok, sq)
    np.testing.assert_allclose(lp2.float().numpy(), lq2.float().numpy(),
                               **SMOKE_TOL)
