"""The port's serving path against the JAX package, on the reduced qwen3-8b
and gemma2-2b configs with the weights carried over by ``params_from_jax``:

* ``quantize_params`` gives the reference's posit16 bits, bit for bit;
* ragged prefill logits and teacher-forced decode-step logits are within
  2e-2 of JAX's on both routes — JAX ``jnp`` vs the port's ``torch``, and
  JAX ``pallas`` + fused vs the port's ``kernel`` backend on CPU tensors
  (the posit-KV attention kernel's plain version) — and the greedy argmax
  is equal wherever JAX's top-2 margin exceeds 4e-2;
* the port's versions of ``tests/test_serve.py``'s engine tests;
* a 5-request engine run whose greedy tokens equal the JAX engine's.
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
from repro.serve import AGGRESSIVE_SERVE as JAGGRESSIVE_SERVE
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JServingEngine
from repro_torch.configs import CONFIGS, reduced
from repro_torch.core.arith import backend_overrides
from repro_torch.core.formats import POSIT16
from repro_torch.core.policy import AGGRESSIVE_POLICY
from repro_torch.core.quant import PositTensor, quantize_params
from repro_torch.models import attention as tattention
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import (AGGRESSIVE_SERVE, ServeConfig, ServePolicy,
                               ServingEngine)

TOL = dict(rtol=2e-2, atol=2e-2)
ARCHS = ["qwen3-8b", "gemma2-2b"]


@functools.lru_cache(maxsize=None)
def _build(name):
    """(name, mesh info, JAX model, JAX raw and posit16 params, port model,
    port raw and posit16 params) — one set of weights, from jax.random."""
    minfo = make_debug_mesh_info()
    with minfo.mesh:
        jm = jbuild_model(jreduced(JCONFIGS[name]), minfo, JAGGRESSIVE)
        jraw = jm.init(jax.random.key(0))
        jq = jquantize_params(jraw, JPOSIT16, cast_rest=jnp.bfloat16)
    tm = build_model(reduced(CONFIGS[name]), AGGRESSIVE_POLICY, device="cpu")
    traw = params_from_jax(jax.tree_util.tree_map(np.asarray, jraw), "cpu")
    tq = quantize_params(traw, POSIT16, cast_rest=torch.bfloat16)
    return name, minfo, jm, jraw, jq, tm, traw, tq


@pytest.fixture(params=ARCHS)
def pair(request):
    return _build(request.param)


@pytest.fixture
def qwen():
    """The engine tests run on the reduced qwen3-8b."""
    return _build("qwen3-8b")


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _np(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def test_quantize_params_bits_equal(pair):
    _, _, _, _, jq, _, _, tq = pair
    jleaves = dict(_leaves(jq))
    tleaves = dict(_leaves(tq))
    assert set(jleaves) == set(tleaves)
    n_posit = 0
    for path, t in tleaves.items():
        j = jleaves[path]
        if isinstance(t, PositTensor):
            assert isinstance(j, JPositTensor), path
            assert t.bits.dtype == torch.int16 and j.scale is None
            np.testing.assert_array_equal(t.bits.numpy(), np.asarray(j.bits))
            n_posit += 1
        else:
            assert not isinstance(j, JPositTensor), path
            np.testing.assert_array_equal(
                _np(t), np.asarray(j).view(np.int16)
                if t.dtype == torch.bfloat16 else np.asarray(j))
    assert n_posit == 8    # table + wq/wk/wv/wo + three ffn matrices


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).astype(np.int32) for n in lens]


def _check_logits(got, want, what):
    got = got.to(torch.float32).numpy()
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, err_msg=what, **TOL)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 4e-2
    np.testing.assert_array_equal(np.argmax(got, -1)[clear],
                                  np.argmax(want, -1)[clear], err_msg=what)


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_prefill_and_decode_logits_match_jax(pair, route, monkeypatch):
    name, minfo, jm, _, jq, tm, _, tq = pair
    calls = []
    kv_attention = tattention.posit_kv_attention
    monkeypatch.setattr(tattention, "posit_kv_attention",
                        lambda *a, **k: calls.append(1) or kv_attention(
                            *a, **k))
    vocab = tm.cfg.vocab
    prompts = _prompts(vocab, [5, 3, 9])
    S, steps = 9, 3
    toks = np.zeros((3, S), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    lengths = np.array([len(p) for p in prompts], np.int32)
    forced = np.random.default_rng(1).integers(1, vocab, (steps, 3, 1))
    jax_route = dict(fused="on", round_backend="pallas" if route == "kernel"
                     else "jnp")
    with minfo.mesh, jbackend(**jax_route), backend_overrides(
            round_backend="kernel" if route == "kernel" else "torch"):
        jl, jc = jm.prefill(jq, {"tokens": jnp.asarray(toks),
                                 "lengths": jnp.asarray(lengths)}, S + steps)
        tl, tc = tm.prefill(tq, {"tokens": torch.from_numpy(toks),
                                 "lengths": torch.from_numpy(lengths)},
                            S + steps)
        _check_logits(tl, jl, f"{name} prefill")
        np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
        for s in range(steps):
            jl, jc = jm.decode_step(jq, jnp.asarray(forced[s]), jc)
            tl, tc = tm.decode_step(tq, torch.from_numpy(forced[s]), tc)
            _check_logits(tl, jl, f"{name} decode step {s}")
        # layer 0 sees identical inputs, so its posit8 K/V bits agree;
        # deeper layers inherit bf16-level differences (tolerance tier)
        for port, ref in ((tc.k, jc.k), (tc.v, jc.v)):
            np.testing.assert_array_equal(port.bits[0].numpy(),
                                          np.asarray(ref.bits[0]))
        np.testing.assert_array_equal(tc.length.numpy(),
                                      np.asarray(jc.length))
    fused = route == "kernel" and tm.cfg.attn_softcap == 0
    assert len(calls) == (tm.cfg.n_layers * steps if fused else 0)


def test_ragged_prefill_logits_match_unbatched(pair):
    _, _, _, _, _, tm, traw, _ = pair
    prompts = _prompts(tm.cfg.vocab, [5, 3, 9])
    S = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), S), np.int64)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    lengths = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    batched, caches = tm.prefill(traw, {"tokens": torch.from_numpy(toks),
                                        "lengths": lengths}, S)
    for i, p in enumerate(prompts):
        solo, _ = tm.prefill(traw, {"tokens": torch.from_numpy(p[None])},
                             len(p))
        np.testing.assert_allclose(batched[i, 0].float().numpy(),
                                   solo[0, -1].float().numpy(), **TOL)
    assert torch.equal(caches.length,
                       lengths.expand(tm.cfg.n_layers, -1))


def test_engine_continuous_batching_and_lanes(qwen):
    _, _, _, _, _, tm, traw, _ = qwen
    eng = ServingEngine(tm, traw, ServeConfig(batch_size=2, max_prompt=16,
                                              max_new_tokens=4, seed=3),
                        AGGRESSIVE_SERVE, device="cpu")
    prompts = _prompts(tm.cfg.vocab, [5, 3, 9, 4, 7], seed=1)
    rids = [eng.submit(p) for p in prompts[:4]]
    rids.append(eng.submit(
        prompts[4], max_new_tokens=2,
        policy=ServePolicy(weights="posit16", kv="posit16")))
    comps = {c.rid: c for c in eng.run()}
    assert sorted(comps) == sorted(rids)
    assert all(len(comps[r].tokens) == 4 for r in rids[:4])
    assert len(comps[rids[4]].tokens) == 2
    assert all(c.finish_reason == "length" for c in comps.values())
    summary = eng.ledger.summary()
    assert {"w=posit16/kv=posit8/act=-", "w=posit16/kv=posit16/act=-",
            "fleet"} <= set(summary)
    fleet = summary["fleet"]
    assert fleet["decode_tokens"] == (4 * 4 + 2) - 5
    assert fleet["requests"] == 5 and fleet["nj_per_token"] > 0


def test_engine_per_request_keys_do_not_replay(qwen):
    _, _, _, _, _, tm, traw, _ = qwen

    def run_twice(seed):
        eng = ServingEngine(tm, traw, ServeConfig(batch_size=2, max_prompt=8,
                                                  max_new_tokens=4,
                                                  seed=seed),
                            device="cpu")
        p = _prompts(tm.cfg.vocab, [6], seed=2)[0]
        r1 = eng.submit(p, temperature=1.0)
        r2 = eng.submit(p, temperature=1.0)
        out = {c.rid: c.tokens for c in eng.run()}
        return out[r1], out[r2]

    a1, a2 = run_twice(seed=11)
    assert not np.array_equal(a1, a2)       # rid enters the draw's seed
    b1, b2 = run_twice(seed=11)
    np.testing.assert_array_equal(a1, b1)   # same seed → reproducible
    np.testing.assert_array_equal(a2, b2)


def test_engine_eos_frees_slot(qwen):
    _, _, _, _, _, tm, traw, _ = qwen
    eng = ServingEngine(tm, traw, ServeConfig(batch_size=1, max_prompt=8,
                                              max_new_tokens=5),
                        device="cpu")
    p = _prompts(tm.cfg.vocab, [4], seed=5)[0]
    eng.submit(p)
    first = eng.run()[0].tokens[0]          # greedy first token
    eng.submit(p, eos_id=int(first))
    c = eng.run()[0]
    assert c.finish_reason == "eos" and len(c.tokens) == 1


def test_engine_greedy_tokens_equal_jax_engine(qwen):
    _, minfo, jm, jraw, _, tm, traw, _ = qwen
    prompts = _prompts(tm.cfg.vocab, [5, 3, 7, 4, 6], seed=4)
    with minfo.mesh:
        jeng = JServingEngine(jm, jraw, JServeConfig(
            batch_size=2, max_prompt=8, max_new_tokens=4), JAGGRESSIVE_SERVE)
        for p in prompts:
            jeng.submit(p)
        want = {c.rid: c.tokens for c in jeng.run()}
    eng = ServingEngine(tm, traw, ServeConfig(batch_size=2, max_prompt=8,
                                              max_new_tokens=4),
                        AGGRESSIVE_SERVE, device="cpu")
    for p in prompts:
        eng.submit(p)
    got = {c.rid: c.tokens for c in eng.run()}
    assert sorted(got) == sorted(want) == list(range(5))
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
