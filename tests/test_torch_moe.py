"""The port's ``moe`` family against the JAX package, on the reduced
granite-moe-3b-a800m (4 experts, top-2) and dbrx-132b (4 experts, top-2)
configs, with the weights carried over by ``params_from_jax`` from a JAX
model built on a (1, 1) mesh (so the expert stacks are not padded):

* the carried tree's shapes, and ``quantize_params``' posit16 bits of every
  leaf the reference's, the expert stacks included;
* ``moe_ffn`` against ``repro.models.moe.moe_ffn``: the same chosen
  experts, the same capacity selection (with tokens over capacity), the
  output within the implementation-defined tier (rtol = atol = 2e-2 of the
  bf16 output; on the CPU it comes out bit for bit), the aux loss within
  1e-6;
* prefill and decode logits against JAX's ``DecoderLM`` on the same
  right-padded batch, within 2e-2, greedy argmax equal where JAX's top-2
  margin exceeds 4e-2 — the prompts [5, 3, 9, 30] included, whose 30-token
  row loses tokens to the capacity in the reference, which the port
  reproduces;
* the reference's own padded-versus-solo break pinned (ROADMAP §C);
* greedy tokens of ``ServingEngine`` equal to the JAX engine's, the
  KV-format lanes of ``tests/test_serve.py``, nJ/token equal to the
  reference's accounting.

The padded-versus-solo and engine comparisons take their JAX side from a
subprocess that compiles with every bf16 rounding kept (see
``REFERENCE_SCRIPT``).
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
from jax import lax

from repro.configs import CONFIGS as JCONFIGS, reduced as jreduced
from repro.core.arith import backend_overrides as jbackend
from repro.core.formats import POSIT16 as JPOSIT16
from repro.core.policy import AGGRESSIVE_POLICY as JAGGRESSIVE
from repro.core.quant import PositTensor as JPositTensor
from repro.core.quant import quantize_params as jquantize_params
from repro.launch.mesh import make_debug_mesh_info
from repro.models import build_model as jbuild_model
from repro.models.moe import _capacity as jcapacity
from repro.models.moe import moe_ffn as jmoe_ffn
from repro_torch.configs import CONFIGS, reduced
from repro_torch.core.arith import backend_overrides
from repro_torch.core.formats import POSIT16
from repro_torch.core.policy import AGGRESSIVE_POLICY
from repro_torch.core.quant import PositTensor, quantize_params
from repro_torch.models import DecoderLM, build_model
from repro_torch.models import moe as tmoe
from repro_torch.models.common import unstack
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import (AGGRESSIVE_SERVE, ServeConfig, ServePolicy,
                               ServingEngine)

TOL = dict(rtol=2e-2, atol=2e-2)
ARCHS = ["granite-moe-3b-a800m", "dbrx-132b"]
PADDED_LENS = [5, 3, 9, 30]


@functools.lru_cache(maxsize=None)
def _build(name):
    """(mesh info, JAX model, JAX raw and posit16 params, port model, port
    raw and posit16 params) — one set of weights, from jax.random."""
    minfo = make_debug_mesh_info()
    with minfo.mesh:
        jm = jbuild_model(jreduced(JCONFIGS[name]), minfo, JAGGRESSIVE)
        jraw = jm.init(jax.random.key(0))
        jq = jquantize_params(jraw, JPOSIT16, cast_rest=jnp.bfloat16)
    tm = build_model(reduced(CONFIGS[name]), AGGRESSIVE_POLICY, device="cpu")
    traw = params_from_jax(jax.tree_util.tree_map(np.asarray, jraw), "cpu")
    tq = quantize_params(traw, POSIT16, cast_rest=torch.bfloat16)
    return minfo, jm, jraw, jq, tm, traw, tq


@pytest.fixture(params=ARCHS)
def pair(request):
    return _build(request.param)


@pytest.fixture
def granite():
    return _build("granite-moe-3b-a800m")


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def test_build_model_is_a_decoder_lm_for_moe_and_refuses_the_rest():
    for name in ARCHS:
        assert type(build_model(reduced(CONFIGS[name]),
                                device="cpu")) is DecoderLM
    for name in ("internvl2-2b", "seamless-m4t-large-v2", "xlstm-1.3b",
                 "zamba2-7b"):
        with pytest.raises(NotImplementedError, match="A3"):
            build_model(reduced(CONFIGS[name]), device="cpu")


def test_moe_tree_carried_over_and_quantized_bits_equal(pair):
    _, jm, _, jq, tm, traw, tq = pair
    cfg = tm.cfg
    L, d, E, f = cfg.n_layers, cfg.d_model, cfg.n_experts, cfg.d_ff
    moe = traw["layers"]["moe"]
    assert tuple(moe["router"].shape) == (L, d, E)
    assert tuple(moe["w_gate"].shape) == tuple(moe["w_up"].shape) == \
        (L, E, d, f)
    assert tuple(moe["w_down"].shape) == (L, E, f, d)
    assert "ffn" not in traw["layers"]
    jleaves, tleaves = dict(_leaves(jq)), dict(_leaves(tq))
    assert set(jleaves) == set(tleaves)
    posit = set()
    for path, t in tleaves.items():
        j = jleaves[path]
        assert isinstance(t, PositTensor) == isinstance(j, JPositTensor), \
            path
        if isinstance(t, PositTensor):
            np.testing.assert_array_equal(t.bits.numpy(), np.asarray(j.bits))
            posit.add(path[-1])
        elif t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          np.asarray(j).view(np.int16))
    assert {"w_gate", "w_up", "w_down"} <= posit
    assert isinstance(tq["layers"]["moe"]["router"], torch.Tensor)


def _jax_selection(xf, rw, cfg, C):
    """The reference's routing and capacity selection (the lines of
    ``repro.models.moe.moe_ffn``'s island for one shard), in jnp."""
    T = xf.shape[0]
    gates = jax.nn.softmax(xf.astype(jnp.float32) @ rw, axis=-1)
    _, assign = lax.top_k(gates, cfg.top_k)
    hit = assign[None] == jnp.arange(cfg.n_experts)[:, None, None]
    routed = hit.any(-1)
    score = jnp.where(routed, (T - jnp.arange(T)).astype(jnp.float32), 0.0)
    _, idx = lax.top_k(score, C)
    return np.asarray(assign), np.asarray(idx), np.asarray(routed)


@pytest.mark.parametrize("T", [30, 120])
def test_moe_ffn_matches_reference(pair, T):
    minfo, jm, _, jq, tm, _, tq = pair
    cfg = tm.cfg
    rng = np.random.default_rng(T)
    # a direction shared by every token skews the routing, as the pad rows
    # of a padded batch do, so that some expert runs over its capacity
    x = rng.normal(size=(4, T // 4, cfg.d_model)) + 2.0 * rng.normal(
        size=cfg.d_model)
    xb = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(
        torch.bfloat16)
    jp = jax.tree_util.tree_map(lambda a: a[1], jq["layers"]["moe"])
    tp = unstack(tq["layers"], cfg.n_layers)[1]["moe"]
    with minfo.mesh:
        want, want_aux = jmoe_ffn(jp, xb, jm.cfg, minfo)
        C = jcapacity(T, jm.cfg)
        assign, idx, routed = _jax_selection(
            xb.reshape(-1, cfg.d_model), jp["router"].astype(jnp.float32),
            jm.cfg, C)
    got, got_aux = tmoe.moe_ffn(tp, xt, cfg)
    assert tmoe._capacity(T, cfg) == C
    xf = xt.reshape(-1, cfg.d_model)
    _, gatev, t_assign = tmoe.route(xf, tp["router"].to(torch.float32),
                                    cfg.top_k)
    np.testing.assert_array_equal(t_assign.numpy(), assign)
    t_idx, _, _, kept = tmoe.select(t_assign, gatev, cfg.n_experts, C)
    np.testing.assert_array_equal(t_idx.numpy(), idx)
    if T == 120:   # some expert is over capacity: tokens are dropped
        assert int(routed.sum()) > int(kept.sum())
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL)
    assert abs(float(got_aux) - float(want_aux)) <= 1e-6


def _padded(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, vocab, size=n).astype(np.int32) for n in lens]
    toks = np.zeros((len(lens), max(lens)), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    return prompts, toks, np.array(lens, np.int32)


def _check_logits(got, want, what):
    got = got.to(torch.float32).numpy()
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, err_msg=what, **TOL)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 4e-2
    np.testing.assert_array_equal(np.argmax(got, -1)[clear],
                                  np.argmax(want, -1)[clear], err_msg=what)


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_prefill_and_decode_logits_match_jax(pair, route):
    """The same right-padded batch through both models, prefill then three
    teacher-forced decode steps, on both routes (the port's ``kernel``
    backend on CPU tensors takes the kernels' plain versions)."""
    minfo, jm, _, jq, tm, _, tq = pair
    vocab = tm.cfg.vocab
    _, toks, lengths = _padded(vocab, PADDED_LENS)
    S, steps = toks.shape[1], 3
    forced = np.random.default_rng(1).integers(1, vocab,
                                               (steps, len(lengths), 1))
    jax_route = dict(fused="on", round_backend="pallas" if route == "kernel"
                     else "jnp")
    with minfo.mesh, jbackend(**jax_route), backend_overrides(
            round_backend="kernel" if route == "kernel" else "torch"):
        jl, jc = jm.prefill(jq, {"tokens": jnp.asarray(toks),
                                 "lengths": jnp.asarray(lengths)}, S + steps)
        tl, tc = tm.prefill(tq, {"tokens": torch.from_numpy(toks),
                                 "lengths": torch.from_numpy(lengths)},
                            S + steps)
        _check_logits(tl, jl, "prefill")
        for s in range(steps):
            jl, jc = jm.decode_step(jq, jnp.asarray(forced[s]), jc)
            tl, tc = tm.decode_step(tq, torch.from_numpy(forced[s]), tc)
            _check_logits(tl, jl, f"decode step {s}")
        np.testing.assert_array_equal(tc.length.numpy(),
                                      np.asarray(jc.length))


# The JAX side of the next two tests runs in a subprocess with XLA's excess
# precision off.  By default XLA's CPU compiler skips bf16 roundings between
# fused operations that the program asks for (and that JAX's op-by-op run
# and the port make); where a router input sits at a top-k or capacity
# boundary, that flips an expert.  At the [5, 3, 9, 30] batch the compiled
# reference's 30-token row is 0.08 from its own op-by-op run, and its
# engine's greedy tokens fork from its op-by-op run's at a near-tie of the
# reduced model's flat logits.  With every rounding kept, the compiled run
# is the op-by-op one, at the compiled speed.
REFERENCE_SCRIPT = textwrap.dedent("""
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import CONFIGS, reduced
    from repro.core.policy import AGGRESSIVE_POLICY
    from repro.launch.mesh import make_debug_mesh_info
    from repro.models import build_model
    from repro.serve import AGGRESSIVE_SERVE, ServeConfig, ServingEngine

    inp = np.load(sys.argv[1])
    out = {}
    minfo = make_debug_mesh_info()
    for name in %r:
        with minfo.mesh:
            m = build_model(reduced(CONFIGS[name]), minfo, AGGRESSIVE_POLICY)
            raw = m.init(jax.random.key(0))
            eng = ServingEngine(m, raw, ServeConfig(
                batch_size=2, max_prompt=8, max_new_tokens=4),
                AGGRESSIVE_SERVE)
            for i in range(5):
                eng.submit(inp[f"{name}/prompt{i}"])
            for c in eng.run():
                out[f"{name}/tokens{c.rid}"] = c.tokens
            lp, _ = m.prefill(raw, {"tokens": jnp.asarray(inp["toks"]),
                                    "lengths": jnp.asarray(inp["lengths"])})
            ls, _ = m.prefill(raw, {"tokens": jnp.asarray(inp["long"])})
            out[f"{name}/padded"] = np.asarray(lp, np.float32)
            out[f"{name}/solo"] = np.asarray(ls, np.float32)
    np.savez(sys.argv[2], **out)
""" % (ARCHS,))


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """The JAX engine's greedy tokens for five prompts and the padded and
    solo prefill logits, for both configs, from a run with every bf16
    rounding kept (``--xla_allow_excess_precision=false``)."""
    d = tmp_path_factory.mktemp("moe_reference")
    inp = {}
    for name in ARCHS:
        vocab = reduced(CONFIGS[name]).vocab
        for i, p in enumerate(_prompts(vocab, [5, 3, 7, 4, 6], seed=4)):
            inp[f"{name}/prompt{i}"] = p
    prompts, toks, lengths = _padded(reduced(CONFIGS[ARCHS[0]]).vocab,
                                     PADDED_LENS)
    inp.update(toks=toks, lengths=lengths, long=prompts[3][None])
    np.savez(d / "in.npz", **inp)
    env = dict(os.environ, PYTHONPATH="src",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    r = subprocess.run([sys.executable, "-c", REFERENCE_SCRIPT,
                        str(d / "in.npz"), str(d / "out.npz")],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr
    return inp, dict(np.load(d / "out.npz"))


def test_padded_batch_reproduces_the_references_capacity_drops(
        pair, reference_runs):
    """The reference's MoE capacity is first-come-first-served over the
    whole batch, pad positions included, so the padded batch's 30-token row
    loses tokens and is not its solo prefill (ROADMAP §C, "Faults of the
    reference").  The port reproduces the padded row, not the solo one."""
    _, _, _, _, tm, traw, _ = pair
    inp, ref = reference_runs
    name = tm.cfg.name
    jl, js = ref[f"{name}/padded"], ref[f"{name}/solo"]
    tl, _ = tm.prefill(traw, {"tokens": torch.from_numpy(inp["toks"]),
                              "lengths": torch.from_numpy(inp["lengths"])})
    ts, _ = tm.prefill(traw, {"tokens": torch.from_numpy(inp["long"])})
    tl, ts = tl.float().numpy(), ts.float().numpy()
    np.testing.assert_allclose(tl, jl, **TOL)
    np.testing.assert_allclose(ts, js, **TOL)
    if name == "granite-moe-3b-a800m":
        assert np.abs(jl[3, 0] - js[0, -1]).max() > 0.1  # the reference
        assert np.abs(tl[3, 0] - ts[0, -1]).max() > 0.1  # and the port
    # the three short rows fit the capacity: padded equals solo there
    for i, n in enumerate(PADDED_LENS[:3]):
        solo, _ = tm.prefill(traw, {"tokens": torch.from_numpy(
            inp["toks"][i:i + 1, :n])})
        np.testing.assert_allclose(tl[i, 0], solo[0, -1].float().numpy(),
                                   **TOL)


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).astype(np.int32) for n in lens]


def test_engine_greedy_tokens_equal_jax_engine(pair, reference_runs):
    """Five requests through two slots: every greedy token equal to the JAX
    engine's (run with every bf16 rounding kept, above)."""
    _, _, _, _, tm, traw, _ = pair
    inp, ref = reference_runs
    name = tm.cfg.name
    eng = ServingEngine(tm, traw, ServeConfig(batch_size=2, max_prompt=8,
                                              max_new_tokens=4),
                        AGGRESSIVE_SERVE, device="cpu")
    for i in range(5):
        eng.submit(inp[f"{name}/prompt{i}"])
    got = {c.rid: c.tokens for c in eng.run()}
    assert sorted(got) == list(range(5))
    for rid in got:
        np.testing.assert_array_equal(got[rid], ref[f"{name}/tokens{rid}"])


def test_engine_kv_format_lanes(granite):
    """tests/test_serve.py's KV-format A/B on the MoE model: 5 requests
    through 2 slots, one on the posit16-KV lane; every request completes
    with its budget and the ledger has both lanes; the posit8 cache moves
    half the posit16 cache's bytes and prices a token lower, and a longer
    context prices it higher."""
    from repro_torch.serve.accounting import (kv_traffic_bytes,
                                              token_energy_nj)
    _, _, _, _, tm, traw, _ = granite
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
    cfg = tm.cfg
    p8 = ServePolicy(weights="posit16", kv="posit8")
    p16 = ServePolicy(weights="posit16", kv="posit16")
    r8, w8 = kv_traffic_bytes(cfg, 100, 8)
    r16, w16 = kv_traffic_bytes(cfg, 100, 16)
    assert r8 * 2 == r16 and w8 * 2 == w16
    e8 = token_energy_nj(cfg, 100, p8)
    assert e8 < token_energy_nj(cfg, 100, p16)
    assert token_energy_nj(cfg, 200, p8) > e8


@pytest.mark.parametrize("name", ARCHS)
def test_token_energy_equals_the_reference(name):
    """serve/accounting.py's n_experts terms: nJ per decode token and per
    prefill equal to the reference's, at full width and reduced."""
    from repro.serve import ServePolicy as JServePolicy
    from repro.serve.accounting import prefill_energy_nj as jprefill
    from repro.serve.accounting import token_energy_nj as jtoken
    from repro_torch.serve.accounting import (prefill_energy_nj,
                                              token_energy_nj)
    for tcfg, jcfg in ((CONFIGS[name], JCONFIGS[name]),
                       (reduced(CONFIGS[name]), jreduced(JCONFIGS[name]))):
        for kv in ("posit8", "posit16"):
            tp = ServePolicy(weights="posit16", kv=kv)
            jp = JServePolicy(weights="posit16", kv=kv)
            for ctx in (1, 37, 96):
                assert token_energy_nj(tcfg, ctx, tp) == \
                    pytest.approx(jtoken(jcfg, ctx, jp), rel=1e-12)
            assert prefill_energy_nj(tcfg, 64, tp) == \
                pytest.approx(jprefill(jcfg, 64, jp), rel=1e-12)


def test_serve_cli_runs_granite_moe(capsys):
    from repro_torch.launch import serve as serve_cli
    serve_cli.main(["--arch", "granite-moe-3b-a800m", "--device", "cpu",
                    "--requests", "3", "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert out.count("[serve] rid=") == 3 and "[ledger] fleet" in out
