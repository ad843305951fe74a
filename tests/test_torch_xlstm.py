"""The port's mLSTM and sLSTM blocks (``models/xlstm.py``) and ``ssm``
family (``models/xlstm_model.py::XLSTMLM``) against the JAX package, on the
reduced xlstm-1.3b config (8 layers: one group of 7 mLSTM + 1 sLSTM blocks;
d_model 64, d_in 128, 4 heads of 32), with the weights carried over by
``params_from_jax``:

* the carried tree equal to the reference's, leaf by leaf, and
  ``quantize_params``' posit16 bits of every leaf the reference's (``w_h``,
  the sLSTM's recurrent weight, included);
* ``mlstm_forward`` (S = 64, ``chunk=16``) and ``slstm_forward`` against
  the reference's (run op by op): outputs and caches within rtol = atol =
  2e-2; one decode step of each from those caches the same way;
* the port of ``tests/test_substrate.py::test_mlstm_chunked_matches_sequential``
  (chunked against the step-by-step oracle, rtol = atol = 5e-2);
* ``XLSTMLM`` prefill at S = 512 (two chunks of the default 256) and 3
  forced decode steps: logits within rtol = atol = 2e-2 of JAX's on both
  routes (JAX ``jnp`` vs the port's ``torch``; JAX ``pallas`` vs the
  port's ``kernel`` backend on CPU tensors), greedy argmax equal wherever
  JAX's top-2 margin exceeds 4e-2;
* the weight decodes of a prefill and of a decode step, counted through
  the wrapped ``quant.posit_decode``: 6 per mLSTM block, 3 per sLSTM
  block, the embedding's rows and the unembedding — ``w_h`` once per sLSTM
  block and pass, not once per position;
* ``ServingEngine`` refusing the model;
* ``tests/test_models_smoke.py``'s decode smoke (shapes, finite logits).

The model-level JAX side runs in a subprocess compiled with
``--xla_allow_excess_precision=false``, as in ``tests/test_torch_ssm.py``.
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
from repro.models import build_model as jbuild_model
from repro.models import xlstm as jxlstm
from repro.models.common import Builder
from repro_torch.configs import CONFIGS, reduced
from repro_torch.core import quant as tquant
from repro_torch.core.arith import backend_overrides
from repro_torch.core.formats import POSIT16
from repro_torch.core.policy import AGGRESSIVE_POLICY
from repro_torch.core.quant import PositTensor, quantize_params
from repro_torch.models import XLSTMLM, build_model
from repro_torch.models import xlstm as txlstm
from repro_torch.models.common import tree_map
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import ServeConfig, ServingEngine

ARCH = "xlstm-1.3b"
TOL = dict(rtol=2e-2, atol=2e-2)            # the serve tests' logit tier
CHUNK_TOL = dict(rtol=5e-2, atol=5e-2)      # test_substrate's chunked tier
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
def xlstm():
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


def _check_cache(got, want, fields, what):
    for f in fields:
        t = getattr(got, f)
        assert t.dtype == torch.float32, (what, f)
        np.testing.assert_allclose(t.numpy(), np.asarray(getattr(want, f)),
                                   err_msg=f"{what} {f}", **TOL)


def test_build_model_is_an_xlstm_lm(xlstm):
    tm = xlstm[4]
    assert type(tm) is XLSTMLM and tm.n_groups == 1
    assert txlstm.mlstm_dims(tm.cfg) == (128, 4, 32)


def test_tree_carried_over_and_quantized_bits_equal(xlstm):
    _, _, jraw, jq, tm, traw, tq = xlstm
    cfg = tm.cfg
    assert set(traw) == {"embed", "groups", "final_ln"}
    g = traw["groups"]
    assert g["mlstm"]["cell"]["wq"]["w"].shape == (1, 7, 128, 128)
    assert g["slstm"]["cell"]["w_h"].shape == (1, 4, 16, 64)
    assert g["mlstm"]["ln"].shape == (1, 7, cfg.d_model)
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
    # the table; the mLSTM's six projections; the sLSTM's w_x, w_h, w_out
    assert len(posit) == 1 + 6 + 3
    assert ("groups", "slstm", "cell", "w_h") in posit


def _cells(xlstm, kind):
    """Group 0's first ``kind`` cell's posit16 parameters on both sides,
    and the reduced configs."""
    _, _, _, jq, tm, _, tq = xlstm
    idx = (0, 0) if kind == "mlstm" else (0,)
    jp = jax.tree_util.tree_map(lambda a: a[idx], jq["groups"][kind]["cell"])
    tp = tree_map(lambda a: a[idx], tq["groups"][kind]["cell"])
    return jp, tp, jreduced(JCONFIGS[ARCH]), tm.cfg


def test_mlstm_forward_and_decode_match_jax(xlstm):
    jp, tp, jcfg, cfg = _cells(xlstm, "mlstm")
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(B, 64, cfg.d_model)), jnp.bfloat16)
    jy, jc = jxlstm.mlstm_forward(jp, x, jcfg, chunk=16)
    ty, tc = txlstm.mlstm_forward(tp, _bf16_to_torch(x), cfg, chunk=16)
    assert ty.dtype == torch.bfloat16 and ty.shape == jy.shape
    np.testing.assert_allclose(_f32(ty), _f32(jy), **TOL)
    _check_cache(tc, jc, "Cnm", "mlstm_forward")
    x1 = jnp.asarray(rng.normal(size=(B, 1, cfg.d_model)), jnp.bfloat16)
    jy, jc = jxlstm.mlstm_decode(jp, x1, jcfg, jc)
    ty, tc = txlstm.mlstm_decode(tp, _bf16_to_torch(x1), cfg, tc)
    np.testing.assert_allclose(_f32(ty), _f32(jy), **TOL)
    _check_cache(tc, jc, "Cnm", "mlstm_decode")


def test_slstm_forward_and_decode_match_jax(xlstm):
    jp, tp, jcfg, cfg = _cells(xlstm, "slstm")
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.normal(size=(B, 64, cfg.d_model)), jnp.bfloat16)
    jy, jc = jxlstm.slstm_forward(jp, x, jcfg)
    ty, tc = txlstm.slstm_forward(tp, _bf16_to_torch(x), cfg)
    assert ty.dtype == torch.bfloat16 and ty.shape == jy.shape
    np.testing.assert_allclose(_f32(ty), _f32(jy), **TOL)
    _check_cache(tc, jc, "cnhm", "slstm_forward")
    x1 = jnp.asarray(rng.normal(size=(B, 1, cfg.d_model)), jnp.bfloat16)
    jy, jc = jxlstm.slstm_decode(jp, x1, jcfg, jc)
    ty, tc = txlstm.slstm_decode(tp, _bf16_to_torch(x1), cfg, tc)
    np.testing.assert_allclose(_f32(ty), _f32(jy), **TOL)
    _check_cache(tc, jc, "cnhm", "slstm_decode")


def test_mlstm_chunked_matches_sequential():
    """tests/test_substrate.py::test_mlstm_chunked_matches_sequential for
    the port, on the reference's weights and input."""
    jcfg = jreduced(JCONFIGS[ARCH])
    cfg = reduced(CONFIGS[ARCH])
    p = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jxlstm.init_mlstm(Builder(jax.random.key(0)), jcfg)),
        "cpu")
    x = torch.from_numpy(np.array(jax.random.normal(
        jax.random.key(1), (2, 64, cfg.d_model), jnp.float32) * 0.5))
    got = txlstm.mlstm_train(p, x, cfg, chunk=16)
    want = txlstm.mlstm_sequential_ref(p, x, cfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **CHUNK_TOL)


# The JAX model's prefill and decode, both routes, with every bf16
# rounding kept (see tests/test_torch_ssm.py).
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
                logits, state = m.prefill(q, {"tokens": jnp.asarray(toks)})
                out[f"{route}/logits0"] = np.asarray(logits, np.float32)
                for s, tok in enumerate(forced):
                    logits, state = m.decode_step(q, jnp.asarray(tok), state)
                    out[f"{route}/logits{s + 1}"] = np.asarray(logits,
                                                               np.float32)
    np.savez(sys.argv[2], **out)
""" % ARCH)


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """The JAX model's logits at prefill and each forced step, per route,
    compiled with every bf16 rounding kept."""
    d = tmp_path_factory.mktemp("xlstm_reference")
    toks, forced = _inputs(reduced(CONFIGS[ARCH]))
    np.savez(d / "in.npz", tokens=toks, forced=forced)
    env = dict(os.environ, PYTHONPATH="src",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    r = subprocess.run([sys.executable, "-c", REFERENCE_SCRIPT,
                        str(d / "in.npz"), str(d / "out.npz")],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr
    return dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_prefill_and_decode_logits_match_jax(xlstm, reference_runs, route,
                                             monkeypatch):
    tm, tq = xlstm[4], xlstm[6]
    cfg = tm.cfg
    ref = {k.split("/", 1)[1]: v for k, v in reference_runs.items()
           if k.startswith(route + "/")}
    w_h = tq["groups"]["slstm"]["cell"]["w_h"]
    decodes = []
    real = tquant.posit_decode
    monkeypatch.setattr(tquant, "posit_decode",
                        lambda bits, *a, **k: decodes.append(
                            tuple(bits.shape)) or real(bits, *a, **k))
    per_pass = tm.n_groups * (7 * 6 + 3) + 2
    toks, forced = _inputs(cfg)
    with backend_overrides(round_backend="kernel" if route == "kernel"
                           else "torch"):
        tl, state = tm.prefill(tq, {"tokens": torch.from_numpy(toks)})
        _check_logits(tl, ref["logits0"], f"{route} prefill")
        assert len(state["mlstm"]) == len(state["slstm"]) == tm.n_groups
        assert all(len(g) == 7 for g in state["mlstm"])
        passes = [decodes[:]]
        for s in range(STEPS):
            decodes.clear()
            tl, state = tm.decode_step(tq, torch.from_numpy(forced[s]),
                                       state)
            _check_logits(tl, ref[f"logits{s + 1}"],
                          f"{route} decode step {s}")
            passes.append(decodes[:])
    for shapes in passes:
        assert len(shapes) == per_pass
        # w_h once per sLSTM block and pass, not once per position
        assert shapes.count(tuple(w_h.bits.shape[1:])) == tm.n_groups


def test_loss_waits_for_the_training_slice(xlstm):
    tm, tq = xlstm[4], xlstm[6]
    with pytest.raises(NotImplementedError, match="A5"):
        tm.loss(tq, {"tokens": torch.zeros((1, 4), dtype=torch.long)})


def test_layers_must_be_whole_groups():
    import dataclasses
    cfg = dataclasses.replace(reduced(CONFIGS[ARCH]), n_layers=12)
    with pytest.raises(ValueError, match="whole groups"):
        build_model(cfg, device="cpu")


def test_serving_engine_refuses_the_ssm_family(xlstm):
    tm, traw = xlstm[4], xlstm[5]
    with pytest.raises(NotImplementedError, match="'ssm' family"):
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


def test_init_draws_the_references_initializers():
    """Ones for the forget-gate bias ``b_f``, 0.02 for ``w_h``, and the
    two-level stack's shapes, each mLSTM block drawn on its own."""
    cfg = reduced(CONFIGS[ARCH])
    p = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    cell = p["groups"]["mlstm"]["cell"]
    assert torch.equal(cell["b_f"], torch.ones((1, 7, cfg.n_heads)))
    assert not cell["b_i"].any()
    w_h = p["groups"]["slstm"]["cell"]["w_h"]
    assert abs(float(w_h.std()) - 0.02) < 0.002
    w = cell["wq"]["w"]
    assert abs(float(w.std()) * 128 ** 0.5 - 1.0) < 0.05
    assert not torch.equal(w[0, 0], w[0, 1])
