"""The port's ``chunked_attention`` (the blocked online softmax a prefill
of more than 1024 positions without ``lengths`` runs) against the
reference's, at S = 2048 on numpy-seeded bf16 inputs: causal, a local
window, a logit softcap and a query offset; and a long prefill of a reduced
model against JAX's.

Tolerances: the attention output is bf16, and both sides accumulate in f32
in their own order, so they are held within rtol = atol = 1e-2 (a few bf16
ulps of outputs of magnitude ~1); the model's logits within 2e-2, as the
serve tests hold them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as JCONFIGS, reduced as jreduced
from repro.launch.mesh import make_debug_mesh_info
from repro.models import build_model as jbuild_model
from repro.models.attention import chunked_attention as jchunked
from repro_torch.configs import CONFIGS, reduced
from repro_torch.models import build_model
from repro_torch.models.attention import chunked_attention, plain_attention
from repro_torch.models.convert import params_from_jax

ATOL = dict(rtol=1e-2, atol=1e-2)
BIG = 1 << 30
CASES = {
    "causal": dict(causal=True, window=BIG, cap=0.0),
    "local_window": dict(causal=True, window=256, cap=0.0),
    "softcap": dict(causal=True, window=BIG, cap=50.0),
    "bidirectional": dict(causal=False, window=BIG, cap=0.0),
}


def _qkv(Sq, Skv, seed=0, H=4, KV=2, D=16):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(1, Sq, H, D)).astype(np.float32)
    k = rng.normal(size=(1, Skv, KV, D)).astype(np.float32)
    v = rng.normal(size=(1, Skv, KV, D)).astype(np.float32)
    j = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    t = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16) for a in j]
    return j, t


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if not isinstance(x, torch.Tensor) else x.float().numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunked_attention_matches_reference_at_2048(case):
    (jq, jk, jv), (tq, tk, tv) = _qkv(2048, 2048)
    kw = CASES[case]
    want = jchunked(jq, jk, jv, **kw)
    got = chunked_attention(tq, tk, tv, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(want), **ATOL)
    # the blocked softmax is the materialized one, blocked
    np.testing.assert_allclose(
        _np(got), _np(plain_attention(tq, tk, tv, **kw)), **ATOL)


def test_chunked_attention_with_query_offset():
    """512 queries placed at positions 1536.. over 2048 keys, causal, with
    query blocks of 128 and key blocks of 256."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(512, 2048, seed=1)
    kw = dict(causal=True, window=BIG, cap=0.0, q_block=128, k_block=256,
              q_offset=1536)
    want = jchunked(jq, jk, jv, **kw)
    got = chunked_attention(tq, tk, tv, **kw)
    np.testing.assert_allclose(_np(got), _np(want), **ATOL)
    plain = plain_attention(tq, tk, tv, causal=True, window=BIG, cap=0.0,
                            q_offset=1536)
    np.testing.assert_allclose(_np(got), _np(plain), **ATOL)


def test_chunked_attention_refuses_blocks_that_do_not_divide():
    _, (tq, tk, tv) = _qkv(96, 96)
    with pytest.raises(ValueError, match="do not divide"):
        chunked_attention(tq, tk, tv, causal=True, window=BIG, cap=0.0,
                          q_block=64, k_block=64)


@pytest.mark.parametrize("name", ["qwen3-8b", "granite-moe-3b-a800m"])
def test_long_prefill_without_lengths_matches_jax(name):
    """A prefill of 2048 positions without ``lengths`` (the chunked route
    on both sides) on the reduced config: last-position logits within
    2e-2 of JAX's, and the cache filled to 2048."""
    minfo = make_debug_mesh_info()
    with minfo.mesh:
        jm = jbuild_model(jreduced(JCONFIGS[name]), minfo)
        jraw = jm.init(jax.random.key(0))
    tm = build_model(reduced(CONFIGS[name]), device="cpu")
    traw = params_from_jax(jax.tree_util.tree_map(np.asarray, jraw), "cpu")
    toks = np.random.default_rng(2).integers(
        1, tm.cfg.vocab, (1, 2048)).astype(np.int32)
    with minfo.mesh:
        jl, jc = jm.prefill(jraw, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(traw, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32),
                               rtol=2e-2, atol=2e-2)
    assert torch.equal(tc.length, torch.full((tm.cfg.n_layers,), 2048,
                                             dtype=torch.int32))
