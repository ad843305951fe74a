"""The posit-KV attention kernel's plain version against the TPU kernel
(``posit_kv_attention(..., interpret=True)``), its batched wrapper
(``repro.kernels.ops.kv_attention``) and ``kv_attention_oracle``, within
rtol = atol = 2e-5 (the reference's kernel-vs-oracle tolerance): S not a
multiple of bs, S == 0, length 0, lengths past S and per-row lengths.  The
CUDA kernel is held against this plain version on the card by
``chip_smoke.py`` and ``tests/test_torch_card.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.formats import PositFormat as JPositFormat
from repro.kernels import ops, ref
from repro.kernels.posit_kv_attention import (_block_plan,
                                              posit_kv_attention as jkv)
from repro_torch.core.formats import PositFormat
from repro_torch.kernels.posit_kv_attention import (block_plan,
                                                    posit_kv_attention,
                                                    posit_kv_attention_torch)

TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(B, S, KV, G, D, n, seed):
    rng = np.random.default_rng(seed)
    jf = JPositFormat(n, 2)
    q = rng.standard_normal((B, KV, G, D)).astype(np.float32)
    kv = rng.standard_normal((2, B, S, KV, D)).astype(np.float32)
    k = np.array(ref.encode_ref(jnp.asarray(kv[0]), jf))
    v = np.array(ref.encode_ref(jnp.asarray(kv[1]), jf))
    return q, k, v


def _port(q, k, v, length, n, bs):
    return posit_kv_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), length,
                              PositFormat(n, 2), bs=bs).numpy()


@pytest.mark.parametrize("S,bs", [(1, 512), (96, 512), (200, 64),
                                  (1024, 256), (300, 128)])
def test_block_plan_matches_reference(S, bs):
    assert block_plan(S, bs) == _block_plan(S, bs)


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("S,bs,length", [(1024, 256, 924), (200, 64, 137),
                                         (96, 512, 96), (37, 16, 0),
                                         (50, 512, 777)])
def test_plain_matches_pallas_kernel(n, S, bs, length):
    G, D = 4, 128
    q, k, v = _inputs(1, S, 1, G, D, n, seed=S + n)
    jf = JPositFormat(n, 2)
    want = np.asarray(jkv(jnp.asarray(q[0, 0]), jnp.asarray(k[0, :, 0]),
                          jnp.asarray(v[0, :, 0]),
                          jnp.asarray(length, jnp.int32), jf, bs=bs,
                          interpret=True))
    got = _port(q, k, v, length, n, bs)[0, 0]
    np.testing.assert_allclose(got, want, **TOL)
    oracle = np.asarray(ref.kv_attention_oracle(
        jnp.asarray(q[0, 0]), jnp.asarray(k[0, :, 0]),
        jnp.asarray(v[0, :, 0]), length, jf, bs=bs))
    np.testing.assert_allclose(got, oracle, **TOL)
    if length == 0:
        assert np.all(got == 0.0)


@pytest.mark.parametrize("n", [8, 16])
def test_batched_per_row_lengths_match_ops_wrapper(n):
    B, S, KV, G, D = 4, 96, 2, 3, 16
    q, k, v = _inputs(B, S, KV, G, D, n, seed=7)
    lengths = np.array([0, 1, 77, 96], np.int32)
    want = np.asarray(ops.kv_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(lengths),
                                       JPositFormat(n, 2), bs=32))
    got = _port(q, k, v, torch.from_numpy(lengths), n, 32)
    assert got.shape == (B, KV, G, D)
    np.testing.assert_allclose(got, want, **TOL)
    # a scalar length is shared by every row
    want = np.asarray(ops.kv_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), 50,
                                       JPositFormat(n, 2), bs=32))
    np.testing.assert_allclose(_port(q, k, v, 50, n, 32), want, **TOL)


def test_empty_sequence_returns_zeros():
    q = torch.randn(2, 2, 3, 16)
    bits = torch.zeros((2, 0, 2, 16), dtype=torch.int8)
    out = posit_kv_attention_torch(q, bits, bits, 5, PositFormat(8, 2))
    assert out.shape == (2, 2, 3, 16) and torch.all(out == 0)
    assert posit_kv_attention.launches == 0
