"""The two kernels of this slice, by their plain versions, against the
reference's Pallas kernels run in interpret mode on the same inputs.

* ``posit_fma_round`` (B4): bitwise — an elementwise chain, the product and
  the sum each rounded in f32 before the posit rounding, as the reference's
  jnp arm ``rnd(a*b + c)`` and its own kernel test define it.  On crafted
  inputs where a fused multiply-add gives other bits, the reference's
  Pallas kernel in interpret mode is contracted by XLA's CPU compiler (a
  jitted ``a*b + c`` becomes one FMA there); the port is held to the
  separately rounded definition on those inputs and to the interpret-mode
  kernel everywhere else.
* ``posit_matmul`` (B7): the decode is bitwise, but the f32 accumulation
  order is each implementation's own, so rtol = atol = 1e-5 (the
  reference's own tolerance for its kernel).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import arith as jarith
from repro.core.formats import POSIT_FORMATS
from repro.core.quire import quire_matmul_ref as jquire_matmul_ref
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.posit_round import posit_fma_round as jfma
from repro_torch.core.arith import Arith, backend_overrides
from repro_torch.core.formats import get_format
from repro_torch.core.quire import quire_matmul_ref
from repro_torch.kernels import ops
from repro_torch.kernels.posit_matmul import posit_matmul, posit_matmul_torch
from repro_torch.kernels.posit_round import (posit_fma_round,
                                             posit_fma_round_torch)


def _bits(a):
    return np.asarray(a).view(np.uint32)


def _crafted(rng, n):
    """a, b arbitrary f32 and c = −fl(a·b): the separately rounded sum is 0
    wherever a·b is inexact, a fused multiply-add gives its error term."""
    a = (rng.standard_normal(n) * 37).astype(np.float32)
    b = (rng.standard_normal(n) * 11).astype(np.float32)
    return a, b, -(a * b)


@pytest.mark.parametrize("name", ["posit8", "posit10", "posit16"])
def test_fma_plain_bitwise_vs_pallas_interpret(name):
    fmt, tfmt = POSIT_FORMATS[name], get_format(name)
    rng = np.random.default_rng(5)
    cases = [tuple(rng.normal(0, 30, (33, 130)).astype(np.float32)
                   for _ in range(3)),
             # broadcast: a row against a column and a scalar
             (rng.normal(0, 9, (1, 130)).astype(np.float32),
              rng.normal(0, 9, (33, 1)).astype(np.float32),
              np.float32(2.5) * np.ones((), np.float32))]
    for a, b, c in cases:
        want = np.asarray(jfma(jnp.asarray(a), jnp.asarray(b),
                               jnp.asarray(c), fmt, interpret=True))
        got = posit_fma_round(*(torch.from_numpy(np.asarray(v))
                                for v in (a, b, c)), tfmt).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("name", ["posit8", "posit10", "posit16"])
def test_fma_crafted_inputs_tell_contraction_apart(name):
    """On the crafted inputs the separately rounded sum is exactly 0 —
    the port's plain version and the reference's jnp arm alike — and a
    fused multiply-add (computed exactly in f64 here) would round to
    nonzero posits."""
    a, b, c = _crafted(np.random.default_rng(6), 4096)
    fmt = get_format(name)
    got = posit_fma_round_torch(*(torch.from_numpy(v) for v in (a, b, c)),
                                fmt)
    with jarith.backend_overrides(round_backend="jnp"):
        want = np.asarray(jarith.Arith.make(name).fma(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(c)))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert torch.all(got == 0)
    fused = (torch.from_numpy(a).double() * torch.from_numpy(b).double()
             + torch.from_numpy(c).double()).float()
    assert float((posit_fma_round_torch(fused, torch.ones(()),
                                        torch.zeros(()), fmt) != 0)
                 .float().mean()) > 0.9


@pytest.mark.parametrize("backend", ["auto", "torch", "kernel", "codec"])
@pytest.mark.parametrize("name", ["posit16", "posit8", "fp16", "fp32"])
def test_arith_fma_under_every_round_backend(name, backend):
    rng = np.random.default_rng(7)
    a, b, c = (rng.normal(0, 20, (17, 9)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jarith.Arith.make(name).fma(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(c)))
    with backend_overrides(round_backend=backend):
        got = Arith.make(name).fma(torch.from_numpy(a), torch.from_numpy(b),
                                   torch.from_numpy(c)).numpy()
        scalar = Arith.make(name).fma(torch.from_numpy(a), 3.0, 0.5).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(scalar), _bits(np.asarray(
        jarith.Arith.make(name).fma(jnp.asarray(a), 3.0, 0.5))))


def _matmul_bits(fmt, M, K, N, seed=2):
    """The reference suite's inputs: realistic magnitudes, encoded."""
    rng = np.random.default_rng(seed)
    a = jref.encode_ref(jnp.asarray(rng.normal(size=(M, K)), jnp.float32),
                        fmt)
    b = jref.encode_ref(jnp.asarray(rng.normal(size=(K, N)) / np.sqrt(K),
                                    jnp.float32), fmt)
    return np.asarray(a), np.asarray(b)


@pytest.mark.parametrize("name", ["posit16", "posit8"])
@pytest.mark.parametrize("mnk", [(128, 128, 128), (256, 128, 256)])
def test_matmul_plain_vs_pallas_interpret_and_oracle(name, mnk):
    M, N, K = mnk
    fmt, tfmt = POSIT_FORMATS[name], get_format(name)
    a, b = _matmul_bits(fmt, M, K, N)
    kernel = np.asarray(jops.matmul(jnp.asarray(a), jnp.asarray(b), fmt,
                                    bm=128, bn=128, bk=128))
    oracle = np.asarray(jquire_matmul_ref(jnp.asarray(a), jnp.asarray(b),
                                          fmt))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = ops.matmul(ta, tb, tfmt, bm=128, bn=128, bk=128).numpy()
    assert got.dtype == np.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got, kernel, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got, posit_matmul_torch(ta, tb,
                                                          tfmt).numpy())
    np.testing.assert_array_equal(got, quire_matmul_ref(ta, tb,
                                                        tfmt).numpy())


def test_matmul_decodes_to_bf16_before_the_product():
    """posit16's 12-bit fractions are rounded to bf16's 8 first, as the
    reference's compute dtype does: 1 + 2⁻¹⁰ times 1 gives 1."""
    fmt = get_format("posit16")
    one_eps = ops.encode(torch.tensor([[1.0 + 2 ** -10]]), fmt)
    one = ops.encode(torch.tensor([[1.0]]), fmt)
    assert float(posit_matmul(one_eps, one, fmt)[0, 0]) == 1.0


@pytest.mark.parametrize("mnk", [(100, 128, 128), (128, 96, 128),
                                 (128, 128, 200)])
def test_ops_matmul_keeps_the_reference_block_assert(mnk):
    M, N, K = mnk
    fmt = POSIT_FORMATS["posit16"]
    a, b = _matmul_bits(fmt, M, K, N)
    with pytest.raises(AssertionError):
        jops.matmul(jnp.asarray(a), jnp.asarray(b), fmt, bm=64, bn=64, bk=64)
    with pytest.raises(AssertionError):
        ops.matmul(torch.from_numpy(a), torch.from_numpy(b),
                   get_format("posit16"), bm=64, bn=64, bk=64)
