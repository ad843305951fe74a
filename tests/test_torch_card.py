"""The CUDA kernels against their plain versions, on the card.

Needs an NVIDIA card and nvcc; without them every test here skips.  Run on
the card with ``python -m pytest -q -m cuda tests/test_torch_card.py``
(the file imports no jax, so it runs where only torch is installed).
Tiers: the round and the butterfly bitwise, the matmul within one ulp.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.arith import Arith, backend_overrides
from repro_torch.core.formats import get_format
from repro_torch.core.posit import encode
from repro_torch.kernels.posit_matmul import (posit_matmul_round,
                                              posit_matmul_round_torch)
from repro_torch.kernels.posit_round import (posit_butterfly,
                                             posit_butterfly_torch,
                                             posit_round, posit_round_torch)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _equal_bits(a, b):
    idt = torch.int32 if a.dtype == torch.float32 else torch.int64
    return torch.equal(a.view(idt), b.view(idt))


@pytest.mark.parametrize("name", ["posit8", "posit10", "posit16", "posit32"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_round_kernel_bitwise(name, dtype, dev):
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(1 << 16, generator=g, dtype=dtype)
         * torch.exp2(torch.randint(-140, 140, (1 << 16,), generator=g)
                      .to(dtype))).to(dev)
    fmt = get_format(name)
    assert _equal_bits(posit_round(x, fmt), posit_round_torch(x, fmt))


def test_butterfly_kernel_bitwise(dev):
    fmt = get_format("posit16")
    g = torch.Generator().manual_seed(1)
    planes = [posit_round_torch(torch.randn(8, 2, 4, 64, generator=g)
                                * 1e4, fmt).to(dev) for _ in range(4)]
    w = [posit_round_torch(torch.randn(4, 1, generator=g), fmt).to(dev)
         for _ in range(2)]
    for a, b in zip(posit_butterfly(*planes, *w, fmt),
                    posit_butterfly_torch(*planes, *w, fmt)):
        assert _equal_bits(a, b)


def test_matmul_kernel_within_one_ulp(dev):
    fmt = get_format("posit16")
    g = torch.Generator().manual_seed(2)
    a = posit_round_torch(torch.rand(37, 2049, generator=g) * 1e6, fmt)
    b = posit_round_torch(torch.rand(2049, 20, generator=g), fmt)
    k = posit_matmul_round(a.to(dev), b.to(dev), fmt).cpu()
    p = posit_matmul_round_torch(a.to(dev), b.to(dev), fmt).cpu()

    def ordered(v):
        q = encode(v, fmt).to(torch.int64) & fmt.mask
        return (q ^ fmt.nar_pattern) - fmt.nar_pattern
    assert int((ordered(k) - ordered(p)).abs().max()) <= 1


def test_kernel_route_rfft_equals_plain_route(dev):
    from repro_torch.apps.dsp import rfft_format
    x = torch.randn(4, 2, 4096, generator=torch.Generator().manual_seed(3))
    ar = Arith.make("posit16")
    with backend_overrides(round_backend="kernel"):
        got = rfft_format(ar, (x * 1e5).to(dev))
    with backend_overrides(round_backend="torch"):
        ref = rfft_format(ar, (x * 1e5).to(dev))
    for a, b in zip(got, ref):
        assert _equal_bits(a.contiguous(), b.contiguous())
