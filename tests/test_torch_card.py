"""The CUDA kernels against their plain versions, on the card.

Needs an NVIDIA card and nvcc; without them every test here skips.  Run on
the card with ``python -m pytest -q -m cuda tests/test_torch_card.py``
(the file imports no jax, so it runs where only torch is installed).
Tiers: the round, the butterfly and the codec bitwise, the matmul within
one ulp, the posit-KV attention within rtol = atol = 2e-5.
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


def _nan_aware_equal(a, b):
    na, nb = torch.isnan(a.float()), torch.isnan(b.float())
    idt = torch.int32 if a.dtype == torch.float32 else torch.int16
    return torch.equal(na, nb) and torch.equal(
        torch.where(na, 0, a.view(idt)), torch.where(nb, 0, b.view(idt)))


@pytest.mark.parametrize("n", [8, 12, 16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_bitwise(n, out_dtype, dev):
    from repro_torch.kernels.posit_codec import (posit_decode,
                                                 posit_decode_torch)
    fmt = get_format(f"posit{n}")
    bits = torch.arange(1 << n).to(torch.int32).to(fmt.storage_dtype)
    assert _nan_aware_equal(posit_decode(bits.to(dev), fmt, out_dtype).cpu(),
                            posit_decode_torch(bits, fmt, out_dtype))


@pytest.mark.parametrize("name", ["posit8", "posit12", "posit16",
                                  "posit32"])
def test_encode_kernel_bitwise(name, dev):
    from repro_torch.kernels.posit_codec import (posit_encode,
                                                 posit_encode_torch)
    g = torch.Generator().manual_seed(4)
    x = torch.cat([
        torch.randn(1 << 16, generator=g)
        * torch.exp2(torch.randint(-150, 128, (1 << 16,), generator=g)
                     .float()),
        torch.tensor([0.0, -0.0, float("inf"), -float("inf"), float("nan"),
                      1e-40, -1e-40])])
    fmt = get_format(name)
    assert torch.equal(posit_encode(x.to(dev), fmt).cpu(),
                       posit_encode_torch(x, fmt))


@pytest.mark.parametrize("name", ["posit8", "posit16"])
@pytest.mark.parametrize("S,bs", [(96, 512), (1000, 256), (37, 16)])
def test_kv_attention_kernel_within_tolerance(name, S, bs, dev):
    """Ragged per-row lengths, S not a multiple of bs, and one layer of a
    layer-stacked cache read in place through its strides."""
    from repro_torch.kernels.posit_codec import posit_encode_torch
    from repro_torch.kernels.posit_kv_attention import (
        posit_kv_attention, posit_kv_attention_torch)
    fmt = get_format(name)
    g = torch.Generator().manual_seed(S)
    q = torch.randn(4, 8, 4, 128, generator=g).to(dev)
    stacked = [posit_encode_torch(torch.randn(3, 4, S, 8, 128, generator=g),
                                  fmt).to(dev) for _ in range(2)]
    kb, vb = stacked[0][1], stacked[1][1]
    lengths = torch.tensor([0, 1, S // 2, S + 5], dtype=torch.int32,
                           device=dev)
    k = posit_kv_attention(q, kb, vb, lengths, fmt, bs=bs)
    p = posit_kv_attention_torch(q, kb, vb, lengths, fmt, bs=bs)
    assert torch.allclose(k, p, rtol=2e-5, atol=2e-5)
    assert torch.all(k[0] == 0)


def test_serve_kernel_route_matches_plain_route(dev):
    """The reduced qwen3-8b on the card: decode steps through the
    KV-attention kernel give the plain route's logits within 2e-2."""
    from repro_torch.configs import CONFIGS, reduced
    from repro_torch.core.policy import AGGRESSIVE_POLICY
    from repro_torch.core.quant import quantize_params
    from repro_torch.models import build_model
    model = build_model(reduced(CONFIGS["qwen3-8b"]), AGGRESSIVE_POLICY,
                        device=dev)
    params = quantize_params(model.init(
        torch.Generator(device=dev).manual_seed(0)), get_format("posit16"),
        cast_rest=torch.bfloat16)
    toks = torch.randint(1, 512, (3, 9), generator=torch.Generator()
                         .manual_seed(1)).to(dev)
    lengths = torch.tensor([5, 3, 9], dtype=torch.int32, device=dev)
    out = {}
    for backend in ("kernel", "torch"):
        with backend_overrides(round_backend=backend):
            logits, caches = model.prefill(
                params, {"tokens": toks, "lengths": lengths}, 12)
            steps = []
            for s in range(3):
                logits, caches = model.decode_step(params, toks[:, s:s + 1],
                                                   caches)
                steps.append(logits.float().cpu())
        out[backend] = steps
    for a, b in zip(out["kernel"], out["torch"]):
        assert torch.allclose(a, b, rtol=2e-2, atol=2e-2)
