"""The CUDA kernels against their plain versions, on the card.

Needs an NVIDIA card and nvcc; without them every test here skips.  Run on
the card with ``python -m pytest -q -m cuda tests/test_torch_card.py``
(the file imports no jax, so it runs where only torch is installed).
Tiers: the round, the multiply-add, the butterfly, the codec and the IEEE
rounding bitwise, the rounded matmul within one ulp, the decode-fused
matmul within 1e-5 of its largest output, the posit-KV attention within
rtol = atol = 2e-5.  The round and the decode are also held on ragged
lengths and views at odd offsets (their 16-byte accesses' head and tail),
every decode container and both output types, and the card-built decode
tables against their plain version; the KV-attention at 48 query rows
per KV head; the KV append bitwise in its three modes, positions it does
not write untouched; the rounded matmul at the main path's shapes, ragged
ones and in f64, the same bits on every call; the FFT stage-range kernel
bitwise at the cough path's middle stages, whole FFTs of 4096 and 256
points (two passes, an odd batch) and in f64, one launch per pass; the
multiply-add at every element offset within 16 bytes, under row, column
and host 0-d broadcasts; a small ingest fleet over localhost TCP on
the card, bitwise equal to the in-process run there; the KV-attention and
the expert-stack decode at granite-moe-3b-a800m's shapes, one MoE layer
the same bits on a second call; the KV-attention at internvl2-2b's and
seamless-m4t-large-v2's heads (G = 2, D = 128; G = 1, D = 64) and the
reduced vlm and encdec models on the card near the CPU; the KV-attention
and the KV append at zamba2-7b's shared attention (KV = 32, G = 1, D =
112) and the reduced ssm and hybrid models on the card near the CPU; and
the ingest
worker pool's workers on the card (a spawned worker refusing the stream
kernels' plain versions on CUDA tensors), their digests equal to the
in-process run.
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_round_kernel_ragged_and_offset_views(dtype, dev):
    """Lengths that leave a head and a tail, views at every element offset
    within 16 bytes, and a 0-d tensor (the fleet's most launched shape),
    bitwise equal to the plain version."""
    fmt = get_format("posit10")
    g = torch.Generator().manual_seed(15)
    base = (torch.randn(70000, generator=g, dtype=dtype)
            * torch.exp2(torch.randint(-40, 40, (70000,), generator=g)
                         .to(dtype)))
    per = 16 // base.element_size()
    cases = [(0, n) for n in (1, per - 1, per + 1, 3 * per + 1, 65537)]
    cases += [(off, 40003) for off in range(1, per)]
    for off, n in cases:
        x = base.to(dev)[off:off + n]
        assert _equal_bits(posit_round(x, fmt).cpu(),
                           posit_round_torch(base[off:off + n], fmt)), (off, n)
    x = base[7].to(dev)
    assert x.dim() == 0
    assert _equal_bits(posit_round(x, fmt).cpu(), posit_round_torch(
        base[7], fmt))


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


def _ordered(v, fmt):
    q = encode(v, fmt).to(torch.int64) & fmt.mask
    return (q ^ fmt.nar_pattern) - fmt.nar_pattern


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("M,K,N", [(64, 2049, 20), (64, 2049, 1),
                                   (64, 20, 13), (32, 10, 1), (37, 2049, 19),
                                   (3, 700, 5), (130, 4100, 9)])
def test_matmul_kernel_shapes_within_one_ulp_and_repeatable(M, K, N, dtype,
                                                            dev):
    """The main path's shapes (mel, centroid, DCT, votes), ragged M and N,
    K split across blocks or not, f32 and f64: bitwise equal to the plain
    version (which sums in the kernel's order, so within one posit16 ulp
    holds a fortiori), two calls give the same bits, and a slab of the
    first rows gives those rows' bits."""
    from repro_torch.kernels.posit_matmul import round_matmul_plan
    fmt = get_format("posit16")
    g = torch.Generator().manual_seed(M + K + N)
    a = posit_round_torch((torch.rand(M, K, generator=g, dtype=dtype)
                           * 2.0 ** 20), fmt).to(dev)
    b = posit_round_torch(torch.randn(K, N, generator=g, dtype=dtype),
                          fmt).to(dev)
    before = posit_matmul_round.launches
    k = posit_matmul_round(a, b, fmt)
    again = posit_matmul_round(a, b, fmt)
    assert posit_matmul_round.launches == before + 2
    p = posit_matmul_round_torch(a, b, fmt)
    assert int((_ordered(k, fmt) - _ordered(p, fmt)).abs().max()) <= 1
    assert _equal_bits(k, p)
    assert _equal_bits(k, again)
    for m in (1, 2, 4, 6):
        assert _equal_bits(posit_matmul_round(a[:m].contiguous(), b, fmt),
                           k[:m])
    if (M, K, N) == (64, 2049, 20):
        assert round_matmul_plan(K, N)[2] > 1


def _kv_append_case(g, name, in_dtype, B, cap, KV, D, s_new, dev):
    """Random storage (two layers stacked, layer 1 used: a view at an
    offset) and new rows with specials."""
    fmt = get_format(name)
    lo = -(1 << (fmt.n - 1))
    store = [torch.randint(lo, -lo, (2, B, cap, KV, D), generator=g)
             .to(fmt.storage_dtype).to(dev) for _ in range(2)]
    rows = []
    for _ in range(2):
        x = torch.randn(B, s_new, KV, D, generator=g) * torch.exp2(
            torch.randint(-30, 30, (B, s_new, KV, D), generator=g).float())
        x.view(-1)[:5] = torch.tensor([0.0, float("inf"), float("nan"),
                                       1e-40, -3e38])
        rows.append(x.to(in_dtype).to(dev))
    return fmt, store, rows


@pytest.mark.parametrize("name", ["posit8", "posit16"])
@pytest.mark.parametrize("in_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mode", ["decode", "prefill", "scalar",
                                  "scalar_clamped", "odd_row"])
def test_kv_append_kernel_bitwise(name, in_dtype, mode, dev):
    """One launch writes K and V; the storage equals the plain version's
    everywhere, so the positions it does not write stay untouched: a
    per-row decode (rows at 0, cap - 1, cap: dropped, 17), a ragged per-row
    prefill, scalar appends in the middle and clamped near cap, and a row
    width of 12 (one value a thread)."""
    from repro_torch.kernels.posit_codec import (posit_kv_append,
                                                 posit_kv_append_torch)
    B, cap, KV, D = 4, 96, 8, 128
    s_new, length = {
        "decode": (1, [0, cap - 1, cap, 17]),
        "prefill": (37, [0, 0, 0, 0]),
        "scalar": (5, 40),
        "scalar_clamped": (9, cap - 3),
        "odd_row": (1, [3, 0, cap, 95]),
    }[mode]
    if mode == "odd_row":
        KV, D = 3, 4
    g = torch.Generator().manual_seed(len(mode) + s_new)
    fmt, store, (k_new, v_new) = _kv_append_case(g, name, in_dtype, B, cap,
                                                 KV, D, s_new, dev)
    length = torch.tensor(length, dtype=torch.int32, device=dev)
    orig = [t.clone() for t in store]
    want = [t.clone() for t in store]
    posit_kv_append_torch(k_new, v_new, want[0][1], want[1][1], length, fmt)
    before = posit_kv_append.launches
    posit_kv_append(k_new, v_new, store[0][1], store[1][1], length, fmt)
    assert posit_kv_append.launches == before + 1
    for got, w, o in zip(store, want, orig):
        assert torch.equal(got, w)
        assert torch.equal(got[0], o[0])        # the other layer
        if mode in ("decode", "odd_row"):       # the row at length == cap
            row = length.tolist().index(cap)
            assert torch.equal(got[1][row], o[1][row])


def test_kv_append_kernel_raises_on_what_it_does_not_take(dev):
    from repro_torch.kernels.posit_codec import posit_kv_append
    fmt = get_format("posit8")
    bits = torch.zeros(2, 8, 2, 16, dtype=torch.int8, device=dev)
    rows = torch.zeros(2, 1, 2, 16, device=dev)
    length = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):              # bits of another format
        posit_kv_append(rows, rows, bits.to(torch.int16),
                        bits.to(torch.int16), length, fmt)
    with pytest.raises(ValueError):             # not contiguous
        posit_kv_append(rows, rows, bits.transpose(2, 3), bits, length, fmt)
    with pytest.raises(ValueError):             # past the capacity
        posit_kv_append(rows.expand(2, 9, 2, 16).contiguous(),
                        rows.expand(2, 9, 2, 16).contiguous(), bits,
                        bits.clone(), length, fmt)
    with pytest.raises(ValueError):             # a CPU tensor among them
        posit_kv_append(rows, rows, bits, bits.clone(), length.cpu(), fmt)


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


def test_decode_table_built_on_the_card_equals_plain(dev):
    from repro_torch.kernels.posit_codec import (decode_table,
                                                 posit_decode_table_torch)
    for name in ("posit8", "posit10", "posit12", "posit16", "posit16e3"):
        fmt = get_format(name)
        for out_dtype in (torch.float32, torch.bfloat16):
            idt = torch.int32 if out_dtype == torch.float32 else torch.int16
            got = decode_table(fmt, out_dtype, dev).cpu()
            assert torch.equal(got.view(idt), posit_decode_table_torch(
                fmt, out_dtype).view(idt))


# (format, container): the table route in every container, and the
# arithmetic route of a posit wider than 16 bits
_DECODE_CASES = [("posit8", torch.int8), ("posit16", torch.int16),
                 ("posit8", torch.int16), ("posit16", torch.int32),
                 ("posit24", torch.int32), ("posit32", torch.int32)]


@pytest.mark.parametrize("name,container", _DECODE_CASES,
                         ids=[f"{n}-{str(c)[6:]}" for n, c in _DECODE_CASES])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_decode_kernel_ragged_and_offset_views(name, container, out_dtype,
                                               dev):
    """Lengths that leave a head and a tail, and views at every element
    offset within 16 bytes (their outputs cannot take whole stores at the
    input's vectors), bitwise equal to the plain version; the kernel is
    launched for each."""
    from repro_torch.kernels.posit_codec import (posit_decode,
                                                 posit_decode_torch)
    fmt = get_format(name)
    g = torch.Generator().manual_seed(14)
    lo, hi = -(1 << (fmt.n - 1)), 1 << (fmt.n - 1)
    base = torch.randint(lo, hi, (70000,), generator=g).to(container)
    base[:64] = torch.tensor([0, lo, hi - 1, 1, -1] * 12 + [0] * 4)
    per = 16 // base.element_size()
    cases = [(0, n) for n in (0, 1, per - 1, per + 1, 3 * per + 5, 65537)]
    cases += [(off, 40003) for off in range(1, per)]
    for off, n in cases:
        bits = base.to(dev)[off:off + n]
        before = posit_decode.launches
        got = posit_decode(bits, fmt, out_dtype).cpu()
        assert posit_decode.launches == before + (1 if n else 0)
        assert _nan_aware_equal(got, posit_decode_torch(
            base[off:off + n], fmt, out_dtype)), (off, n)


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
@pytest.mark.parametrize("S,bs", [(96, 512), (1000, 256), (37, 16),
                                  (4096, 512)])
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


@pytest.mark.parametrize("name", ["posit8", "posit16"])
def test_kv_attention_split_path(name, dev):
    """S = 4096 runs in several splits per (row, KV head) on this card; the
    merged result is the plain version's, a length-0 row exactly 0."""
    from repro_torch.kernels.posit_codec import posit_encode_torch
    from repro_torch.kernels.posit_kv_attention import (
        kv_split_plan, posit_kv_attention, posit_kv_attention_torch)
    fmt = get_format(name)
    B, S, KV, G, D = 4, 4096, 8, 4, 128
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert kv_split_plan(S, 512, B * KV, sms)[3] > 1
    g = torch.Generator().manual_seed(11)
    q = torch.randn(B, KV, G, D, generator=g).to(dev)
    kb, vb = (posit_encode_torch(torch.randn(B, S, KV, D, generator=g),
                                 fmt).to(dev) for _ in range(2))
    lengths = torch.tensor([0, 1, 777, S], dtype=torch.int32, device=dev)
    k = posit_kv_attention(q, kb, vb, lengths, fmt)
    p = posit_kv_attention_torch(q, kb, vb, lengths, fmt)
    assert torch.allclose(k, p, rtol=2e-5, atol=2e-5)
    assert torch.all(k[0] == 0)


@pytest.mark.parametrize("name", ["posit8", "posit16"])
@pytest.mark.parametrize("S", [96, 4096])
def test_kv_attention_many_query_rows_per_kv_head(name, S, dev):
    """granite-20b's shape: 48 query rows over one KV head, D = 128, run as
    six groups of eight rows in one launch (and through the split path at
    S = 4096), within 2e-5 of the plain version."""
    from repro_torch.kernels.posit_codec import posit_encode_torch
    from repro_torch.kernels.posit_kv_attention import (
        posit_kv_attention, posit_kv_attention_torch, query_groups)
    fmt = get_format(name)
    B, KV, G, D = 4, 1, 48, 128
    assert query_groups(G, D) == (8, 6)
    g = torch.Generator().manual_seed(13)
    q = torch.randn(B, KV, G, D, generator=g).to(dev)
    kb, vb = (posit_encode_torch(torch.randn(B, S, KV, D, generator=g),
                                 fmt).to(dev) for _ in range(2))
    lengths = torch.tensor([1, S // 3, S - 1, S], dtype=torch.int32,
                           device=dev)
    before = posit_kv_attention.launches
    k = posit_kv_attention(q, kb, vb, lengths, fmt)
    assert posit_kv_attention.launches == before + 1
    p = posit_kv_attention_torch(q, kb, vb, lengths, fmt)
    assert torch.allclose(k, p, rtol=2e-5, atol=2e-5)
    for G2 in (9, 12, 33):          # groups of unequal size
        k = posit_kv_attention(q[:, :, :G2].contiguous(), kb, vb, lengths,
                               fmt)
        assert torch.allclose(k, p[:, :, :G2], rtol=2e-5, atol=2e-5)


def test_kv_attention_never_reads_masked_positions(dev):
    """A NaR pattern past a row's length: the kernel never reads it, while
    the plain version multiplies its NaN by a zero weight (ROADMAP §C)."""
    from repro_torch.kernels.posit_codec import posit_encode_torch
    from repro_torch.kernels.posit_kv_attention import (
        posit_kv_attention, posit_kv_attention_torch)
    fmt = get_format("posit8")
    g = torch.Generator().manual_seed(12)
    q = torch.randn(2, 8, 4, 128, generator=g).to(dev)
    kb, vb = (posit_encode_torch(torch.randn(2, 1024, 8, 128, generator=g),
                                 fmt).to(dev) for _ in range(2))
    vb[:, 900:] = fmt.nar_pattern - (1 << fmt.n)      # NaR, as int8
    lengths = torch.tensor([600, 900], dtype=torch.int32, device=dev)
    k = posit_kv_attention(q, kb, vb, lengths, fmt, bs=256)
    p = posit_kv_attention_torch(q, kb, vb, lengths, fmt, bs=256)
    assert torch.all(torch.isfinite(k))
    assert torch.all(torch.isnan(p[1])) and torch.all(torch.isnan(p[0]))
    vb[:, 900:] = 0
    assert torch.allclose(
        k, posit_kv_attention_torch(q, kb, vb, lengths, fmt, bs=256),
        rtol=2e-5, atol=2e-5)


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


@pytest.mark.parametrize("name", ["posit8", "posit16", "posit32"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fma_kernel_bitwise(name, dtype, dev):
    """Random operands, broadcast ones, and c = −fl(a·b), where a
    contracted multiply-add would give other bits."""
    from repro_torch.kernels.posit_round import (posit_fma_round,
                                                 posit_fma_round_torch)
    fmt = get_format(name)
    g = torch.Generator().manual_seed(5)
    a, b, c = (torch.randn(3, 1 << 14, generator=g, dtype=dtype) * 37)
    cases = [(a, b, c), (a, b, -(a * b)),
             (a[:64, None], b[None, :64], torch.tensor(0.5, dtype=dtype))]
    for x, y, z in cases:
        k = posit_fma_round(x.to(dev), y.to(dev), z.to(dev), fmt).cpu()
        assert _equal_bits(k, posit_fma_round_torch(x, y, z, fmt))


@pytest.mark.parametrize("case", [
    ("posit16", 4096, 2, 11, (32, 2), torch.float32),   # the cough path
    ("posit10", 4096, 0, 12, (3,), torch.float32),      # a whole FFT
    ("posit8", 4096, 0, 12, (2, 2), torch.float32),
    ("posit10", 256, 0, 8, (3,), torch.float32),        # two passes, odd
    ("posit8", 256, 0, 8, (5,), torch.float32),
    ("posit16", 4096, 2, 11, (3,), torch.float64),
])
def test_fft_stages_kernel_bitwise(case, dev):
    from repro_torch.apps.dsp import get_fft_plan
    from repro_torch.kernels.posit_fft import (fft_pass_plan,
                                               posit_fft_stages,
                                               posit_fft_stages_torch)
    name, n, s0, s1, batch, dtype = case
    fmt = get_format(name)
    g = torch.Generator().manual_seed(s1 + n)
    L, R = 1 << s0, n >> s0
    z = posit_round_torch(torch.randn(2, *batch, L, R, generator=g,
                                      dtype=dtype) * 1e3, fmt)
    plan = get_fft_plan(n, name, dtype, "cpu")
    want, tr = posit_fft_stages_torch(z, plan.table, s0, s1, fmt)
    card = get_fft_plan(n, name, dtype, str(dev))
    before = posit_fft_stages.launches
    got, tr_k = posit_fft_stages(z.to(dev), card.table, s0, s1, fmt)
    passes = fft_pass_plan(n, s0, s1, z[0].numel() // n, dtype,
                           torch.cuda.get_device_properties(dev)
                           .multi_processor_count)
    assert posit_fft_stages.launches - before == len(passes)
    assert tr_k == tr and got.shape == want.shape and got.is_contiguous()
    assert _equal_bits(got.cpu(), want)


@pytest.mark.parametrize("full", [False, True])
def test_fft_path_runs_one_stage_range_launch(full, dev):
    """The FFT path under the kernel backend: one stage-range launch for
    the rfft's middle stages, one a pass of the plan for a whole FFT, no
    butterfly launch, the same bits as the CPU."""
    from repro_torch.apps import dsp
    from repro_torch.kernels.posit_fft import fft_pass_plan, posit_fft_stages
    ar = Arith.make("posit16")
    g = torch.Generator().manual_seed(21)
    x = torch.randn(32, 2, 4096 if not full else 256, generator=g) * 300
    counts = (posit_fft_stages.launches, posit_butterfly.launches)
    if full:
        got = dsp.fft_format(ar, x.to(dev), torch.zeros_like(x).to(dev))
        want = dsp.fft_format(ar, x, torch.zeros_like(x))
    else:
        got, want = dsp.rfft_format(ar, x.to(dev)), dsp.rfft_format(ar, x)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    passes = len(fft_pass_plan(256, 0, 8, 64, torch.float32, sms)) if full \
        else 1
    assert posit_fft_stages.launches - counts[0] == passes
    assert posit_butterfly.launches == counts[1]
    for k, p in zip(got, want):
        assert _equal_bits(k.cpu(), p)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fma_kernel_offsets_and_broadcasts(dtype, dev):
    """The flat path at every element offset within 16 bytes (the three
    operands alike: 16-byte loads with a head and a tail, the results
    stored one value at a time where the output is not at their offset;
    unlike: one value a thread), ragged lengths, and the broadcast path
    under row, column and host 0-d operands, bitwise equal to the plain
    version."""
    from repro_torch.kernels.posit_round import (posit_fma_round,
                                                 posit_fma_round_torch)
    fmt = get_format("posit10")
    g = torch.Generator().manual_seed(9)
    base = [torch.randn(70000, generator=g, dtype=dtype) * 41
            for _ in range(3)]
    on = [t.to(dev) for t in base]
    per = 16 // base[0].element_size()
    cases = [((off, off, off), m) for off in range(per)
             for m in (1, per + 1, 4099, 65537)]
    cases += [((0, off, (2 * off) % per), 40001) for off in range(1, per)]
    for offs, m in cases:
        k = posit_fma_round(*(t[o:o + m] for t, o in zip(on, offs)), fmt)
        p = posit_fma_round_torch(*(t[o:o + m] for t, o in zip(base, offs)),
                                  fmt)
        assert _equal_bits(k.cpu(), p), (offs, m)
    a, b, c = (t[:64 * 96].reshape(64, 96) for t in base)
    s = torch.tensor(0.375, dtype=dtype)
    for ops in ((a, b[:1], c), (a[:, :1], b, c[:1]), (a, s, c), (s, b, s),
                (a[:, :1], b[:1], s), (a.T, b.T, c.T)):
        k = posit_fma_round(*(t if t.dim() == 0 else t.to(dev)
                              for t in ops), fmt)
        assert _equal_bits(k.cpu(), posit_fma_round_torch(*ops, fmt))


@pytest.mark.parametrize("name", ["posit8", "posit16"])
@pytest.mark.parametrize("mkn", [(128, 256, 256), (64, 1000, 300),
                                 (1, 7, 5), (64, 4096, 1024)])
def test_decode_matmul_kernel_within_tolerance(name, mkn, dev):
    from repro_torch.kernels.posit_codec import posit_encode_torch
    from repro_torch.kernels.posit_matmul import (posit_matmul,
                                                  posit_matmul_torch)
    fmt = get_format(name)
    M, K, N = mkn
    g = torch.Generator().manual_seed(6)
    a = posit_encode_torch(torch.randn(M, K, generator=g), fmt).to(dev)
    b = posit_encode_torch(torch.randn(K, N, generator=g) / K ** 0.5,
                           fmt).to(dev)
    k = posit_matmul(a, b, fmt)
    p = posit_matmul_torch(a, b, fmt)
    assert float((k - p).abs().max()) <= 1e-5 * float(p.abs().max())


@pytest.mark.parametrize("name,widen", [("posit16", True),
                                        ("posit24", False)])
def test_decode_matmul_kernel_int32_container(name, widen, dev):
    """int32 patterns: posit16 bits widened, and posit24's own storage;
    a ragged shape."""
    from repro_torch.kernels.posit_codec import posit_encode_torch
    from repro_torch.kernels.posit_matmul import (posit_matmul,
                                                  posit_matmul_torch)
    fmt = get_format(name)
    M, K, N = 70, 333, 200
    g = torch.Generator().manual_seed(13)
    a = posit_encode_torch(torch.randn(M, K, generator=g), fmt)
    b = posit_encode_torch(torch.randn(K, N, generator=g) / K ** 0.5, fmt)
    a, b = (t.to(torch.int32).to(dev) for t in (a, b))
    assert a.dtype == torch.int32 and (widen or fmt.n > 16)
    k = posit_matmul(a, b, fmt)
    p = posit_matmul_torch(a, b, fmt)
    assert float((k - p).abs().max()) <= 1e-5 * float(p.abs().max())


@pytest.mark.parametrize("name", ["fp16", "bfloat16", "fp8e5m2",
                                  "fp8e4m3"])
def test_round_to_float_card_equals_cpu(name, dev):
    from repro_torch.core.floatsim import round_to_float
    g = torch.Generator().manual_seed(7)
    for dtype in (torch.float32, torch.float64):
        x = torch.cat([
            torch.randn(1 << 16, generator=g, dtype=dtype)
            * torch.exp2(torch.randint(-150, 128, (1 << 16,), generator=g)
                         .to(dtype)),
            torch.tensor([448.0, 464.0, 464.01, 500.0, float("inf"),
                          65520.0, 1e-40, 0.0, -0.0], dtype=dtype)])
        k = round_to_float(x.to(dev), get_format(name)).cpu()
        p = round_to_float(x, get_format(name))
        assert torch.equal(torch.isnan(k), torch.isnan(p))
        ok = ~torch.isnan(p)
        assert _equal_bits(k[ok], p[ok])


def test_ingest_tcp_fleet_on_the_card_equals_inproc(dev):
    """A small mixed fleet over localhost TCP (duplicates, deferred frames,
    one stalled ECG patient) on the card: every delivered window bitwise
    equal to the in-process run on the card, the stalled patient evicted,
    no window dropped, and the stream kernels launched."""
    import asyncio

    from repro_torch.apps.cough import train_reference_forest
    from repro_torch.ingest import (FleetSimulator, IngestServer,
                                    SessionManager, Supervisor)
    from repro_torch.kernels.posit_fft import posit_fft_stages
    from repro_torch.stream import (StreamEngine, cough_pipeline,
                                    rpeak_pipeline)

    forest = train_reference_forest(24, 123, n_trees=5, depth=4, device=dev)
    pipes = {"cough": cough_pipeline(forest), "rpeak": rpeak_pipeline()}

    def sim():
        return FleetSimulator(n_patients=8, windows=2, seed=3, mixed=True,
                              n_cough=4, dup_rate=0.1, defer_rate=0.1,
                              stall_after={"ecg-002": 1})

    def engine():
        return StreamEngine(pipes, max_batch=4, pad_policy="max",
                            result_capacity=None, device=dev)

    ref = engine()
    sim().run_inproc(ref)             # also builds and warms the kernels
    eng, fleet = engine(), sim()
    sup = Supervisor(eng, capacity=1024)
    for c in (posit_round, posit_fft_stages, posit_matmul_round):
        c.launches = 0

    async def main():
        sm = SessionManager(eng, stall_timeout_s=5.0)
        fleet.pin_all(eng)
        async with IngestServer(sm, port=0) as srv:
            done = [False]
            pump = asyncio.ensure_future(
                sup.run_async(0.005, stop=lambda: done[0]))
            await fleet.run_tcp("127.0.0.1", srv.port)
            while not sm.all_closed():
                await asyncio.sleep(0.02)
            done[0] = True
            await pump

    asyncio.run(main())
    for c in (posit_round, posit_fft_stages, posit_matmul_round):
        assert c.launches > 0, c.__name__
    ts = eng.ledger.transport_summary()
    assert ts["ecg-002"]["evictions"] == 1
    assert ts["fleet"]["evictions"] == 1
    assert ts["fleet"]["windows_dropped"] == 0
    want = {(r.patient, r.widx): r for r in ref.pop_results()}
    got = sup.pop()
    assert len(got) >= 14
    for r in got:
        w = want[(r.patient, r.widx)]
        assert r.fmt == w.fmt
        for k, v in r.outputs.items():
            np.testing.assert_array_equal(v, w.outputs[k])


@pytest.mark.parametrize("name", ["posit8", "posit16"])
@pytest.mark.parametrize("S", [96, 2048])
def test_kv_attention_granite_moe_geometry(name, S, dev):
    """granite-moe-3b-a800m's heads: D = 64, 3 query rows per KV head over
    8 KV heads, in one query group, within 2e-5 of the plain version."""
    from repro_torch.kernels.posit_codec import posit_encode_torch
    from repro_torch.kernels.posit_kv_attention import (
        posit_kv_attention, posit_kv_attention_torch, query_groups)
    fmt = get_format(name)
    B, KV, G, D = 4, 8, 3, 64
    assert query_groups(G, D) == (3, 1)
    g = torch.Generator().manual_seed(14)
    q = torch.randn(B, KV, G, D, generator=g).to(dev)
    kb, vb = (posit_encode_torch(torch.randn(B, S, KV, D, generator=g),
                                 fmt).to(dev) for _ in range(2))
    lengths = torch.tensor([1, S // 3, S - 1, S], dtype=torch.int32,
                           device=dev)
    k = posit_kv_attention(q, kb, vb, lengths, fmt)
    p = posit_kv_attention_torch(q, kb, vb, lengths, fmt)
    assert torch.allclose(k, p, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape", [(40, 1536, 512), (40, 512, 1536)])
def test_decode_kernel_expert_stacks_bitwise(shape, dev):
    """The decode of a whole expert stack (granite-moe-3b-a800m's gate/up
    and down), int16 posit16 bits to bf16, bitwise."""
    from repro_torch.kernels.posit_codec import (posit_decode,
                                                 posit_decode_torch)
    fmt = get_format("posit16")
    g = torch.Generator().manual_seed(15)
    bits = torch.randint(-2 ** 15, 2 ** 15, shape, generator=g,
                         dtype=torch.int16).to(dev)
    before = posit_decode.launches
    k = posit_decode(bits, fmt, torch.bfloat16)
    assert posit_decode.launches == before + 1
    assert _nan_aware_equal(k, posit_decode_torch(bits, fmt,
                                                  torch.bfloat16))


@pytest.mark.parametrize("B,S", [(4, 1), (1, 64), (2, 96)])
def test_moe_layer_same_bits_twice_and_near_the_cpu(B, S, dev):
    """One MoE layer of the reduced granite-moe-3b-a800m with posit16
    expert stacks: a second call on the card gives the same bits (the
    combine adds in a fixed order, without atomics), the expert decodes
    take the decode kernel, and the output is within 2e-2 of the CPU's on
    the same weights and inputs."""
    from repro_torch.configs import CONFIGS, reduced
    from repro_torch.core.quant import quantize_params
    from repro_torch.kernels.posit_codec import posit_decode
    from repro_torch.models.common import materialize, to_device
    from repro_torch.models.moe import init_moe, moe_ffn
    cfg = reduced(CONFIGS["granite-moe-3b-a800m"])
    layer = quantize_params({"moe": materialize(
        init_moe(cfg), torch.Generator().manual_seed(16),
        torch.device("cpu"))}, get_format("posit16"))["moe"]
    x = torch.randn(B, S, cfg.d_model, generator=torch.Generator()
                    .manual_seed(17)).to(torch.bfloat16)
    on_card = to_device(layer, dev)
    before = posit_decode.launches
    out1, aux1 = moe_ffn(on_card, x.to(dev), cfg)
    assert posit_decode.launches == before + 3
    out2, aux2 = moe_ffn(on_card, x.to(dev), cfg)
    assert torch.equal(out1.view(torch.int16), out2.view(torch.int16))
    assert torch.equal(aux1.view(torch.int32), aux2.view(torch.int32))
    cpu, cpu_aux = moe_ffn(layer, x, cfg)
    assert torch.allclose(out1.float().cpu(), cpu.float(), rtol=2e-2,
                          atol=2e-2)
    assert abs(float(aux1) - float(cpu_aux)) <= 1e-6


@pytest.mark.parametrize("name", ["posit8", "posit16"])
@pytest.mark.parametrize("KV,G,D,S", [(8, 2, 128, 352), (8, 2, 128, 4096),
                                      (16, 1, 64, 48), (16, 1, 64, 2048)],
                         ids=["internvl2-352", "internvl2-4096",
                              "seamless-48", "seamless-2048"])
def test_kv_attention_vlm_and_encdec_geometry(name, KV, G, D, S, dev):
    """internvl2-2b's heads (8 KV heads, 2 query rows each, D = 128) and
    seamless-m4t-large-v2's (16 KV heads, 1 query row each, D = 64), in
    one query group, within 2e-5 of the plain version."""
    from repro_torch.kernels.posit_codec import posit_encode_torch
    from repro_torch.kernels.posit_kv_attention import (
        posit_kv_attention, posit_kv_attention_torch, query_groups)
    fmt = get_format(name)
    B = 4
    assert query_groups(G, D) == (G, 1)
    g = torch.Generator().manual_seed(18)
    q = torch.randn(B, KV, G, D, generator=g).to(dev)
    kb, vb = (posit_encode_torch(torch.randn(B, S, KV, D, generator=g),
                                 fmt).to(dev) for _ in range(2))
    lengths = torch.tensor([1, S // 3, S - 1, S], dtype=torch.int32,
                           device=dev)
    k = posit_kv_attention(q, kb, vb, lengths, fmt)
    p = posit_kv_attention_torch(q, kb, vb, lengths, fmt)
    assert torch.allclose(k, p, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("arch", ["internvl2-2b", "seamless-m4t-large-v2"])
def test_reduced_vlm_and_encdec_on_the_card_near_the_cpu(arch, dev):
    """The reduced vlm and encdec models with posit16 weights and a posit8
    KV cache on the card and on the CPU, the same weights and batch
    (patch rows or source frames): prefill and 3 decode steps fed the
    CPU's greedy tokens, logits within 2e-2, the KV-attention kernel
    launched once a layer and decode step, and the encdec prefill's cross
    K/V encoded on the card."""
    from repro_torch.configs import CONFIGS, reduced
    from repro_torch.core.policy import AGGRESSIVE_POLICY
    from repro_torch.core.quant import quantize_params
    from repro_torch.kernels.posit_codec import posit_encode
    from repro_torch.kernels.posit_kv_attention import posit_kv_attention
    from repro_torch.models import build_model
    from repro_torch.models.common import to_device
    cfg = reduced(CONFIGS[arch])
    cpu = build_model(cfg, AGGRESSIVE_POLICY, device="cpu")
    on_card = build_model(cfg, AGGRESSIVE_POLICY, device=dev)
    params = quantize_params(cpu.init(torch.Generator().manual_seed(19)),
                             get_format("posit16"), cast_rest=torch.bfloat16)
    g = torch.Generator().manual_seed(20)
    rows = ("frontend", (3, cfg.frontend_len, cfg.d_model)) \
        if cfg.family == "vlm" else ("frames", (3, 12, cfg.d_model))
    batch = {"tokens": torch.randint(1, cfg.vocab, (3, 9), generator=g),
             rows[0]: torch.randn(rows[1], generator=g)}
    l_cpu, s_cpu = cpu.prefill(params, batch, 12)
    before = posit_encode.launches, posit_kv_attention.launches
    l_card, s_card = on_card.prefill(to_device(params, dev),
                                     {k: v.to(dev) for k, v in batch.items()},
                                     12)
    enc = 2 * cfg.n_layers if cfg.family == "encdec" else 0
    assert posit_encode.launches == before[0] + enc
    for step in range(3):
        assert torch.allclose(l_card.float().cpu(), l_cpu.float(),
                              rtol=2e-2, atol=2e-2), step
        tok = l_cpu[:, -1, :cfg.vocab].argmax(-1)[:, None]
        l_cpu, s_cpu = cpu.decode_step(params, tok, s_cpu)
        l_card, s_card = on_card.decode_step(to_device(params, dev),
                                             tok.to(dev), s_card)
    assert torch.allclose(l_card.float().cpu(), l_cpu.float(), rtol=2e-2,
                          atol=2e-2)
    assert posit_kv_attention.launches == before[1] + 3 * cfg.n_layers


@pytest.mark.parametrize("name", ["posit8", "posit16"])
@pytest.mark.parametrize("S", [544, 4096])
def test_kv_attention_zamba_geometry(name, S, dev):
    """zamba2-7b's shared attention: 32 KV heads of one query row each at
    D = 112, where lanes 28-31 of each warp hold no element of a row (a
    lane takes 4), within 2e-5 of the plain version."""
    from repro_torch.kernels.posit_codec import posit_encode_torch
    from repro_torch.kernels.posit_kv_attention import (
        lane_plan, posit_kv_attention, posit_kv_attention_torch,
        query_groups)
    fmt = get_format(name)
    B, KV, G, D = 4, 32, 1, 112
    assert query_groups(G, D) == (1, 1) and lane_plan(1, D) == (4, 2)
    g = torch.Generator().manual_seed(21)
    q = torch.randn(B, KV, G, D, generator=g).to(dev)
    kb, vb = (posit_encode_torch(torch.randn(B, S, KV, D, generator=g),
                                 fmt).to(dev) for _ in range(2))
    lengths = torch.tensor([1, S // 3, S - 1, S], dtype=torch.int32,
                           device=dev)
    k = posit_kv_attention(q, kb, vb, lengths, fmt)
    p = posit_kv_attention_torch(q, kb, vb, lengths, fmt)
    assert torch.allclose(k, p, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name", ["posit8", "posit16"])
@pytest.mark.parametrize("mode", ["decode", "prefill", "scalar"])
def test_kv_append_kernel_zamba_geometry_bitwise(name, mode, dev):
    """The KV append at zamba2-7b's shared attention (KV = 32, D = 112: a
    row of 3584 values) in its three modes, bf16 rows in, bitwise against
    the plain version, the other layer untouched."""
    from repro_torch.kernels.posit_codec import (posit_kv_append,
                                                 posit_kv_append_torch)
    B, cap, KV, D = 4, 544, 32, 112
    s_new, length = {"decode": (1, [0, cap - 1, cap, 517]),
                     "prefill": (512, [0, 0, 0, 0]),
                     "scalar": (1, 512)}[mode]
    g = torch.Generator().manual_seed(22 + s_new)
    fmt, store, (k_new, v_new) = _kv_append_case(
        g, name, torch.bfloat16, B, cap, KV, D, s_new, dev)
    length = torch.tensor(length, dtype=torch.int32, device=dev)
    want = [t.clone() for t in store]
    posit_kv_append_torch(k_new, v_new, want[0][1], want[1][1], length, fmt)
    before = posit_kv_append.launches
    posit_kv_append(k_new, v_new, store[0][1], store[1][1], length, fmt)
    assert posit_kv_append.launches == before + 1
    for got, w in zip(store, want):
        assert torch.equal(got, w)


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "zamba2-7b"])
def test_reduced_ssm_and_hybrid_on_the_card_near_the_cpu(arch, dev):
    """The reduced ssm and hybrid models with posit16 weights (and a posit8
    KV cache for the hybrid's shared attention) on the card and on the
    CPU, the same weights and prompt: prefill over two chunks and 3 decode
    steps fed the CPU's greedy tokens, logits within 2e-2; the hybrid's
    KV-attention kernel launched once a group and decode step."""
    from repro_torch.configs import CONFIGS, reduced
    from repro_torch.core.policy import AGGRESSIVE_POLICY
    from repro_torch.core.quant import quantize_params
    from repro_torch.kernels.posit_kv_attention import posit_kv_attention
    from repro_torch.models import build_model
    from repro_torch.models.common import to_device
    cfg = reduced(CONFIGS[arch])
    cpu = build_model(cfg, AGGRESSIVE_POLICY, device="cpu")
    on_card = build_model(cfg, AGGRESSIVE_POLICY, device=dev)
    params = quantize_params(cpu.init(torch.Generator().manual_seed(23)),
                             get_format("posit16"), cast_rest=torch.bfloat16)
    card_params = to_device(params, dev)
    g = torch.Generator().manual_seed(24)
    batch = {"tokens": torch.randint(1, cfg.vocab, (3, 512), generator=g)}
    l_cpu, s_cpu = cpu.prefill(params, batch, 515)
    before = posit_kv_attention.launches
    l_card, s_card = on_card.prefill(card_params,
                                     {"tokens": batch["tokens"].to(dev)}, 515)
    for step in range(3):
        assert torch.allclose(l_card.float().cpu(), l_cpu.float(),
                              rtol=2e-2, atol=2e-2), step
        tok = l_cpu[:, -1, :cfg.vocab].argmax(-1)[:, None]
        l_cpu, s_cpu = cpu.decode_step(params, tok, s_cpu)
        l_card, s_card = on_card.decode_step(card_params, tok.to(dev),
                                             s_card)
    assert torch.allclose(l_card.float().cpu(), l_cpu.float(), rtol=2e-2,
                          atol=2e-2)
    groups = cfg.n_layers // cfg.shared_attn_every if arch == "zamba2-7b" \
        else 0
    assert posit_kv_attention.launches == before + 3 * groups


# Run as its own process: the spawned pool workers import it as
# ``__mp_main__``, where a stream kernel's plain version raises on a CUDA
# tensor (``refuse_plain_on_card``), so a worker that fell back to one fails
# and shows in ``failed_workers``.
POOL_SCRIPT = """
import json

from repro_torch.kernels.counts import refuse_plain_on_card


def main():
    from repro_torch.ingest import (FleetSimulator, Supervisor,
                                    run_worker_fleet)
    from repro_torch.ingest.workers import _result_digests
    from repro_torch.stream import StreamEngine, rpeak_pipeline

    def sim():
        return FleetSimulator(n_patients=8, windows=2, seed=6, mixed=False,
                              n_cough=0)
    ref = StreamEngine({"rpeak": rpeak_pipeline()}, max_batch=8,
                       pad_policy="max", result_capacity=None, device="cuda")
    sim().run_inproc(ref)
    sup = Supervisor(ref, capacity=1 << 12)
    sup.poll()
    doc = run_worker_fleet(sim(), 2, max_batch=8)
    print(json.dumps({"want": _result_digests(sup), "doc": doc}))


if __name__ == "__main__":
    main()
elif __name__ == "__mp_main__":
    refuse_plain_on_card()
"""


def test_worker_pool_on_the_card_equals_inproc(dev, tmp_path):
    """Two pool workers, each with its own CUDA context, score a small ECG
    fleet on the card: every digest equal to the in-process card run, the
    round kernel launched in each worker, and no worker failed, where a
    stream kernel's plain version given a CUDA tensor raises
    (``POOL_SCRIPT``)."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    script = tmp_path / "pool_on_the_card.py"
    script.write_text(POOL_SCRIPT)
    src = Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=str(src)))
    assert out.returncode == 0, out.stderr[-4000:]
    run = json.loads(out.stdout.strip().splitlines()[-1])
    doc = run["doc"]
    assert doc["failed_workers"] == [] and doc["windows"] == 16
    assert doc["digests"] == run["want"]
    for w in doc["workers"]:
        assert w["kernel_calls"]["posit_round"] > 0


def test_refuse_plain_on_card_raises_on_a_cuda_tensor(dev, monkeypatch):
    """The guard the pool test's workers install: a stream kernel's plain
    version raises on a CUDA tensor and still runs on a CPU one."""
    import importlib

    from repro_torch.kernels import posit_round as round_module
    from repro_torch.kernels.counts import STREAM_PLAIN, refuse_plain_on_card
    for m, n in STREAM_PLAIN:          # restored after the test
        mod = importlib.import_module(m)
        monkeypatch.setattr(mod, n, getattr(mod, n))
    refuse_plain_on_card()
    fmt = get_format("posit10")
    x = torch.randn(64)
    assert torch.equal(round_module.posit_round_torch(x, fmt),
                       posit_round_torch(x, fmt))
    with pytest.raises(AssertionError, match="CUDA tensor"):
        round_module.posit_round_torch(x.to(dev), fmt)
