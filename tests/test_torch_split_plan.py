"""The launch plans of the two redesigned kernels, and the posit-KV
attention's split-and-combine schedule in plain torch.

``query_groups`` cuts a KV head's query rows into the groups that the
KV-attention kernel takes in its grid's third dimension; every G from 1 to
64 is covered once at the head dims the configs use, and the grouped
schedule (``grouped_schedule``) is held against the plain version on the
whole G and against the TPU kernel at G = 12 and G = 48 (granite-20b's 48
query heads over one KV head).

``kv_split_plan`` (B6), ``matmul_plan`` (B7) and ``round_matmul_plan``
(B3) are pure Python, so their guarantees are held here: every split
non-empty, every key block, K slab or k covered once, every output of the
rounded matmul in exactly one tile, one split where the cache fits one key
block, enough thread blocks to fill 132 SMs at the long cache and at the
FFN width.  B3's summation order (each thread's every-256th k, the warp's
shuffle tree, the warps in order, the K splits in order) is mirrored by
``round_matmul_mirror`` and held within one posit ulp of the TPU kernel in
interpret mode at the mel and centroid shapes.  The CUDA
kernel's schedule for B6 (key blocks split across thread blocks, masked
blocks and rows never read, (m, l, acc) partials merged in split order) is
mirrored op for op by ``split_schedule`` below and held within rtol = atol
= 2e-5 (the reference's kernel-vs-oracle tolerance) against the port's
plain version and against the TPU kernel in interpret mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.formats import PositFormat as JPositFormat
from repro.kernels import ref
from repro.kernels.posit_kv_attention import posit_kv_attention as jkv
from repro.kernels.posit_matmul import posit_matmul_round_2d
from repro_torch.core.formats import PositFormat, get_format
from repro_torch.core.posit import decode, encode, round_posit_math
from repro_torch.kernels.posit_kv_attention import (BLOCKS_PER_SM, NEG_INF,
                                                    block_plan,
                                                    kv_split_plan, lane_plan,
                                                    posit_kv_attention_torch,
                                                    query_groups)
from repro_torch.kernels.posit_matmul import (ROUND_ACC,
                                              ROUND_SPLIT_BLOCKS,
                                              ROUND_THREADS, matmul_plan,
                                              posit_matmul_round_torch,
                                              round_matmul_plan)

TOL = dict(rtol=2e-5, atol=2e-5)
H100_SMS = 132


@pytest.mark.parametrize("S,bs", [(1, 512), (96, 512), (512, 512),
                                  (513, 512), (1000, 256), (4096, 512),
                                  (32768, 512), (37, 16), (100000, 512)])
@pytest.mark.parametrize("n_heads", [1, 4, 32, 528])
def test_kv_split_plan_covers_every_key_block_once(S, bs, n_heads):
    bs2, n_blocks, per, splits = kv_split_plan(S, bs, n_heads, H100_SMS)
    assert (bs2, n_blocks * bs2) == block_plan(S, bs)
    assert per >= 1 and splits >= 1
    # split s holds key blocks [s per, min((s + 1) per, n_blocks)): none
    # empty, together every block once
    covered = [b for s in range(splits)
               for b in range(s * per, min((s + 1) * per, n_blocks))]
    assert covered == list(range(n_blocks))
    assert all(s * per < n_blocks for s in range(splits))
    if S <= bs:
        assert splits == 1
    if n_heads * n_blocks >= BLOCKS_PER_SM * H100_SMS:
        assert n_heads * splits >= BLOCKS_PER_SM * H100_SMS


def test_kv_split_plan_at_the_long_cache_and_the_serve_shape():
    # B x KV = 32 heads: at least 4 thread blocks per SM at S = 32768, one
    # split (and so no combine launch) at the serve path's 96 slots
    _, _, _, splits = kv_split_plan(32768, 512, 32, H100_SMS)
    assert 32 * splits >= 4 * H100_SMS
    assert kv_split_plan(96, 512, 32, H100_SMS)[3] == 1


_SLABS = 64          # the kernel's K slab depth


@pytest.mark.parametrize("M,N,K", [(64, 12288, 4096), (128, 256, 256),
                                   (1, 5, 7), (64, 300, 1000),
                                   (64, 1024, 4096), (70, 200, 333),
                                   (4096, 4096, 4096), (3, 4, 0)])
@pytest.mark.parametrize("bits_size,nbits", [(1, 8), (2, 16), (4, 24)])
def test_matmul_plan_covers_every_slab_once(M, N, K, bits_size, nbits):
    bn, splits, per, grid, table = matmul_plan(M, N, K, bits_size, nbits,
                                               H100_SMS)
    assert bn in (64, 128, 256) and splits >= 1 and per >= 1
    slabs = max(1, -(-K // _SLABS))
    covered = [k for s in range(splits)
               for k in range(s * per, min((s + 1) * per, slabs))]
    assert covered == list(range(slabs))
    assert all(s * per < slabs for s in range(splits))
    units = -(-M // 64) * -(-N // bn) * splits
    assert 1 <= grid <= units
    assert not table or nbits <= 16


def test_matmul_plan_fills_the_card_at_the_ffn_width():
    """(64, 4096)·(4096, 12288): at least ~1.5 work units per SM, and the
    A panel decoded once per bn >= 128 columns."""
    for bits_size, nbits in ((1, 8), (2, 16)):
        bn, splits, _, grid, _ = matmul_plan(64, 12288, 4096, bits_size,
                                             nbits, H100_SMS)
        assert bn >= 128
        assert (12288 // bn) * splits >= 1.5 * H100_SMS
        assert grid == H100_SMS


def split_schedule(q, k_bits, v_bits, lengths, fmt, bs, sms):
    """The CUDA kernel's schedule in plain torch: each (row, KV head) runs
    the online softmax over each split's key blocks separately, reading
    only positions below its length, and the splits' (m, l, acc) are
    merged in split order."""
    B, KV, G, D = q.shape
    S = k_bits.shape[1]
    bs, n_blocks, per, splits = kv_split_plan(S, bs, B * KV, sms)
    out = torch.zeros((B, KV, G, D))
    for b in range(B):
        length = min(int(lengths[b]), S)
        for h in range(KV):
            parts = []
            for s in range(splits):
                m = torch.full((G,), NEG_INF)
                l = torch.zeros(G)
                acc = torch.zeros(G, D)
                for blk in range(s * per, min((s + 1) * per, n_blocks)):
                    base = blk * bs
                    if base >= length:
                        break
                    valid = min(bs, length - base)
                    k = decode(k_bits[b, base:base + valid, h], fmt)
                    v = decode(v_bits[b, base:base + valid, h], fmt)
                    logits = (q[b, h] @ k.T) * (D ** -0.5)
                    mx = logits.amax(dim=-1)
                    if valid < bs:
                        mx = torch.clamp(mx, min=NEG_INF)
                    m_new = torch.maximum(m, mx)
                    p = torch.exp(logits - m_new[:, None])
                    alpha = torch.exp(m - m_new)
                    l = l * alpha + p.sum(dim=-1)
                    acc = acc * alpha[:, None] + p @ v
                    m = m_new
                parts.append((m, l, acc))
            M = torch.stack([m for m, _, _ in parts]).amax(dim=0)
            num, den = torch.zeros(G, D), torch.zeros(G)
            for m, l, acc in parts:
                w = torch.exp(m - M)
                num = num + w[:, None] * acc
                den = den + w * l
            out[b, h] = num / torch.clamp(den, min=1e-30)[:, None]
    return out, splits


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("S,bs", [(200, 64), (1000, 256)])
def test_split_schedule_matches_plain_and_pallas_kernel(n, S, bs):
    B, KV, G, D = 4, 1, 4, 16
    rng = np.random.default_rng(S + n)
    jf = JPositFormat(n, 2)
    q = rng.standard_normal((B, KV, G, D)).astype(np.float32)
    kv = rng.standard_normal((2, B, S, KV, D)).astype(np.float32)
    k = np.array(ref.encode_ref(jnp.asarray(kv[0]), jf))
    v = np.array(ref.encode_ref(jnp.asarray(kv[1]), jf))
    lengths = np.array([0, 1, S // 2 + 3, S + 5], np.int32)
    fmt = PositFormat(n, 2)
    got, splits = split_schedule(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), lengths, fmt, bs,
                                 sms=H100_SMS)
    assert splits > 1
    assert torch.all(got[0] == 0)
    plain = posit_kv_attention_torch(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lengths), fmt, bs=bs)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    for b in range(B):
        want = np.asarray(jkv(jnp.asarray(q[b, 0]), jnp.asarray(k[b, :, 0]),
                              jnp.asarray(v[b, :, 0]),
                              jnp.asarray(lengths[b], jnp.int32), jf, bs=bs,
                              interpret=True))
        np.testing.assert_allclose(got[b, 0].numpy(), want, **TOL)


@pytest.mark.parametrize("D", [64, 128, 256])
def test_query_groups_cover_every_row_once(D):
    for G in range(1, 65):
        rows, groups = query_groups(G, D)
        spans = [range(g * rows, min((g + 1) * rows, G))
                 for g in range(groups)]
        assert all(len(r) > 0 for r in spans)
        assert [i for r in spans for i in r] == list(range(G))
        # the kernel runs every group as the variant of ``rows``
        assert lane_plan(rows, D) is not None
        assert rows * D <= 1024
        if G <= rows:
            assert groups == 1
    assert query_groups(48, 128) == (8, 6)
    assert query_groups(4, 300) is None


def grouped_schedule(q, k_bits, v_bits, lengths, fmt, bs, sms):
    """The kernel's grouped schedule in plain torch: each group of
    ``query_groups`` rows runs ``split_schedule`` on its slice of q, into
    its slice of the output."""
    B, KV, G, D = q.shape
    rows, groups = query_groups(G, D)
    out = torch.zeros((B, KV, G, D))
    for g in range(groups):
        sl = slice(g * rows, min((g + 1) * rows, G))
        out[:, :, sl], splits = split_schedule(
            q[:, :, sl].contiguous(), k_bits, v_bits, lengths, fmt, bs, sms)
    return out, groups, splits


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("G", [12, 48])
def test_grouped_schedule_matches_plain_and_pallas_kernel(n, G):
    B, KV, D, S, bs = 2, 1, 128, 200, 64
    rng = np.random.default_rng(G + n)
    jf = JPositFormat(n, 2)
    q = rng.standard_normal((B, KV, G, D)).astype(np.float32)
    kv = rng.standard_normal((2, B, S, KV, D)).astype(np.float32)
    k = np.array(ref.encode_ref(jnp.asarray(kv[0]), jf))
    v = np.array(ref.encode_ref(jnp.asarray(kv[1]), jf))
    lengths = np.array([S // 2 + 3, S], np.int32)
    fmt = PositFormat(n, 2)
    got, groups, splits = grouped_schedule(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        lengths, fmt, bs, sms=H100_SMS)
    assert groups > 1 and splits > 1
    plain = posit_kv_attention_torch(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lengths), fmt, bs=bs)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    for b in range(B):
        want = np.asarray(jkv(jnp.asarray(q[b, 0]), jnp.asarray(k[b, :, 0]),
                              jnp.asarray(v[b, :, 0]),
                              jnp.asarray(lengths[b], jnp.int32), jf, bs=bs,
                              interpret=True))
        np.testing.assert_allclose(got[b, 0].numpy(), want, **TOL)


# The rounded matmul's main-path shapes (M, K, N): mel, centroid, DCT and
# forest votes at the cough batch of 32 (64 rows).
MAIN_PATH = [(64, 2049, 20), (64, 2049, 1), (64, 20, 13), (32, 10, 1)]


@pytest.mark.parametrize("M,K,N", MAIN_PATH + [
    (1, 1, 1), (37, 2049, 20), (1, 4096, 1), (4096, 1, 1), (1, 1, 4096),
    (4096, 4096, 8), (8, 4096, 4096), (129, 255, 3), (33, 257, 17),
    (70, 513, 5), (5, 3, 2), (64, 0, 20), (300, 4096, 64)])
def test_round_matmul_plan_covers_every_output_and_k_once(M, K, N):
    tm, tn, splits, per = round_matmul_plan(K, N)
    assert tn in (1, 2, 4, 8) and tm * tn == ROUND_ACC
    assert tn >= min(N, 8)
    assert 1 <= splits <= 16 and per % ROUND_THREADS == 0
    # block x of the grid: rows (x // n_tiles) tm + l // tn, columns
    # (x % n_tiles) tn + l % tn of lane l's output
    n_tiles = -(-N // tn)
    x = np.arange(-(-M // tm) * n_tiles)[:, None]
    lane = np.arange(ROUND_ACC)[None, :]
    m = (x // n_tiles) * tm + lane // tn
    n = (x % n_tiles) * tn + lane % tn
    inside = (m < M) & (n < N)
    hits = np.bincount((m * N + n)[inside], minlength=M * N)
    assert np.all(hits == 1)
    # split s, thread t: k = s per + t, s per + t + 256, ... below the
    # split's end; together every k once, no split empty
    ks = [k for s in range(splits) for t in range(ROUND_THREADS)
          for k in range(s * per + t, min(K, (s + 1) * per), ROUND_THREADS)]
    assert sorted(ks) == list(range(K))
    assert all(s * per < K for s in range(splits)) or K == 0


def test_round_matmul_plan_splits_k_where_the_tiles_are_few():
    """One row block of the mel and centroid products has 3 and 1 output
    tiles: K is split until those reach the H100's SMs or one k a thread
    (9 splits of 256 for K = 2049, at any M), the DCT and votes (K <= 256)
    are not split, and an output width that fills the SMs alone is not
    split either.  The plan takes no M: the sum order is K's and N's."""
    assert ROUND_SPLIT_BLOCKS == H100_SMS
    assert round_matmul_plan(2049, 20) == (4, 8, 9, ROUND_THREADS)
    assert round_matmul_plan(2049, 1) == (32, 1, 9, ROUND_THREADS)
    assert round_matmul_plan(20, 13)[2] == 1
    assert round_matmul_plan(10, 1)[2] == 1
    assert round_matmul_plan(4096, 8 * H100_SMS)[2] == 1
    assert round_matmul_plan(8192, 1)[2:] == (16, 2 * ROUND_THREADS)


def round_matmul_mirror(a, b, fmt):
    """The rounded matmul kernel's summation order in plain torch: thread
    t of split s adds the products of k = s per + t + 256 i in order; each
    warp adds its lanes' partials pairwise across lane ^ 16, 8, 4, 2, 1;
    the eight warps' sums are added in order, then the splits in order,
    and the sum is rounded once."""
    M, K = a.shape
    N = b.shape[1]
    _, _, splits, per = round_matmul_plan(K, N)
    t = torch.arange(ROUND_THREADS)
    lane = torch.arange(32)
    total = None
    for s in range(splits):
        end = min(K, (s + 1) * per)
        acc = torch.zeros(ROUND_THREADS, M, N, dtype=a.dtype)
        for base in range(s * per, end, ROUND_THREADS):
            k = base + t
            live = k < end
            k = torch.where(live, k, 0)
            prod = a[:, k].T[:, :, None] * b[k][:, None, :]
            acc = acc + torch.where(live[:, None, None], prod, 0.0)
        x = acc.reshape(ROUND_THREADS // 32, 32, M, N)
        for o in (16, 8, 4, 2, 1):
            x = x + x[:, lane ^ o]
        part = x[0, 0]
        for w in range(1, ROUND_THREADS // 32):
            part = part + x[w, 0]
        total = part if total is None else total + part
    return round_posit_math(total, fmt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("M,K,N", MAIN_PATH + [
    (37, 2049, 19), (3, 700, 5), (130, 4100, 9), (5, 3, 2), (64, 0, 20)])
def test_plain_rounded_matmul_sums_in_the_kernels_order(M, K, N, dtype):
    """The plain version (``round_matmul_sum``, vectorised, rows in slabs)
    is bitwise the mirror of the kernel's schedule above, in f32 and
    f64."""
    fmt = get_format("posit16")
    rng = np.random.default_rng(M * 7 + K + N)
    a = round_posit_math(torch.from_numpy(
        rng.random((M, K)) * np.exp2(rng.integers(0, 30, (M, K)))).to(dtype),
        fmt)
    b = round_posit_math(torch.from_numpy(
        rng.standard_normal((K, N))).to(dtype), fmt)
    got = posit_matmul_round_torch(a, b, fmt)
    want = round_matmul_mirror(a, b, fmt)
    assert torch.equal(got.view(torch.int64 if dtype == torch.float64
                                else torch.int32),
                       want.view(torch.int64 if dtype == torch.float64
                                 else torch.int32))


def _ulp_distance(a, b, fmt):
    def ordered(v):
        p = encode(v, fmt).to(torch.int64) & fmt.mask
        return (p ^ fmt.nar_pattern) - fmt.nar_pattern
    return (ordered(a) - ordered(b)).abs()


@pytest.mark.parametrize("name", ["posit8", "posit10", "posit16"])
@pytest.mark.parametrize("shape", ["mel", "centroid"])
def test_round_matmul_mirror_within_one_ulp_of_pallas_kernel(name, shape):
    """Power spectra (2^0-2^40) against a non-negative filterbank or the
    centroid's 0-8000 Hz bin frequencies, rounded to the format as the
    cough path rounds them."""
    fmt = get_format(name)
    rng = np.random.default_rng(len(name) + len(shape))
    M, K, N = (64, 2049, 20) if shape == "mel" else (64, 2049, 1)
    psd = (rng.random((M, K)) * np.exp2(rng.integers(0, 40, (M, K))))
    b = (np.maximum(rng.standard_normal((K, N)), 0) if shape == "mel"
         else np.linspace(0, 8000, K)[:, None])
    a = round_posit_math(torch.from_numpy(psd.astype(np.float32)), fmt)
    b = round_posit_math(torch.from_numpy(b.astype(np.float32)), fmt)
    got = round_matmul_mirror(a, b, fmt)
    want = torch.from_numpy(np.array(posit_matmul_round_2d(
        jnp.asarray(a.numpy()), jnp.asarray(b.numpy()),
        JPositFormat(fmt.n, fmt.es), interpret=True)))
    assert int(_ulp_distance(got, want, fmt).max()) <= 1
    assert int(_ulp_distance(got, posit_matmul_round_torch(a, b, fmt),
                             fmt).max()) <= 1
