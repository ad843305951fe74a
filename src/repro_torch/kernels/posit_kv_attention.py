"""One decode step of attention over a posit-quantized KV cache.

``posit_kv_attention(q, k_bits, v_bits, length, fmt, bs)`` takes q
(B, KV, G, D) f32, the K/V bits as the cache holds them (B, S, KV, D) and
``length`` as an int or a (B,) int tensor of valid positions per row, and
returns (B, KV, G, D) f32.  Replaces
``repro/kernels/posit_kv_attention.py::posit_kv_attention`` together with
the B × KV vmap of ``repro/kernels/ops.py::kv_attention``.

A CUDA tensor launches ``csrc/posit_kv_attention.cu`` or raises; a CPU
tensor takes the plain version.  The kernel splits the key blocks of
``block_plan`` across thread blocks (``kv_split_plan``): the grid is (B ×
KV, splits, query groups), each block runs the online softmax over its
contiguous range of key blocks, skipping the blocks and rows at or past
the row's length, and a second kernel merges the splits' (m, l, acc)
partials in a fixed order; a cache of one key block (the serve path's)
takes one split and no second launch.  A KV head's G query rows are cut
into groups of at most 8 rows (4 at D > 128), the slices of q and of the
output that a lane keeps in registers (``query_groups``), and the groups
are the grid's third dimension: one launch takes any G.  K/V rows must be
contiguous and 16-byte aligned and D at most 256.
The plain version replays
``repro/kernels/ref.py::kv_attention_oracle`` op for op:
the same ``block_plan``, the same masking order, the same carry updates.
The kernel sums its dot products in another order and merges its
splits, so the two agree within rtol = atol = 2e-5 (the reference's own
kernel-vs-oracle tolerance), not bitwise.  A masked position is never
read by the kernel; the plain version multiplies its decoded value by a
zero weight, so a NaR pattern there gives NaN only in the plain version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple, Union

import torch

from repro_torch.core.formats import PositFormat
from repro_torch.core.posit import decode

from . import build

NEG_INF = -1e30
_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
_BITS_DTYPES = (torch.int8, torch.int16, torch.int32)
_lib = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("posit_kv_attention")
        lib.posit_kv_attention.argtypes = (
            [_P] * 6 + [_I] * 7 + [_LL] * 4 + [_I] * 6 + [_F]
            + [_I] * 3 + [_P])
        lib.posit_kv_attention.restype = _I
        _lib = lib
    return _lib


def block_plan(S: int, bs: int) -> Tuple[int, int]:
    """(bs, S_pad): the block size clamped to the padded sequence and
    rounded to 8, and S padded up to a whole number of blocks — the plan
    of ``repro/kernels/posit_kv_attention.py::_block_plan``."""
    rounded = -(-max(S, 1) // 8) * 8
    bs = max(8, min(bs, rounded))
    return bs, -(-S // bs) * bs


# blocks per SM the split plan aims at on a long cache
BLOCKS_PER_SM = 4


@functools.lru_cache(maxsize=1024)
def kv_split_plan(S: int, bs: int, n_heads: int,
                  sms: int) -> Tuple[int, int, int, int]:
    """(bs, n_blocks, blocks_per_split, splits) of the kernel's grid.

    The key blocks of ``block_plan(S, bs)`` are cut into ``splits``
    contiguous ranges of ``blocks_per_split`` (the last may be shorter,
    none is empty).  The ``n_heads`` (= B × KV) × ``splits`` thread blocks
    must put at least ``BLOCKS_PER_SM`` on each of the ``sms`` SMs where
    the cache has that many key blocks; among such cuts the plan takes the
    least work on the busiest SM (``ceil(blocks / sms)`` thread blocks of
    ``blocks_per_split`` key blocks each), then the fewer splits.  A cache
    of one key block takes one split: no partials and no combine
    launch."""
    bs, S_pad = block_plan(S, bs)
    n_blocks = S_pad // bs
    if n_blocks <= 1:
        return bs, n_blocks, 1, 1
    best = None
    for per in range(n_blocks, 0, -1):
        splits = -(-n_blocks // per)
        if per > 1 and -(-n_blocks // (per - 1)) == splits:
            continue            # the same splits, more evenly cut below
        blocks = n_heads * splits
        if blocks < BLOCKS_PER_SM * sms and per > 1:
            continue
        key = (-(-blocks // sms) * per, splits)
        if best is None or key < best[0]:
            best = (key, (bs, n_blocks, per, splits))
    return best[1]


def lane_plan(G: int, D: int) -> Optional[Tuple[int, int]]:
    """(el, gp): elements of a K/V row per lane (a power of two, D <= 32
    el) and G rounded up to a power of two, at least 2; None where the
    kernel has no such variant (el > 8, gp > 8 or el × gp > 32: q's slice
    and the accumulators live in registers)."""
    el = 1 << max(0, -(-D // 32) - 1).bit_length()
    gp = max(2, 1 << max(0, G - 1).bit_length())
    return (el, gp) if el <= 8 and gp <= 8 and el * gp <= 32 else None


def query_groups(G: int, D: int) -> Optional[Tuple[int, int]]:
    """(rows, groups): G query rows per KV head cut into ``groups`` groups
    of ``rows`` (the last may be shorter, none is empty), the fewest groups
    whose rows have a ``lane_plan`` variant, their rows as even as the
    count allows; None where no group size has one (D > 256)."""
    cap = next((g for g in (8, 4, 2) if lane_plan(g, D)), None)
    if cap is None or G < 1:
        return None
    groups = -(-G // cap)
    rows = -(-G // groups)
    return rows, -(-G // rows)


def _lengths(length, B: int, device) -> torch.Tensor:
    return torch.as_tensor(length, dtype=torch.int32, device=device
                           ).reshape(-1).expand(B).contiguous()


def posit_kv_attention_torch(q: torch.Tensor, k_bits: torch.Tensor,
                             v_bits: torch.Tensor,
                             length: Union[int, torch.Tensor],
                             fmt: PositFormat, bs: int = 512
                             ) -> torch.Tensor:
    """Plain version of the kernel (see the module docstring)."""
    B, KV, G, D = q.shape
    S = k_bits.shape[1]
    q = q.to(torch.float32)
    if S == 0:
        return torch.zeros((B, KV, G, D), dtype=torch.float32,
                           device=q.device)
    bs, S_pad = block_plan(S, bs)
    length = torch.clamp(_lengths(length, B, q.device), max=S)
    m = torch.full((B, KV, G, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KV, G, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, D), dtype=torch.float32, device=q.device)
    for i in range(S_pad // bs):
        lo, hi = i * bs, min((i + 1) * bs, S)
        pad = (0, 0, 0, 0, 0, bs - (hi - lo))       # zero patterns past S
        k = decode(torch.nn.functional.pad(k_bits[:, lo:hi], pad), fmt)
        v = decode(torch.nn.functional.pad(v_bits[:, lo:hi], pad), fmt)
        logits = torch.einsum("bhgd,bshd->bhgs", q, k) * (D ** -0.5)
        pos = lo + torch.arange(bs, device=q.device)
        valid = (pos[None, :] < length[:, None])[:, None, None, :]
        logits = torch.where(valid, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        p = torch.exp(logits - m_new)
        p = torch.where(valid, p, 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgs,bshd->bhgd", p, v)
        m = m_new
    return acc / torch.clamp(l, min=1e-30)


def posit_kv_attention(q: torch.Tensor, k_bits: torch.Tensor,
                       v_bits: torch.Tensor,
                       length: Union[int, torch.Tensor], fmt: PositFormat,
                       bs: int = 512) -> torch.Tensor:
    """Attention of q (B, KV, G, D) over the posit K/V bits (B, S, KV, D)
    up to each row's ``length``; (B, KV, G, D) f32."""
    if all(t.device.type == "cpu" for t in (q, k_bits, v_bits)):
        return posit_kv_attention_torch(q, k_bits, v_bits, length, fmt, bs)
    B, KV, G, D = q.shape
    S = k_bits.shape[1]
    for t in (q, k_bits, v_bits):
        if not t.is_cuda:
            raise ValueError(f"posit_kv_attention: tensors must all be on "
                             f"the card (got {t.device})")
    if q.dtype != torch.float32 or not q.is_contiguous():
        raise TypeError("posit_kv_attention: q must be contiguous float32")
    if k_bits.dtype not in _BITS_DTYPES or v_bits.dtype != k_bits.dtype:
        raise TypeError(f"posit_kv_attention: K/V bits must share one of "
                        f"{_BITS_DTYPES}, got {k_bits.dtype}, "
                        f"{v_bits.dtype}")
    if (k_bits.shape != (B, S, KV, D) or v_bits.shape != k_bits.shape
            or v_bits.stride() != k_bits.stride()):
        raise ValueError(f"posit_kv_attention: K/V {tuple(k_bits.shape)} "
                         f"must be (B, S, KV, D) = {(B, S, KV, D)} with "
                         f"one layout")
    plan = query_groups(G, D)
    if plan is None or B * KV >= 2 ** 31 or S >= 2 ** 31:
        raise ValueError(f"posit_kv_attention: G = {G}, D = {D}: the kernel "
                         f"takes D <= 256, and B*KV, S within int32")
    rows, groups = plan
    e = k_bits.element_size()
    if (k_bits.stride(-1) != 1
            or any(st * e % 16 for st in (D, *k_bits.stride()[:3]))
            or k_bits.data_ptr() % 16 or v_bits.data_ptr() % 16):
        raise ValueError("posit_kv_attention: K/V rows must be contiguous "
                         "and 16-byte aligned (D * itemsize a multiple of "
                         "16), as a cache's are")
    out = torch.empty((B, KV, G, D), dtype=torch.float32, device=q.device)
    if S == 0 or B * KV == 0:
        return out.zero_()
    bs, n_blocks, per, splits = kv_split_plan(
        S, bs, B * KV, build.sm_count(q.device.index))
    part = (torch.empty(B * KV * groups * splits * (rows * D + 2 * rows),
                        dtype=torch.float32, device=q.device)
            if splits > 1 else None)
    lengths = _lengths(length, B, q.device)
    rc = _kernels().posit_kv_attention(
        q.data_ptr(), k_bits.data_ptr(), v_bits.data_ptr(),
        lengths.data_ptr(), out.data_ptr(),
        part.data_ptr() if part is not None else None, B, KV, G, rows,
        groups, D, S, *k_bits.stride(), bs, n_blocks, per, splits,
        *lane_plan(rows, D), D ** -0.5,
        e, fmt.n, fmt.es, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"posit_kv_attention: CUDA launch failed (cudaError {rc})")
    posit_kv_attention.launches += 1
    return out


posit_kv_attention.launches = 0
