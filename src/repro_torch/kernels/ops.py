"""The kernels' public wrappers with the reference's shape handling — the
counterpart of ``repro.kernels.ops``.

Each call runs the CUDA kernel for tensors on the card and its plain
version for tensors on the CPU; no call pads or tiles, since the kernels
take any length.  ``matmul`` keeps the reference's block arguments and its
divisibility assertion, so a shape the reference refuses is refused here
too.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import PositFormat

from .posit_codec import posit_decode, posit_encode
from .posit_kv_attention import posit_kv_attention
from .posit_matmul import posit_matmul, posit_matmul_round
from .posit_round import posit_butterfly


def decode(bits: torch.Tensor, fmt: PositFormat,
           out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Values of posit patterns of any shape (f32 or bf16)."""
    return posit_decode(bits.contiguous(), fmt, out_dtype)


def encode(x: torch.Tensor, fmt: PositFormat) -> torch.Tensor:
    """Posit patterns (``fmt.storage_dtype``) of f32 values of any shape."""
    return posit_encode(x.to(torch.float32).contiguous(), fmt)


def matmul(a_bits: torch.Tensor, b_bits: torch.Tensor, fmt: PositFormat,
           bm: int = 256, bn: int = 256, bk: int = 512) -> torch.Tensor:
    """(M,K)·(K,N) posit bits → f32.  Dims must divide the block sizes
    (each clamped to its dim), as in the reference; the kernel's own tiles
    do not depend on them."""
    M, K = a_bits.shape
    K2, N = b_bits.shape
    assert K == K2
    bm, bn, bk = min(bm, M), min(bn, N), min(bk, K)
    assert M % bm == 0 and N % bn == 0 and K % bk == 0, (M, N, K, bm, bn, bk)
    return posit_matmul(a_bits.contiguous(), b_bits.contiguous(), fmt)


def matmul_rounded(a: torch.Tensor, b: torch.Tensor,
                   fmt: PositFormat) -> torch.Tensor:
    """Fused ``round_fmt(a·b)`` on float values (the Arith.matmul path)."""
    return posit_matmul_round(a.contiguous(), b.contiguous(), fmt)


def butterfly(e_re, e_im, o_re, o_im, w_re, w_im, fmt: PositFormat):
    """One fused rounded radix-2 butterfly over whole planes; the twiddles
    broadcast along one axis."""
    return posit_butterfly(*(t.contiguous() for t in (e_re, e_im, o_re,
                                                      o_im)),
                           w_re, w_im, fmt)


def kv_attention(q: torch.Tensor, k_bits: torch.Tensor,
                 v_bits: torch.Tensor, length, fmt: PositFormat,
                 bs: int = 512) -> torch.Tensor:
    """q (B, KV, G, D); k/v bits (B, S, KV, D); ``length`` a scalar shared
    by every row or a (B,) vector of per-row valid lengths."""
    return posit_kv_attention(q, k_bits, v_bits, length, fmt, bs=bs)
