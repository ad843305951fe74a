"""Quire semantics: fused accumulation without intermediate storage rounding.

The counterpart of ``repro.core.quire``.  The paper's quire is a 16n-bit
fixed-point register that accumulates MACs exactly before one rounding to
posit (the Xposit QMADD...QROUND sequence).  Here, as in the reference, an
exact accumulation is simulated in floats with error-free transformations:
``two_sum``/``two_prod`` split every partial result into a rounded value
plus its exact error, and the compensated ``comp_*`` reducers carry the
running sum as an unevaluated ``(s, c)`` pair.  The same elementwise ops in
the same order as the reference (the same pairwise tree, the same zero
padding), so the results are bit for bit the reference's — including the
inputs where its compensation is one ulp short of the exact oracle.

Eager torch ops never contract ``a * b + c`` into one fused multiply-add,
so Dekker's split in ``two_prod`` holds on the CPU and on the card.

Exactness envelope (per posit⟨n,es⟩; significand = n−2−es bits): products
are exact in f32 for n ≤ 16 and in f64 for n ≤ 24; posit32 products need
``two_prod`` even in f64.  The wide posits (24/32) need the f64
accumulator for their product range.  The reference picks f64 for them only
under ``jax_enable_x64``; torch always has f64, so ``quire_acc_dtype``
here always takes it (the reference's result under x64).

Public pieces:

* ``quire_dot_exact``   — pure-Python exact oracle (Fractions).
* ``two_sum``/``two_prod``/``comp_sum``/``comp_dot``/``comp_cumsum`` — the
  EFT building blocks ``Arith`` uses for its quire paths.
* ``qdot``              — bits-in/bits-out fused dot: decode → compensated
                          accumulation → one final rounding.
* ``quire_matmul_ref``  — the oracle of the decode-fused posit matmul.
"""
from __future__ import annotations

from fractions import Fraction
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .formats import PositFormat
from .posit import decode, encode
from .posit_scalar import decode_scalar, encode_scalar


# ---------------------------------------------------------------------------
# Exact oracle
# ---------------------------------------------------------------------------

def quire_dot_exact(a_bits, b_bits, fmt: PositFormat) -> int:
    """Exact fused dot product of two posit vectors → posit pattern.

    Products and the running sum are exact; one rounding at the end.  NaR
    in any operand poisons the result, as in the standard."""
    total = Fraction(0)
    for pa, pb in zip(np.asarray(a_bits).ravel(), np.asarray(b_bits).ravel()):
        va = decode_scalar(int(pa), fmt)
        vb = decode_scalar(int(pb), fmt)
        if va is None or vb is None:
            return fmt.nar_pattern
        total += va * vb
    return encode_scalar(total, fmt)


# ---------------------------------------------------------------------------
# Error-free transformations
# ---------------------------------------------------------------------------

def two_sum(a: torch.Tensor, b: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Knuth's branch-free EFT: ``s = fl(a+b)`` and ``s + e == a + b``
    exactly, for any finite IEEE inputs (NaN/Inf propagate)."""
    s = a + b
    bp = s - a
    e = (a - (s - bp)) + (b - bp)
    return s, e


# Dekker split constants 2^ceil(p/2) + 1: f32 → 2^12+1, f64 → 2^27+1
_SPLIT = {torch.float32: 4097.0, torch.float64: 134217729.0}


def two_prod(a: torch.Tensor, b: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dekker's EFT product: ``p = fl(a·b)`` and ``p + e == a·b`` exactly
    (no FMA), provided the split does not overflow."""
    split = _SPLIT[torch.result_type(a, b)]
    p = a * b
    ca = split * a
    ah = ca - (ca - a)
    al = a - ah
    cb = split * b
    bh = cb - (cb - b)
    bl = b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _comp_reduce_last(s: torch.Tensor, c: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pairwise compensated reduction over the last axis of an ``(s, c)``
    pair field → ``(s, c)`` without that axis.  Zero padding to a power of
    two is exact; each merge is one ``two_sum`` plus exact-error carries."""
    K = s.shape[-1]
    if K == 0:
        z = torch.zeros(s.shape[:-1], dtype=s.dtype, device=s.device)
        return z, z
    P = 1 << (K - 1).bit_length()
    if P != K:
        s = F.pad(s, (0, P - K))
        c = F.pad(c, (0, P - K))
    while s.shape[-1] > 1:
        h = s.shape[-1] // 2
        s, e = two_sum(s[..., :h], s[..., h:])
        c = (c[..., :h] + c[..., h:]) + e
    return s[..., 0], c[..., 0]


def comp_sum(x: torch.Tensor, axis=-1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compensated sum along ``axis`` (None = ravel): ``(s, c)`` with
    ``s + c`` the near-exact total."""
    if axis is None:
        x, axis = x.reshape(-1), -1
    moved = torch.movedim(x, axis, -1)
    return _comp_reduce_last(moved, torch.zeros_like(moved))


def comp_dot(a: torch.Tensor, b: torch.Tensor, axis=-1,
             product_eft: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compensated dot along ``axis`` (Ogita–Rump–Oishi Dot2 shape):
    products (split through ``two_prod`` when ``product_eft``) feed the
    pairwise compensated reduction."""
    if axis is None:
        a, b = torch.broadcast_tensors(a, b)
        a, b, axis = a.reshape(-1), b.reshape(-1), -1
    if product_eft:
        a, b = torch.broadcast_tensors(a, b)
        p, e = two_prod(a, b)
    else:
        p = a * b
        e = torch.zeros_like(p)
    return _comp_reduce_last(torch.movedim(p, axis, -1),
                             torch.movedim(e, axis, -1))


def comp_cumsum(x: torch.Tensor, axis=-1
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compensated prefix sums along ``axis`` (None = ravel): every prefix
    is its own quire accumulation, returned as an ``(s, c)`` pair field."""
    if axis is None:
        x, axis = x.reshape(-1), -1
    moved = torch.movedim(x, axis, 0)
    s = c = torch.zeros(moved.shape[1:], dtype=moved.dtype,
                        device=moved.device)
    ss, cc = [], []
    for xk in moved:
        s, e = two_sum(s, xk)
        c = c + e
        ss.append(s)
        cc.append(c)
    if not ss:
        return x, torch.zeros_like(x)
    return (torch.movedim(torch.stack(ss), 0, axis),
            torch.movedim(torch.stack(cc), 0, axis))


# ---------------------------------------------------------------------------
# Per-format accumulator resolution
# ---------------------------------------------------------------------------

def product_eft_needed(fmt: PositFormat, acc_dtype: torch.dtype) -> bool:
    """True iff a single product of ``fmt`` values can be inexact in
    ``acc_dtype``: only posit32 in f64 among the registered formats."""
    mant = 53 if acc_dtype == torch.float64 else 24
    return 2 * (fmt.max_fraction_bits + 1) > mant


def quire_acc_dtype(fmt: PositFormat) -> torch.dtype:
    """Narrowest float dtype whose significand and exponent range carry
    ``fmt``'s products exactly: f32 for n ≤ 16, f64 for the wide posits
    (always available here, unlike the reference without x64)."""
    needs_wide = (2 * (fmt.max_fraction_bits + 1) > 24
                  or 2 * fmt.max_scale > 126)
    return torch.float64 if needs_wide else torch.float32


# ---------------------------------------------------------------------------
# Fused bits-in/bits-out ops
# ---------------------------------------------------------------------------

def qdot(a_bits: torch.Tensor, b_bits: torch.Tensor, fmt: PositFormat,
         acc_dtype: torch.dtype = None,
         out_format: Optional[PositFormat] = None) -> torch.Tensor:
    """Fused posit dot product: decode → compensated accumulation → one
    rounding.  Returns posit patterns when ``out_format`` is given, else
    the wide accumulator value."""
    if acc_dtype is None:
        acc_dtype = quire_acc_dtype(fmt)
    va = decode(a_bits, fmt, dtype=acc_dtype).reshape(-1)
    vb = decode(b_bits, fmt, dtype=acc_dtype).reshape(-1)
    s, c = comp_dot(va, vb, axis=-1,
                    product_eft=product_eft_needed(fmt, acc_dtype))
    acc = s + c
    if out_format is None:
        return acc
    return encode(acc, out_format)


def quire_matmul_ref(a_bits: torch.Tensor, b_bits: torch.Tensor,
                     fmt: PositFormat, acc_dtype: torch.dtype = torch.float32,
                     compute_dtype: torch.dtype = torch.bfloat16
                     ) -> torch.Tensor:
    """(M,K)·(K,N) posit bits → ``acc_dtype``: decode, round to
    ``compute_dtype`` (the matrix unit's input format), multiply-accumulate
    in ``acc_dtype``.  A bf16 × bf16 product is exact in f32, so only the
    accumulation order is left to the matmul."""
    va = decode(a_bits, fmt, dtype=torch.float32).to(compute_dtype)
    vb = decode(b_bits, fmt, dtype=torch.float32).to(compute_dtype)
    return va.to(acc_dtype) @ vb.to(acc_dtype)
