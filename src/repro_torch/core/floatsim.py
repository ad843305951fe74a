"""Narrow IEEE-like float rounding, bit for bit as ``repro.core.floatsim``.

The reference rounds by a round trip through the narrow type under XLA's
convert (ml_dtypes semantics): round to nearest even, subnormals kept,
fp16/bf16/fp8e5m2 overflowing to ±Inf, and fp8e4m3fn (OCP "fn": no Inf)
overflowing to NaN — the failure the paper reports for BayeSlope under
FP8E4M3.  Two places where a bare ``.to()`` in torch gives other bits:

* **fp8e4m3fn overflow.**  torch's cast saturates (500, ±Inf → ±448); the
  reference gives NaN for every |x| > 464 (the midpoint of 448 and the
  missing 480) and for ±Inf.  Handled explicitly below.
* **float64 inputs.**  XLA rounds f64 to fp16 and to both fp8s directly,
  but to bf16 through f32 (so 1 + 2⁻⁸ + 2⁻⁴⁰ → 1.0 in bf16, a double
  rounding the reference keeps), and XLA's f64 → f32 step flushes a
  result that is subnormal in f32 (tiny after rounding to 24 bits) to ±0.
  torch rounds f64 → fp16 through f32 on the CPU and directly on the
  card, and keeps f32 subnormals.  Here a direct rounding goes through f32
  rounded to odd, which is then exact for every target with at most 22
  significand bits, on any device; the f32 step flushes as XLA's does.

NaN results carry no promised payload: compare them NaN-aware.
"""
from __future__ import annotations

import torch

from .formats import FloatFormat

# |x| above this rounds past fp8e4m3fn's largest finite value (448) to the
# pattern that is NaN in the "fn" encoding; 464 itself ties to even → 448
_E4M3FN_OVERFLOW = 464.0
# f64 → narrow rounding XLA does directly (else: through f32)
_DIRECT_FROM_F64 = ("fp16", "fp8e5m2", "fp8e4m3")


def _f32_round_to_odd(x: torch.Tensor) -> torch.Tensor:
    """f64 → f32 rounded to odd: an inexact result takes the neighbour
    whose last significand bit is 1, so a later round to nearest even at
    ≤ 22 bits sees the sticky information the first rounding dropped."""
    r = x.to(torch.float32)
    bits = r.view(torch.int32)
    inexact = (r.to(torch.float64) != x) & torch.isfinite(r)
    # sign-magnitude words: +1 moves away from zero, −1 towards it
    step = torch.where(r.abs().to(torch.float64) > x.abs(), -1, 1).to(
        torch.int32)
    bits = torch.where(inexact & ((bits & 1) == 0), bits + step, bits)
    return bits.view(torch.float32)


def _f64_to_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f64 → f32 convert: round to nearest even, and ±0 where the
    result rounded to 24 bits (exponent unbounded) lies below 2⁻¹²⁶."""
    r = x.to(torch.float32)
    tiny = (x.abs() < 2.0 ** -126) & (
        (x * 2.0 ** 64).to(torch.float32).abs() < 2.0 ** -62)
    return torch.where(tiny, r * 0.0, r)


def round_to_float(x: torch.Tensor, fmt: FloatFormat) -> torch.Tensor:
    """``x`` rounded to the narrow format ``fmt``, in ``x``'s own dtype."""
    out_dtype = x.dtype
    if out_dtype == torch.float64:
        x32 = (_f32_round_to_odd(x) if fmt.name in _DIRECT_FROM_F64
               else _f64_to_f32(x))
    else:
        x32 = x.to(torch.float32)
    if fmt.name == "fp32":
        return x if out_dtype == torch.float32 else x32.to(out_dtype)
    y = x32.to(fmt.dtype).to(torch.float32)
    if fmt.name == "fp8e4m3":
        y = torch.where(x32.abs() > _E4M3FN_OVERFLOW,
                        torch.full_like(y, float("nan")), y)
    return y.to(out_dtype)
