"""Exact scalar posit reference implementation (pure Python, arbitrary precision).

A copy of ``repro.core.posit_scalar``: the independent oracle for the
vectorized codec, kept here so the port stands alone.

* ``decode_scalar`` follows the standard field-by-field decoding of the
  two's-complement magnitude, returning an exact ``Fraction``.
* ``encode_scalar`` exploits the posit ordering property (bit patterns of
  non-NaR posits are monotone in value when read as 2's-complement integers)
  to find the nearest pattern by exact binary search — it shares *no* logic
  with the vectorized encoder.
"""
from __future__ import annotations

from fractions import Fraction
from typing import Optional

from .formats import PositFormat


def decode_scalar(pattern: int, fmt: PositFormat) -> Optional[Fraction]:
    """Exact value of an n-bit posit pattern; None encodes NaR."""
    n, es = fmt.n, fmt.es
    pattern &= fmt.mask
    if pattern == 0:
        return Fraction(0)
    if pattern == fmt.nar_pattern:
        return None

    sign = (pattern >> (n - 1)) & 1
    mag = ((~pattern + 1) & fmt.mask) if sign else pattern

    # Walk the regime.
    bits = [(mag >> i) & 1 for i in reversed(range(n - 1))]  # below sign bit
    r0 = bits[0]
    k = 0
    while k < len(bits) and bits[k] == r0:
        k += 1
    r = -k if r0 == 0 else k - 1

    rest = bits[k + 1:]  # skip terminator (may be absent if regime fills)
    e_bits = rest[:es]
    e = 0
    for i in range(es):
        b = e_bits[i] if i < len(e_bits) else 0
        e = (e << 1) | b
    f_bits = rest[es:]
    m = len(f_bits)
    F = 0
    for b in f_bits:
        F = (F << 1) | b

    scale = r * (1 << es) + e
    frac = Fraction(F, 1 << m) if m else Fraction(0)
    val = (1 + frac) * (Fraction(2) ** scale)
    return -val if sign else val


def encode_scalar(value, fmt: PositFormat) -> int:
    """Nearest posit pattern to ``value``.

    Rounding follows the reference implementations (softposit, Universal):
    round-to-nearest-even applied to the *encoding* bit string extended to
    infinite precision — computed here exactly with Fractions. Saturates to
    maxpos/minpos (no overflow to NaR / underflow to zero).
    """
    import math

    if isinstance(value, float) and (math.isnan(value) or math.isinf(value)):
        return fmt.nar_pattern
    v = Fraction(value)
    if v == 0:
        return 0

    sign = v < 0
    a = -v if sign else v
    n, es = fmt.n, fmt.es

    maxpos = Fraction(2) ** fmt.max_scale
    minpos = Fraction(2) ** (-fmt.max_scale)
    if a >= maxpos:
        body = fmt.maxpos_pattern
    elif a <= minpos:
        body = fmt.minpos_pattern
    else:
        # exact q = floor(log2(a)) and m = a / 2^q in [1, 2)
        q = a.numerator.bit_length() - a.denominator.bit_length()
        if a < Fraction(2) ** q:
            q -= 1
        m = a / (Fraction(2) ** q)
        assert 1 <= m < 2
        r, e = q >> es, q - ((q >> es) << es)
        nR = r + 2 if r >= 0 else 1 - r
        R = (((1 << (r + 1)) - 1) << 1) if r >= 0 else 1

        body_len = n - 1
        # Exact encoding as a real number whose integer part is the body.
        S = (Fraction(R) * Fraction(2) ** (body_len - nR)
             + (Fraction(e) + (m - 1)) * Fraction(2) ** (body_len - nR - es))
        body = int(S)  # floor (S >= 0)
        rem = S - body
        if rem > Fraction(1, 2) or (rem == Fraction(1, 2) and (body & 1)):
            body += 1
        body = max(min(body, fmt.maxpos_pattern), fmt.minpos_pattern)

    pattern = ((~body + 1) & fmt.mask) if sign else body
    return pattern


def round_scalar(value, fmt: PositFormat) -> Optional[Fraction]:
    return decode_scalar(encode_scalar(value, fmt), fmt)
