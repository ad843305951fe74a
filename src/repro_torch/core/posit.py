"""Vectorized posit⟨n,es⟩ codec and direct rounding in torch bit arithmetic.

The counterpart of ``repro.core.posit``, bit for bit.  torch has no unsigned
shifts or compares past uint8, so the unsigned 32-bit words of the reference
are carried in int64 with explicit masking, and the rounding runs on the
float's own bits as int32 (f32) or int64 (f64), where every intermediate of
``round_posit_math`` stays non-negative.

Subnormal inputs are flushed to zero explicitly: the reference runs on
flush-to-zero backends (XLA CPU and TPU), where ``x == 0`` holds for a
subnormal ``x``; torch's CPU and CUDA compares do not flush.
"""
from __future__ import annotations

import torch

from .formats import PositFormat

_U32 = 0xFFFFFFFF


def _clz32(v: torch.Tensor) -> torch.Tensor:
    """Leading zeros of 32-bit words held in int64 (32 for zero)."""
    _, e = torch.frexp(v.to(torch.float64))     # exact for v < 2**53
    return 32 - e.to(torch.int64)


def decode(bits: torch.Tensor, fmt: PositFormat,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Decode n-bit posit patterns to floating point; NaR decodes to NaN."""
    if bits.dtype not in (torch.int8, torch.int16, torch.int32, torch.int64,
                          torch.uint8):
        raise TypeError(f"posit bit patterns must be integer, got {bits.dtype}")
    n, es = fmt.n, fmt.es
    x = bits.to(torch.int64) & fmt.mask

    sign = (x >> (n - 1)) & 1
    is_zero = x == 0
    is_nar = x == fmt.nar_pattern
    mag = torch.where(sign == 1, (-x) & fmt.mask, x)
    # the n-1 bits below the sign, aligned to the top of a 32-bit word
    y = (mag << (33 - n)) & _U32

    r0 = y >> 31
    inv = torch.where(r0 == 1, (~y) & _U32, y)
    k = torch.clamp(_clz32(inv), max=n - 1)             # regime run length
    r = torch.where(r0 == 0, -k, k - 1)                 # regime value
    z = torch.where(k + 1 >= 32, torch.zeros_like(y),
                    (y << torch.clamp(k + 1, max=31)) & _U32)
    if es > 0:
        e = z >> (32 - es)
        frac_top = (z << es) & _U32
    else:
        e = torch.zeros_like(k)
        frac_top = z

    scale = r * (1 << es) + e
    f = frac_top.to(dtype) * (2.0 ** -32)
    # exact 2**scale by exponent-field construction
    if dtype == torch.float64:
        pw = ((torch.clamp(scale, -1022, 1023) + 1023) << 52).view(
            torch.float64)
    else:
        pw = ((torch.clamp(scale, -126, 127) + 127) << 23).to(
            torch.int32).view(torch.float32).to(dtype)
    val = (1.0 + f) * pw
    val = torch.where(sign == 1, -val, val)
    val = torch.where(is_zero, torch.zeros_like(val), val)
    val = torch.where(is_nar, torch.full_like(val, float("nan")), val)
    return val.to(dtype)


def encode(values: torch.Tensor, fmt: PositFormat) -> torch.Tensor:
    """Encode floats to n-bit posit patterns (RNE on the posit lattice,
    saturating; NaN/±Inf → NaR), in ``fmt.storage_dtype``."""
    n, es = fmt.n, fmt.es
    v = values
    if v.dtype == torch.float64:
        mbits, ebits, ebias, wrap = 52, 11, 1023, None
        vbits = v.view(torch.int64)
    else:
        v = v.to(torch.float32)
        mbits, ebits, ebias, wrap = 23, 8, 127, _U32
        vbits = v.view(torch.int32).to(torch.int64) & _U32

    def w(t):               # uint32 wrap-around for the f32 words
        return t if wrap is None else t & wrap

    tbits = es + mbits
    exp_field = (vbits >> mbits) & ((1 << ebits) - 1)
    is_zero = exp_field == 0                            # zero or subnormal
    is_nar = ~torch.isfinite(v)
    sign = torch.signbit(v) & ~is_zero

    a = torch.clamp(v.abs(), fmt.minpos, fmt.maxpos)
    if wrap is None:
        abits = a.view(torch.int64)
    else:
        abits = a.view(torch.int32).to(torch.int64) & _U32
    biased = (abits >> mbits) & ((1 << ebits) - 1)
    man = abits & ((1 << mbits) - 1)
    q = biased - ebias                                  # power-of-two scale

    r = q >> es                                         # floor division
    e = q - (r << es)                                   # 0 .. 2^es - 1
    one = torch.ones_like(q)
    r_pos = torch.clamp(r, min=0)
    R = torch.where(r >= 0, w((w(one << (r_pos + 1)) - 1) << 1), one)
    nR = torch.where(r >= 0, r + 2, 1 - r)              # regime bit count

    T = (e << mbits) | man                              # exp ++ fraction
    shift = nR + tbits - (n - 1)                        # bits dropped

    sh_p = torch.clamp(shift, 1, tbits)
    body_p = w(R << (tbits - sh_p)) | (T >> sh_p)
    g_p = (T >> (sh_p - 1)) & 1
    st_p = (T & ((one << (sh_p - 1)) - 1)) != 0

    sh_n = torch.clamp(-shift, 0, 31)
    body_n = w(R << torch.clamp(tbits - shift, 0, 63)) | w(T << sh_n)

    sh_t = torch.clamp(shift - tbits, 0, 31)
    body_t = R >> sh_t

    body = torch.where(shift <= 0, body_n,
                       torch.where(shift <= tbits, body_p, body_t))
    mid = (shift >= 1) & (shift <= tbits)
    g = torch.where(mid, g_p, torch.zeros_like(g_p))
    st = mid & st_p

    body = body + (g & (st.to(torch.int64) | (body & 1)))
    body = torch.clamp(body, fmt.minpos_pattern, fmt.maxpos_pattern)

    pattern = torch.where(sign, (-body) & fmt.mask, body)
    pattern = torch.where(is_zero, torch.zeros_like(pattern), pattern)
    pattern = torch.where(is_nar, torch.full_like(pattern, fmt.nar_pattern),
                          pattern)
    return pattern.to(fmt.storage_dtype)


def round_posit_math(x: torch.Tensor, fmt: PositFormat) -> torch.Tensor:
    """Direct rounding onto the posit lattice by float-bit manipulation.

    The same algorithm as ``repro.core.posit.round_posit_math`` (regime run
    length from the float exponent, integer RNE of the float's own bits at
    the posit's last kept bit, the pure-regime tie-break override), written
    on signed words: the magnitude is below 2**(width-1) and every step
    (clamp, +1 binade alignment, +half ulp) stays there.  The CUDA kernels
    share this arithmetic through ``csrc/posit_math.cuh``.
    """
    n, es = fmt.n, fmt.es
    if x.dtype == torch.float64:
        idt, width, mbits, ebits, bias = torch.int64, 64, 52, 11, 1023
        nan_bits = 0x7FF8000000000000
    else:
        x = x.to(torch.float32)
        idt, width, mbits, ebits, bias = torch.int32, 32, 23, 8, 127
        nan_bits = 0x7FC00000
    tbits = es + mbits
    sign_bit = -(1 << (width - 1))
    full_exp = ((1 << ebits) - 1) << mbits              # |Inf| bit pattern
    minpos_bits = (bias - fmt.max_scale) << mbits
    maxpos_bits = (bias + fmt.max_scale) << mbits

    bits = x.view(idt)
    sbit = bits & sign_bit
    mag = bits & ((1 << (width - 1)) - 1)
    is_zero = mag < (1 << mbits)                        # zero or subnormal
    is_nar = mag >= full_exp                            # ±Inf or NaN
    m = torch.clamp(mag, minpos_bits, maxpos_bits)

    q = (m >> mbits) - bias                             # power-of-two scale
    r = q >> es                                         # regime value
    nr = (r ^ (r >> (width - 1))) + 2                   # regime bit count
    drop = nr + (tbits - (n - 1))
    if 2 + tbits - (n - 1) >= 1:          # narrow formats: drop >= 1 always
        dropc = torch.clamp(drop, max=tbits)
    else:
        dropc = torch.clamp(drop, 1, tbits)

    adj = m + (1 << mbits)                              # bias+1 alignment
    half_ulp = torch.ones_like(dropc) << (dropc - 1)
    # pure-regime patterns: the last kept bit is the regime's low bit
    lsb = torch.where(drop < tbits, (adj >> dropc) & 1,
                      (r >> (width - 1)) & 1)
    rounded = (adj + (half_ulp - 1) + lsb) & ~((half_ulp << 1) - 1)
    out = rounded - (1 << mbits)
    if 2 + tbits - (n - 1) < 1:                         # only wide posits
        out = torch.where(drop >= 1, out, m)            # can be exact
    out = out | sbit
    out = torch.where(is_zero, torch.zeros_like(out), out)
    out = torch.where(is_nar, torch.full_like(out, nan_bits), out)
    return out.view(x.dtype)


def round_to_posit(x: torch.Tensor, fmt: PositFormat,
                   dtype: torch.dtype = None) -> torch.Tensor:
    """Nearest posit value, in float — the direct float-bit path."""
    return round_posit_math(x, fmt).to(dtype or x.dtype)


def round_to_posit_codec(x: torch.Tensor, fmt: PositFormat,
                         dtype: torch.dtype = None) -> torch.Tensor:
    """encode∘decode: nearest posit value, in float (the codec oracle)."""
    return decode(encode(x, fmt), fmt, dtype=dtype or x.dtype)
