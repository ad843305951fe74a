"""Posit formats and the direct rounding onto a posit lattice, in plain
torch: a frozen copy of the port's ``PositFormat`` and
``round_posit_math`` (``src/repro_torch/core/formats.py``, ``posit.py``),
kept here so that the benchmark's yardstick does not move with the
program.  Subnormal inputs round to zero (flush-to-zero, as the port's).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PositFormat:
    """A posit⟨n,es⟩ format description."""

    n: int
    es: int = 2

    def __post_init__(self) -> None:
        if not (2 <= self.n <= 32):
            raise ValueError(f"posit width {self.n} outside supported 2..32")
        if not (0 <= self.es <= 3):
            raise ValueError(f"posit es {self.es} outside supported 0..3")

    @property
    def name(self) -> str:
        return f"posit{self.n}" if self.es == 2 else f"posit{self.n}e{self.es}"

    @property
    def mask(self) -> int:
        return (1 << self.n) - 1

    @property
    def max_scale(self) -> int:
        """Scale (power of two) of maxpos: (n-2) * 2**es."""
        return (self.n - 2) << self.es

    @property
    def maxpos(self) -> float:
        return float(2.0 ** self.max_scale)


def get_format(name: str) -> PositFormat:
    """``positN`` (es = 2) or ``positNeE``."""
    if not name.startswith("posit"):
        raise KeyError(f"the reference rounds posit formats only: {name!r}")
    body = name[len("posit"):]
    if "e" in body:
        n_s, es_s = body.split("e")
        return PositFormat(int(n_s), int(es_s))
    return PositFormat(int(body), 2)


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
