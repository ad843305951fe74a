"""Number-format registries: posit⟨n,es⟩ and narrow IEEE-like float formats.

The 2022 Posit Standard fixes es=2; earlier drafts allowed es to vary and the
paper additionally evaluates the non-standard posit⟨16,3⟩, so ``es`` stays a
parameter here.  Same registry and names as ``repro.core.formats``, with
torch dtypes in place of jnp ones.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass(frozen=True)
class PositFormat:
    """A posit⟨n,es⟩ format description.

    Bit patterns are carried in the smallest signed container
    (int8/int16/int32) with the n-bit pattern in the low bits.
    """

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
    def nar_pattern(self) -> int:
        return 1 << (self.n - 1)

    @property
    def maxpos_pattern(self) -> int:
        return (1 << (self.n - 1)) - 1

    @property
    def minpos_pattern(self) -> int:
        return 1

    @property
    def max_scale(self) -> int:
        """Scale (power of two) of maxpos: (n-2) * 2**es."""
        return (self.n - 2) << self.es

    @property
    def maxpos(self) -> float:
        return float(2.0 ** self.max_scale)

    @property
    def minpos(self) -> float:
        return float(2.0 ** (-self.max_scale))

    @property
    def storage_dtype(self) -> torch.dtype:
        if self.n <= 8:
            return torch.int8
        if self.n <= 16:
            return torch.int16
        return torch.int32


@dataclasses.dataclass(frozen=True)
class FloatFormat:
    """A narrow IEEE-like binary float format (the torch dtype it rounds to)."""

    name: str
    exp_bits: int
    man_bits: int
    dtype: torch.dtype
    has_inf: bool = True

    @property
    def n(self) -> int:
        return 1 + self.exp_bits + self.man_bits


POSIT8 = PositFormat(8, 2)
POSIT10 = PositFormat(10, 2)
POSIT12 = PositFormat(12, 2)
POSIT16 = PositFormat(16, 2)
POSIT16E3 = PositFormat(16, 3)
POSIT24 = PositFormat(24, 2)
POSIT32 = PositFormat(32, 2)

FP8E4M3 = FloatFormat("fp8e4m3", 4, 3, torch.float8_e4m3fn, has_inf=False)
FP8E5M2 = FloatFormat("fp8e5m2", 5, 2, torch.float8_e5m2)
FP16 = FloatFormat("fp16", 5, 10, torch.float16)
BF16 = FloatFormat("bfloat16", 8, 7, torch.bfloat16)
FP32 = FloatFormat("fp32", 8, 23, torch.float32)

POSIT_FORMATS: Dict[str, PositFormat] = {
    f.name: f
    for f in [POSIT8, POSIT10, POSIT12, POSIT16, POSIT16E3, POSIT24, POSIT32]
}
FLOAT_FORMATS: Dict[str, FloatFormat] = {
    f.name: f for f in [FP8E4M3, FP8E5M2, FP16, BF16, FP32]
}
ALL_FORMATS: Dict[str, object] = {**POSIT_FORMATS, **FLOAT_FORMATS}


def get_format(name: str):
    """Look up any registered format; also parses ``positN`` / ``positNeE``."""
    if name in ALL_FORMATS:
        return ALL_FORMATS[name]
    if name.startswith("posit"):
        body = name[len("posit"):]
        if "e" in body:
            n_s, es_s = body.split("e")
            return PositFormat(int(n_s), int(es_s))
        return PositFormat(int(body), 2)
    raise KeyError(f"unknown arithmetic format: {name!r}")
