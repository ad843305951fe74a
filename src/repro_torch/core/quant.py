"""Posit tensor quantization — the counterpart of ``repro.core.quant``.

``PositTensor`` carries the narrow bit patterns (the memory/bandwidth side
of the energy argument); ``dequant`` is the PRAU-decode analogue executed
at compute time, through the codec kernel's wrapper (``posit_decode``: the
CUDA kernel for a tensor on the card, its plain version on the CPU).
``quantize_params`` encodes a whole parameter tree through ``posit_encode``
with the reference's leaf rules.  ``fake_quant`` rounds onto a posit
lattice with a straight-through gradient; the narrow IEEE formats wait for
a later slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels.posit_codec import posit_decode, posit_encode

from .arith import _DEFERRED
from .formats import PositFormat, get_format
from .posit import round_to_posit


@dataclasses.dataclass
class PositTensor:
    """A tensor stored as posit bit patterns (+ optional scale)."""

    bits: torch.Tensor
    fmt: PositFormat
    scale: Optional[torch.Tensor] = None  # value = decode(bits) * scale

    def dequant(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        if self.scale is None:
            # the kernel rounds its f32 value to bf16 in the register:
            # the same bits as decoding to f32 and casting
            if dtype in (torch.float32, torch.bfloat16):
                return posit_decode(self.bits.contiguous(), self.fmt, dtype)
            return posit_decode(self.bits.contiguous(), self.fmt).to(dtype)
        v = posit_decode(self.bits.contiguous(), self.fmt).to(dtype)
        return v * self.scale.to(dtype)

    def __getitem__(self, idx) -> "PositTensor":
        """Index the bits (e.g. one layer of a stacked tree); a scalar
        scale is shared."""
        scale = self.scale
        if scale is not None and scale.dim() > 0:
            scale = scale[idx]
        return PositTensor(self.bits[idx], self.fmt, scale)


def quantize(x: torch.Tensor, fmt: PositFormat, scaled: bool = False,
             axis: Optional[int] = None) -> PositTensor:
    """Quantize a float tensor to posit patterns.

    ``scaled=True`` divides by the RMS (per tensor, or per ``axis`` slice)
    before encoding, snapped to a power of two so dequantization is exact.
    """
    x = x.to(torch.float32)
    if not scaled:
        return PositTensor(posit_encode(x.contiguous(), fmt), fmt, None)
    if axis is None:
        rms = torch.sqrt(torch.mean(torch.square(x)) + 1e-30)
    else:
        rms = torch.sqrt(torch.mean(torch.square(x), dim=axis, keepdim=True)
                         + 1e-30)
    scale = torch.exp2(torch.round(torch.log2(rms)))
    return PositTensor(posit_encode((x / scale).contiguous(), fmt), fmt,
                       scale)


def dequantize(t: PositTensor, dtype: torch.dtype = torch.float32
               ) -> torch.Tensor:
    return t.dequant(dtype)


# ---------------------------------------------------------------------------
# Straight-through fake quantization
# ---------------------------------------------------------------------------

class _FakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fmt):
        return round_to_posit(x, fmt, dtype=x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


def fake_quant(x: torch.Tensor, fmt_name: str) -> torch.Tensor:
    """Round onto the format lattice; gradient passes straight through."""
    fmt = get_format(fmt_name)
    if not isinstance(fmt, PositFormat):
        raise NotImplementedError(f"fake_quant({fmt_name!r}): {_DEFERRED}")
    return _FakeQuant.apply(x, fmt)


# ---------------------------------------------------------------------------
# Whole-tree weight quantization (serving path)
# ---------------------------------------------------------------------------

_WEIGHT_LEAVES = {"w", "table", "w_h"}
_MOE_WEIGHTS = {"w_gate", "w_up", "w_down"}


def quantize_params(params, fmt: PositFormat, cast_rest=None):
    """Quantize genuine weight matrices to posit bits; leave everything else
    (norm gains, biases, scalars) in float — the paper's setup, where data
    memory goes narrow but reference/control stays wide.  ``params`` is a
    tree of nested dicts; a leaf's path names decide, as in the reference:
    ``w``/``table``/``w_h`` leaves (and MoE expert weights) of two or more
    dimensions become ``PositTensor``; with ``cast_rest``, every other f32
    leaf is cast to it."""
    def visit(names, x):
        if isinstance(x, dict):
            return {k: visit(names + [str(k)], v) for k, v in x.items()}
        leaf = names[-1] if names else ""
        is_weight = (leaf in _WEIGHT_LEAVES
                     or ("moe" in names and leaf in _MOE_WEIGHTS))
        if (is_weight and x.dim() >= 2
                and x.dtype in (torch.float32, torch.bfloat16)):
            return quantize(x, fmt, scaled=False)
        if cast_rest is not None and x.dtype == torch.float32:
            return x.to(cast_rest)
        return x

    return visit([], params)
