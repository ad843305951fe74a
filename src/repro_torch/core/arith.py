"""Format-parametrized arithmetic: every op computes wide, then rounds.

The counterpart of ``repro.core.arith`` for posit formats and exact fp32.
Two switches select how the rounded ops are realized:

* ``set_round_backend`` — how a posit rounding is computed: ``"kernel"``
  (the CUDA kernels of ``repro_torch.kernels``; a CPU tensor takes each
  kernel's plain version), ``"torch"`` (the direct float-bit rounding in
  torch ops), or ``"codec"`` (the encode∘decode oracle).  ``"auto"``
  resolves per tensor: ``kernel`` for CUDA tensors, ``torch`` for CPU ones.
* ``set_fused_kernels`` — fused one-launch-per-stage hot paths (the FFT
  stage loop, the matmul kernel route) or the retained per-op oracles.
  Fused and unfused paths are bit-identical.

Not in this slice: the narrow IEEE formats (fp16, bf16, fp8 — their
sequential rounded reductions) and quire mode.  Both raise
``NotImplementedError`` instead of running another arithmetic; ROADMAP.md
queue A lists them.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Union

import torch

from repro_torch.kernels.posit_matmul import posit_matmul_round
from repro_torch.kernels.posit_round import posit_round

from .formats import FloatFormat, PositFormat, get_format
from .posit import round_to_posit, round_to_posit_codec

_ROUND_BACKENDS = ("auto", "torch", "kernel", "codec")
_round_backend = "auto"
_FUSED_MODES = ("auto", "on", "off")
_fused_kernels = "auto"

_DEFERRED = ("not ported yet: the narrow IEEE formats and quire mode come "
             "in a later slice of the port (ROADMAP.md, queue A item 1)")


def set_round_backend(name: str) -> None:
    """Select how posit rounding is realized (see module docstring)."""
    if name not in _ROUND_BACKENDS:
        raise ValueError(f"round backend {name!r} not in {_ROUND_BACKENDS}")
    global _round_backend
    _round_backend = name


def get_round_backend(x: torch.Tensor = None) -> str:
    """The backend that rounds ``x``: ``auto`` resolves to ``kernel`` for
    a CUDA tensor and to ``torch`` otherwise."""
    if _round_backend != "auto":
        return _round_backend
    return "kernel" if x is not None and x.is_cuda else "torch"


def set_fused_kernels(name: str) -> None:
    """Select fused ("on") vs oracle ("off") hot-path realizations."""
    if name not in _FUSED_MODES:
        raise ValueError(f"fused mode {name!r} not in {_FUSED_MODES}")
    global _fused_kernels
    _fused_kernels = name


def get_fused_kernels() -> bool:
    return _fused_kernels != "off"


def set_quire(name: str) -> None:
    """Quire mode is deferred; only "off"/"auto" (its default) are taken."""
    if name not in ("auto", "off"):
        raise NotImplementedError(f"quire mode {name!r}: {_DEFERRED}")


def fusion_cache_key() -> tuple:
    """Key for caches of per-format callables, so an A/B toggle of either
    switch builds a fresh callable."""
    return (_round_backend, get_fused_kernels())


@contextlib.contextmanager
def backend_overrides(fused: str = None, round_backend: str = None):
    """Temporarily select backend realizations; restores on every exit."""
    prev_fused, prev_rb = _fused_kernels, _round_backend
    try:
        if fused is not None:
            set_fused_kernels(fused)
        if round_backend is not None:
            set_round_backend(round_backend)
        yield
    finally:
        set_fused_kernels(prev_fused)
        set_round_backend(prev_rb)


def _round_posit_dispatch(x: torch.Tensor, fmt: PositFormat) -> torch.Tensor:
    backend = get_round_backend(x)
    if backend == "kernel":
        return posit_round(x.contiguous(), fmt)
    if backend == "codec":
        return round_to_posit_codec(x, fmt, dtype=x.dtype)
    return round_to_posit(x, fmt, dtype=x.dtype)


def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        x, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class Arith:
    """A rounded arithmetic context for a given storage format."""

    fmt: Union[PositFormat, FloatFormat]

    def __post_init__(self) -> None:
        if isinstance(self.fmt, FloatFormat) and self.fmt.name != "fp32":
            raise NotImplementedError(f"format {self.fmt.name!r}: {_DEFERRED}")

    @staticmethod
    def make(name: str) -> "Arith":
        return Arith(get_format(name))

    @property
    def name(self) -> str:
        return self.fmt.name

    @property
    def is_posit(self) -> bool:
        return isinstance(self.fmt, PositFormat)

    @property
    def exact(self) -> bool:
        return not self.is_posit

    # -- rounding ------------------------------------------------------------
    def rnd(self, x) -> torch.Tensor:
        x = _t(x)
        if self.exact:
            return x if x.dtype == torch.float32 else x.float().to(x.dtype)
        return _round_posit_dispatch(x, self.fmt)

    # -- elementary ops (each correctly rounded to the format) ----------------
    def add(self, a, b):
        return self.rnd(a + b)

    def sub(self, a, b):
        return self.rnd(a - b)

    def mul(self, a, b):
        return self.rnd(a * b)

    def div(self, a, b):
        return self.rnd(a / b)

    def sqrt(self, a):
        return self.rnd(torch.sqrt(_t(a)))

    def fdot2(self, a, b, c, d):
        """``rnd(a·b + c·d)`` as three rounded ops (mul, mul, add)."""
        return self.add(self.mul(a, b), self.mul(c, d))

    # -- transcendental: libm computes wide, the result is stored in format --
    def exp(self, a):
        return self.rnd(torch.exp(_t(a)))

    def log(self, a):
        return self.rnd(torch.log(_t(a)))

    # -- reductions: ONE rounding of a wide device sum ------------------------
    @staticmethod
    def _flatten_if_axis_none(a, axis):
        if axis is None:
            return a.reshape(-1), -1
        return a, axis

    def dot(self, a, b, axis=-1):
        prod, axis = self._flatten_if_axis_none(_t(a) * _t(b), axis)
        return self.rnd(torch.sum(prod, dim=axis))

    def sum(self, a, axis=-1):
        a, axis = self._flatten_if_axis_none(_t(a), axis)
        return self.rnd(torch.sum(a, dim=axis))

    def cumsum(self, a, axis=-1):
        a, axis = self._flatten_if_axis_none(_t(a), axis)
        return self.rnd(torch.cumsum(a, dim=axis))

    def mean(self, a, axis=-1):
        a = _t(a)
        cnt = a.shape[axis] if axis is not None else a.numel()
        return self.div(self.sum(a, axis=axis), float(cnt))

    def matmul(self, a, b):
        """Rounded matrix product ``a (..., K) · b (K, N) → (..., N)``: one
        wide product per output, rounded once.  Under the kernel backend the
        product and its rounding are one ``posit_matmul_round`` launch."""
        a, b = _t(a), _t(b)
        K, N = b.shape
        batch = a.shape[:-1]
        a2 = a.reshape(-1, K)
        if (self.is_posit and get_round_backend(a2) == "kernel"
                and get_fused_kernels()):
            out = posit_matmul_round(a2.contiguous(), b.contiguous(),
                                     self.fmt)
            return out.reshape(*batch, N)
        return self.rnd((a2 @ b).reshape(*batch, N))
