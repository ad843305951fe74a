"""Format-parametrized arithmetic: every op computes wide, then rounds.

The counterpart of ``repro.core.arith``, for every registered format: the
posits, the narrow IEEE formats (fp16, bf16, fp8e5m2, fp8e4m3) and exact
fp32.  Three switches select how the rounded ops are realized:

* ``set_round_backend`` — how a posit rounding is computed: ``"kernel"``
  (the CUDA kernels of ``repro_torch.kernels``; a CPU tensor takes each
  kernel's plain version), ``"torch"`` (the direct float-bit rounding in
  torch ops), or ``"codec"`` (the encode∘decode oracle).  ``"auto"``
  resolves per tensor: ``kernel`` for CUDA tensors, ``torch`` for CPU ones.
* ``set_fused_kernels`` — fused one-launch-per-stage hot paths (the FFT
  stage loop, the matmul kernel route) or the retained per-op oracles.
  Fused and unfused paths are bit-identical.
* ``set_quire`` (or ``REPRO_QUIRE=on`` in the environment, read at import
  as the reference reads it) — posit reductions (``dot``/``sum``/
  ``cumsum``/``matmul``/``fdot2`` and the FFT twiddle joins) accumulate
  exactly through ``core.quire``'s compensated sums and round once, instead
  of rounding a wide device sum.  It changes posit accumulation bits (that
  is its point); off by default.

IEEE formats have no quire: their reductions round after every add, in a
fixed sequential order (``_ieee_accumulate``), so they are bitwise the
reference's on any device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Union

import torch

from repro_torch.kernels.posit_matmul import (posit_matmul_round,
                                              round_matmul_sum)
from repro_torch.kernels.posit_round import posit_fma_round, posit_round

from .floatsim import round_to_float
from .formats import FloatFormat, PositFormat, get_format
from .posit import round_to_posit, round_to_posit_codec
from .quire import (comp_cumsum, comp_dot, comp_sum, product_eft_needed,
                    two_prod, two_sum)

_ROUND_BACKENDS = ("auto", "torch", "kernel", "codec")
_round_backend = "auto"
_FUSED_MODES = ("auto", "on", "off")
_fused_kernels = "auto"
_QUIRE_MODES = ("auto", "on", "off")
_quire = os.environ.get("REPRO_QUIRE", "auto")


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
    """Select quire-exact posit accumulation ("on") vs wide-sum ("off");
    "auto" is off."""
    if name not in _QUIRE_MODES:
        raise ValueError(f"quire mode {name!r} not in {_QUIRE_MODES}")
    global _quire
    _quire = name


def get_quire() -> bool:
    return _quire == "on"


def fusion_cache_key() -> tuple:
    """Key for caches of per-format callables, so an A/B toggle of any
    switch builds a fresh callable."""
    return (_round_backend, get_fused_kernels(), get_quire())


@contextlib.contextmanager
def backend_overrides(fused: str = None, round_backend: str = None,
                      quire: str = None):
    """Temporarily select backend realizations; restores on every exit."""
    prev_fused, prev_rb, prev_q = _fused_kernels, _round_backend, _quire
    try:
        if fused is not None:
            set_fused_kernels(fused)
        if round_backend is not None:
            set_round_backend(round_backend)
        if quire is not None:
            set_quire(quire)
        yield
    finally:
        set_fused_kernels(prev_fused)
        set_round_backend(prev_rb)
        set_quire(prev_q)


def round_posit(x: torch.Tensor, fmt: PositFormat) -> torch.Tensor:
    """Nearest posit values of ``x`` (f32 or f64) as the round backend
    selects: ``Arith.rnd``'s and ``core.quant.fake_quant``'s one dispatch
    (B1's kernel for a CUDA tensor under ``auto``)."""
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
        return isinstance(self.fmt, FloatFormat) and self.fmt.name == "fp32"

    @property
    def quire(self) -> bool:
        """Quire-exact accumulation is live for this context (posits only:
        IEEE formats have no quire, fp32 reductions are the wide
        reference)."""
        return self.is_posit and get_quire()

    def _product_eft(self, dtype: torch.dtype) -> bool:
        return product_eft_needed(self.fmt, dtype)

    # -- rounding ------------------------------------------------------------
    def rnd(self, x) -> torch.Tensor:
        x = _t(x)
        if self.exact and x.dtype == torch.float32:
            return x
        if self.is_posit:
            return round_posit(x, self.fmt)
        return round_to_float(x, self.fmt)

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

    def fma(self, a, b, c):
        """``rnd(a·b + c)``, one rounding of the product and sum computed
        separately in the operands' float type (the reference's bits).  A
        posit context under the kernel backend makes it one
        ``posit_fma_round`` launch."""
        a, b, c = _t(a), _t(b), _t(c)
        on = next((t for t in (a, b, c) if t.is_cuda), a)
        if self.is_posit and get_round_backend(on) == "kernel":
            return posit_fma_round(a, b, c, self.fmt)
        return self.rnd(a * b + c)

    def fdot2(self, a, b, c, d):
        """``rnd(a·b + c·d)`` — the FFT twiddle-join primitive.  Quire mode
        accumulates the two products exactly (``two_sum``, with
        ``two_prod`` where a product outruns the accumulator) and rounds
        once; otherwise three rounded ops (mul, mul, add)."""
        a, b, c, d = (_t(v) for v in (a, b, c, d))
        if self.quire:
            if self._product_eft(torch.promote_types(
                    torch.result_type(a, b), torch.result_type(c, d))):
                p1, e1 = two_prod(a, b)
                p2, e2 = two_prod(c, d)
                s, e = two_sum(p1, p2)
                return self.rnd(s + (e + (e1 + e2)))
            s, e = two_sum(a * b, c * d)
            return self.rnd(s + e)
        return self.add(self.mul(a, b), self.mul(c, d))

    # -- transcendental: libm computes wide, the result is stored in format --
    def exp(self, a):
        return self.rnd(torch.exp(_t(a)))

    def log(self, a):
        return self.rnd(torch.log(_t(a)))

    def sin(self, a):
        return self.rnd(torch.sin(_t(a)))

    def cos(self, a):
        return self.rnd(torch.cos(_t(a)))

    def tanh(self, a):
        return self.rnd(torch.tanh(_t(a)))

    # -- reductions ----------------------------------------------------------
    #
    # IEEE formats round after every partial add, along axis 0 in order.
    # The reference realizes that chain two ways with identical bits (an
    # unrolled chain for K ≤ 64 when fused, a per-step scan otherwise); in
    # eager torch both are this one Python loop of elementwise rounded ops.

    def _ieee_accumulate(self, moved: torch.Tensor, keep_prefixes: bool):
        """Rounded sequential accumulation over axis 0 of ``moved``: the
        final accumulator, or every prefix when ``keep_prefixes``."""
        acc = torch.zeros(moved.shape[1:], dtype=moved.dtype,
                          device=moved.device)
        outs = []
        for k in range(moved.shape[0]):
            acc = self.rnd(acc + moved[k])
            outs.append(acc)
        if keep_prefixes:
            return torch.stack(outs) if outs else torch.zeros_like(moved)
        return acc

    @staticmethod
    def _flatten_if_axis_none(a, axis):
        """``axis=None`` reductions ravel first on every path, so all arms
        reduce the same element order."""
        if axis is None:
            return a.reshape(-1), -1
        return a, axis

    def dot(self, a, b, axis=-1):
        """Posits and fp32: one rounding of a wide accumulation (exact
        under quire mode); IEEE: a rounded product and a rounded add per
        MAC, in order."""
        a, b = _t(a), _t(b)
        if self.quire:
            s, c = comp_dot(a, b, axis=axis, product_eft=self._product_eft(
                torch.result_type(a, b)))
            return self.rnd(s + c)
        if self.is_posit or self.exact:
            prod, axis = self._flatten_if_axis_none(a * b, axis)
            return self.rnd(torch.sum(prod, dim=axis))
        prod, axis = self._flatten_if_axis_none(self.rnd(a * b), axis)
        return self._ieee_accumulate(torch.movedim(prod, axis, 0), False)

    def sum(self, a, axis=-1):
        a, axis = self._flatten_if_axis_none(_t(a), axis)
        if self.quire:
            s, c = comp_sum(a, axis=axis)
            return self.rnd(s + c)
        if self.is_posit or self.exact:
            return self.rnd(torch.sum(a, dim=axis))
        return self._ieee_accumulate(torch.movedim(a, axis, 0), False)

    def cumsum(self, a, axis=-1):
        """Rounded prefix sums: posits round each wide prefix once (exact
        per prefix under quire mode); IEEE rounds after every add."""
        a, axis = self._flatten_if_axis_none(_t(a), axis)
        if self.quire:
            s, c = comp_cumsum(a, axis=axis)
            return self.rnd(s + c)
        if self.is_posit or self.exact:
            return self.rnd(torch.cumsum(a, dim=axis))
        out = self._ieee_accumulate(torch.movedim(a, axis, 0), True)
        return torch.movedim(out, 0, axis)

    def mean(self, a, axis=-1):
        a = _t(a)
        cnt = a.shape[axis] if axis is not None else a.numel()
        return self.div(self.sum(a, axis=axis), float(cnt))

    def matmul(self, a, b):
        """Rounded matrix product ``a (..., K) · b (K, N) → (..., N)``.

        * posit: one wide product per output, rounded once — under the
          kernel backend one ``posit_matmul_round`` launch, otherwise
          summed in that kernel's order, so a row's bits never depend on
          how many rows the batch has; under quire mode an exact
          compensated K-accumulation per output instead.
        * IEEE: a rounded product and a rounded add per MAC, sequentially
          along K.
        * fp32: the plain device matmul.
        """
        a, b = _t(a), _t(b)
        K, N = b.shape
        batch = a.shape[:-1]
        if self.is_posit or self.exact:
            a2 = a.reshape(-1, K)
            if self.quire:
                s, c = comp_dot(a2[:, :, None], b[None, :, :], axis=1,
                                product_eft=self._product_eft(
                                    torch.result_type(a2, b)))
                return self.rnd(s + c).reshape(*batch, N)
            if (self.is_posit and get_round_backend(a2) == "kernel"
                    and get_fused_kernels()):
                out = posit_matmul_round(a2.contiguous(), b.contiguous(),
                                         self.fmt)
                return out.reshape(*batch, N)
            if self.is_posit:
                # the kernel's sum order: a row's bits do not depend on M
                return self.rnd(round_matmul_sum(a2, b).reshape(*batch, N))
            return self.rnd((a2 @ b).reshape(*batch, N))
        prod = self.rnd(a[..., :, None] * b)            # (..., K, N)
        return self._ieee_accumulate(torch.movedim(prod, -2, 0), False)
