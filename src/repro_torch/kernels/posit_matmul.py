"""Posit matrix products as CUDA kernels with plain torch versions.

* ``posit_matmul_round`` — ``round_fmt(A[M,K] · B[K,N])`` on float values:
  one wide accumulation per output, rounded once — the ``Arith.matmul``
  posit path.  Replaces ``repro/kernels/posit_matmul.py::
  posit_matmul_round_2d``.  The kernel keeps K whole inside one thread
  block per output tile and accumulates in the input's float type (f32 on
  the main path); its summation order differs from ``torch.matmul``'s, so
  kernel and plain version agree within one format ulp, not bitwise.
* ``posit_matmul`` — ``decode(A_bits[M,K]) · decode(B_bits[K,N])`` → f32,
  the posit bits read straight from device memory, each tile decoded to
  bf16 (the reference's compute dtype) and accumulated in f32.  Replaces
  ``posit_matmul`` (``ops.matmul``).  Its plain version is
  ``core.quire.quire_matmul_ref``; the two sum in other orders, so they
  agree to f32 accumulation error, not bitwise.

Both kernels are in ``csrc/posit_matmul.cu``.  A wrapper given CUDA
tensors launches its kernel or raises; given CPU tensors it runs the plain
version.  Each wrapper counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.formats import PositFormat
from repro_torch.core.posit import round_posit_math
from repro_torch.core.quire import quire_matmul_ref

from . import build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_lib = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("posit_matmul")
        for sfx in _SUFFIX.values():
            f = getattr(lib, f"posit_matmul_round_{sfx}")
            f.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _P]
            f.restype = _I
        lib.posit_matmul_decode.argtypes = [_P, _P, _P] + [_I] * 6 + [_P]
        lib.posit_matmul_decode.restype = _I
        _lib = lib
    return _lib


def posit_matmul_round_torch(a: torch.Tensor, b: torch.Tensor,
                             fmt: PositFormat) -> torch.Tensor:
    """Plain version (and the kernel's oracle): ``round(a @ b)``."""
    return round_posit_math(a @ b, fmt)


def posit_matmul_round(a: torch.Tensor, b: torch.Tensor,
                       fmt: PositFormat) -> torch.Tensor:
    """``round_fmt(a @ b)`` for 2-D ``a (M, K)`` and ``b (K, N)``."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return posit_matmul_round_torch(a, b, fmt)
    for t in (a, b):
        if not t.is_cuda:
            raise ValueError(f"posit_matmul_round: tensors must all be on "
                             f"the card (got {t.device})")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError("posit_matmul_round: 2-D contiguous operands")
    if a.dtype not in _SUFFIX or b.dtype != a.dtype:
        raise TypeError(f"posit_matmul_round: float32/float64 operands of "
                        f"one dtype, got {a.dtype} and {b.dtype}")
    (M, K), (K2, N) = a.shape, b.shape
    if K != K2:
        raise ValueError(f"posit_matmul_round: inner dims {K} != {K2}")
    if max(M, K, N) >= 2 ** 31:
        raise ValueError("posit_matmul_round: dims must fit int32")
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if M and N:
        fn = getattr(_kernels(), f"posit_matmul_round_{_SUFFIX[a.dtype]}")
        rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, K, N,
                fmt.n, fmt.es, torch.cuda.current_stream(a.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(
                f"posit_matmul_round: CUDA launch failed (cudaError {rc})")
        posit_matmul_round.launches += 1
    return out


posit_matmul_round.launches = 0


_BITS_DTYPES = (torch.int8, torch.int16, torch.int32)


def posit_matmul_torch(a_bits: torch.Tensor, b_bits: torch.Tensor,
                       fmt: PositFormat) -> torch.Tensor:
    """Plain version of the decode-fused product: decode, round to bf16,
    upcast (exact) and an f32 ``@``."""
    return quire_matmul_ref(a_bits, b_bits, fmt)


def posit_matmul(a_bits: torch.Tensor, b_bits: torch.Tensor,
                 fmt: PositFormat) -> torch.Tensor:
    """``decode(a_bits) · decode(b_bits)`` in f32 for 2-D posit patterns
    ``a_bits (M, K)`` and ``b_bits (K, N)`` of one integer container."""
    if a_bits.device.type == "cpu" and b_bits.device.type == "cpu":
        return posit_matmul_torch(a_bits, b_bits, fmt)
    for t in (a_bits, b_bits):
        if not t.is_cuda:
            raise ValueError(f"posit_matmul: tensors must all be on the card "
                             f"(got {t.device})")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError("posit_matmul: 2-D contiguous operands")
    if a_bits.dtype not in _BITS_DTYPES or b_bits.dtype != a_bits.dtype:
        raise TypeError(f"posit_matmul: int8/int16/int32 patterns of one "
                        f"dtype, got {a_bits.dtype} and {b_bits.dtype}")
    (M, K), (K2, N) = a_bits.shape, b_bits.shape
    if K != K2:
        raise ValueError(f"posit_matmul: inner dims {K} != {K2}")
    if max(M, K, N) >= 2 ** 31:
        raise ValueError("posit_matmul: dims must fit int32")
    out = torch.empty((M, N), dtype=torch.float32, device=a_bits.device)
    if M and N:
        rc = _kernels().posit_matmul_decode(
            a_bits.data_ptr(), b_bits.data_ptr(), out.data_ptr(), M, K, N,
            a_bits.element_size(), fmt.n, fmt.es,
            torch.cuda.current_stream(a_bits.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(
                f"posit_matmul: CUDA launch failed (cudaError {rc})")
        posit_matmul.launches += 1
    return out


posit_matmul.launches = 0
