"""Rounded matrix product ``round_fmt(A[M,K] · B[K,N])``: one wide
accumulation per output, rounded once — the ``Arith.matmul`` posit path.

Replaces ``repro/kernels/posit_matmul.py::posit_matmul_round_2d``.  The
CUDA kernel (``csrc/posit_matmul.cu``) keeps K whole inside one thread
block per output tile and accumulates in the input's float type (f32 on
the main path); its summation order differs from ``torch.matmul``'s, so
kernel and plain version agree within one format ulp, not bitwise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.formats import PositFormat
from repro_torch.core.posit import round_posit_math

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
