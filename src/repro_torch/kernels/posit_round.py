"""Posit rounding on the float datapath: the elementwise round, the rounded
multiply-add and the rounded radix-2 FFT butterfly, as CUDA kernels with
plain torch versions.

* ``posit_round``     — x → nearest posit(x), f32 or f64, any shape.
  Replaces ``repro/kernels/posit_round.py::posit_round_2d``.
* ``posit_fma_round`` — round(a·b + c) with the product and the sum each
  computed in the float type and one posit rounding at the end, operands
  broadcast.  Replaces ``posit_fma_round_2d``.
* ``posit_butterfly`` — the radix-2 DIT butterfly with all ten ops rounded:
  t = w ⊗ o (4 mul + 2 add), u = e + t, v = e − t.  One launch per FFT
  stage over the whole plane.  Replaces ``posit_butterfly_2d``.

A wrapper given CUDA tensors launches its kernel (``csrc/posit_round.cu``)
or raises; given CPU tensors it runs the plain version beside it.  Each
wrapper counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from repro_torch.core.formats import PositFormat
from repro_torch.core.posit import round_posit_math

from . import build

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_lib = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("posit_round")
        for sfx in _SUFFIX.values():
            f = getattr(lib, f"posit_round_{sfx}")
            f.argtypes = [_P, _P, _LL, _I, _I, _P]
            f.restype = _I
            f = getattr(lib, f"posit_fma_round_{sfx}")
            f.argtypes = [_P] * 4 + [_LL, ctypes.POINTER(_LL), _I, _I, _P]
            f.restype = _I
            f = getattr(lib, f"posit_butterfly_{sfx}")
            f.argtypes = [_P] * 10 + [_LL, _LL, _LL, _I, _I, _P]
            f.restype = _I
        _lib = lib
    return _lib


def _check_cuda(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if not t.is_cuda:
            raise ValueError(f"{name}: tensors must all be on the card "
                             f"(got {t.device})")
        if t.dtype not in _SUFFIX:
            raise TypeError(f"{name}: float32/float64 only, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if len({(t.dtype, t.device) for t in ts}) != 1:
        raise ValueError(f"{name}: mixed dtypes or devices")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")


# ---------------------------------------------------------------------------
# Elementwise round
# ---------------------------------------------------------------------------

def posit_round_torch(x: torch.Tensor, fmt: PositFormat) -> torch.Tensor:
    """Plain version of the round kernel."""
    return round_posit_math(x, fmt)


def posit_round(x: torch.Tensor, fmt: PositFormat) -> torch.Tensor:
    """Nearest posit values of ``x`` (f32 or f64), same shape and dtype."""
    if x.device.type == "cpu":
        return posit_round_torch(x, fmt)
    _check_cuda("posit_round", x)
    out = torch.empty_like(x)
    if x.numel():
        fn = getattr(_kernels(), f"posit_round_{_SUFFIX[x.dtype]}")
        _raise_on(fn(x.data_ptr(), out.data_ptr(), x.numel(), fmt.n, fmt.es,
                     torch.cuda.current_stream(x.device).cuda_stream),
                  "posit_round")
        posit_round.launches += 1
    return out


posit_round.launches = 0


# ---------------------------------------------------------------------------
# Rounded multiply-add
# ---------------------------------------------------------------------------

_MAX_DIMS = 8                   # csrc/posit_round.cu kMaxDims


def posit_fma_round_torch(a, b, c, fmt: PositFormat) -> torch.Tensor:
    """Plain version of the multiply-add kernel: the product and the sum
    are two separate float ops (eager torch never contracts them)."""
    return round_posit_math(a * b + c, fmt)


def posit_fma_round(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                    fmt: PositFormat) -> torch.Tensor:
    """``round(a·b + c)`` over the broadcast of the three operands (f32 or
    f64, promoted to one dtype).  A 0-d operand on the CPU counts as a
    scalar and joins the others on the card."""
    ops = (a, b, c)
    if all(t.device.type == "cpu" for t in ops):
        return posit_fma_round_torch(a, b, c, fmt)
    dev = next(t.device for t in ops if t.is_cuda)
    dtype = torch.promote_types(torch.result_type(a, b), c.dtype)
    ops = tuple(t.to(device=dev, dtype=dtype) if t.dim() == 0 else
                t.to(dtype) for t in ops)
    for t in ops:
        if not t.is_cuda:
            raise ValueError(f"posit_fma_round: tensors must all be on the "
                             f"card (got {t.device})")
    if dtype not in _SUFFIX:
        raise TypeError(f"posit_fma_round: float32/float64 only, got {dtype}")
    shape = torch.broadcast_shapes(*(t.shape for t in ops))
    if len(shape) > _MAX_DIMS:
        raise ValueError(f"posit_fma_round: at most {_MAX_DIMS} dims")
    out = torch.empty(shape, dtype=dtype, device=dev)
    n = out.numel()
    if n:
        flat = all(t.shape == shape and t.is_contiguous() for t in ops)
        views = [t.expand(shape) for t in ops]
        pad = [0] * (_MAX_DIMS - len(shape))
        geom = [0 if flat else len(shape), *shape, *pad]
        for v in views:
            geom += [*v.stride(), *pad]
        fn = getattr(_kernels(), f"posit_fma_round_{_SUFFIX[dtype]}")
        _raise_on(fn(*(v.data_ptr() for v in views), out.data_ptr(), n,
                     (_LL * len(geom))(*geom), fmt.n, fmt.es,
                     torch.cuda.current_stream(dev).cuda_stream),
                  "posit_fma_round")
        posit_fma_round.launches += 1
    return out


posit_fma_round.launches = 0


# ---------------------------------------------------------------------------
# Rounded butterfly
# ---------------------------------------------------------------------------

def posit_butterfly_torch(e_re, e_im, o_re, o_im, w_re, w_im,
                          fmt: PositFormat):
    """Plain version of the butterfly kernel (operands broadcast)."""
    def rnd(v):
        return round_posit_math(v, fmt)

    t_re = rnd(rnd(w_re * o_re) - rnd(w_im * o_im))
    t_im = rnd(rnd(w_re * o_im) + rnd(w_im * o_re))
    return (rnd(e_re + t_re), rnd(e_im + t_im),
            rnd(e_re - t_re), rnd(e_im - t_im))


def twiddle_layout(w: torch.Tensor, shape: Tuple[int, ...]
                   ) -> Tuple[int, int]:
    """How the kernel reads a twiddle broadcast against ``shape``: element
    ``i`` of the plane uses ``w[(i // inner) % length]``.  The twiddle may
    vary along one axis only (the stage's L axis), which is how both
    Stockham layouts broadcast it; anything else raises."""
    ws = (1,) * (len(shape) - w.dim()) + tuple(w.shape)
    if len(ws) != len(shape):
        raise ValueError(f"twiddle {tuple(w.shape)} does not broadcast to "
                         f"{tuple(shape)}")
    axes = [d for d, s in enumerate(ws) if s != 1]
    if not axes:
        return 1, 1
    if len(axes) > 1 or ws[axes[0]] != shape[axes[0]]:
        raise ValueError(f"twiddle {tuple(w.shape)} must vary along one "
                         f"axis of {tuple(shape)}")
    d = axes[0]
    return math.prod(shape[d + 1:]), shape[d]


def posit_butterfly(e_re, e_im, o_re, o_im, w_re, w_im, fmt: PositFormat):
    """Rounded butterfly over whole planes: returns (u_re, u_im, v_re, v_im).

    ``e_*``/``o_*`` share one shape; the twiddles broadcast against it along
    one axis and are read through ``twiddle_layout`` (never expanded)."""
    planes = (e_re, e_im, o_re, o_im)
    if all(t.device.type == "cpu" for t in (*planes, w_re, w_im)):
        return posit_butterfly_torch(*planes, w_re, w_im, fmt)
    _check_cuda("posit_butterfly", *planes, w_re, w_im)
    shape = e_re.shape
    if any(t.shape != shape for t in planes):
        raise ValueError("posit_butterfly: e/o planes must share one shape")
    layout = twiddle_layout(w_re, shape)
    if twiddle_layout(w_im, shape) != layout or w_re.shape != w_im.shape:
        raise ValueError("posit_butterfly: w_re and w_im differ in layout")
    outs = tuple(torch.empty_like(e_re) for _ in range(4))
    n = e_re.numel()
    if n:
        fn = getattr(_kernels(), f"posit_butterfly_{_SUFFIX[e_re.dtype]}")
        _raise_on(fn(*(t.data_ptr() for t in (*planes, w_re, w_im, *outs)),
                     n, *layout, fmt.n, fmt.es,
                     torch.cuda.current_stream(e_re.device).cuda_stream),
                  "posit_butterfly")
        posit_butterfly.launches += 1
    return outs


posit_butterfly.launches = 0
