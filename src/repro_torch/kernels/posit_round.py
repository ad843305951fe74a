"""Posit rounding on the float datapath: the elementwise round, the rounded
multiply-add and the rounded radix-2 FFT butterfly, as CUDA kernels with
plain torch versions.

* ``posit_round``     — x → nearest posit(x), f32 or f64, any shape.
  Replaces ``repro/kernels/posit_round.py::posit_round_2d``.
* ``posit_fma_round`` — round(a·b + c) with the product and the sum each
  computed in the float type and one posit rounding at the end, operands
  broadcast.  Replaces ``posit_fma_round_2d``.
* ``posit_butterfly`` — the radix-2 DIT butterfly with all ten ops rounded:
  t = w ⊗ o (4 mul + 2 add), u = e + t, v = e − t, over whole planes.
  Replaces ``posit_butterfly_2d`` stage by stage; the FFT path runs a
  range of stages in one launch instead (``kernels/posit_fft.py``).

A wrapper given CUDA tensors launches its kernel (``csrc/posit_round.cu``)
or raises; given CPU tensors it runs the plain version beside it.  Each
wrapper counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Callable, Dict, Tuple

import torch

from repro_torch.core.formats import PositFormat
from repro_torch.core.posit import round_posit_math

from . import build

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_SCALAR = {torch.float32: ctypes.c_float, torch.float64: ctypes.c_double}
_lib = None
# the round's and the multiply-add's entry points by dtype, bound once with
# the library
_round_fns: Dict[torch.dtype, Callable[..., int]] = {}
_fma_fns: Dict[torch.dtype, Callable[..., int]] = {}


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("posit_round")
        for dtype, sfx in _SUFFIX.items():
            f = getattr(lib, f"posit_round_{sfx}")
            f.argtypes = [_P, _P, _LL, _I, _I, _P]
            f.restype = _I
            _round_fns[dtype] = f
            f = getattr(lib, f"posit_fma_round_{sfx}")
            f.argtypes = ([_P] * 3 + [_SCALAR[dtype]] * 3
                          + [_P, _LL, ctypes.POINTER(_LL), _I, _I, _P])
            f.restype = _I
            _fma_fns[dtype] = f
            f = getattr(lib, f"posit_butterfly_{sfx}")
            f.argtypes = [_P] * 10 + [_LL, _LL, _LL, _I, _I, _P]
            f.restype = _I
        lib.posit_empty_launch.argtypes = [_P]
        lib.posit_empty_launch.restype = _I
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
    """Nearest posit values of ``x`` (f32 or f64), same shape and dtype.

    The most launched wrapper of the stream path (the 2-means rounds
    scalars and short rows), so its host path is kept short: one test of
    device, dtype and contiguity (``_check_cuda`` says which failed), the
    entry point bound once, and the current stream read as a raw handle
    (``torch.cuda.current_stream`` builds a ``Stream`` object each call)."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return posit_round_torch(x, fmt)
        _check_cuda("posit_round", x)
    if x.dtype not in _SUFFIX or not x.is_contiguous():
        _check_cuda("posit_round", x)
    out = torch.empty_like(x)
    n = x.numel()
    if n:
        fn = _round_fns.get(x.dtype)
        if fn is None:
            _kernels()
            fn = _round_fns[x.dtype]
        rc = fn(x.data_ptr(), out.data_ptr(), n, fmt.n, fmt.es,
                torch._C._cuda_getCurrentRawStream(x.get_device()))
        if rc:
            _raise_on(rc, "posit_round")
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


def fma_geometry(shape: Tuple[int, ...], strides: Tuple[Tuple[int, ...], ...]
                 ) -> Tuple[Tuple[int, ...], Tuple[Tuple[int, ...], ...]]:
    """The broadcast path's geometry: ``shape`` and each operand's element
    strides over it with the size-1 dimensions dropped and each pair of
    adjacent dimensions merged where every operand's outer stride is its
    inner stride times the inner size (a broadcast axis beside another
    merges: 0 = 0 · size).  Maps every output index to the same offsets."""
    dims = []
    for d, size in enumerate(shape):
        if size == 1:
            continue
        st = [s[d] for s in strides]
        if dims and all(o == i * size for o, i in zip(dims[-1][1], st)):
            dims[-1] = (dims[-1][0] * size, st)
        else:
            dims.append((size, st))
    return (tuple(size for size, _ in dims),
            tuple(tuple(st[k] for _, st in dims)
                  for k in range(len(strides))))


def scalar_value(t: torch.Tensor, dtype: torch.dtype) -> float:
    """A host 0-d operand's value after promotion to the output ``dtype``:
    the multiply-add kernel's by-value argument (exact in its C type)."""
    return (t.to(dtype) if t.dtype != dtype else t).item()


def _broadcast_geometry(ops):
    """(output shape, the kernel's geometry array) of the broadcast path
    for the operands ``ops``, None where one goes by value: the shapes
    broadcast as ``torch.broadcast_shapes`` does (whose error a mismatch
    raises), each operand's strides as ``expand``'s, then merged."""
    full = [t for t in ops if t is not None]
    nd = max(t.dim() for t in full)
    shape = [1] * nd
    for t in full:
        for d, size in enumerate(t.shape, nd - t.dim()):
            if size != 1 and shape[d] != size:
                if shape[d] != 1:
                    torch.broadcast_shapes(*(t.shape for t in full))
                shape[d] = size
    strides = []
    for t in ops:
        st = [0] * nd
        if t is not None:
            for d, size, s in zip(range(nd - t.dim(), nd), t.shape,
                                  t.stride()):
                if size == shape[d]:
                    st[d] = s
        strides.append(tuple(st))
    dims, strides = fma_geometry(tuple(shape), tuple(strides))
    if len(dims) > _MAX_DIMS:
        raise ValueError(f"posit_fma_round: at most {_MAX_DIMS} dims after "
                         f"merging, got {len(dims)}")
    pad = [0] * (_MAX_DIMS - len(dims))
    g = [len(dims), *dims, *pad]
    for st in strides:
        g += [*st, *pad]
    return torch.Size(shape), (_LL * len(g))(*g)


def posit_fma_round(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                    fmt: PositFormat) -> torch.Tensor:
    """``round(a·b + c)`` over the broadcast of the three operands (f32 or
    f64, promoted to one dtype).  A 0-d operand on the CPU counts as a
    scalar and goes to the kernel by value."""
    if not (a.is_cuda or b.is_cuda or c.is_cuda):
        return posit_fma_round_torch(a, b, c, fmt)
    dtype = a.dtype
    if b.dtype != dtype or c.dtype != dtype:
        dtype = torch.promote_types(torch.result_type(a, b), c.dtype)
    fn = _fma_fns.get(dtype)
    if fn is None:
        if dtype not in _SUFFIX:
            raise TypeError(f"posit_fma_round: float32/float64 only, got "
                            f"{dtype}")
        _kernels()
        fn = _fma_fns[dtype]
    ops, vals, full = [], [], []
    for t in (a, b, c):
        if t.dim() == 0 and not t.is_cuda:
            ops.append(None)            # by value: never copied to the card
            vals.append(scalar_value(t, dtype))
            continue
        if not t.is_cuda:
            raise ValueError(f"posit_fma_round: tensors must all be on the "
                             f"card (got {t.device})")
        if t.dtype != dtype:
            t = t.to(dtype)
        ops.append(t)
        vals.append(0.0)
        full.append(t)
    first = full[0]
    if all(t.shape == first.shape and t.is_contiguous() for t in full):
        out, geom = torch.empty_like(first), None
    else:
        shape, geom = _broadcast_geometry(ops)
        out = torch.empty(shape, dtype=dtype, device=first.device)
    n = out.numel()
    if not n:
        return out
    rc = fn(*(None if t is None else t.data_ptr() for t in ops), *vals,
            out.data_ptr(), n, geom, fmt.n, fmt.es,
            torch._C._cuda_getCurrentRawStream(first.get_device()))
    if rc:
        _raise_on(rc, "posit_fma_round")
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
