"""The posit codec as CUDA kernels, elementwise over any shape.

* ``posit_decode`` — int8/int16/int32 posit bits → f32 or bf16.  Replaces
  ``repro/kernels/posit_decode.py::posit_decode_2d``.
* ``posit_encode`` — f32 → posit bits in ``fmt.storage_dtype`` (RNE,
  saturating, NaN/±Inf → NaR, zero and subnormals → 0).  Replaces
  ``repro/kernels/posit_encode.py::posit_encode_2d``.

A wrapper given a CUDA tensor launches its kernel (``csrc/posit_codec.cu``)
or raises; given a CPU tensor it runs the plain version beside it, which is
``repro_torch.core.posit``'s codec.  Each wrapper counts its launches in
``<wrapper>.launches``.  Both are bitwise equal to their plain versions.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.formats import PositFormat
from repro_torch.core.posit import decode, encode

from . import build

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_BITS_DTYPES = (torch.int8, torch.int16, torch.int32)
_OUT_DTYPES = (torch.float32, torch.bfloat16)
_lib = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("posit_codec")
        lib.posit_decode.argtypes = [_P, _P, _LL, _I, _I, _I, _I, _P]
        lib.posit_decode.restype = _I
        lib.posit_encode.argtypes = [_P, _P, _LL, _I, _I, _I, _P]
        lib.posit_encode.restype = _I
        _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, dtypes) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name}: tensor must be on the card (got "
                         f"{t.device})")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")


def posit_decode_torch(bits: torch.Tensor, fmt: PositFormat,
                       out_dtype: torch.dtype = torch.float32
                       ) -> torch.Tensor:
    """Plain version of the decode kernel: ``decode(f32).to(out_dtype)``."""
    return decode(bits, fmt, torch.float32).to(out_dtype)


def posit_decode(bits: torch.Tensor, fmt: PositFormat,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Values of the posit patterns ``bits`` (any shape), f32 or bf16."""
    if bits.device.type == "cpu":
        return posit_decode_torch(bits, fmt, out_dtype)
    _check("posit_decode", bits, _BITS_DTYPES)
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"posit_decode: out_dtype {out_dtype} not in "
                        f"{_OUT_DTYPES}")
    out = torch.empty(bits.shape, dtype=out_dtype, device=bits.device)
    if bits.numel():
        _raise_on(_kernels().posit_decode(
            bits.data_ptr(), out.data_ptr(), bits.numel(),
            bits.element_size(), int(out_dtype == torch.bfloat16), fmt.n,
            fmt.es, torch.cuda.current_stream(bits.device).cuda_stream),
            "posit_decode")
        posit_decode.launches += 1
    return out


posit_decode.launches = 0


def posit_encode_torch(x: torch.Tensor, fmt: PositFormat) -> torch.Tensor:
    """Plain version of the encode kernel."""
    return encode(x.to(torch.float32), fmt)


def posit_encode(x: torch.Tensor, fmt: PositFormat) -> torch.Tensor:
    """Posit patterns of the f32 values ``x`` (any shape), in
    ``fmt.storage_dtype``."""
    if x.device.type == "cpu":
        return posit_encode_torch(x, fmt)
    _check("posit_encode", x, (torch.float32,))
    if fmt.max_scale > 126:
        raise ValueError(f"posit_encode: {fmt.name} has minpos/maxpos "
                         f"outside the normal f32 range")
    out = torch.empty(x.shape, dtype=fmt.storage_dtype, device=x.device)
    if x.numel():
        _raise_on(_kernels().posit_encode(
            x.data_ptr(), out.data_ptr(), x.numel(), out.element_size(),
            fmt.n, fmt.es, torch.cuda.current_stream(x.device).cuda_stream),
            "posit_encode")
        posit_encode.launches += 1
    return out


posit_encode.launches = 0
