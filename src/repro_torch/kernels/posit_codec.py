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

The decode kernel reads a posit of 16 bits or fewer through a table of the
values of its non-negative patterns (``posit_decode_table_torch`` is the
table's plain version), built on the card once per (card, format, output
type) by a kernel of its own and kept in ``_tables``; that build is not a
launch of the decode kernel and is not counted.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.core.formats import PositFormat
from repro_torch.core.posit import decode, encode

from . import build

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_BITS_DTYPES = (torch.int8, torch.int16, torch.int32)
_OUT_DTYPES = (torch.float32, torch.bfloat16)
_NEG_NAN = {torch.float32: -0x00400000, torch.bfloat16: -0x40}  # 0xFFC0...
_INT_VIEW = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
_lib = None
# (card index, n, es, output dtype) -> the decode table on that card
_tables: Dict[Tuple[int, int, int, torch.dtype], torch.Tensor] = {}


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("posit_codec")
        lib.posit_decode.argtypes = [_P, _P, _LL, _I, _I, _I, _I, _P, _I, _P]
        lib.posit_decode.restype = _I
        lib.posit_decode_table.argtypes = [_P, _I, _I, _I, _P]
        lib.posit_decode_table.restype = _I
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


def vector_plan(addr: int, n: int, size: int,
                per: int) -> Tuple[int, int, int]:
    """(head, n_vec, tail): how the decode and round kernels split ``n``
    elements of ``size`` bytes at byte address ``addr`` into vectors of
    ``per`` elements (``per * size`` bytes, a power of two up to 16) —
    ``head`` elements up to the first vector boundary, ``n_vec`` whole
    vectors, ``tail`` elements after them.  The decode takes ``per = 16 //
    max(pattern size, output size)``, the round ``16 // size``.  The plain
    mirror of ``csrc/posit_math.cuh::vec_plan``."""
    nbytes = per * size
    mis = addr % nbytes
    head = min(n, (nbytes - mis) // size if mis else 0)
    n_vec = (n - head) // per
    return head, n_vec, n - head - n_vec * per


def table_entries(fmt: PositFormat, out_dtype: torch.dtype) -> int:
    """Entries of the decode table in memory: 2^(n-1) values and NaR's,
    padded to whole 16 bytes (the kernel copies it in 16-byte chunks)."""
    per = 16 // torch.empty((), dtype=out_dtype).element_size()
    return -(-((1 << (fmt.n - 1)) + 1) // per) * per


def posit_decode_table_torch(fmt: PositFormat,
                             out_dtype: torch.dtype = torch.float32
                             ) -> torch.Tensor:
    """Plain version of the decode table kernel: entry i < 2^(n-1) holds
    the value of pattern i in ``out_dtype``, entry 2^(n-1) NaR's, a NaN
    with the sign bit set (0xFFC00000 in f32, 0xFFC0 in bf16), and zeros
    pad it to ``table_entries``.  For n <= 16."""
    if fmt.n > 16:
        raise ValueError(f"{fmt.name}: no decode table above 16 bits")
    half = 1 << (fmt.n - 1)
    vals = decode(torch.arange(half, dtype=torch.int32), fmt).to(out_dtype)
    idt = _INT_VIEW[out_dtype]
    table = torch.zeros(table_entries(fmt, out_dtype), dtype=idt)
    table[:half] = vals.view(idt)
    table[half] = _NEG_NAN[out_dtype]
    return table.view(out_dtype)


def decode_table(fmt: PositFormat, out_dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """The decode kernel's table of ``fmt`` on ``device``, built there by
    the table kernel at first use and cached."""
    key = (device.index, fmt.n, fmt.es, out_dtype)
    table = _tables.get(key)
    if table is None:
        table = torch.zeros(table_entries(fmt, out_dtype), dtype=out_dtype,
                            device=device)
        _raise_on(_kernels().posit_decode_table(
            table.data_ptr(), fmt.n, fmt.es,
            int(out_dtype == torch.bfloat16),
            torch.cuda.current_stream(device).cuda_stream),
            "posit_decode_table")
        _tables[key] = table
    return table


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
    if fmt.n > 8 * bits.element_size():
        raise ValueError(f"posit_decode: {fmt.name} patterns do not fit "
                         f"{bits.dtype}")
    out = torch.empty(bits.shape, dtype=out_dtype, device=bits.device)
    if bits.numel():
        table = (decode_table(fmt, out_dtype, bits.device) if fmt.n <= 16
                 else None)
        _raise_on(_kernels().posit_decode(
            bits.data_ptr(), out.data_ptr(), bits.numel(),
            bits.element_size(), int(out_dtype == torch.bfloat16), fmt.n,
            fmt.es, None if table is None else table.data_ptr(),
            0 if table is None else table.numel() * table.element_size(),
            torch.cuda.current_stream(bits.device).cuda_stream),
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
