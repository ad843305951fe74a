"""The posit codec as CUDA kernels, elementwise over any shape.

* ``posit_decode`` — int8/int16/int32 posit bits → f32 or bf16.  Replaces
  ``repro/kernels/posit_decode.py::posit_decode_2d``.
* ``posit_encode`` — f32 → posit bits in ``fmt.storage_dtype`` (RNE,
  saturating, NaN/±Inf → NaR, zero and subnormals → 0).  Replaces
  ``repro/kernels/posit_encode.py::posit_encode_2d``.
* ``posit_kv_append`` — the encode at the KV write: one layer's new K and
  V rows (bf16 or f32) encoded and written into that layer's posit cache
  in place, at the positions ``KVCache.append`` writes, in one launch.
  Replaces ``posit_encode_2d`` at the KV write, with the scatter around it.

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
_IN_DTYPES = (torch.float32, torch.bfloat16)
# posit_kv_append's modes (csrc/posit_codec.cu KvMode)
KV_PER_ROW_DECODE, KV_PER_ROW_PREFILL, KV_SCALAR_LENGTH = 0, 1, 2
_lib = None
_kv_append_fn = None    # the append's entry point, bound once
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
        lib.posit_kv_append.argtypes = [_P] * 5 + [_I] * 9 + [_P]
        lib.posit_kv_append.restype = _I
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


# ---------------------------------------------------------------------------
# The KV write
# ---------------------------------------------------------------------------

def kv_mode(s_new: int, length: torch.Tensor) -> int:
    """Where ``KVCache.append`` writes ``s_new`` positions: per-row
    lengths with one position are a decode (row b at ``length[b]``), with
    more a prefill (the block at 0); a scalar length writes the block at
    ``clamp(length, 0, cap - s_new)``."""
    if length.dim() == 1:
        return KV_PER_ROW_DECODE if s_new == 1 else KV_PER_ROW_PREFILL
    return KV_SCALAR_LENGTH


def kv_scatter(raw: torch.Tensor, enc: torch.Tensor,
               length: torch.Tensor) -> None:
    """Write ``enc`` (B, S_new, KV, D) into the cache storage ``raw`` (B,
    cap, KV, D) in place, at the positions of ``kv_mode``; a per-row decode
    writes nothing in a row whose length is outside [0, cap), as the
    reference's scatter drops it.  The bf16 cache's write, and the scatter
    of ``posit_kv_append``'s plain version."""
    s_new, cap = enc.shape[1], raw.shape[1]
    mode = kv_mode(s_new, length)
    if mode == KV_PER_ROW_DECODE:
        rows = torch.arange(raw.shape[0], device=raw.device)
        idx = torch.clamp(length, 0, cap - 1).long()
        keep = (length >= 0) & (length < cap)
        old = raw[rows, idx]
        raw[rows, idx] = torch.where(keep[:, None, None], enc[:, 0], old)
    elif s_new > cap:
        raise ValueError(f"KVCache.append: {s_new} positions exceed the "
                         f"capacity {cap}")
    elif mode == KV_PER_ROW_PREFILL:
        raw[:, :s_new] = enc
    else:
        start = torch.clamp(length, 0, cap - s_new)
        idx = start + torch.arange(s_new, device=raw.device)
        raw.index_copy_(1, idx.long(), enc)


def posit_kv_append_torch(k_new: torch.Tensor, v_new: torch.Tensor,
                          k_bits: torch.Tensor, v_bits: torch.Tensor,
                          length: torch.Tensor, fmt: PositFormat) -> None:
    """Plain version of the KV-append kernel: encode each of K and V, then
    scatter it (``kv_scatter``)."""
    for new, bits in ((k_new, k_bits), (v_new, v_bits)):
        kv_scatter(bits, posit_encode_torch(new, fmt), length)


def _check_kv_append(k_new, v_new, k_bits, v_bits, length,
                     fmt: PositFormat) -> None:
    ts = (k_new, v_new, k_bits, v_bits, length)
    if not all(t.is_cuda and t.device == k_new.device for t in ts):
        raise ValueError(f"posit_kv_append: tensors must all be on one card "
                         f"(got {[str(t.device) for t in ts]})")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("posit_kv_append: tensors must be contiguous")
    if k_new.dtype not in _IN_DTYPES or v_new.dtype != k_new.dtype:
        raise TypeError(f"posit_kv_append: K/V rows of one dtype in "
                        f"{_IN_DTYPES}, got {k_new.dtype} and {v_new.dtype}")
    if k_bits.dtype != fmt.storage_dtype or v_bits.dtype != k_bits.dtype:
        raise TypeError(f"posit_kv_append: {fmt.name} bits are "
                        f"{fmt.storage_dtype}, got {k_bits.dtype} and "
                        f"{v_bits.dtype}")
    if length.dtype != torch.int32:
        raise TypeError(f"posit_kv_append: int32 lengths, got "
                        f"{length.dtype}")
    if k_new.dim() != 4 or v_new.shape != k_new.shape or \
            v_bits.shape != k_bits.shape or k_bits.dim() != 4 or \
            k_bits.shape[0] != k_new.shape[0] or \
            k_bits.shape[2:] != k_new.shape[2:]:
        raise ValueError(f"posit_kv_append: K/V rows (B, S_new, KV, D) and "
                         f"storage (B, cap, KV, D), got {tuple(k_new.shape)}"
                         f", {tuple(v_new.shape)}, {tuple(k_bits.shape)}, "
                         f"{tuple(v_bits.shape)}")
    if length.shape not in ((), (k_new.shape[0],)):
        raise ValueError(f"posit_kv_append: a scalar or ({k_new.shape[0]},)"
                         f" length, got {tuple(length.shape)}")
    if k_bits.numel() >= 2 ** 31 or k_new.numel() >= 2 ** 31:
        raise ValueError("posit_kv_append: sizes must fit int32")
    if fmt.max_scale > 126:
        raise ValueError(f"posit_kv_append: {fmt.name} has minpos/maxpos "
                         f"outside the normal f32 range")


def posit_kv_append(k_new: torch.Tensor, v_new: torch.Tensor,
                    k_bits: torch.Tensor, v_bits: torch.Tensor,
                    length: torch.Tensor, fmt: PositFormat) -> None:
    """Encode one layer's new K and V rows, ``k_new``/``v_new`` (B, S_new,
    KV, D) bf16 or f32, into its posit storage ``k_bits``/``v_bits`` (B,
    cap, KV, D) in ``fmt.storage_dtype``, in place, at the positions that
    ``kv_mode`` reads from the int32 ``length`` (a scalar or (B,)), which
    stays on the card.  One launch for K, V and every row."""
    if k_new.device.type == "cpu":
        return posit_kv_append_torch(k_new, v_new, k_bits, v_bits, length,
                                     fmt)
    _check_kv_append(k_new, v_new, k_bits, v_bits, length, fmt)
    B, s_new = k_new.shape[:2]
    cap = k_bits.shape[1]
    mode = kv_mode(s_new, length)
    if mode != KV_PER_ROW_DECODE and s_new > cap:
        raise ValueError(f"KVCache.append: {s_new} positions exceed the "
                         f"capacity {cap}")
    if not k_new.numel():
        return
    global _kv_append_fn
    if _kv_append_fn is None:
        _kv_append_fn = _kernels().posit_kv_append
    rc = _kv_append_fn(
        k_new.data_ptr(), v_new.data_ptr(), k_bits.data_ptr(),
        v_bits.data_ptr(), length.data_ptr(),
        int(k_new.dtype == torch.bfloat16), k_bits.element_size(), B, s_new,
        cap, k_new.shape[2] * k_new.shape[3], mode, fmt.n, fmt.es,
        torch._C._cuda_getCurrentRawStream(k_new.get_device()))
    if rc:
        _raise_on(rc, "posit_kv_append")
    posit_kv_append.launches += 1


posit_kv_append.launches = 0
