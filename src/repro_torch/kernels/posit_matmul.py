"""Posit matrix products as CUDA kernels with plain torch versions.

* ``posit_matmul_round`` — ``round_fmt(A[M,K] · B[K,N])`` on float values:
  one wide accumulation per output, rounded once — the ``Arith.matmul``
  posit path.  Replaces ``repro/kernels/posit_matmul.py::
  posit_matmul_round_2d``.  The kernel's schedule, chosen by
  ``round_matmul_plan``: a block of 256 threads owns a tm × tn output tile
  (32 outputs) over one split of K; each thread accumulates every 256th k
  of the split in the input's float type (f32 on the main path), the
  threads' partials are added in a fixed tree (warp shuffles, then the
  eight warps in order) and the sum is rounded once; where one row
  block's output tiles alone would leave SMs idle, K is split across
  blocks and a second kernel adds the splits in order and rounds.  No
  atomics: the same bits every run.  The split is a function of K and N
  alone, so an output's sum order, and its bits, do not depend on M: a
  slab of rows gives the bits of the same rows of the whole batch.  The
  plain version sums in the kernel's order (``round_matmul_sum``), so the
  two agree bitwise.
* ``posit_matmul`` — ``decode(A_bits[M,K]) · decode(B_bits[K,N])`` → f32,
  the posit bits read straight from device memory, each tile decoded to
  bf16 (the reference's compute dtype) and accumulated in f32.  Replaces
  ``posit_matmul`` (``ops.matmul``).  The kernel's schedule, chosen by
  ``matmul_plan``: persistent blocks walk work units, each a 64 × BN
  output tile (BN = 64, 128 or 256) over a contiguous range of 64-deep K
  slabs; a block stages the slab after next's bits with ``cp.async``,
  decodes the current slab (for a posit of up to 16 bits, where it pays,
  through a table of all 2^n bf16 values) into swizzled bf16 tiles in
  shared memory and multiplies them on the tensor cores (``wgmma``),
  adding each slab's f32 product into an f32 register accumulator.  When
  the output tiles alone would leave SMs idle, K is split across work
  units, each split writes an f32 partial tile to scratch and a second
  kernel adds the splits in a fixed order.  Its plain version is
  ``core.quire.quire_matmul_ref``; the two sum in other orders, so they
  agree to f32 accumulation error, not bitwise.

Both kernels are in ``csrc/posit_matmul.cu``.  A wrapper given CUDA
tensors launches its kernel or raises; given CPU tensors it runs the plain
version.  Each wrapper counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
import functools
import itertools
from typing import Tuple

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
            f.argtypes = [_P] * 4 + [_I] * 8 + [_P]
            f.restype = _I
        lib.posit_matmul_decode.argtypes = [_P] * 4 + [_I] * 11 + [_P]
        lib.posit_matmul_decode.restype = _I
        _lib = lib
    return _lib


# The rounded matmul's geometry (csrc/posit_matmul.cu).
ROUND_THREADS = 256     # threads of a block, each on every 256th k
ROUND_ACC = 32          # outputs of a block's tile: tm x tn
_MAX_ROUND_SPLITS = 16
# the blocks a split aims at: the H100 SXM's 132 SMs, fixed, so that the
# plan, and with it every output's bits, is the same on any card and in
# the plain version on the CPU
ROUND_SPLIT_BLOCKS = 132
_PLAIN_ELEMS = 1 << 22  # partials the plain version holds at once


@functools.lru_cache(maxsize=1024)
def round_matmul_plan(K: int, N: int) -> Tuple[int, int, int, int]:
    """(tm, tn, splits, per) for the rounded matmul.

    A block owns a tm × tn output tile (tn = 8, 4, 2 or 1, the least power
    of two at or above N up to 8, and tm = 32 / tn, so each of a warp's
    lanes ends up with one output of the tile) over K's split ``s``,
    [s·per, min((s + 1)·per, K)); ``per`` is a multiple of the block's 256
    threads.  K is split across blocks until one row block's tiles times
    the splits fill ``ROUND_SPLIT_BLOCKS``, at most 16 ways and never
    below one k per thread, so no split is empty.  M takes no part: the
    sum order of every output is a function of K and N alone."""
    tn = min(8, 1 << max(0, N - 1).bit_length())
    tm = ROUND_ACC // tn
    tiles = -(-N // tn)
    chunks = max(1, -(-K // ROUND_THREADS))
    want = max(1, min(-(-ROUND_SPLIT_BLOCKS // tiles), chunks,
                      _MAX_ROUND_SPLITS))
    per = -(-chunks // want) * ROUND_THREADS
    return tm, tn, max(1, -(-K // per)), per


def round_matmul_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` summed in the rounded matmul kernel's order, unrounded:
    thread t of split s adds the products of k = s·per + t + 256·i in
    order; each warp's 32 partials are added pairwise (lane ^ 16, 8, 4, 2,
    1, here as halvings: float addition commutes); the eight warps' sums
    are added in order, then the splits in order.  Rows are summed in
    slabs of at most ``_PLAIN_ELEMS`` partials, which changes no bit."""
    (M, K), N = a.shape, b.shape[1]
    _, _, splits, per = round_matmul_plan(K, N)
    T = ROUND_THREADS
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    step = max(1, _PLAIN_ELEMS // (T * max(N, 1)))
    for r0 in range(0, M, step):
        rows = a[r0:r0 + step]
        total = None
        for s in range(splits):
            end = min(K, (s + 1) * per)
            acc = torch.zeros((T, rows.shape[0], N), dtype=a.dtype,
                              device=a.device)
            for k0 in range(s * per, end, T):
                n = min(T, end - k0)
                acc[:n] += rows[:, k0:k0 + n].T[:, :, None] \
                    * b[k0:k0 + n][:, None, :]
            x = acc.view(T // 32, 32, rows.shape[0], N)
            for h in (16, 8, 4, 2, 1):
                x = x[:, :h] + x[:, h:2 * h]
            part = x[0, 0]
            for w in range(1, T // 32):
                part = part + x[w, 0]
            total = part if total is None else total + part
        out[r0:r0 + step] = total
    return out


def posit_matmul_round_torch(a: torch.Tensor, b: torch.Tensor,
                             fmt: PositFormat) -> torch.Tensor:
    """Plain version (and the kernel's oracle): ``round(a @ b)``, summed
    in the kernel's order."""
    return round_posit_math(round_matmul_sum(a, b), fmt)


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
        tm, tn, splits, per = round_matmul_plan(K, N)
        if -(-M // tm) * -(-N // tn) >= 2 ** 31:
            raise ValueError("posit_matmul_round: too many output tiles")
        part = (torch.empty((splits, M, N), dtype=a.dtype, device=a.device)
                if splits > 1 else None)
        fn = getattr(_kernels(), f"posit_matmul_round_{_SUFFIX[a.dtype]}")
        rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                part.data_ptr() if part is not None else None, M, K, N, tn,
                splits, per, fmt.n, fmt.es,
                torch.cuda.current_stream(a.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(
                f"posit_matmul_round: CUDA launch failed (cudaError {rc})")
        posit_matmul_round.launches += 1
    return out


posit_matmul_round.launches = 0


_BITS_DTYPES = (torch.int8, torch.int16, torch.int32)

# The decode-fused kernel's geometry (csrc/posit_matmul.cu) and the H100's
# limits the plan fits it to.
_BM, _BK = 64, 64                  # output rows per block, slab depth
_TABLE_BITS = 16                   # posits up to 16 bits decode by table
_BLOCK_SMEM = 232448               # dynamic shared memory one block may use
_SM_SMEM = 233472                  # an SM's shared memory (1 KB per block)
_SM_THREADS, _SM_REGS = 2048, 65536
_THREADS, _REGS_PER_THREAD = 512, 128   # a block; __launch_bounds__ caps
# The plan's cost model, estimates for one SM of the H100: ~3e9 posit
# decodes a second by arithmetic (some 30 integer operations each at 64
# integer lanes x 1.755 GHz), ~9e9 by table (one 2-byte shared-memory
# load, ~3.5-way bank conflicts on random patterns); the split partials
# cost their bytes at 3.35 TB/s and the combine launch a few microseconds.
_DECODES_PER_SM_S = 3e9
_LOOKUPS_PER_SM_S = 9e9
_HBM_BYTES_S = 3.35e12
_COMBINE_S = 3e-6
_MAX_SPLITS = 16


def _wgmma_smem(bn: int, bits_size: int, nbits: int, table: bool) -> int:
    """Dynamic shared memory of one block (``wgmma_smem_bytes`` in
    csrc/posit_matmul.cu): the alignment pad, the swizzled bf16 tiles, two
    stages of raw bits and, when used, the bf16 table."""
    return 1024 + 2 * (_BM + bn) * 128 \
        + 2 * (_BM * _BK + _BK * bn) * bits_size + (2 << nbits if table else 0)


@functools.lru_cache(maxsize=1024)
def matmul_plan(M: int, N: int, K: int, bits_size: int, nbits: int,
                sms: int) -> Tuple[int, int, int, int, bool]:
    """(bn, splits, slabs_per_split, grid, table) for the decode-fused
    kernel.

    The kernel's time is the decoding: a work unit (a 64 × bn output tile
    over one split of the 64-deep K slabs) decodes 64 × (64 + bn) values
    per slab, and ``grid`` persistent blocks, as many as fit on the SMs,
    share the units, so each SM runs ``ceil(units / sms)`` of them.  A
    posit of up to 16 bits may decode by a table of its 2^n bf16 values
    that each block builds once (``table``).  Among the widths that fit
    shared memory, with and without the table, and the K splits that leave
    no split empty, the plan takes the least estimated time (the table's
    build, the decoding, plus the partials' bytes and the combine launch
        when K is split), the fewer splits, the wider tile and then the table
    on a tie.  A wide ``bn`` decodes the A panel once per ``bn`` columns;
    splitting K fills the card when the output tiles are few (M = 64
    rows)."""
    slabs = max(1, -(-K // _BK))
    m_tiles = -(-M // _BM)
    best = None
    for bn, table in itertools.product((256, 128, 64), (True, False)):
        if table and nbits > _TABLE_BITS:
            continue
        smem = _wgmma_smem(bn, bits_size, nbits, table)
        if smem > _BLOCK_SMEM:
            continue
        rate = _LOOKUPS_PER_SM_S if table else _DECODES_PER_SM_S
        per_sm = min(_SM_SMEM // (smem + 1024), _SM_THREADS // _THREADS,
                     _SM_REGS // (_THREADS * _REGS_PER_THREAD))
        tiles = m_tiles * -(-N // bn)
        for per in range(slabs, 0, -1):
            splits = -(-slabs // per)
            if splits > _MAX_SPLITS:
                break
            if per > 1 and -(-slabs // (per - 1)) == splits:
                continue        # the same splits, more evenly cut below
            units = tiles * splits
            grid = min(units, sms * per_sm)
            t = -(-units // sms) * per * _BM * (_BM + bn) / rate
            if table:
                t += -(-grid // sms) * 2 ** nbits / _DECODES_PER_SM_S
            if splits > 1:
                t += (2 * splits + 1) * M * N * 4 / _HBM_BYTES_S + _COMBINE_S
            key = (t, splits, -bn, not table)
            if best is None or key < best[0]:
                best = (key, (bn, splits, per, grid, table))
    if best is None:
        raise ValueError(f"posit_matmul: no tile fits shared memory for "
                         f"{bits_size}-byte patterns")
    return best[1]



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
        bn, splits, per, grid, table = matmul_plan(
            M, N, K, a_bits.element_size(), fmt.n,
            build.sm_count(a_bits.device.index))
        part = (torch.empty((splits, M, N), dtype=torch.float32,
                            device=a_bits.device) if splits > 1 else None)
        rc = _kernels().posit_matmul_decode(
            a_bits.data_ptr(), b_bits.data_ptr(), out.data_ptr(),
            part.data_ptr() if part is not None else None, M, K, N,
            a_bits.element_size(), fmt.n, fmt.es, bn, splits, per, grid,
            int(table), torch.cuda.current_stream(a_bits.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(
                f"posit_matmul: CUDA launch failed (cudaError {rc})")
        posit_matmul.launches += 1
    return out


posit_matmul.launches = 0
