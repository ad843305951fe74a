"""A range of rounded radix-2 FFT stages in one launch, as a CUDA kernel
with a plain torch version.

* ``posit_fft_stages`` — stages ``s0 .. s1-1`` of the stacked Stockham
  stage loop (``apps/dsp.py``), every butterfly's ten ops rounded to the
  posit format, one launch per pass of ``fft_pass_plan``.  Replaces
  ``repro/kernels/posit_round.py::posit_butterfly_2d`` on the FFT path,
  where the TPU kernel runs one launch per stage.

The state entering stage ``s`` is ``(L, R)`` with ``L = 2^s`` and ``R = n
>> s``, held "transposed" (``l·R + r``) while ``R/2 ≥ MIN_RUN`` and
"natural" (``r·L + l``) after that.  Stage ``s`` pairs ``(l, r)`` with
``(l, r + R/2)``, reads twiddle ``w_s[l]`` and writes ``u`` to ``(l, r)``
and ``v`` to ``(l + L, r)`` of the ``(2L, R/2)`` state.  Over ``k``
stages from ``s0`` an output therefore depends only on the inputs with
its ``l`` mod ``L0`` and its ``r`` mod ``R0 >> k``: the state splits into
``n >> k`` independent groups of ``2^k`` complex values, which the
kernel's blocks run in shared memory (``csrc/posit_fft.cu``).  Inside a
group the butterflies are the same rounded ops in the same order as the
stage loop's, so the outputs are the same bits.

A wrapper given CUDA tensors launches its kernel or raises; given CPU
tensors it runs the plain version, which is the stage loop itself.  It
counts its launches in ``posit_fft_stages.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.core.formats import PositFormat
from repro_torch.core.posit import round_posit_math

from . import build
from .posit_round import _SUFFIX, _check_cuda, _raise_on

# The Stockham loop's one transposed → natural switch: when a stage's split
# runs (R/2) would drop below this many elements.
MIN_RUN = 64
# Shared memory a block takes without opting in to more: a group's two
# buffers (two planes each) must fit it.
SMEM_BUDGET = 48 * 1024
MAX_THREADS = 256          # threads a block; a thread loops past them
MIN_THREADS = 64           # small groups are packed until a block has these
CARD_SMS = 132             # an H100 SXM's SMs: the blocks a pass should fill

_P, _I = ctypes.c_void_p, ctypes.c_int
_lib = None
_fns: Dict[torch.dtype, Callable[..., int]] = {}


class FFTPass(NamedTuple):
    """One launch: stages ``s0 .. s1-1`` on groups of ``group`` values."""
    s0: int
    s1: int
    group: int              # 2^(s1 - s0) complex values a group
    groups_per_block: int
    threads: int
    shared_bytes: int       # two buffers of two planes of every group
    blocks: int


def _pass(n: int, s0: int, s1: int, batch: int, size: int) -> FFTPass:
    k = s1 - s0
    group = 1 << k
    total = batch * (n >> k)
    g = max(1, MIN_THREADS >> (k - 1))
    while g > 1 and g // 2 >= total:
        g //= 2
    return FFTPass(s0, s1, group, g, min(g * group // 2, MAX_THREADS),
                   4 * size * g * group, -(-total // g))


@functools.lru_cache(maxsize=None)
def fft_pass_plan(n: int, s0: int, s1: int, batch: int, dtype: torch.dtype,
                  sms: int = CARD_SMS) -> Tuple[FFTPass, ...]:
    """How ``posit_fft_stages`` cuts stages ``[s0, s1)`` of ``batch``
    FFTs of length ``n`` into launches: the fewest passes whose groups'
    double buffers fit ``SMEM_BUDGET``, cut further only while a pass
    would have fewer than ``sms`` blocks (then the cut with the most
    blocks in its smallest pass, the fewest passes among equals).  The
    stages are shared out as evenly as the cut allows, the longer passes
    first."""
    stages = s1 - s0
    if stages <= 0:
        return ()
    size = torch.empty((), dtype=dtype).element_size()
    k_max = (SMEM_BUDGET // (4 * size)).bit_length() - 1
    best, best_blocks = None, -1
    for count in range(-(-stages // k_max), stages + 1):
        q, extra = divmod(stages, count)
        passes, s = [], s0
        for i in range(count):
            k = q + (i < extra)
            passes.append(_pass(n, s, s + k, batch, size))
            s += k
        blocks = min(p.blocks for p in passes)
        if blocks >= sms:
            return tuple(passes)
        if blocks > best_blocks:
            best, best_blocks = tuple(passes), blocks
    return best


def transposed_after(n: int, s0: int, s1: int, transposed: bool) -> bool:
    """Whether the stage loop holds the state transposed after stages
    ``s0 .. s1-1``, entering them in ``transposed``."""
    return transposed and (s1 <= s0 or (n >> (s1 - 1)) // 2 >= MIN_RUN)


def pass_index_map(n: int, p: FFTPass, batch: int, tr_in: bool,
                   tr_out: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(inputs, outputs): each an int64 ``(batch · n / group, group)``
    tensor of flat indices into one ``(batch, n)`` plane — the elements a
    group of pass ``p`` reads, member ``j`` being ``(l0, rr + j·Rk)`` of
    the entering state, and the elements it writes, member ``i`` being
    ``(l0 + i·L0, rr)`` of the state after the pass.  Groups are in the
    kernel's order: along ``rr`` first where the input is transposed,
    along ``l0`` first where it is natural (each block's loads contiguous).
    The plain mirror of ``csrc/posit_fft.cu``'s index arithmetic."""
    k = (p.group).bit_length() - 1
    L0, R0 = 1 << p.s0, n >> p.s0
    Rk, L1 = R0 >> k, L0 << k
    gl = torch.arange(n >> k)
    if tr_in:
        l0, rr = gl // Rk, gl % Rk
    else:
        l0, rr = gl % L0, gl // L0
    j = torch.arange(p.group)
    r = rr[:, None] + j[None, :] * Rk
    ins = l0[:, None] * R0 + r if tr_in else r * L0 + l0[:, None]
    l = l0[:, None] + j[None, :] * L0
    outs = l * Rk + rr[:, None] if tr_out else rr[:, None] * L1 + l
    base = (torch.arange(batch) * n)[:, None, None]
    return ((base + ins).reshape(-1, p.group),
            (base + outs).reshape(-1, p.group))


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("posit_fft")
        for dtype, sfx in _SUFFIX.items():
            f = getattr(lib, f"posit_fft_stages_{sfx}")
            f.argtypes = [_P] * 3 + [_I] * 12 + [_P]
            f.restype = _I
            _fns[dtype] = f
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# Plain version: the stacked stage loop
# ---------------------------------------------------------------------------

def stockham_stage(z: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor,
                   R: int, tr: bool, rnd) -> torch.Tensor:
    """One stage of the stacked loop on ``z (2, ..., L, R)`` (transposed)
    or ``(2, ..., R, L)`` (natural): three rounded calls, the same
    elementary rounded ops in the same order as the butterfly kernel."""
    nb = z.dim() - 3                       # batch dims between stack and L/R
    if tr:
        e, o = z[..., : R // 2], z[..., R // 2:]
    else:
        e, o = z[..., : R // 2, :], z[..., R // 2:, :]
    # [wr·o_re, wi·o_im] = [wr, wi]⊙o and [wi·o_re, wr·o_im] =
    # [wi, wr]⊙o, so P = [P0, P1, P3, P2] (f32 addition commutes bitwise)
    shp = (2, *([1] * nb), -1, 1) if tr else (2, *([1] * nb), 1, -1)
    w2 = torch.stack([wr, wi]).reshape(shp)
    w2f = torch.stack([wi, wr]).reshape(shp)
    P = rnd(torch.cat([w2 * o, w2f * o], dim=0))
    t = rnd(torch.stack([P[0] - P[1], P[3] + P[2]]))
    return rnd(torch.cat([e + t, e - t], dim=-2 if tr else -1))


def stage_twiddles(twiddles: torch.Tensor, s: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage ``s``'s ``(wr, wi)`` in the table of every stage's."""
    w = twiddles[:, (1 << s) - 1:(2 << s) - 1]
    return w[0], w[1]


def posit_fft_stages_torch(z: torch.Tensor, twiddles: torch.Tensor, s0: int,
                           s1: int, fmt: PositFormat, rnd=None
                           ) -> Tuple[torch.Tensor, bool]:
    """Plain version of ``posit_fft_stages``: the stacked stage loop, every
    value rounded by ``rnd`` (``round_posit_math`` to ``fmt`` if None)."""
    n = twiddles.shape[-1] + 1
    tr = True
    if rnd is None:
        def rnd(v):
            return round_posit_math(v, fmt)
    for s in range(s0, s1):
        R = n >> s
        if tr and R // 2 < MIN_RUN:
            z = z.transpose(-1, -2)
            tr = False
        z = stockham_stage(z, *stage_twiddles(twiddles, s), R, tr, rnd)
    return z.contiguous(), tr


# ---------------------------------------------------------------------------
# The kernel's wrapper
# ---------------------------------------------------------------------------

def _state_shape(batch: Tuple[int, ...], n: int, s: int, tr: bool):
    L, R = 1 << s, n >> s
    return (2, *batch, L, R) if tr else (2, *batch, R, L)


def posit_fft_stages(z: torch.Tensor, twiddles: torch.Tensor, s0: int,
                     s1: int, fmt: PositFormat) -> Tuple[torch.Tensor, bool]:
    """Stages ``s0 .. s1-1`` of the stacked FFT stage loop: returns the
    state after stage ``s1 - 1`` and whether it is transposed, contiguous
    in the layout the loop holds it then.

    ``z`` is the state entering stage ``s0`` in the transposed layout,
    ``(2, batch..., L, R)``, contiguous, f32 or f64 (both callers enter
    their range so: ``fft_format`` at stage 0, ``_rfft_fused`` after its
    two transposed real stages); ``twiddles`` is ``(2, n - 1)``, every
    stage's rounded ``(wr, wi)`` in stage order (``FFTPlan.table``).  At
    most 2^31 - 1 elements."""
    if z.device.type == "cpu" and twiddles.device.type == "cpu":
        return posit_fft_stages_torch(z, twiddles, s0, s1, fmt)
    _check_cuda("posit_fft_stages", z, twiddles)
    n = twiddles.shape[-1] + 1
    batch = tuple(z.shape[1:-2])
    if (n & (n - 1) or twiddles.dim() != 2 or twiddles.shape[0] != 2
            or not 0 <= s0 <= s1 <= n.bit_length() - 1
            or tuple(z.shape) != _state_shape(batch, n, s0, True)):
        raise ValueError(f"posit_fft_stages: state {tuple(z.shape)} with "
                         f"twiddles {tuple(twiddles.shape)} is not the "
                         f"transposed state entering stage {s0} of {s1}")
    if z.numel() >= 1 << 31:
        raise ValueError(f"posit_fft_stages: {z.numel()} elements, at most "
                         f"2^31 - 1")
    nfft = z.numel() // (2 * n)
    tr = True
    if not nfft:                        # no FFT: the state after, empty
        tr = transposed_after(n, s0, s1, tr)
        return z.new_empty(_state_shape(batch, n, s1, tr)), tr
    fn = _fns.get(z.dtype)
    if fn is None:
        _kernels()
        fn = _fns[z.dtype]
    index = z.get_device()
    stream = torch._C._cuda_getCurrentRawStream(index)
    for p in fft_pass_plan(n, s0, s1, nfft, z.dtype, build.sm_count(index)):
        tr_out = transposed_after(n, p.s0, p.s1, tr)
        out = torch.empty(_state_shape(batch, n, p.s1, tr_out),
                          dtype=z.dtype, device=z.device)
        rc = fn(z.data_ptr(), out.data_ptr(), twiddles.data_ptr(), nfft,
                n.bit_length() - 1, p.s0, p.s1 - p.s0,
                p.groups_per_block.bit_length() - 1, int(tr), int(tr_out),
                p.blocks, p.threads, p.shared_bytes, fmt.n, fmt.es, stream)
        if rc:
            _raise_on(rc, "posit_fft_stages")
        posit_fft_stages.launches += 1
        z, tr = out, tr_out
    return z, tr


posit_fft_stages.launches = 0
