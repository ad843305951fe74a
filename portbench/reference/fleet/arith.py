"""Posit arithmetic in plain torch: every op computes in the operands'
float type, then rounds onto the format's lattice.

A frozen copy of the port's ``core.arith.Arith`` on its plain path (the
torch round backend, quire off), posit formats only: a reduction is one
wide torch sum rounded once, and a matrix product is summed in the order
of the port's rounded-matmul kernel (``round_matmul_sum``, copied below
with its plan), so a row's bits do not depend on the batch.  No kernel of
the program is called.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch

from .posit import PositFormat, get_format, round_posit_math

# the port's rounded-matmul kernel geometry (kernels/posit_matmul.py)
ROUND_THREADS = 256
ROUND_ACC = 32
ROUND_SPLIT_BLOCKS = 132
_MAX_ROUND_SPLITS = 16
_PLAIN_ELEMS = 1 << 22


@functools.lru_cache(maxsize=1024)
def round_matmul_plan(K: int, N: int) -> Tuple[int, int, int, int]:
    """(tm, tn, splits, per): the sum order of every output of the rounded
    matmul is a function of K and N alone."""
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
    order; each warp's 32 partials are added pairwise; the eight warps'
    sums in order, then the splits in order."""
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


def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        x, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class Arith:
    """A rounded posit arithmetic context."""

    fmt: PositFormat

    @staticmethod
    def make(name: str) -> "Arith":
        return Arith(get_format(name))

    @property
    def name(self) -> str:
        return self.fmt.name

    def rnd(self, x) -> torch.Tensor:
        return round_posit_math(_t(x), self.fmt)

    def add(self, a, b):
        return self.rnd(_t(a) + _t(b))

    def sub(self, a, b):
        return self.rnd(_t(a) - _t(b))

    def mul(self, a, b):
        return self.rnd(_t(a) * _t(b))

    def div(self, a, b):
        return self.rnd(_t(a) / _t(b))

    def sqrt(self, a):
        return self.rnd(torch.sqrt(_t(a)))

    def exp(self, a):
        return self.rnd(torch.exp(_t(a)))

    def log(self, a):
        return self.rnd(torch.log(_t(a)))

    def sum(self, a, axis=-1):
        return self.rnd(torch.sum(_t(a), dim=axis))

    def cumsum(self, a, axis=-1):
        return self.rnd(torch.cumsum(_t(a), dim=axis))

    def mean(self, a, axis=-1):
        a = _t(a)
        return self.div(self.sum(a, axis=axis), float(a.shape[axis]))

    def matmul(self, a, b):
        """``a (..., K) · b (K, N)``: one wide sum per output in the
        kernel's order, rounded once."""
        a, b = _t(a), _t(b)
        K, N = b.shape
        batch = a.shape[:-1]
        return self.rnd(round_matmul_sum(a.reshape(-1, K), b)
                        .reshape(*batch, N))
