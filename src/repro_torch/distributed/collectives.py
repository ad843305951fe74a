"""Posit-compressed collectives on ``torch.distributed`` — the counterpart
of ``repro.distributed.collectives``: the paper's bit-width → energy
argument mapped onto the links between processes.

Posit bits, not floats, go over the wire in both phases of the all-reduce
(a reduce-scatter as an all-to-all of encoded chunks, then an all-gather of
encoded partials).  Neither gloo nor NCCL carries a 16-bit integer, so the
bits travel as a ``uint8`` view of ``fmt.storage_dtype``: the wire carries
the storage width's bytes and no more.  The codec runs through
``kernels.ops`` (on a CUDA tensor, the ``posit_codec.cu`` kernels).

Each function runs in every process of ``group`` (default: the default
process group), one process per rank, after
``torch.distributed.init_process_group``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.formats import PositFormat
from repro_torch.kernels.ops import decode, encode


def _wire(bits: torch.Tensor) -> torch.Tensor:
    """The bytes of posit patterns, as the collectives carry them."""
    return bits.contiguous().view(torch.uint8)


def posit_all_reduce(x: torch.Tensor, fmt: PositFormat,
                     group=None) -> torch.Tensor:
    """Mean-all-reduce of ``x`` over ``group`` with posit bits on the wire.

    1. encode this rank's tensor, cut into world-size chunks;
    2. all-to-all of the chunks' bits (the reduce-scatter phase);
    3. decode, sum the received chunks in f32 in rank order, divide by the
       world size;
    4. encode the partial sum, all-gather the bits, decode.

    Returns f32 of ``x``'s shape, on ``x``'s device."""
    P = dist.get_world_size(group)
    flat = x.reshape(-1).to(torch.float32)
    n = flat.numel()
    pad = (-n) % P
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    chunks = flat.reshape(P, -1)
    send = _wire(encode(chunks, fmt))                          # (P, C·w)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    vals = decode(recv.view(fmt.storage_dtype), fmt, torch.float32)
    part = vals[0]
    for r in range(1, P):
        part = part + vals[r]
    part = part / P
    gathered = torch.empty_like(send)
    dist.all_gather(list(gathered.unbind(0)), _wire(encode(part, fmt)),
                    group=group)
    out = decode(gathered.view(fmt.storage_dtype), fmt,
                 torch.float32).reshape(-1)
    return out[:n].reshape(x.shape)


def ledger_psum(rows: Sequence[torch.Tensor]) -> torch.Tensor:
    """Exact sum of the mesh's per-device ledger rows (``[real, padded]``
    window counts), one tensor per device on any device, as an int64
    tensor on the host.  The sharded ``StreamEngine`` dispatch reduces its
    slabs' rows through it.  Integer addition is exact in any order, which
    keeps the sharded ledger equal to the single-device one."""
    total = None
    for r in rows:
        r = r.to("cpu", torch.int64)
        total = r.clone() if total is None else total + r
    if total is None:
        raise ValueError("ledger_psum: no rows")
    return total


def posit_all_reduce_ef(x: torch.Tensor, residual: Optional[torch.Tensor],
                        fmt: PositFormat, group=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback variant: this rank's quantization error ``xf − q`` is
    returned as the residual, to be added to the next step's ``x``."""
    xf = x.to(torch.float32)
    if residual is not None:
        xf = xf + residual
    q = decode(encode(xf, fmt), fmt, torch.float32)
    out = posit_all_reduce(q, fmt, group)
    return out, xf - q
