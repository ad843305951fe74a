"""The R-peak tracker's 1-D 2-means in one launch, as a CUDA kernel.

* ``posit_kmeans_1d`` — the whole 2-means of one reservoir (the initial
  rounding, the cold or warm start, every Lloyd iteration), every op
  rounded to a posit format as ``apps/kmeans.py::kmeans_1d`` rounds it, in
  one thread block (``csrc/posit_kmeans.cu``); returns the two centroids.
  The warm-start centroids go to the kernel by value.

Each centroid's sum is an f32 sum in a fixed order: each of the kernel's
512 threads adds its elements in turn, then the partials are added in a
tree.  It equals ``kmeans_1d``'s per-op path, which is its plain version,
wherever that order cannot decide a rounding (every f32 sum exact: the
tracker's scores).

The wrapper takes CUDA tensors only (``kmeans_1d`` runs the per-op path
elsewhere) and counts its launches in ``posit_kmeans_1d.launches``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.formats import PositFormat

from . import build

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        f = build.load("posit_kmeans").posit_kmeans_1d_f32
        f.argtypes = [_P, _LL, _I, _I, _F, _F, _P, _I, _I, _P]
        f.restype = _I
        _fn = f
    return _fn


def posit_kmeans_1d(x: torch.Tensor, fmt: PositFormat, iters: int = 12,
                    init=None) -> torch.Tensor:
    """The two centroids of the 1-D f32 CUDA tensor ``x`` (a CUDA tensor of
    two values), every op rounded to ``fmt``; ``init`` (two values, best on
    the host: a CUDA tensor is copied back first) warm-starts them."""
    if not x.is_cuda:
        raise ValueError(f"posit_kmeans_1d: x must be on the card (got "
                         f"{x.device})")
    if x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"posit_kmeans_1d: a contiguous 1-D float32 tensor "
                         f"only, got {x.dtype} {tuple(x.shape)}")
    n = x.numel()
    if init is None:
        if n == 0:
            raise RuntimeError("posit_kmeans_1d: the cold start needs the "
                               "min and max of a non-empty x")
        c0 = c1 = 0.0
    else:
        vals = np.asarray(torch.as_tensor(init).detach().to("cpu",
                                                            torch.float32))
        if vals.size != 2:
            raise ValueError(f"posit_kmeans_1d: {vals.size} warm-start "
                             f"centroids, not 2")
        c0, c1 = vals.reshape(-1).tolist()
    out = torch.empty(2, dtype=torch.float32, device=x.device)
    rc = _kernel()(x.data_ptr(), n, iters, init is not None, c0, c1,
                   out.data_ptr(), fmt.n, fmt.es,
                   torch._C._cuda_getCurrentRawStream(x.get_device()))
    if rc:
        raise RuntimeError(f"posit_kmeans_1d: CUDA launch failed "
                           f"(cudaError {rc})")
    posit_kmeans_1d.launches += 1
    return out


posit_kmeans_1d.launches = 0
