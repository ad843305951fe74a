"""k-means clustering in a chosen arithmetic format (BayeSlope's last stage)."""
from __future__ import annotations

import torch

from repro_torch.core.arith import Arith, get_fused_kernels
from repro_torch.kernels.posit_kmeans import posit_kmeans_1d


def kmeans_route(ar: Arith, device, dtype: torch.dtype = torch.float32,
                 k: int = 2) -> str:
    """``"kernel"`` where ``kmeans_1d`` on a tensor of ``device`` and
    ``dtype`` runs as one ``posit_kmeans_1d`` launch (a 2-means of an f32
    tensor on the card, a posit format, fused kernels on, quire off), else
    ``"ops"``: the per-op path, the kernel's oracle."""
    if (k == 2 and torch.device(device).type == "cuda"
            and dtype == torch.float32 and ar.is_posit
            and get_fused_kernels() and not ar.quire):
        return "kernel"
    return "ops"


def kmeans_1d(ar: Arith, x: torch.Tensor, k: int = 2, iters: int = 12,
              init: torch.Tensor = None) -> torch.Tensor:
    """1-D k-means, all arithmetic rounded to the format. Returns centroids.

    ``init`` warm-starts the centroids (e.g. from the previous streaming
    window's solution) instead of the lo..hi linspace; warm starts are
    rounded to the format first.  Where ``kmeans_route`` says ``"kernel"``
    the whole of it is one ``posit_kmeans_1d`` launch (``init`` best on the
    host, where the kernel takes it from).
    """
    if kmeans_route(ar, x.device, x.dtype, k) == "kernel":
        return posit_kmeans_1d(x.contiguous(), ar.fmt, iters, init)
    x = ar.rnd(x)
    if init is not None:
        cent = ar.rnd(torch.as_tensor(init, device=x.device).to(x.dtype))
    else:
        lo, hi = torch.min(x), torch.max(x)
        frac = torch.arange(k, dtype=x.dtype, device=x.device) / max(k - 1, 1)
        cent = lo + (hi - lo) * frac
        if k > 1:
            cent[-1] = hi                   # linspace ends exactly at hi
        cent = ar.rnd(cent)
    for _ in range(iters):
        d = torch.abs(ar.sub(x[:, None], cent[None, :]))
        assign = torch.argmin(d, dim=1)
        new = []
        for j in range(k):
            m = assign == j
            cnt = torch.clamp(m.sum(), min=1).to(x.dtype)
            # pre-scaled accumulation: divide members by the count, THEN
            # sum (keeps the running sum inside the format's range — IEEE
            # formats have no quire, so their sums round per add)
            contrib = ar.div(torch.where(m, x, torch.zeros_like(x)), cnt)
            new.append(ar.sum(contrib, axis=-1))
        cent = torch.stack(new)
    return cent
