"""k-means clustering in a chosen arithmetic format (BayeSlope's last stage)."""
from __future__ import annotations

import torch

from repro_torch.core.arith import Arith


def kmeans_1d(ar: Arith, x: torch.Tensor, k: int = 2, iters: int = 12,
              init: torch.Tensor = None) -> torch.Tensor:
    """1-D k-means, all arithmetic rounded to the format. Returns centroids.

    ``init`` warm-starts the centroids (e.g. from the previous streaming
    window's solution) instead of the lo..hi linspace; warm starts are
    rounded to the format first.
    """
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
