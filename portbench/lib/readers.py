"""Arithmetic the per-layer readers share: a kernel's share of its
roofline in a traced window, and the device's idle share."""
from __future__ import annotations

from typing import Dict, Optional

from portbench import counts
from portbench.lib.kernel_counts import KERNELS


def whole(ctx: Dict) -> bool:
    """The traced window recorded its lead spins, so it holds every event
    of the calls inside it."""
    tr = ctx.get("traced")
    return tr is not None and tr.spins > 0 and bool(tr.events)


def roofline_pct(ctx: Dict, wrapper: str, operand: str = "f32"
                 ) -> Optional[float]:
    """The least time the card could take for the traced window's calls of
    ``wrapper`` (their counted operations and bytes) over the device time
    of their kernels, in %; None where the window had no such call."""
    if not whole(ctx):
        return None
    t = ctx["kernels"].get(wrapper)
    if not t or not t["calls"]:
        return None
    dev = ctx["traced"].kernel(KERNELS[wrapper])
    if not dev["count"] or dev["seconds"] <= 0:
        return None
    return 100.0 * counts.bound_s(t["flops"], t["bytes"], operand) \
        / dev["seconds"]


def idle_pct(ctx: Dict) -> Optional[float]:
    if not whole(ctx):
        return None
    tr = ctx["traced"]
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
