"""The whole decode step's share of the card's peak: its counted
operations (2 × active parameters × rows, plus attention) over the bf16
peak, or its counted bytes (every posit16 weight once, plus the K/V
read) over 3.35 TB/s, whichever is larger, over the decode steps' host
time in the traced steps, in %."""
from portbench import counts


def read(ctx):
    st = ctx.get("steps")
    if not st or not st["steps"] or not ctx.get("traced_decode_s"):
        return None
    return 100.0 * counts.bound_s(st["flops"], st["bytes"], "bf16") \
        / ctx["traced_decode_s"]
