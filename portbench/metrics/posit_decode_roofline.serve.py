"""The posit weight decode kernel's share of its roofline: each call's
patterns read and values written once over 3.35 TB/s, over its device
time in the traced steps, in %."""
from portbench.lib.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "posit_decode")
