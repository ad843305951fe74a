"""The rounded matmul kernel's share of its roofline (mel, centroid, DCT
and votes products), in the traced window, in %."""
from portbench.lib.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "posit_matmul_round")
