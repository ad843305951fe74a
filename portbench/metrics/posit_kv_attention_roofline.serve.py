"""The posit-KV attention kernel's share of its roofline: q and the K/V
rows each batch row has filled read once, the output written once, over
its device time (with its combine kernel) in the traced steps, in %."""
from portbench.lib.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "posit_kv_attention")
