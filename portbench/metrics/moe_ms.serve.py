"""Host time inside the MoE blocks of one decode step (the program's
``model.moe`` spans under each ``serve.decode``, summed over the layers),
mean over the traced steps."""
from portbench.lib.spans import mean


def read(ctx):
    sp = ctx.get("spans")
    if sp is None:
        return None
    m = mean([sum(b.dur for b in sp.descendants(s, "model.moe"))
              for s in sp.named("serve.decode")])
    return None if m is None else 1e3 * m
