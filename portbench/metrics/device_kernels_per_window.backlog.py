"""Device kernels, copies and fills per window scored, in the traced
window."""
from portbench.lib.readers import whole


def read(ctx):
    if not whole(ctx) or not ctx.get("traced_windows"):
        return None
    return len(ctx["traced"].events) / ctx["traced_windows"]
