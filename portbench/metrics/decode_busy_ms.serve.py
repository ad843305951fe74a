"""Mean device busy time inside one batched decode step (the merged
device events starting inside each of the program's ``serve.decode``
spans, mapped onto the device trace's clock), beside
``decode_step_ms.serve``'s host time, in the traced steps."""
from portbench.lib.spans import mean


def read(ctx):
    sp = ctx.get("spans")
    if sp is None:
        return None
    m = mean([sp.busy_s(s) for s in sp.named("serve.decode")])
    return None if m is None else 1e3 * m
