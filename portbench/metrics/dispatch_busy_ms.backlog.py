"""Mean device busy time inside one dispatch (the merged device events
starting inside each of the program's ``stream.dispatch`` spans, mapped
onto the device trace's clock), beside ``dispatch_ms.backlog``'s host
time, in the traced window."""
from portbench.lib.spans import mean


def read(ctx):
    sp = ctx.get("spans")
    if sp is None:
        return None
    m = mean([sp.busy_s(s) for s in sp.named("stream.dispatch")])
    return None if m is None else 1e3 * m
