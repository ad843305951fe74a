"""Mean host time of one ECG window's tracker update (the program's
``stream.track`` spans: the 2-means threshold and its host copy, the
stitch and the router's observe), in the traced window."""
from portbench.lib.spans import mean


def read(ctx):
    sp = ctx.get("spans")
    if sp is None:
        return None
    m = mean([s.dur for s in sp.named("stream.track")])
    return None if m is None else 1e3 * m
