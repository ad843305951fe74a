"""Host time of one engine step outside its admissions and its decode
(each ``serve.step`` span less its ``serve.admit`` and ``serve.decode``
children: the per-row accounting, ``on_token`` and the scheduler), mean
over the traced steps."""
from portbench.lib.spans import mean


def read(ctx):
    sp = ctx.get("spans")
    if sp is None:
        return None
    m = mean([s.dur - sum(k.dur for k in sp.children(
        s, ("serve.admit", "serve.decode"))) for s in sp.named("serve.step")])
    return None if m is None else 1e3 * m
