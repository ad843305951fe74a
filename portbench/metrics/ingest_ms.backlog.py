"""Host time of the stream engine's ingest itself (the self time of the
program's ``stream.ingest`` spans: ring push and window assembly, not
the dispatches they set off) per window scored, in the traced window."""


def read(ctx):
    sp = ctx.get("spans")
    if sp is None:
        return None
    windows = sum(s.args.get("B", 0) for s in sp.named("stream.dispatch"))
    ingest = sp.named("stream.ingest")
    if not windows or not ingest:
        return None
    return 1e3 * sum(sp.self_s(s) for s in ingest) / windows
