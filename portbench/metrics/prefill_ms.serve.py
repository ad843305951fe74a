"""Mean host time of one admission prefill (B = 1, the prompt padded to
its bucket, the rows installed into the lane), from the TokenLedger over
the measured window."""


def read(ctx):
    if not ctx.get("prefills"):
        return None
    return 1e3 * ctx["prefill_s"] / ctx["prefills"]
