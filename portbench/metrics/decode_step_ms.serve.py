"""Mean host time of one batched decode step (it ends on its tokens' host
copy), from the serving engine's TokenLedger over the measured window."""


def read(ctx):
    if not ctx.get("decode_steps"):
        return None
    return 1e3 * ctx["decode_s"] / ctx["decode_steps"]
