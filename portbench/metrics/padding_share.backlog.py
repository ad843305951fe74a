"""Padding rows of the dispatched batches, as a share of all rows (the
EnergyLedger's padded_windows over windows + padded_windows), in %."""


def read(ctx):
    rows = ctx.get("windows", 0) + ctx.get("padded", 0)
    if not rows:
        return None
    return 100.0 * ctx["padded"] / rows
