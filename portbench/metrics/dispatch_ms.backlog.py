"""Mean host time of one dispatch (batch staged, scored, copied back),
from the engine's EnergyLedger over the measured window."""


def read(ctx):
    if not ctx.get("dispatches"):
        return None
    return 1e3 * ctx["dispatch_s"] / ctx["dispatches"]
