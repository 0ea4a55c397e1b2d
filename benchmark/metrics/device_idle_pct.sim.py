"""``device_idle_pct.sim``: 1 - the union of the device's busy intervals
over the traced sub-window's wall time, in %, in a Monte Carlo cell."""


def read(ctx):
    if ctx.kind != "mc_stats":
        return None
    return ctx.idle_pct()
