"""``device_idle_pct.eval``: 1 - the union of the device's busy intervals
over the traced sub-window's wall time, in %, in a policy-evaluation
cell."""


def read(ctx):
    if ctx.kind != "evaluate":
        return None
    return ctx.idle_pct()
