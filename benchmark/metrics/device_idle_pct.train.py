"""``device_idle_pct.train``: 1 - the union of the device's busy intervals
over the traced sub-window's wall time, in %, in a training cell."""


def read(ctx):
    if ctx.kind != "train":
        return None
    return ctx.idle_pct()
