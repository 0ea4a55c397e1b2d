"""``k1_roofline_pct``: K1's bound (its operations at 67 TFLOP/s float32)
over its device time a launch, in %."""


def read(ctx):
    if ctx.kind != "mc_stats":
        return None
    return ctx.kernel_roofline("as_episode")
