"""``k4_roofline_pct``: K4's bound (its FLOPs at 989 TFLOP/s or its bytes at
3.35 TB/s, whichever is longer) over its device time a launch, in %."""


def read(ctx):
    if ctx.kind != "train":
        return None
    return ctx.kernel_roofline("ppo_fused_grads_T")
