"""``k3_roofline_pct.train``: K3's bound over its device time a launch in a
training cell, in %."""


def read(ctx):
    if ctx.kind != "train":
        return None
    return ctx.kernel_roofline("mlp_rollout")
