"""``k3_roofline_pct.eval``: K3's bound over its device time a launch in a
policy-evaluation cell, in %."""


def read(ctx):
    if ctx.kind != "evaluate":
        return None
    return ctx.kernel_roofline("mlp_rollout")
