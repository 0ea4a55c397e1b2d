"""``ppo_mfu``: the matrix FLOPs of the window's PPO iterations (K3's
forward per env-step, K4's forward and backward per sample and epoch) over
the window's seconds times the card's dense bf16 peak, in %."""
from benchmark.yardstick import roofline


def read(ctx):
    if ctx.kind != "train":
        return None
    calls = len(ctx.call_s)
    return 100.0 * ctx.loop.flops_per_call * calls / (ctx.window_s * roofline.BF16_OPS_PER_S)
