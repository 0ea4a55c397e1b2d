"""``train_host_ms``: the median, over the traced iterations of a
training cell, of ``mbt.train_iteration``'s host time: the program's own
span around ``jit_train_iteration``, less what its ``mbt.sync.*`` spans
(the host waiting on the card) cover (``mbt_gym_torch.utils.profiling``).
None where the program records no such span."""
import statistics


def read(ctx):
    if ctx.kind != "train":
        return None
    from mbt_gym_torch.utils import profiling

    host_seconds = getattr(profiling, "host_seconds", None)
    times = host_seconds("mbt.train_iteration") if host_seconds else []
    return 1e3 * statistics.median(times) if times else None
