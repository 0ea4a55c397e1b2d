"""``capture_s``: the seconds the process spent capturing CUDA graphs of
a training cell's iteration (the warm-up call and the capture), the sum
of the program's ``mbt.graph.capture`` spans, which record whether
tracing is on or not (``mbt_gym_torch.utils.profiling``).  None where the
program records no such span (on the CPU no graph is captured)."""


def read(ctx):
    if ctx.kind != "train":
        return None
    from mbt_gym_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    captures = [r.end_ns - r.start_ns for r in spans() if r.name == "mbt.graph.capture"] if spans else []
    return sum(captures) / 1e9 if captures else None
