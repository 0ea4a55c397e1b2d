"""``host_gap_ms.eval``: the median, over the traced calls of a
policy-evaluation cell, of the device's idle time from one call's last
device operation to the next call's first (dispatch, the params' copy,
the K3 wrapper's padding and packing, the result's read)."""
import statistics


def read(ctx):
    if ctx.kind != "evaluate" or ctx.trace is None or not ctx.trace.call_gaps_s:
        return None
    return 1e3 * statistics.median(ctx.trace.call_gaps_s)
