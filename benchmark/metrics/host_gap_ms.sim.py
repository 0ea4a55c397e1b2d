"""``host_gap_ms.sim``: the median, over the traced calls of a Monte Carlo
cell, of the device's idle time from one call's last device operation to
the next call's first: the host work a call does between its kernels'
runs (dispatch, the seed's draw, the moments' read)."""
import statistics


def read(ctx):
    if ctx.kind != "mc_stats" or ctx.trace is None or not ctx.trace.call_gaps_s:
        return None
    return 1e3 * statistics.median(ctx.trace.call_gaps_s)
