"""solve_s_p90: the 90th percentile of every solve time of the window
(host clock, from the solve's start to the global tally on the host),
by statistics.quantiles over all solves."""

import statistics


def read(ctx):
    times = [s["solve_s"] for s in ctx.solves]
    if len(times) < 2:
        return times[0]
    return statistics.quantiles(times, n=10)[8]
