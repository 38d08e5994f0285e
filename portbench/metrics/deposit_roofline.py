"""deposit_roofline: the least time of the window's segment deposits
(deposit_bound.deposit_seconds, from each census's facet count) over the
program's "raster" phase (StepMetrics.phases: the device time of every
deposit launch, re-runs included), in %; nothing where the cell's
censuses have no such phase."""

from portbench.deposit_bound import deposit_roofline


def read(ctx):
    c, t = ctx.config, ctx.traffic
    return deposit_roofline(ctx.solves, c["nx"] * c["ny"], t["dtype"],
                            t["tally_dtype"])
