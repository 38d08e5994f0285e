"""deposit_overflow_ms: the device time of the segment deposit launches
whose piece buffer overflowed, which deposited nothing before their
re-run: the program's "raster_overflow" phase (StepMetrics.phases),
summed over a solve's censuses, meaned over the window's solves.  0.0
where no deposit overflowed; nothing where the cell's censuses have no
such phase (no deposit, or a program that does not time it)."""


def read(ctx):
    return ctx.phase_ms("raster_overflow")
