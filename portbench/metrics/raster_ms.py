"""raster_ms: the program's "raster" phase (StepMetrics.phases), summed
over a solve's censuses, meaned over the window's solves;
nothing where the cell's censuses have no such phase."""


def read(ctx):
    return ctx.phase_ms("raster")
