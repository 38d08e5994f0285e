"""deposit_tiles_ms: the segment deposit's tile stage, the program's
"raster_tiles" phase (StepMetrics.phases: device time from CUDA events of
every deposit launch, re-runs after an overflow included), summed over a
solve's censuses, meaned over the window's solves; nothing where the
cell's censuses have no such phase."""


def read(ctx):
    return ctx.phase_ms("raster_tiles")
