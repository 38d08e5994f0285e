"""deposit_bins_ms: the segment deposit's bin stage, the program's
"raster_bins" phase (StepMetrics.phases: device time from CUDA events of
every deposit launch, re-runs after an overflow included), summed over a
solve's censuses, meaned over the window's solves; nothing where the
cell's censuses have no such phase."""


def read(ctx):
    return ctx.phase_ms("raster_bins")
