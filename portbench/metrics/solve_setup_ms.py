"""solve_setup_ms: the benchmark's span around driver.make_simulation
(geometry, mesh, cross-sections, injection, kernel buffers; it waits for
the card), meaned over the window's solves."""


def read(ctx):
    return sum(s["setup_ms"] for s in ctx.solves) / len(ctx.solves)
