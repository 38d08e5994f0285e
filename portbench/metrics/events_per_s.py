"""events_per_s: the facet and collision events of every solve in the
window, counted over every particle, over the window's whole
wall time (host clock): the upstream's figure of merit (main.c:118-125)
over a window, not a step."""


def read(ctx):
    events = sum(st["facets"] + st["collisions"]
                 for s in ctx.solves for st in s["steps"])
    return events / ctx.record.window_s
