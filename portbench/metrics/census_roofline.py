"""census_roofline: the least time the window's censuses could take on the
cell's cards (roofline.solve_seconds, from their counts) over the cards'
busy time inside the benchmark's census spans (the trace), in %."""


def read(ctx):
    cards = ctx.cards()
    busy = sum(c["census_busy_s"] for c in cards) / len(cards) if cards else 0
    if busy <= 0:
        return None
    return 100.0 * ctx.least_census_s() / busy
