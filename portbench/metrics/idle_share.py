"""idle_share: 1 minus each card's busy share of the traced window (the
union of its kernels, copies and sets), meaned over the cell's cards,
in %."""


def read(ctx):
    cards = ctx.cards()
    if not cards:
        return None
    return 100.0 * sum(1.0 - c["busy_s"] / c["window_s"]
                       for c in cards) / len(cards)
