"""setup_s: process start to the window's start (host clock): imports,
the kernel library, the deck and one warm-up solve."""


def read(ctx):
    return ctx.record.setup_s
