"""Frames completed in the window over the window's time (the sum of the
timed passes, each ending in a synchronize; restores are not timed)."""


def read(ctx):
    return ctx["frames"] / ctx["window_s"] if ctx.get("window_s") else None
