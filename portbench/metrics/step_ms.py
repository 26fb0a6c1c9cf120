"""Milliseconds a step: the window's time over the steps it completed."""


def read(ctx):
    return 1000.0 * ctx.window.seconds / len(ctx.window.steps)
