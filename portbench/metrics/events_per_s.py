"""KMC events executed in the window over the window's time."""


def read(ctx):
    return sum(int(s.stats.get("n_events", 0)) for s in ctx.window.steps) / ctx.window.seconds
