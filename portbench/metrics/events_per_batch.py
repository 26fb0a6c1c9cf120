"""Events a batch of the batched loop: the window's events over its batches."""


def read(ctx):
    batches = sum(int(s.stats.get("n_batches", 0)) for s in ctx.window.steps)
    if not batches:
        return None
    return sum(int(s.stats.get("n_events", 0)) for s in ctx.window.steps) / batches
