"""K-solve CG iterations a step: each step's ``cg_iterations``, summed over
the window's steps."""


def read(ctx):
    return sum(int(s.stats.get("cg_iterations", 0)) for s in ctx.window.steps) / len(ctx.window.steps)
