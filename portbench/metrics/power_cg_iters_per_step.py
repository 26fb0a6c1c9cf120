"""Power-CG iterations a step: each full-physics step's
``power_cg_iterations``, over the window's steps."""


def read(ctx):
    got = [int(s.stats["power_cg_iterations"]) for s in ctx.window.steps
           if "power_cg_iterations" in s.stats]
    return sum(got) / len(got) if got else None
