"""Device milliseconds of the cell's pairwise potential (``ops/pairwise.py``
through the model's own path) on the window's last state, by CUDA events
over repeated calls."""

from portbench import timing


def measure(ctx):
    if ctx.device.type != "cuda":
        return
    model, charge = ctx.model, ctx.last_state.charge
    ctx.measured["pairwise_ms"] = timing.cuda_time_ms(lambda: model._pairwise(charge), reps=5)


def read(ctx):
    return ctx.measured.get("pairwise_ms")
