"""Host synchronisations a step over the traced window, counted by
``torch.cuda.set_sync_debug_mode("warn")``."""

from portbench import timing


def read(ctx):
    if ctx.recorder is None or ctx.device.type != "cuda":
        return None
    return timing.n_syncs(ctx.recorder.syncs) / len(ctx.window.steps)
