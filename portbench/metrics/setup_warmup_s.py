"""Host seconds of ``VCMModel.warmup`` (builds and captures) and of the warm
pass that settles the caps before the window."""


def read(ctx):
    parts = ctx.setup.parts
    return parts["warmup_s"] + parts["warm_pass_s"]
