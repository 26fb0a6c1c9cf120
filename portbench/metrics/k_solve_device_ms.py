"""Device milliseconds of the K solve a superstep, as the window runs it
(warm-started, the fused cooperative CG included): the ``k_solve`` span of
``VCMModel._fields`` over the spanned pass after the window
(``portbench/spans.py``)."""

from portbench import spans


def measure(ctx):
    spans.measure(ctx)


def read(ctx):
    return spans.value(ctx, "ms", "k_solve")
