"""Device milliseconds of the power solve a superstep (the power CG as a
while node, I_macro and the site power): the ``power_solve`` span of
``VCMModel._power`` over the spanned pass after the window
(``portbench/spans.py``)."""

from portbench import spans


def measure(ctx):
    spans.measure(ctx)


def read(ctx):
    return spans.value(ctx, "ms", "power_solve")
