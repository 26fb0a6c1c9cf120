"""Device milliseconds of the pairwise potential a superstep inside the
program: the ``pairwise`` span of ``VCMModel._fields`` over the spanned pass
after the window (``portbench/spans.py``)."""

from portbench import spans


def measure(ctx):
    spans.measure(ctx)


def read(ctx):
    return spans.value(ctx, "ms", "pairwise")
