"""Device milliseconds a superstep inside the program: the ``superstep``
span (the program's body, from its first node to its pack) over the spanned
pass after the window (``portbench/spans.py``)."""

from portbench import spans


def measure(ctx):
    spans.measure(ctx)


def read(ctx):
    return spans.value(ctx, "ms", "superstep")
