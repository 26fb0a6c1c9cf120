"""Device milliseconds of the event loop a superstep: the ``event_loop``
span around the loop's conditional while node, over the spanned pass after
the window (``portbench/spans.py``)."""

from portbench import spans


def measure(ctx):
    spans.measure(ctx)


def read(ctx):
    return spans.value(ctx, "ms", "event_loop")
