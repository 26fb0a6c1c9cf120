"""Share of the spanned pass's window (the first dispatch's ``load`` to the
last one's ``unpack``) in which neither a device operation of the profiler
nor a device span of the program, put on the profiler's clock by its
dispatch's anchor, is open (``portbench/spans.py``). The profiler's own
idle share over the same window goes to the ``info:`` line beside it."""

from portbench import spans


def measure(ctx):
    spans.measure(ctx)


def read(ctx):
    return spans.value(ctx, "untraced_idle_pct")
