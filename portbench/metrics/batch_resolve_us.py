"""Device microseconds of a batch's resolution (slots, conflict and mass
cuts, writes, row updates, counters: B-sized work): the ``batch.resolve``
span's sum over its count in the spanned pass after the window
(``portbench/spans.py``)."""

from portbench import spans


def measure(ctx):
    spans.measure(ctx)


def read(ctx):
    return spans.value(ctx, "batch_resolve_us")
