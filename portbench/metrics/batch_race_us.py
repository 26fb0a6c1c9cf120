"""Device microseconds of a batch's race over every row (the draw, every
row's clock, the B smallest): the ``batch.race`` span's sum over its count
(one a batch) in the spanned pass after the window (``portbench/spans.py``)."""

from portbench import spans


def measure(ctx):
    spans.measure(ctx)


def read(ctx):
    return spans.value(ctx, "batch_race_us")
