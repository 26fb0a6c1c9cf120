"""Device milliseconds of one CB-edge solve (``update_cb_edge``, once a
bias): the ``cb_edge`` span around the CB edge's CG, which a bias's first
full-physics superstep carries in its table, over the spanned pass after
the window (``portbench/spans.py``), divided by its count a superstep."""

from portbench import spans


def measure(ctx):
    spans.measure(ctx)


def read(ctx):
    ms, n = spans.value(ctx, "ms", "cb_edge"), spans.value(ctx, "n", "cb_edge")
    return ms / n if ms is not None and n else None
