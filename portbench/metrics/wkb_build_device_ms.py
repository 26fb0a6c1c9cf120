"""Device milliseconds of the WKB build of the tunnel blocks a superstep
(W_tt, W_ct with its contact-trap energy integral, W_cc, the diagonal): the
``wkb_build`` span of ``VCMModel._power`` over the spanned pass after the
window (``portbench/spans.py``)."""

from portbench import spans


def measure(ctx):
    spans.measure(ctx)


def read(ctx):
    return spans.value(ctx, "ms", "wkb_build")
