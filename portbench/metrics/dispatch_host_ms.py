"""Host milliseconds of a dispatch outside the device's wait: the ``load``
(copies in), ``launch`` (the replay call) and ``unpack`` (counts, output
copies, the new state) phases, a dispatch, over the unprofiled spanned pass
after the window (``portbench/spans.py``)."""

from portbench import spans


def measure(ctx):
    spans.measure(ctx)


def read(ctx):
    return spans.value(ctx, "dispatch_host_ms")
