"""Share of its roofline that the cell's WKB build reaches: a superstep's
mean of the terms of its build of the tunnel blocks, on the state and the
CB edge it built them from (``portbench/roofline_power.py``), at
``TERM_FLOPS`` f64 operations a term and the f64 peak, over the
``wkb_build`` span a superstep of the spanned pass after the window
(``portbench/spans.py``). Both come from that pass: its terms from the same
pass run again on its stream (``roofline_power.measure_work``)."""

from portbench import roofline_power, spans


def measure(ctx):
    spans.measure(ctx)
    roofline_power.measure_work(ctx)


def read(ctx):
    work = ctx.measured.get("power_work")
    ms = spans.value(ctx, "ms", "wkb_build")
    if work is None or ms is None or not work["steps"]:
        return None
    return roofline_power.share_pct(roofline_power.wkb_build_mean_least_s(work), ms)
