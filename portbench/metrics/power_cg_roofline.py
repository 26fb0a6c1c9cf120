"""Share of its roofline that the cell's power CG reaches: a superstep's
mean of its iterations times the least time of one iteration
(``portbench/roofline_power.py``: the live tunnel blocks read once, the
neighbor codes, seven f64 vectors of n_atom, counted on the superstep's own
state), over the ``power_solve`` span a superstep of the spanned pass after
the window (``portbench/spans.py``). Both come from that pass: its
iterations and counts from the same pass run again on its stream
(``roofline_power.measure_work``)."""

from portbench import roofline_power, spans


def measure(ctx):
    spans.measure(ctx)
    roofline_power.measure_work(ctx)


def read(ctx):
    work = ctx.measured.get("power_work")
    ms = spans.value(ctx, "ms", "power_solve")
    if work is None or ms is None or not work["steps"]:
        return None
    return roofline_power.share_pct(roofline_power.power_cg_least_s(work), ms)
