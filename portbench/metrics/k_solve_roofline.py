"""Share of its roofline that the cell's K solve reaches: the system of the
window's last state and bias solved from a cold start, standalone, between
CUDA events, against the least time of the CG iterations it ran by the
frozen count of ``portbench/roofline.py`` (the operator's nonzeros, one
int8 code each, and the f64 vectors)."""

import torch

from portbench import roofline


def measure(ctx):
    if ctx.device.type != "cuda":
        return
    model, st, Vd = ctx.model, ctx.last_state, ctx.last_Vd
    zeros = torch.zeros_like(st.potential_boundary)
    out = {}

    def solve():
        out["cg"] = model._solve_boundary(st.element, st.charge, zeros, Vd)[1]

    solve()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    solve()
    end.record()
    torch.cuda.synchronize()
    ctx.measured["k_solve"] = {"ms": start.elapsed_time(end),
                               "iterations": int(out["cg"].iterations)}


def read(ctx):
    got = ctx.measured.get("k_solve")
    if got is None or ctx.ref is None:
        return None
    least = roofline.k_solve_least_s(ctx.ref.nbr, ctx.ref.L, got["iterations"])
    return 100.0 * least / (got["ms"] * 1e-3)
