"""One pass of a full-physics bias program with a fixed number of supersteps
a bias (``--full-physics``, as ``runtime/driver.py::_run`` drives each bias):
at each bias the CB edge once (``update_cb_edge``), the clock restarted,
then ``supersteps_per_bias`` supersteps (``superstep_full``) with the power
solve warm-started from the last, across the pass, and its tolerance
tightened 100x after a sub-nA current, the driver's "auto" rule. The
mt19937 stream is drawn from (seed, pass). A fixed count, where
``staircase.py`` runs each bias to its ``t_switch``, keeps a pass's work the
same on every stream.

With the model's spans on, a bias's first superstep carries the span of the
CB edge solved before it (``cb_edge``, outside the superstep's own span):
the spanned passes read one table a step (``spans.py``), and this step's
table is the one that follows its bias's CB edge. A program without that
span carries nothing.

Traffic keys: ``V_switch``, ``supersteps_per_bias``. The check judges the CB
edge, the power solution, I_macro and site power on the blocked reference
(``reference/transmission.py``, ``judge_extra``), and the control puts that
reference's power stage and CB edge in the program's place
(``control_extra``); the events are replayed as ``staircase.py`` replays
them."""

import torch

from portbench import check, harness
from portbench.reference import current as ref_current
from portbench.reference import transmission

_staircase = harness.module("entries", "staircase")
replay = _staircase.replay


def steps(setup, traffic: dict, seed: int, pass_index):
    from akmc_tpu_torch.rng import BufferedStream, ReferenceRNG

    model, state = setup.model, setup.state0
    stream_seed = harness.mix(seed, "kmc", pass_index)
    stream = BufferedStream(ReferenceRNG(stream_seed))
    used = 0
    m_warm, last_I = None, None
    for Vd in traffic["V_switch"]:
        Vd = float(Vd)
        state = model.update_cb_edge(state, Vd)
        cb_span = model.last_spans.get("cb_edge") if getattr(model, "spans", False) else None
        state = state.replace(kmc_time=state.kmc_time * 0.0)
        for _ in range(int(traffic["supersteps_per_bias"])):
            rscale = 1e-2 if last_I is not None and abs(last_I) < 1e-9 else 1.0
            new, stats, m_new = model.superstep_full(state, Vd, stream, m_prev=m_warm,
                                                     rtol_scale=rscale)
            if cb_span is not None:
                model.last_spans = {**model.last_spans, "cb_edge": {**cb_span, "parent": None}}
                cb_span = None
            # the power solutions ride in the stats: the stream's record stays
            # JSON (it seeds the spanned passes, ``spans.py``)
            where = {"stream_seed": stream_seed, "offset": used, "rtol_scale": rscale,
                     "m": None}
            stats = {**stats, "power_m": m_new, "power_m_prev": m_warm}
            m_warm, last_I = m_new, stats["I_macro"]
            yield state, new, stats, Vd, where
            used += 2 * int(stats["n_events"])
            state = new


def warm_kwargs(traffic: dict) -> dict:
    """``VCMModel.warmup``'s arguments for the shapes the mix uses."""
    return {"full_physics": True}


def first_bias(traffic: dict) -> float:
    return float(traffic["V_switch"][0])


def _system(ref):
    if getattr(ref, "transmission", None) is None:
        ref.transmission = transmission.Transmission(ref.element0, ref.pos, ref.nbr, ref.metal,
                                                     ref.L, ref.ph)
    return ref.transmission


def judge_extra(ref, traffic: dict, step, element, charge, out: dict) -> dict:
    """``cb_res``, the CB edge in the reference's own Laplace system (its
    scaled residual over the stop tolerance 1e-14); ``power_res``, the step's
    power solution ``m`` in the reference's own blocked transmission system,
    sqrt(r.z / b.b) over the stop tolerance; ``imacro_err`` and
    ``power_err``, I_macro and site power against those the reference
    derives from that solution on the same blocks. The program's solution
    is the step's ``stats["power_m"]`` (``out["m"]`` is None), the
    control's its own."""
    dev = ref.dev
    nums = {"cb_res": ref_current.cb_residual(out["cb"].to(dev), ref.element0, ref.nbr,
                                              ref.metal, ref.L, step.Vd,
                                              float(ref.ph["G_coeff"]))}
    tr = _system(ref)
    C = tr.coupling(element, charge, step.pre.cb_edge.to(dev))
    m = (step.stats["power_m"] if out["m"] is None else out["m"]).to(dev)
    nums["power_res"] = tr.residual_ratio(C, step.Vd, m, step.stream["rtol_scale"])
    I_r, p_r = tr.outputs(C, step.Vd, m)
    site = torch.zeros(element.shape[0], dtype=torch.float64, device=dev)
    site[tr.atom] = p_r
    nums["imacro_err"] = check.rel(float(out["I_macro"]), I_r)
    nums["power_err"] = (float((out["power"].to(dev) - site).abs().max())
                         / max(float(site.abs().max()), 1e-300))
    return nums


def control_extra(ref, traffic: dict, step, element, charge, dtypes: dict) -> dict:
    """The blocked reference's power stage (coupling, CG from the step's warm
    start, outputs) and CB edge in ``dtypes["current"]`` in the program's place."""
    dev, dtype = ref.dev, dtypes["current"]
    tr = _system(ref)
    C = tr.coupling(element, charge, step.pre.cb_edge.to(dev), dtype)
    m_prev = step.stats["power_m_prev"]
    m0 = (torch.zeros(tr.n + 2, dtype=torch.float64, device=dev) if m_prev is None
          else m_prev.to(dev))
    m = tr.solve(C, step.Vd, m0, step.stream["rtol_scale"], dtype)
    I_c, p_c = tr.outputs(C, step.Vd, m, dtype)
    site = torch.zeros(element.shape[0], dtype=torch.float64, device=dev)
    site[tr.atom] = p_c
    cb = ref_current.cb_solve(ref.element0, ref.nbr, ref.metal, ref.L, step.Vd,
                              float(ref.ph["G_coeff"]), dtype)
    return {"I_macro": I_c, "power": site, "cb": cb, "m": m.to(torch.float64)}
