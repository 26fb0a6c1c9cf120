"""One pass of a bias staircase as ``runtime/driver.py::_run`` drives it: at
each bias the clock restarts and steps run until it reaches the bias's
``t_switch``. ``mode`` "superstep": the committed-parity superstep
(``VCMModel.superstep``) on an mt19937 stream; "full": ``--full-physics``,
the CB edge once a bias (``update_cb_edge``), then ``superstep_full`` with
the power solve warm-started from the last and its tolerance tightened
100x after a sub-nA current, the driver's "auto" rule.

Traffic keys: ``mode``, ``V_switch``, ``t_switch``. With full physics the
check also judges the CB edge, the power solution, I_macro and site power
(``judge_extra``), and the control puts the reference's power stage in the
program's place (``control_extra``)."""

import torch

from portbench import check, harness
from portbench.reference import current as ref_current
from portbench.reference import events as ref_events
from portbench.reference import streams

RAND_WINDOW = 8192


def steps(setup, traffic: dict, seed: int, pass_index):
    from akmc_tpu_torch.rng import BufferedStream, ReferenceRNG

    model, state = setup.model, setup.state0
    full = traffic["mode"] == "full"
    stream_seed = harness.mix(seed, "kmc", pass_index)
    stream = BufferedStream(ReferenceRNG(stream_seed))
    used = 0
    m_warm, last_I = None, None
    for Vd, t_bias in zip(traffic["V_switch"], traffic["t_switch"]):
        Vd = float(Vd)
        if full:
            state = model.update_cb_edge(state, Vd)
        state = state.replace(kmc_time=state.kmc_time * 0.0)
        kmc_time = 0.0
        while kmc_time < float(t_bias):
            where = {"stream_seed": stream_seed, "offset": used}
            if full:
                rscale = 1e-2 if last_I is not None and abs(last_I) < 1e-9 else 1.0
                new, stats, m_new = model.superstep_full(state, Vd, stream, m_prev=m_warm,
                                                         rtol_scale=rscale)
                where.update(m_prev=m_warm, rtol_scale=rscale, m=m_new)
                m_warm, last_I = m_new, stats["I_macro"]
            else:
                new, stats = model.superstep(state, Vd, stream)
            kmc_time += stats["event_time"]
            yield state, new, stats, Vd, where
            used += 2 * int(stats["n_events"])
            state = new


def warm_kwargs(traffic: dict) -> dict:
    """``VCMModel.warmup``'s arguments for the shapes the mix uses."""
    return {"full_physics": traffic["mode"] == "full"}


def first_bias(traffic: dict) -> float:
    return float(traffic["V_switch"][0])


def replay(ref, traffic: dict, element, charge, P, etype, ln_S, where: dict, dtype):
    """The step's residence-time loop in the reference on the mt19937
    stream from where the step's draws start: (element, charge, events,
    None, time)."""
    u = streams.mt19937_uniforms(where["stream_seed"], where["offset"], RAND_WINDOW)
    el, q, n, t = ref_events.serial(ref.table, element, charge, P, etype, ln_S,
                                    float(ref.ph["freq"]), u)
    return el, q, n, None, t


def _current(ref):
    if getattr(ref, "current", None) is None:
        ref.current = ref_current.Current(ref.element0, ref.pos, ref.nbr, ref.metal, ref.L,
                                          ref.ph)
    return ref.current


def judge_extra(ref, traffic: dict, step, element, charge, out: dict) -> dict:
    """With full physics: ``cb_res``, the CB edge in the reference's own
    Laplace system (its scaled residual over the stop tolerance 1e-14);
    ``power_res``, the step's power solution ``m`` in the reference's own
    transmission system, sqrt(r.z / b.b) over the stop tolerance;
    ``imacro_err`` and ``power_err``, I_macro and site power against those
    the reference derives from that solution."""
    if traffic["mode"] != "full":
        return {}
    dev = ref.dev
    nums = {"cb_res": ref_current.cb_residual(out["cb"].to(dev), ref.element0, ref.nbr,
                                              ref.metal, ref.L, step.Vd,
                                              float(ref.ph["G_coeff"]))}
    cur = _current(ref)
    C = cur.coupling(element, charge, step.pre.cb_edge.to(dev))
    nums["power_res"] = cur.residual_ratio(C, step.Vd, out["m"].to(dev),
                                           step.stream["rtol_scale"])
    I_r, p_r = cur.outputs(C, step.Vd, out["m"].to(dev))
    site = torch.zeros(element.shape[0], dtype=torch.float64, device=dev)
    site[cur.atom] = p_r
    nums["imacro_err"] = check.rel(float(out["I_macro"]), I_r)
    nums["power_err"] = (float((out["power"].to(dev) - site).abs().max())
                         / max(float(site.abs().max()), 1e-300))
    return nums


def control_extra(ref, traffic: dict, step, element, charge, dtypes: dict) -> dict:
    """With full physics, the reference's power stage and CB edge in
    ``dtypes["current"]`` in the program's place."""
    if traffic["mode"] != "full":
        return {}
    dev, dtype = ref.dev, dtypes["current"]
    cur = _current(ref)
    C = cur.coupling(element, charge, step.pre.cb_edge.to(dev), dtype)
    m_prev = step.stream["m_prev"]
    m0 = (torch.zeros(cur.n + 2, dtype=torch.float64, device=dev) if m_prev is None
          else m_prev.to(dev))
    m = cur.solve(C, step.Vd, m0, step.stream["rtol_scale"], dtype)
    I_c, p_c = cur.outputs(C, step.Vd, m, dtype)
    site = torch.zeros(element.shape[0], dtype=torch.float64, device=dev)
    site[cur.atom] = p_c
    cb = ref_current.cb_solve(ref.element0, ref.nbr, ref.metal, ref.L, step.Vd,
                              float(ref.ph["G_coeff"]), dtype)
    return {"I_macro": I_c, "power": site, "cb": cb, "m": m.to(torch.float64)}

