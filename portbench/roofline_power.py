"""Frozen counts of the power layer's work: one power-CG iteration and one
build of the WKB tunnel blocks, computed from the structure and the state
(the reference's own atom layout, ``reference/transmission.py``), not from
any kernel's layout, so that they read the same work whatever implements it.
The peaks are ``roofline.py``'s (one H100 SXM at 700 W: f64 outside the
tensor cores 34 TFLOP/s, HBM3 3.35 TB/s).

**A power-CG iteration** on n atoms with nv live vacancies and nc window
contacts (the state's counts, not any padded capacity) must at least read
each tunnel block once, 8 B an entry (W_tt nv^2, W_ct nc nv, W_cc nc^2), one
int8 code for each structural nonzero of the atom adjacency (its diagonal
and every neighbor pair, as ``roofline.py`` counts the K operator), and the
f64 vectors x, r, p and the inverse diagonal, writing x, r and p back:
7 * 8 * n bytes. It computes the products (2 flops an entry, W_ct used in
both directions: 4), 2 flops a neighbor nonzero, and 12 flops a row.

**A build of the tunnel blocks** is counted in terms: each eligible
trap-trap and contact-contact pair (unordered, non-neighbors, |dE| of CB
edge above 0.01 eV) one term, each eligible contact-trap pair ceil(|dE| /
0.01 eV) terms (its energy window). A term costs ``TERM_FLOPS`` f64
operations: E2 = E1 - |dE|, E1^1.5 and E2^1.5 (a root and a product each),
their difference, its product with the pair's factor, the exponential and
the sum, each counted as one operation (an exponential or a root costs a
card several).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from portbench.check import ELEMENT_CODES
from portbench.reference import lattice as ref_lattice
from portbench.reference.current import EV_TO_J
from portbench.reference.lattice import ELEM
from portbench.reference.transmission import Transmission, block_rows
from portbench.roofline import PEAK_F64_FLOPS, PEAK_HBM_BYTES

TERM_FLOPS = 10
DE_STEP = EV_TO_J * 0.01


def layout(structure: dict, physics: dict, device) -> Transmission:
    """The reference's atom layout of a raw structure (``harness.Setup.structure``)."""
    dev = torch.device(device)
    pos = torch.as_tensor(structure["pos"], dtype=torch.float64, device=dev)
    element0 = torch.as_tensor(structure["element0"], device=dev)
    excluded = torch.as_tensor(structure["excluded"], device=dev)
    nbr = ref_lattice.neighbors(pos, float(physics["nn_dist"]), excluded)
    codes = torch.tensor([ELEMENT_CODES[m] for m in physics["metals"]], device=dev)
    metal = torch.isin(element0.to(torch.int64), codes)
    return Transmission(element0, pos, nbr, metal, int(structure["L"]), physics)


def power_work(tr: Transmission, element: torch.Tensor) -> dict:
    """n atoms, structural nonzeros of the atom adjacency, live vacancies and
    window contacts of the state ``element`` (sites)."""
    nv = int((element.to(tr.pos.device)[tr.atom] == ELEM["VACANCY"]).sum())
    return {"n": tr.n, "nnz": tr.n + int((tr.nbr >= 0).sum()), "nv": nv,
            "nc": int(tr.contact.shape[0])}


def power_iteration_least_s(work: dict) -> float:
    n, nnz, nv, nc = work["n"], work["nnz"], work["nv"], work["nc"]
    entries = nv * nv + nc * nv + nc * nc
    flops = 2.0 * (nv * nv + nc * nc) + 4.0 * nc * nv + 2.0 * nnz + 12.0 * n
    bytes_ = 8.0 * entries + nnz + 7 * 8.0 * n
    return max(flops / PEAK_F64_FLOPS, bytes_ / PEAK_HBM_BYTES)


def _terms(tr: Transmission, a, b, cb_a, integrate: bool, unordered: bool) -> int:
    total = 0
    pb, cb_b = tr.pos[b], cb_a[b]
    step = block_rows(b.shape[0])
    for s in range(0, a.shape[0], step):
        ia = a[s:s + step]
        pa = tr.pos[ia]
        d2 = (pa[:, None, 0] - pb[None, :, 0]) ** 2
        for k in (1, 2):
            d2 = d2 + (pa[:, None, k] - pb[None, :, k]) ** 2
        dE = torch.abs(cb_a[ia][:, None] - cb_b[None, :])
        ok = (ia[:, None] != b[None, :]) & ~(torch.sqrt(d2) < tr.nn_dist) & (dE > DE_STEP)
        if unordered:
            ok &= ia[:, None] < b[None, :]
        if integrate:
            total += int(torch.ceil(dE[ok] / DE_STEP).sum())
        else:
            total += int(ok.sum())
    return total


def wkb_terms(tr: Transmission, element: torch.Tensor, cb_edge: torch.Tensor) -> dict:
    """Terms of one build of the tunnel blocks on the state ``element`` (sites)
    and the CB edge ``cb_edge`` [J] (sites), by block."""
    dev = tr.pos.device
    ae = element.to(dev)[tr.atom]
    cb_a = cb_edge.to(dev, torch.float64)[tr.atom]
    vac = torch.nonzero(ae == ELEM["VACANCY"]).flatten()
    con = tr.contact
    return {"tt": _terms(tr, vac, vac, cb_a, False, True),
            "cc": _terms(tr, con, con, cb_a, False, True),
            "ct": _terms(tr, con, vac, cb_a, True, False)}


def wkb_build_least_s(terms: dict) -> float:
    return TERM_FLOPS * float(sum(terms.values())) / PEAK_F64_FLOPS


def share_pct(least_s: float, ms: float) -> Optional[float]:
    """The least time as a share of a measured time in ms."""
    if not ms or not math.isfinite(ms):
        return None
    return 100.0 * least_s / (ms * 1e-3)


def measure_work(ctx) -> None:
    """Once a traced run: the spanned pass's own work, in
    ``ctx.measured["power_work"]``. ``spans.py`` times that pass in a
    process of its own, on the stream it draws from the run's seed; here the
    same pass runs again on that stream, on the traced run's own model, after
    the window and untimed, and each of its supersteps gives its power-CG
    iterations, its counts (``power_work``) and its terms (``wkb_terms``, on
    the state and the CB edge it built its blocks from). The port is
    deterministic, so these are the spanned pass's own: the readers set them
    against that pass's spans, a superstep's mean over a superstep's mean."""
    from portbench import harness, spans

    if "power_work" in ctx.measured or ctx.model is None:
        return
    traffic = harness.load("traffic", harness.cell_entry(ctx.cell)["traffic"])
    entry = harness.module("entries", traffic["entry"])
    tr = layout(ctx.setup.structure, ctx.setup.physics, ctx.device)
    steps = []
    for pre, _, stats, _, _ in entry.steps(ctx.setup, traffic, spans._seed(ctx), "spans"):
        steps.append({"iterations": int(stats["power_cg_iterations"]),
                      "power": power_work(tr, pre.element),
                      "terms": wkb_terms(tr, pre.element, pre.cb_edge)})
    ctx.measured["power_work"] = {"steps": steps}


def power_cg_least_s(work: dict) -> float:
    """A superstep's mean least time of its power CG: each superstep's
    iterations times one iteration's least time on its own counts."""
    steps = work["steps"]
    return sum(s["iterations"] * power_iteration_least_s(s["power"]) for s in steps) / len(steps)


def wkb_build_mean_least_s(work: dict) -> float:
    """A superstep's mean least time of its build of the tunnel blocks."""
    steps = work["steps"]
    return sum(wkb_build_least_s(s["terms"]) for s in steps) / len(steps)
