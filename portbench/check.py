"""The comparison that decides ``correct``.

After the window has closed, ``memory_peak_bytes`` has been read and the
program's model is freed, the plain reference (``portbench/reference``)
works out the structure's tables again from the raw structure and judges
each sampled step of the window. It follows the program step by step from
the program's own state: a step's input state (the seeded initial state
for a pass's first step) is the program's, and so is the summed potential
on which the reference builds the rates it replays the events on; each
stage that this skips is judged by itself:

* ``k_res``: the program's boundary potential in the reference's own K
  system of the step's charges, sqrt(r.z / b.b) over the upstream stop
  tolerance 1e-14 * n_interface (1: the stop rule just met);
* ``pair_err``: the program's pairwise potential (summed less boundary) at
  sampled sites against the reference's, the largest gap over the largest
  reference value;
* ``charge_mm``, ``elem_mm``: sites whose charge or element differs from the
  reference's (the charge rules; the events replayed by the cell's entry,
  ``entries/<entry>.py::replay``);
* ``events_mm``, ``batches_mm``: the gap in events fired and batches run;
* ``time_err``: the relative gap of the superstep's time;
* whatever more the entry judges (``judge_extra``), such as the power
  layer of a full-physics staircase.

``judge`` takes the outputs to judge as a dict, so that the control (the
reference in a lower precision put in the program's place, ``control.py``)
is judged by the same numbers.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from portbench.reference import events as ref_events
from portbench.reference import fields as ref_fields
from portbench.reference import lattice as ref_lattice

ELEMENT_CODES = {"Ti": 6, "N": 8, "Hf": 4, "O": 3, "Ni": 5, "Pt": 7}


class Reference:
    """The reference's tables of one structure."""

    def __init__(self, structure: dict, physics: dict, device):
        dev = torch.device(device)
        self.dev = dev
        self.ph = physics
        self.pos = torch.as_tensor(structure["pos"], dtype=torch.float64, device=dev)
        self.element0 = torch.as_tensor(structure["element0"], device=dev)
        self.excluded = torch.as_tensor(structure["excluded"], device=dev)
        self.L = int(structure["L"])
        self.nbr = ref_lattice.neighbors(self.pos, float(physics["nn_dist"]), self.excluded)
        codes = torch.tensor([ELEMENT_CODES[m] for m in physics["metals"]], device=dev)
        self.metal = torch.isin(self.element0.to(torch.int64), codes)
        self.k = 8.987552e9 / float(physics["epsilon"])
        self.high_G = float(physics["G_coeff"])
        self.low_G = float(physics["G_coeff"]) * 1e-8
        layers = [dict(start_x=l[4], end_x=l[5]) for l in physics["layers"]]
        self.layer = ref_lattice.layer_ids(self.pos[:, 0], layers)
        self.energies = {name: [l[c] for l in physics["layers"]]
                         for c, name in enumerate(("gen", "rec", "vdiff", "odiff"))}
        self.table = ref_events.Table(self.element0, self.pos, self.nbr, self.layer,
                                      float(physics["sigma"]), self.k)
        self.current = None          # an entry's tables of the power layer, built on demand

    def ksystem(self, element, charge, Vd):
        return ref_fields.KSystem(element, charge, self.nbr, self.metal, self.L, Vd,
                                  self.high_G, self.low_G)

    def pairwise(self, sites, charge, dtype=torch.float64):
        return ref_fields.pairwise(sites, self.pos, charge, float(self.ph["cutoff_radius"]),
                                   float(self.ph["sigma"]), self.k, dtype)

    def replay(self, entry, traffic: dict, element, charge, pot, where: dict,
               dtype=torch.float64):
        """The step's events replayed by the cell's entry on rates built
        from ``pot`` (in ``dtype``, with ``dtype`` clocks): (element,
        charge, events, batches or None, time)."""
        ph = self.ph
        P, etype, ln_S = self.table.rates(element, charge, pot, ph["background_temp"],
                                          self.energies, float(ph["freq"]),
                                          bool(ph["rate_normalize"]), dtype)
        return entry.replay(self, traffic, element, charge, P, etype, ln_S, where, dtype)


def rel(a: float, b: float) -> float:
    if a == b:
        return 0.0
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / max(abs(b), 1e-300)


def program_outputs(step, sites) -> dict:
    """What the program produced at a sampled step."""
    post = step.post
    pb = post.potential_boundary.to(torch.float64)
    out = {"pb": pb, "pair": (post.potential_charge - pb)[sites],
           "element": post.element, "charge": post.charge,
           "events": int(step.stats.get("n_events", 0)),
           "batches": step.stats.get("n_batches"),
           "time": float(step.stats.get("event_time", 0.0))}
    if "I_macro" in step.stats:
        out.update(I_macro=float(step.stats["I_macro"]), power=post.power,
                   cb=step.pre.cb_edge, m=step.stream["m"])
    return out


def _inputs(ref: Reference, step):
    element = step.pre.element.to(ref.dev)
    charge = ref_fields.charges(element, step.pre.charge.to(ref.dev), ref.nbr, ref.metal)
    return element, charge


def judge(ref: Reference, entry, traffic: dict, step, sites, out: dict) -> Dict[str, float]:
    """The numbers of one sampled step for the outputs ``out``."""
    dev = ref.dev
    element, charge = _inputs(ref, step)
    nums = {"k_res": ref.ksystem(element, charge, step.Vd).residual_ratio(out["pb"].to(dev))}
    pair_ref = ref.pairwise(sites, charge)
    scale = float(pair_ref.abs().max())
    nums["pair_err"] = float((out["pair"].to(dev) - pair_ref).abs().max()) / max(scale, 1e-300)
    if hasattr(entry, "judge_extra"):
        nums.update(entry.judge_extra(ref, traffic, step, element, charge, out))
    pot = step.post.potential_charge.to(dev)
    el_r, q_r, n_r, nb_r, t_r = ref.replay(entry, traffic, element, charge, pot, step.stream)
    nums["elem_mm"] = int((out["element"].to(dev) != el_r).sum())
    nums["charge_mm"] = int((out["charge"].to(dev) != q_r).sum())
    nums["events_mm"] = abs(int(out["events"]) - int(n_r))
    if nb_r is not None:
        nums["batches_mm"] = abs(int(out["batches"]) - int(nb_r))
    nums["time_err"] = rel(float(out["time"]), float(t_r))
    return nums


def worst(per_step: List[Dict[str, float]]) -> Dict[str, float]:
    """Over the sampled steps: counts of mismatches add, gaps take the largest."""
    out: Dict[str, float] = {}
    for nums in per_step:
        for name, v in nums.items():
            if name.endswith("_mm"):
                out[name] = out.get(name, 0) + v
            else:
                out[name] = max(out.get(name, -math.inf), v)
    return out


def pair_sites(ref: Reference, seed_value: int, count: int) -> torch.Tensor:
    """Sites at which the pairwise potential is compared, drawn from the
    seed among the structure's real sites."""
    real = torch.nonzero(~ref.excluded).flatten().cpu().numpy()
    rng = np.random.default_rng(seed_value)
    pick = real if count >= len(real) else np.sort(rng.choice(real, size=count, replace=False))
    return torch.as_tensor(pick, device=ref.dev)


def compare(ref: Reference, entry, traffic: dict, samples, sites) -> Dict[str, float]:
    per_step = [judge(ref, entry, traffic, s, sites, program_outputs(s, sites)) for s in samples]
    return worst(per_step)


def verdict(nums: Dict[str, float], limits: Dict[str, float], n_checked: int):
    """(correct, the numbers beside their limits)."""
    checks = {}
    ok = n_checked > 0
    for name, limit in limits.items():
        v = nums.get(name)
        ok = ok and v is not None and v <= limit       # NaN compares false
        checks[name] = {"value": v, "limit": limit}
    checks["steps_checked"] = {"value": n_checked, "limit": 1}
    return ok, checks


def control_outputs(ref: Reference, entry, traffic: dict, step, sites,
                    dtypes: Dict[str, torch.dtype]) -> dict:
    """The reference in lower precisions put in the program's place for one
    step: its K solve from the step's warm start, its pairwise plane, its
    events on rates and clocks of that precision, and whatever more the
    entry puts in (``control_extra``); judged by ``judge``."""
    dev = ref.dev
    element, charge = _inputs(ref, step)
    pb, _ = ref.ksystem(element, charge, step.Vd).solve(step.pre.potential_boundary.to(dev),
                                                         dtypes["k"])
    out = {"pb": pb, "pair": ref.pairwise(sites, charge, dtypes["pair"])}
    if hasattr(entry, "control_extra"):
        out.update(entry.control_extra(ref, traffic, step, element, charge, dtypes))
    pot = step.post.potential_charge.to(dev)
    el, q, n, nb, t = ref.replay(entry, traffic, element, charge, pot, step.stream,
                                 dtype=dtypes["events"])
    out.update(element=el, charge=q, events=n, batches=nb, time=t)
    return out
