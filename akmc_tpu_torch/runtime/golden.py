"""Golden trajectories: a driver run's work directory reduced to what two
runs of the same deck must share, and the comparison of two such records.

Both drivers (``akmc_tpu`` and this port) write the same files, so the
record can be taken from either:

    python -m akmc_tpu_torch.runtime.golden <workdir> > golden.json
    python -m akmc_tpu_torch.runtime.golden <golden> <other>

The second form takes two records (a ``.json`` record or a workdir each)
and prints how far the other is from the golden: the largest relative KMC
time difference, the supersteps whose CG iteration counts differ, and the
mismatches ``compare`` finds apart from KMC times.

It holds, per superstep, the bias, the event count, the CG iterations and
the KMC time (from ``metrics.jsonl``), and the element column of the final
snapshot as one digit per site. A full-physics run (``--full-physics``) adds
the current ``I_macro`` [A], the dissipated power ``P_tot`` [W], the
background temperature ``T_bg`` [K], the power CG's tolerance multiplier
``power_rtol_scale`` and its iterations ``power_cg_iterations``.

The record of the two deck modes (``runtime/synth_deck.py::MODES``) is made
from three workdirs of akmc_tpu's driver on the mode decks: the fields-only
sweep with ``--dia-pallas`` (the golden) and without it (its spread), and
the events-only sweep:

    python -m akmc_tpu_torch.runtime.golden --modes FO_PALLAS FO_XLA EO > modes.json

The fields-only part adds the snapshots' potentials (``potentials``) and the
spread between the two matvecs (``spread``).
"""

from __future__ import annotations

import json
import math
import os
import re
import sys

from akmc_tpu_torch.lattice import NAME_TO_ELEMENT


def _final_snapshot(workdir: str) -> str:
    with open(os.path.join(workdir, "output1_0.txt")) as f:
        folders = re.findall(r"^Created folder: (\S+)$", f.read(), re.M)
    folder = os.path.join(workdir, folders[-1])
    steps = [
        int(m.group(1))
        for name in os.listdir(folder)
        if (m := re.fullmatch(r"snapshot_(\d+)\.xyz", name))
    ]
    return os.path.join(folder, f"snapshot_{max(steps)}.xyz")


_KEYS = ("bias", "n_events", "cg_iterations", "kmc_time")
_FULL_PHYSICS_KEYS = ("I_macro", "P_tot", "T_bg", "power_rtol_scale", "power_cg_iterations")


def summarize(workdir: str) -> dict:
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    with open(_final_snapshot(workdir)) as f:
        lines = f.read().splitlines()[2:]
    elements = "".join(str(int(NAME_TO_ELEMENT[ln.split()[0]])) for ln in lines if ln)
    return {
        "supersteps": [
            {k: r[k] for k in _KEYS + _FULL_PHYSICS_KEYS if k in r}
            for r in rows
        ],
        "final_elements": elements,
    }


def _snapshot_potentials(path: str) -> list:
    with open(path) as f:
        return [float(ln.split()[4]) for ln in f.read().splitlines()[2:] if ln.strip()]


def potentials(workdir: str) -> dict:
    """The potential column of each bias point's last snapshot: its sum of
    absolute values per bias point (``abs_sums``), and every value of the
    run's last snapshot (``final``), as the snapshots print them."""
    with open(os.path.join(workdir, "output1_0.txt")) as f:
        folders = re.findall(r"^Created folder: (\S+)$", f.read(), re.M)
    sums = []
    for folder in folders:
        path = os.path.join(workdir, folder)
        last = max(int(m.group(1)) for name in os.listdir(path)
                   if (m := re.fullmatch(r"snapshot_(\d+)\.xyz", name)))
        sums.append(math.fsum(abs(v) for v in _snapshot_potentials(
            os.path.join(path, f"snapshot_{last}.xyz"))))
    return {"abs_sums": sums, "final": _snapshot_potentials(_final_snapshot(workdir))}


def potential_distance(golden: dict, got: dict) -> dict:
    """How far ``got``'s potentials (``potentials``) are from ``golden``'s: the
    largest relative difference of a bias point's sum, and the largest
    absolute difference of a site in the final snapshot [V]."""
    gs, hs = golden["abs_sums"], got["abs_sums"]
    gf, hf = golden["final"], got["final"]
    if len(gs) != len(hs) or len(gf) != len(hf):
        return {"abs_sum_max_rel": math.inf, "final_max_abs": math.inf}
    return {"abs_sum_max_rel": max((_rel(h, g) for g, h in zip(gs, hs)), default=0.0),
            "final_max_abs": max((abs(h - g) for g, h in zip(gf, hf)), default=0.0)}


def modes_record(fields_golden: str, fields_other: str, events: str) -> dict:
    """The golden of the two deck modes out of akmc_tpu's three workdirs (see
    the module docstring), with the fields-only sweep's spread between its
    two matvecs: CG counts per pass and potentials."""
    fo, fo_other = summarize(fields_golden), summarize(fields_other)
    pot, pot_other = potentials(fields_golden), potentials(fields_other)
    return {
        "fields_only": {**fo, "potentials": pot},
        "spread": {
            "cg_iterations_max_abs": max(
                (abs(a["cg_iterations"] - b["cg_iterations"])
                 for a, b in zip(fo["supersteps"], fo_other["supersteps"])), default=0),
            **potential_distance(pot, pot_other),
            "mismatches": compare(fo, fo_other, 0.0),
        },
        "events_only": summarize(events),
    }


def _rel(h: float, g: float) -> float:
    return abs(h - g) / abs(g) if g else (0.0 if h == g else math.inf)


def compare(golden: dict, got: dict, kmc_rtol: float,
            current_rtol: float | None = None, power_rtol: float | None = None) -> list:
    """Mismatches of ``got`` against ``golden`` (empty when they agree):
    superstep count, per-superstep bias and events and the final elements
    exactly, KMC times to ``kmc_rtol``, and, where given, each superstep's
    ``I_macro`` to ``current_rtol`` and ``P_tot`` to ``power_rtol``
    (relative). CG iteration counts are not compared: a last-ulp change of
    the reduction order may move them."""
    bad = []
    gs, hs = golden["supersteps"], got["supersteps"]
    if len(gs) != len(hs):
        bad.append(f"superstep count {len(hs)} != golden {len(gs)}")
    for i, (g, h) in enumerate(zip(gs, hs)):
        if g["bias"] != h["bias"] or g["n_events"] != h["n_events"]:
            bad.append(f"superstep {i}: (bias, events) {h['bias'], h['n_events']} "
                       f"!= golden {g['bias'], g['n_events']}")
        if not math.isclose(h["kmc_time"], g["kmc_time"], rel_tol=kmc_rtol, abs_tol=0.0):
            bad.append(f"superstep {i}: kmc_time {h['kmc_time']!r} != golden "
                       f"{g['kmc_time']!r} (rtol {kmc_rtol})")
        for key, rtol in (("I_macro", current_rtol), ("P_tot", power_rtol)):
            if rtol is not None and not _rel(h[key], g[key]) <= rtol:
                bad.append(f"superstep {i}: {key} {h[key]!r} != golden {g[key]!r} (rtol {rtol})")
    ge, he = golden["final_elements"], got["final_elements"]
    if ge != he:
        diff = sum(a != b for a, b in zip(ge, he)) + abs(len(ge) - len(he))
        bad.append(f"final elements differ at {diff} of {len(ge)} sites")
    return bad


def load(path: str) -> dict:
    """A record from a ``.json`` file, or summarized from a workdir."""
    if os.path.isdir(path):
        return summarize(path)
    with open(path) as f:
        return json.load(f)


def distance(golden: dict, got: dict) -> dict:
    """How far ``got`` is from ``golden``: the largest relative KMC time
    difference, the supersteps whose CG counts differ, the mismatches apart
    from KMC times and, on full-physics records, the largest relative
    ``I_macro`` and ``P_tot`` differences and the power CG's counts side by
    side."""
    gs, hs = golden["supersteps"], got["supersteps"]
    pairs = list(zip(gs, hs))
    rel = [_rel(h["kmc_time"], g["kmc_time"]) for g, h in pairs]
    full = {}
    if pairs and all("I_macro" in g and "I_macro" in h for g, h in pairs):
        full = {
            f"{key}_max_rel": max(_rel(h[key], g[key]) for g, h in pairs)
            for key in ("I_macro", "P_tot")
        }
        full["power_cg_iterations"] = [
            (g["power_cg_iterations"], h["power_cg_iterations"]) for g, h in pairs
        ]
    return {
        "kmc_time_max_rel": max(rel) if rel else None,
        "cg_iterations_differ": [
            (i, g["cg_iterations"], h["cg_iterations"])
            for i, (g, h) in enumerate(zip(gs, hs))
            if g["cg_iterations"] != h["cg_iterations"]
        ],
        "mismatches": compare(golden, got, math.inf),
        **full,
    }


if __name__ == "__main__":
    if sys.argv[1] == "--modes":
        json.dump(modes_record(*sys.argv[2:5]), sys.stdout)     # one line: 30k potentials
    elif len(sys.argv) == 3:
        json.dump(distance(load(sys.argv[1]), load(sys.argv[2])), sys.stdout)
    else:
        json.dump(summarize(sys.argv[1]), sys.stdout, indent=1)
    sys.stdout.write("\n")
