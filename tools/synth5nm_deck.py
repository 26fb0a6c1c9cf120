"""Write the 5 nm-sized disordered stand-in deck, and optionally run it
through akmc_tpu's ELL K operator.

The 5 nm device's structure file is not in the repository, so
``akmc_tpu.models.crossbar.synthetic_stack`` with its defaults (n_yz=24, 10
contact / 20 oxide / 8 Ti / 10 contact slices: the numbers of
``decks/iv_sweep_5nm.txt``) stands in for it. This script writes

    W/synth5nm_n<N_YZ>.xyz   the stack, x shifted by -10 a so that
                             ``config.default_layers()`` covers it
    W/deck.txt               ``decks/iv_sweep_5nm.txt`` with ``restart_xyz_file``
                             pointing at that file and the generator's
                             lattice and contact counts; all else the deck's

so that the normal entry point runs the disordered sweep:

    python tools/synth5nm_deck.py W
    JAX_PLATFORMS=cpu python -m akmc_tpu.runtime.driver W/deck.txt \
        --workdir W/out --cache-dir W/.cache
    python -m akmc_tpu_torch.runtime.golden W/out \
        > akmc_tpu_torch/golden/iv_sweep_synth5nm_n24.json

``akmc_tpu_torch/runtime/synth_deck.py`` writes the same two files byte for
byte from the port's own generator.

``--ell-record OUT.json`` steps ``VCMModel(..., use_dia_k=False,
use_banded_k=False).superstep`` over the deck's bias program (its first
``--ell-bias-points`` points) as ``akmc_tpu.runtime.driver.run`` loops and
writes the trajectory in the format of ``akmc_tpu_torch.runtime.golden``: that
command line has no flag for the K operator, and the distance between the
banded and the ELL record is the yardstick for the port's distance from the
golden.

``--cold-solves`` prints, for the deck's first state at 1 V from a zero start,
the iteration counts of akmc_tpu's banded and ELL K solves and the largest
difference of their potentials, open and with ``pbc = 1``: the yardstick for
the same comparison of the port's two operators on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
DECK = os.path.join(HERE, "decks", "iv_sweep_5nm.txt")
SHIFT_SLICES = 10


def write_synth_deck(workdir: str, n_yz: int = 24, template: str = DECK) -> str:
    """Write the xyz file and the deck into ``workdir``; returns the deck's
    path."""
    from akmc_tpu.lattice import write_xyz_snapshot
    from akmc_tpu.models.crossbar import synthetic_stack

    a = 2.131255
    element, x, y, z, lattice, patch = synthetic_stack(n_yz=n_yz, a=a)
    x = x - SHIFT_SLICES * a
    os.makedirs(workdir, exist_ok=True)
    xyz_name = f"synth5nm_n{n_yz}.xyz"
    zeros = np.zeros(len(element))
    write_xyz_snapshot(os.path.join(workdir, xyz_name), element, x, y, z, zeros, zeros)

    values = {
        "restart_xyz_file": xyz_name,
        "lattice": " ".join(f"{float(v):.10g}" for v in lattice),
        "num_atoms_first_layer": str(patch["num_atoms_first_layer"]),
        "num_layers_contact": str(patch["num_layers_contact"]),
        "num_atoms_contact": str(patch["num_atoms_contact"]),
    }
    with open(template) as f:
        text = f.read()
    for key, value in values.items():
        text, n = re.subn(rf"(?m)^{key} = .*$", f"{key} = {value}", text)
        if n != 1:
            raise ValueError(f"the template deck must set {key!r} exactly once")
    deck = os.path.join(workdir, "deck.txt")
    with open(deck, "w") as f:
        f.write(text)
    return deck


def ell_record(deck: str, bias_points: int | None = None) -> dict:
    """The deck's sweep through the ELL K operator, superstep by superstep
    as ``akmc_tpu.runtime.driver.run`` loops."""
    from akmc_tpu.config import KMCParameters
    from akmc_tpu.lattice import build_lattice
    from akmc_tpu.models.vcm import VCMModel
    from akmc_tpu.rng import BufferedStream, ReferenceRNG
    from akmc_tpu.runtime.driver import load_structure
    from akmc_tpu.state import make_device_state, make_substoichiometric

    p = KMCParameters.from_file(deck)
    element, x, y, z = load_structure(p, os.path.dirname(os.path.abspath(deck)))
    element = make_substoichiometric(
        element, p.initial_vacancy_concentration, ReferenceRNG(p.rnd_seed)
    )
    lat = build_lattice(element, x, y, z, p)
    rate_normalize = max(abs(v) for v in p.V_switch) >= 8.0
    model = VCMModel(p, lat, rate_normalize=rate_normalize,
                     use_dia_k=False, use_banded_k=False)
    assert model.kop is None
    state = make_device_state(lat, p.background_temp)
    stream = BufferedStream(ReferenceRNG(p.rnd_seed_kmc))
    rows = []
    for Vd, t_bias in list(zip(p.V_switch, p.t_switch))[:bias_points]:
        kmc_time = 0.0
        state = state._replace(kmc_time=state.kmc_time * 0.0)
        while kmc_time < t_bias:
            state, stats = model.superstep(state, Vd, stream)
            kmc_time += stats["event_time"]
            rows.append({"bias": Vd, "n_events": stats["n_events"],
                         "cg_iterations": stats["cg_iterations"], "kmc_time": kmc_time})
            print(f"[ELL Vd={Vd}] kmc_time={kmc_time:.5e} events={stats['n_events']} "
                  f"cg={stats['cg_iterations']}", flush=True)
    return {
        "supersteps": rows,
        "final_elements": "".join(str(int(e)) for e in np.asarray(state.element)),
    }


def cold_solves(deck: str) -> list:
    """akmc_tpu's banded against its ELL K solve on the deck's first state."""
    from akmc_tpu.config import KMCParameters
    from akmc_tpu.lattice import build_lattice
    from akmc_tpu.models.vcm import VCMModel
    from akmc_tpu.rng import ReferenceRNG
    from akmc_tpu.runtime.driver import load_structure
    from akmc_tpu.state import make_device_state, make_substoichiometric

    out = []
    for pbc in (False, True):
        p = KMCParameters.from_file(deck).replace(pbc=pbc)
        element, x, y, z = load_structure(p, os.path.dirname(os.path.abspath(deck)))
        element = make_substoichiometric(
            element, p.initial_vacancy_concentration, ReferenceRNG(p.rnd_seed)
        )
        lat = build_lattice(element, x, y, z, p)
        state = make_device_state(lat, p.background_temp)
        pots, row = {}, {"pbc": pbc, "N": lat.N}
        for name, flags in (("banded", {}), ("ell", dict(use_dia_k=False, use_banded_k=False))):
            model = VCMModel(p, lat, rate_normalize=True, pair_table_budget=0, **flags)
            if name == "banded":
                assert model.dia is None and model.banded is not None
                row["band_blocks"] = list(model.banded.blocks.shape)
            fr = model._run_fields(state, 1.0)
            pots[name] = np.asarray(fr.potential_boundary)
            row[f"{name}_iterations"] = int(fr.cg_iterations)
        row["max_abs_banded_minus_ell"] = float(np.abs(pots["banded"] - pots["ell"]).max())
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("workdir")
    ap.add_argument("--n-yz", type=int, default=24)
    ap.add_argument("--ell-record", default=None, metavar="OUT.json")
    ap.add_argument("--ell-bias-points", type=int, default=None)
    ap.add_argument("--cold-solves", action="store_true")
    args = ap.parse_args(argv)
    deck = write_synth_deck(args.workdir, args.n_yz)
    print(deck)
    if args.ell_record:
        with open(args.ell_record, "w") as f:
            json.dump(ell_record(deck, args.ell_bias_points), f, indent=1)
            f.write("\n")
    if args.cold_solves:
        cold_solves(deck)


if __name__ == "__main__":
    main()
