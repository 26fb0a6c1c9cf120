"""A disordered 5 nm-sized stand-in deck, written from this package's own
generator.

The 5 nm device's structure file is not in the repository;
``models/crossbar.py::synthetic_stack`` with its defaults (n_yz=24, 10
contact / 20 oxide / 8 Ti / 10 contact slices, the numbers of
``decks/iv_sweep_5nm.txt``) stands in for it: N = 31,088, no DIA form, a
narrow band. ``write_synth_deck`` writes

    <workdir>/synth5nm_n<N_YZ>.xyz   the stack, x shifted by -10 a so that
                                     ``config.default_layers()`` covers it
    <workdir>/deck.txt               the template deck with ``restart_xyz_file``
                                     pointing at that file and the generator's
                                     lattice and contact counts

byte for byte as ``tools/synth5nm_deck.py`` writes them from ``akmc_tpu``, so
both drivers run the same sweep from the same files:

    python -m akmc_tpu_torch.runtime.synth_deck W [--n-yz 24]
    python -m akmc_tpu_torch.runtime.driver W/deck.txt --workdir W/out

``write_heating_deck`` writes a copy of a deck with one of the two heat
models switched on (``solve_heating_global`` or ``solve_heating_local``) and
the heat constants of ``HEAT_CONSTANTS``; ``write_mode_deck`` a copy that
runs the fields only (``perturb_structure = 0``) or the events only
(``solve_potential = 0``); ``write_deck_copy`` one with any keys set.
"""

from __future__ import annotations

import argparse
import os
import re

import numpy as np

from akmc_tpu_torch.lattice import write_xyz_snapshot
from akmc_tpu_torch.models.crossbar import synthetic_stack

SHIFT_SLICES = 10


def write_synth_deck(template: str, workdir: str, n_yz: int = 24) -> str:
    """Write the xyz file and the deck into ``workdir``; returns the deck's
    path. ``template`` is the deck to copy (``decks/iv_sweep_5nm.txt``)."""
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


# the heat-model constants of the toy full-physics tests
# (tests/test_full_physics.py::_full_setup); ``A`` [m^2] is written apart, as the
# deck's y-z cross-section
HEAT_CONSTANTS = {
    "dissipation_constant": "1e-13",
    "t_ox": "5e-9",
    "c_p": "1.92",
    "delta_t": "1e-13",
    "L_char": "3.5e-10",
    "k_th_non_vacancy": "0.5",
    "k_th_vacancies": "5.0",
}


def write_heating_deck(template: str, workdir: str, kind: str) -> str:
    """``template`` with ``solve_heating_<kind> = 1`` (``kind`` is "global" or
    "local"), the other heat model off, the constants of ``HEAT_CONSTANTS`` and
    ``A`` = lattice[1] x lattice[2] of the deck, written to
    ``<workdir>/deck_heating_<kind>.txt``; returns its path."""
    if kind not in ("global", "local"):
        raise ValueError(f"kind is 'global' or 'local', not {kind!r}")
    with open(template) as f:
        text = f.read()
    lattice = re.search(r"(?m)^lattice = (.*)$", text).group(1).split()
    values = {
        "solve_heating_global": "1" if kind == "global" else "0",
        "solve_heating_local": "1" if kind == "local" else "0",
        **HEAT_CONSTANTS,
        "A": f"{float(lattice[1])}e-10 {float(lattice[2])}e-10",
    }
    return write_deck_copy(text, values, os.path.join(workdir, f"deck_heating_{kind}.txt"))


# the deck flags of each mode that runs a part of the superstep
# (kmc_main.cpp gates the field modules on solve_potential and the event step
# on perturb_structure)
MODES = {
    "fields_only": {"perturb_structure": "0", "solve_potential": "1"},
    "events_only": {"perturb_structure": "1", "solve_potential": "0"},
}


def write_mode_deck(template: str, workdir: str, mode: str) -> str:
    """``template`` with the flags of ``MODES[mode]``, written to
    ``<workdir>/deck_<mode>.txt``; returns its path."""
    if mode not in MODES:
        raise ValueError(f"mode is one of {sorted(MODES)}, not {mode!r}")
    with open(template) as f:
        text = f.read()
    return write_deck_copy(text, MODES[mode], os.path.join(workdir, f"deck_{mode}.txt"))


def write_deck_copy(text: str, values: dict, deck: str) -> str:
    """The deck ``text`` with each key of ``values`` set (appended where the
    deck lacks it), written to ``deck``."""
    for key, value in values.items():
        text, n = re.subn(rf"(?m)^{key} = .*$", f"{key} = {value}", text)
        if n > 1:
            raise ValueError(f"the template deck sets {key!r} more than once")
        if n == 0:
            text = text.rstrip("\n") + f"\n{key} = {value}\n"
    os.makedirs(os.path.dirname(deck) or ".", exist_ok=True)
    with open(deck, "w") as f:
        f.write(text)
    return deck


def main(argv=None):
    ap = argparse.ArgumentParser(description="write the disordered stand-in deck, or with "
                                             "--mode a copy of the template in that mode")
    ap.add_argument("workdir")
    ap.add_argument("--n-yz", type=int, default=24)
    ap.add_argument("--template", default=os.path.join("decks", "iv_sweep_5nm.txt"))
    ap.add_argument("--mode", choices=sorted(MODES), default=None)
    args = ap.parse_args(argv)
    if args.mode:
        print(write_mode_deck(args.template, args.workdir, args.mode))
    else:
        print(write_synth_deck(args.template, args.workdir, args.n_yz))


if __name__ == "__main__":
    main()
