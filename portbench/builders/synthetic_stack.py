"""The disordered TiN | HfO2 | Ti | TiN stand-in (``models/crossbar.py::
synthetic_stack``) under a deck of the upstream's format: the stack built
from the configuration's ``builder_args`` with its fixed seed, x shifted by
``runtime/synth_deck.py::SHIFT_SLICES`` slices, and the deck under
``configs/`` (``config["deck"]``) patched in memory as ``write_synth_deck``
patches it (the structure file's name, the lattice and the contact counts
the stack gives). A ``pristine`` deck then draws its vacancies from its own
``rnd_seed``, as the driver does: the structure is the same in every run and
the run's seed drives the KMC stream only."""

import re

import numpy as np

from portbench import harness


def deck_text(text: str, n_yz: int, lattice, patch: dict) -> str:
    """``text`` with the keys ``write_synth_deck`` sets, in its formats."""
    values = {
        "restart_xyz_file": f"synth5nm_n{n_yz}.xyz",
        "lattice": " ".join(f"{float(v):.10g}" for v in lattice),
        "num_atoms_first_layer": str(patch["num_atoms_first_layer"]),
        "num_layers_contact": str(patch["num_layers_contact"]),
        "num_atoms_contact": str(patch["num_atoms_contact"]),
    }
    for key, value in values.items():
        text, n = re.subn(rf"(?m)^{key} = .*$", f"{key} = {value}", text)
        if n != 1:
            raise ValueError(f"the deck must set {key!r} exactly once")
    return text


def build(config: dict, device, model_opts: dict, params: dict) -> harness.Setup:
    import dataclasses

    import torch

    from akmc_tpu_torch.config import KMCParameters
    from akmc_tpu_torch.lattice import build_lattice
    from akmc_tpu_torch.models.crossbar import synthetic_stack
    from akmc_tpu_torch.models.vcm import VCMModel
    from akmc_tpu_torch.rng import ReferenceRNG
    from akmc_tpu_torch.runtime.synth_deck import SHIFT_SLICES
    from akmc_tpu_torch.state import make_device_state, make_substoichiometric

    dev = torch.device(device)
    parts: dict = {}
    args = config["builder_args"]

    def structure():
        element, x, y, z, lattice, patch = synthetic_stack(**args)
        x = x - SHIFT_SLICES * float(args["a"])
        text = (harness.HERE / "configs" / config["deck"]).read_text()
        p = KMCParameters.from_string(deck_text(text, int(args["n_yz"]), lattice, patch))
        p = dataclasses.replace(p, **params)
        if p.pristine:
            element = make_substoichiometric(element, p.initial_vacancy_concentration,
                                             ReferenceRNG(p.rnd_seed))
        return p, element, x, y, z

    p, element, x, y, z = harness.timed(parts, "structure_s", dev, structure)
    harness.check_physics(p, config["physics"])
    lat = harness.timed(parts, "lattice_s", dev, lambda: build_lattice(element, x, y, z, p))
    model = harness.timed(parts, "model_s", dev,
                          lambda: VCMModel(p, lat, device=dev, **model_opts))
    state0 = make_device_state(lat, p.background_temp, model.device)
    structure = dict(pos=np.stack([lat.x, lat.y, lat.z], axis=1), element0=lat.element0.copy(),
                     L=int(p.num_atoms_first_layer), excluded=np.zeros(lat.N, dtype=bool))
    return harness.Setup(model, state0, structure, config["physics"], parts)
