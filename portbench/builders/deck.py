"""A configuration that is a deck of the upstream's format
(``parameters.txt``) with its own structure files beside it, loaded as
``runtime/driver.py`` loads a deck: ``config["deck"]`` is the deck's path
under ``configs/``; a ``pristine`` deck draws its vacancies from its own
``rnd_seed``, so the structure is the same in every run and the run's seed
drives the KMC stream only."""

import dataclasses
import os

import numpy as np

from portbench import harness


def build(config: dict, device, model_opts: dict, params: dict) -> harness.Setup:
    import torch

    from akmc_tpu_torch.config import KMCParameters
    from akmc_tpu_torch.lattice import build_lattice
    from akmc_tpu_torch.models.vcm import VCMModel
    from akmc_tpu_torch.rng import ReferenceRNG
    from akmc_tpu_torch.runtime.driver import load_structure
    from akmc_tpu_torch.state import make_device_state, make_substoichiometric

    dev = torch.device(device)
    parts: dict = {}
    deck = harness.HERE / "configs" / config["deck"]

    def structure():
        p = dataclasses.replace(KMCParameters.from_file(str(deck)), **params)
        element, x, y, z = load_structure(p, os.path.dirname(deck))
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
