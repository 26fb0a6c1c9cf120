"""The grid-native crossbar stand-in (``models/crossbar.py::
build_grid_crossbar``), built from the configuration's ``builder_args``
with its fixed seed: the same structure in every run."""

import dataclasses

import numpy as np

from portbench import harness


def build(config: dict, device, model_opts: dict, params: dict) -> harness.Setup:
    import torch

    from akmc_tpu_torch.lattice import ELEM
    from akmc_tpu_torch.models.crossbar import build_grid_crossbar
    from akmc_tpu_torch.models.vcm import VCMModel
    from akmc_tpu_torch.state import make_device_state

    dev = torch.device(device)
    parts: dict = {}
    p, lat = harness.timed(parts, "structure_s", dev,
                           lambda: build_grid_crossbar(**config["builder_args"]))
    p = dataclasses.replace(p, **params)
    harness.check_physics(p, config["physics"])
    model = harness.timed(parts, "model_s", dev,
                          lambda: VCMModel(p, lat, device=dev, **model_opts))
    state0 = make_device_state(lat, p.background_temp, model.device)
    structure = dict(pos=np.stack([lat.x, lat.y, lat.z], axis=1), element0=lat.element0.copy(),
                     L=int(p.num_atoms_first_layer),
                     excluded=lat.element0 == int(ELEM.NULL_ELEMENT))
    return harness.Setup(model, state0, structure, config["physics"], parts)
