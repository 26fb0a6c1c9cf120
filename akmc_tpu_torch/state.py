"""Mutable simulation state: one dataclass of tensors on the run's device.

f64 for all field vectors (the CG tolerances of 1e-14·N demand it,
potential_solver_gpu.cu:885), int32 for discrete per-site attributes.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from akmc_tpu_torch.lattice import ELEM, Lattice
from akmc_tpu_torch.rng import ReferenceRNG


@dataclass
class DeviceState:
    """Per-site dynamic state (reference: Device.h:85-107 field vectors)."""

    element: torch.Tensor             # (N,) int32 element codes
    charge: torch.Tensor              # (N,) int32 site charges
    potential_boundary: torch.Tensor  # (N,) f64 [V] solution of the K system
    potential_charge: torch.Tensor    # (N,) f64 [V] pairwise + summed potential
    power: torch.Tensor               # (N,) f64 [W] dissipated power
    temperature: torch.Tensor         # (N,) f64 [K]
    cb_edge: torch.Tensor             # (N,) f64 [J] conduction-band edge
    T_bg: torch.Tensor                # ()  f64 [K] global background temperature
    kmc_time: torch.Tensor            # ()  f64 [s] elapsed time at this bias point

    def replace(self, **changes) -> "DeviceState":
        return dataclasses.replace(self, **changes)


def make_device_state(
    lat: Lattice, background_temp: float, device: torch.device
) -> DeviceState:
    n = lat.N
    f64 = dict(dtype=torch.float64, device=device)
    return DeviceState(
        element=torch.as_tensor(lat.element0, dtype=torch.int32, device=device),
        charge=torch.zeros(n, dtype=torch.int32, device=device),
        potential_boundary=torch.zeros(n, **f64),
        potential_charge=torch.zeros(n, **f64),
        power=torch.zeros(n, **f64),
        temperature=torch.full((n,), float(background_temp), **f64),
        cb_edge=torch.zeros(n, **f64),
        T_bg=torch.tensor(float(background_temp), **f64),
        kmc_time=torch.tensor(0.0, **f64),
    )


def make_substoichiometric(
    element: np.ndarray,
    vacancy_concentration: float,
    rng: ReferenceRNG,
) -> np.ndarray:
    """Convert an initial fraction of O atoms to vacancies using the Device
    RNG stream — draw-for-draw identical to the reference
    (Device.cpp:180-211): draws index into the *atom* (non-defect) list and
    retries until enough O sites were hit."""
    element = element.copy()
    atom_ind = np.nonzero(
        (element != int(ELEM.DEFECT)) & (element != int(ELEM.OXYGEN_DEFECT))
    )[0]
    n_atom = len(atom_ind)
    atom_element = element[atom_ind].copy()
    num_o = int((element == int(ELEM.O)).sum())
    num_v_add = int(vacancy_concentration * num_o)
    while num_v_add > 0:
        loc = int(rng.one() * n_atom)
        if atom_element[loc] == int(ELEM.O):
            atom_element[loc] = int(ELEM.VACANCY)
            element[atom_ind[loc]] = int(ELEM.VACANCY)
            num_v_add -= 1
    return element
