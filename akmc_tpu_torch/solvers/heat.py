"""Temperature solvers, as ``akmc_tpu/solvers/heat.py`` defines them.

Reference: heat_solver.cpp / heat_solver_gpu.cu.

Global (capacitative, analytic — updateTemperatureGlobal, heat_solver.cpp:106-140):
    C_th = A * t_ox * c_p * 1e6                      [J/K]
    a = kappa_diss / C_th
    c = a*T_bg + P_tot / C_th
    T_bg <- c/a + (T_bg - c/a) * exp(-a * dt)

Local (Laplacian site-temperature model — updateLocalTemperature,
heat_solver.cpp:144-303): transient explicit steps or a steady-state solve
over the interface sites, with vacancy-dependent thermal transfer
coefficients. The reference declares but does not ship ``constructLaplacian``
(Device.h:195); the operator is the graph Laplacian of the neighbor network
with the contacts as Dirichlet values, as in akmc_tpu.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, fields

import numpy as np
import torch

from akmc_tpu_torch.lattice import ELEM
from akmc_tpu_torch.solvers.cg import Operator, addresses, jacobi_cg


def update_temperature_global(
    T_bg: torch.Tensor,
    site_power: torch.Tensor,
    event_time,
    dissipation_constant: float,
    background_temp: float,
    t_ox: float,
    A: float,
    c_p: float,
) -> torch.Tensor:
    """Analytic capacitative global heat balance (heat_solver.cpp:106-140).
    The reference uses the current T_bg both as the initial condition and
    inside the steady-state coefficient c (c = a*T_bg + P/C): kept."""
    C_th = A * t_ox * c_p * 1e6
    P_tot = torch.sum(site_power)
    a = dissipation_constant / C_th
    c = a * T_bg + P_tot / C_th
    return c / a + (T_bg - c / a) * torch.exp(-a * torch.as_tensor(event_time, dtype=T_bg.dtype,
                                                                    device=T_bg.device))


def update_temperature_global_discrete(
    T_bg: torch.Tensor,
    site_power: torch.Tensor,
    event_time,
    small_step: float,
    dissipation_constant: float,
    background_temp: float,
    t_ox: float,
    A: float,
    c_p: float,
) -> torch.Tensor:
    """Geometric-series discretization (update_temp_global,
    heat_solver_gpu.cu:43-70): T <- c*(1-a^n)/(1-a) + a^n*T with
    a = 1 - k/C*dt, c = k/C*dt*T_amb + P/C*dt, n = event_time/small_step."""
    C_th = A * t_ox * c_p * 1e6
    P_tot = torch.sum(site_power)
    n_steps = torch.floor(torch.as_tensor(event_time, dtype=T_bg.dtype, device=T_bg.device)
                          / small_step)
    a = -dissipation_constant / C_th * small_step + 1.0
    b = dissipation_constant / C_th * small_step * background_temp
    c = b + P_tot / C_th * small_step
    an = a**n_steps
    return c * (1.0 - an) / (1.0 - a) + an * T_bg


@dataclass
class LocalHeat:
    """Static pieces of the local Laplacian site-temperature model: the
    interface sites (the temperature unknowns) and the neighbor table the
    graph Laplacian runs over,

        (Lap T)_i = sum_j (T_j - T_i)   over nn neighbors j,

    with the contacts entering as Dirichlet values."""

    if_mask: torch.Tensor         # (N,) bool interface-site mask
    neigh_idx: torch.Tensor       # (N, NN) int64
    deg: torch.Tensor             # (N,) f64 interface-neighbor counts
    n_if: int

    def to(self, device) -> "LocalHeat":
        return LocalHeat(**{
            f.name: getattr(self, f.name).to(device)
            if isinstance(getattr(self, f.name), torch.Tensor) else getattr(self, f.name)
            for f in fields(self)
        })


def build_local_heat(neigh_idx, n: int, num_atoms_contact: int) -> LocalHeat:
    """Host-side construction (tensors on the CPU)."""
    neigh_idx = np.asarray(neigh_idx)
    if_mask = np.zeros(n, bool)
    if_mask[num_atoms_contact : n - num_atoms_contact] = True
    valid = neigh_idx >= 0
    nbr_if = if_mask[np.clip(neigh_idx, 0, None)] & valid
    return LocalHeat(
        if_mask=torch.as_tensor(if_mask),
        neigh_idx=torch.as_tensor(neigh_idx, dtype=torch.int64),
        deg=torch.as_tensor(nbr_if.sum(1).astype(np.float64)),
        n_if=int(if_mask.sum()),
    )


def _lap(lh: LocalHeat, t: torch.Tensor) -> torch.Tensor:
    """Graph Laplacian over the interface sites; contacts enter as Dirichlet
    values of t."""
    valid = lh.neigh_idx >= 0
    tj = torch.where(valid, t[lh.neigh_idx.clamp(min=0)], 0.0)
    nbr_sum = torch.sum(tj, dim=1)
    degree = torch.sum(valid, dim=1).to(t.dtype)
    return torch.where(lh.if_mask, nbr_sum - degree * t, 0.0)


def _neg_lap(u, degree, valid, nbr, *, if_mask):
    """-Lap u with Dirichlet-zero contacts, identity on contact rows."""
    uz = torch.where(if_mask, u, 0.0)
    tj = torch.where(valid, uz[nbr], 0.0)
    return torch.where(if_mask, degree * uz - torch.sum(tj, dim=1), u)


def _source(lh, site_power, element, background_temp, nn_dist_m, k_th_interface,
            k_th_vacancies):
    """(src, T_1 - T0): the power injected per interface site, scaled by the
    vacancy-dependent transfer coefficients (heat_solver.cpp:158-161)."""
    T0 = background_temp
    T_1 = T0 + 1000.0
    p_vac = 1.0 / ((nn_dist_m * k_th_interface) * (T_1 - T0))
    p_non = 1.0 / ((nn_dist_m * k_th_vacancies) * (T_1 - T0))
    is_vac = element == int(ELEM.VACANCY)
    coef = torch.where(is_vac, torch.full((), p_vac, dtype=site_power.dtype,
                                          device=site_power.device), p_non)
    return torch.where(lh.if_mask, site_power * coef, 0.0), T_1 - T0


# explicit steps per pass of the transient model's while loop (in a program)
HEAT_PASS_STEPS = 8


def update_temperature_local_ref(
    lh: LocalHeat,
    temperature: torch.Tensor,
    site_power: torch.Tensor,
    element: torch.Tensor,
    step_time,                     # [s] this superstep's event time: a 0-d f64 tensor
    delta_t: float,
    tau: float,
    background_temp: float,
    nn_dist_m: float,
    k_th_interface: float,
    k_th_vacancies: float,
    graphs=None,
) -> torch.Tensor:
    """The reference's Device::updateTemperature LOCAL dispatch
    (heat_solver.cpp:75-97):

      * ``step_time > 1e3 * delta_t``  -> steady-state solve;
      * otherwise                      -> ``int(step_time/delta_t) + 1``
        transient explicit steps of duration ``delta_t`` each (at most 1,001).

    Outside a program the choice and the step count are made on the host,
    from one read of ``step_time`` (a float is taken as it is). Inside one
    (``device_loop.in_program``) they stay on the device, as akmc_tpu's
    ``lax.cond`` keeps them: the transient steps are a while loop of
    ``HEAT_PASS_STEPS`` guarded steps a pass (no pass when steady), the
    steady solve runs under a ``device_loop.cond`` on the same flag, and
    ``torch.where`` picks the branch. Both forms give the same bits.
    ``graphs``: the caller's ``LoopGraphs`` for the steady solve's CG."""
    from akmc_tpu_torch.ops import device_loop

    def steady():
        return update_temperature_local_steady(
            lh, temperature, site_power, element, background_temp,
            nn_dist_m, k_th_interface, k_th_vacancies, graphs=graphs,
        )

    def step(t):
        return t + dt_eff * (_lap(lh, t) + src * scale)

    dt_eff = min(delta_t * tau, 0.2)   # explicit-step stability
    # akmc_tpu's compiled division by the constant delta_t is a multiplication
    # by its reciprocal, which decides the step count where step_time is a
    # multiple of delta_t
    if not device_loop.in_program():
        step_time = float(step_time)
        if step_time > 1e3 * delta_t:
            return steady()
        src, scale = _source(lh, site_power, element, background_temp, nn_dist_m,
                             k_th_interface, k_th_vacancies)
        n_steps = int(np.floor(step_time * (1.0 / delta_t))) + 1
        t = temperature
        for _ in range(n_steps):
            t = step(t)
        return torch.where(lh.if_mask, t, temperature)

    is_steady = step_time > 1e3 * delta_t
    src, scale = _source(lh, site_power, element, background_temp, nn_dist_m,
                         k_th_interface, k_th_vacancies)
    n_steps = torch.where(is_steady, 0,
                          torch.floor(step_time * (1.0 / delta_t)).to(torch.int64) + 1)
    t = temperature.clone()
    i = torch.zeros((), dtype=torch.int64, device=t.device)
    live = i < n_steps

    def transient_pass():
        for _ in range(HEAT_PASS_STEPS):
            on = i < n_steps
            torch.where(on, step(t), t, out=t)
            i.add_(on.to(torch.int64))
        live.copy_(i < n_steps)
    device_loop.while_loop(live, transient_pass)

    t_steady = temperature.clone()
    device_loop.cond(is_steady, lambda: t_steady.copy_(steady()))
    return torch.where(is_steady, t_steady, torch.where(lh.if_mask, t, temperature))


def update_temperature_local(
    lh: LocalHeat,
    temperature: torch.Tensor,     # (N,) [K]
    site_power: torch.Tensor,      # (N,) [W]
    element: torch.Tensor,
    step_time: float,              # [s] superstep duration
    delta_t: float,                # [s] sub-step (p.delta_t)
    tau: float,                    # thermal rate constant [1/s] (p.tau)
    background_temp: float,
    nn_dist_m: float,
    k_th_interface: float,
    k_th_vacancies: float,
    n_substeps: int = 16,
) -> torch.Tensor:
    """Transient local model: a fixed number of explicit diffusion substeps
    covering ``step_time`` (the reference's per-delta_t loop,
    heat_solver.cpp:87-95, with its p_transfer source scaling, 158-161)."""
    src, scale = _source(lh, site_power, element, background_temp, nn_dist_m,
                         k_th_interface, k_th_vacancies)
    # explicit-step stability: scaled into the graph-Laplacian spectral bound
    dt_eff = min((step_time * tau) / n_substeps, 0.2)
    t = temperature
    for _ in range(n_substeps):
        t = t + dt_eff * (_lap(lh, t) + src * scale)
    return torch.where(lh.if_mask, t, temperature)


def update_temperature_local_steady(
    lh: LocalHeat,
    temperature: torch.Tensor,
    site_power: torch.Tensor,
    element: torch.Tensor,
    background_temp: float,
    nn_dist_m: float,
    k_th_interface: float,
    k_th_vacancies: float,
    tol: float = 1e-10,
    graphs=None,
) -> torch.Tensor:
    """Steady-state local model: -Lap T' = src with Dirichlet contacts at
    T_bg (updateLocalTemperatureSteadyState, heat_solver.cpp:235-303, with
    the dense laplacian_ss replaced by CG: the device loop of
    ``solvers/cg.py``, ``graphs`` the caller's ``LoopGraphs``)."""
    src, scale = _source(lh, site_power, element, background_temp, nn_dist_m,
                         k_th_interface, k_th_vacancies)
    valid = lh.neigh_idx >= 0
    degree = torch.sum(valid, dim=1).to(temperature.dtype)
    nbr = lh.neigh_idx.clamp(min=0)
    A = Operator("heat", functools.partial(_neg_lap, if_mask=lh.if_mask), (degree, valid, nbr),
                 addresses(lh.if_mask))

    b = src * scale
    inv_diag = torch.where(lh.if_mask, 1.0 / torch.clamp(degree, min=1.0), 1.0)
    res = jacobi_cg(A, b, torch.zeros_like(b), inv_diag, tol, 20000, graphs=graphs)
    return torch.where(lh.if_mask, background_temp + res.x, temperature)
