"""The port's heat models against akmc_tpu's on the same numpy inputs: the
global capacitative model (analytic and discrete), the local Laplacian model's
tables and operator, its transient and steady-state updates, and the
reference dispatch between them (both branches)."""

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)
# one PyTorch thread in a process that runs JAX (ROADMAP §3, "CPU test flake")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from akmc_tpu.lattice import ELEM  # noqa: E402
from akmc_tpu.solvers import heat as jheat  # noqa: E402
from akmc_tpu_torch import convert  # noqa: E402
from akmc_tpu_torch.solvers import heat as theat  # noqa: E402

GLOBAL = dict(dissipation_constant=1e-13, background_temp=300.0, t_ox=5e-9, A=2.6e-17, c_p=1.92)
LOCAL = dict(background_temp=300.0, nn_dist_m=3.5e-10, k_th_interface=0.725,
             k_th_vacancies=5.0)


@pytest.fixture(scope="module")
def toy():
    """The toy device's neighbor table, elements with vacancies, and a
    random non-negative site power of 1e-9 W scale."""
    from tests.util_toy import toy_device

    p, lat = toy_device(nx=10, ny=3, nz=3, contact_layers=3)
    rng = np.random.default_rng(11)
    elem = lat.element0.copy()
    elem[rng.random(lat.N) < 0.2] = int(ELEM.VACANCY)
    power = rng.random(lat.N) * 1e-9
    return lat, p.num_atoms_first_layer * 3, elem, power


@pytest.mark.parametrize("event_time", [0.0, 1e-12, 3e-9, 1e3])
def test_global_models_match_akmc_tpu(event_time):
    """update_temperature_global and _discrete: rtol 1e-14 from T_bg = 350 K
    with 1 uW in, from no time to the steady state."""
    power = np.zeros(10)
    power[0] = 1e-6
    tj = jheat.update_temperature_global(jnp.asarray(350.0), jnp.asarray(power), event_time,
                                         **GLOBAL)
    tt = theat.update_temperature_global(torch.tensor(350.0, dtype=torch.float64),
                                         torch.tensor(power), event_time, **GLOBAL)
    np.testing.assert_allclose(float(tt), float(tj), rtol=1e-14)
    dj = jheat.update_temperature_global_discrete(jnp.asarray(350.0), jnp.asarray(power),
                                                  event_time, 1e-13, **GLOBAL)
    dt = theat.update_temperature_global_discrete(torch.tensor(350.0, dtype=torch.float64),
                                                  torch.tensor(power), event_time, 1e-13,
                                                  **GLOBAL)
    np.testing.assert_allclose(float(dt), float(dj), rtol=1e-14)


def test_local_heat_tables_and_laplacian(toy):
    """build_local_heat's masks and degrees exactly; _lap on a random field to
    rtol 1e-14."""
    lat, n_contact, _, _ = toy
    lj = jheat.build_local_heat(lat.neigh_idx, lat.N, n_contact)
    lt = theat.build_local_heat(lat.neigh_idx, lat.N, n_contact)
    assert lt.n_if == lj.n_if
    for name in ("if_mask", "neigh_idx", "deg"):
        np.testing.assert_array_equal(getattr(lt, name).numpy(), np.asarray(getattr(lj, name)))
    assert convert.local_heat(lj).n_if == lt.n_if
    t = 300.0 + np.random.default_rng(1).random(lat.N)
    np.testing.assert_allclose(theat._lap(lt, torch.tensor(t)).numpy(),
                               np.asarray(jheat._lap(lj, jnp.asarray(t))), rtol=1e-14, atol=1e-12)


@pytest.mark.parametrize("step_time", [3e-13, 5e-11, 2e-10], ids=["transient-4",
                                                                    "transient-501", "steady"])
def test_local_dispatch_matches_akmc_tpu(toy, step_time):
    """update_temperature_local_ref on both branches (4 and 501 explicit steps
    of delta_t = 1e-13 s; past 1e3 delta_t the steady-state solve): rtol
    1e-12 on the temperature rise over the background, contacts pinned."""
    lat, n_contact, elem, power = toy
    lj = jheat.build_local_heat(lat.neigh_idx, lat.N, n_contact)
    lt = theat.build_local_heat(lat.neigh_idx, lat.N, n_contact)
    temp = np.full(lat.N, 300.0)
    args = (1e-13, 3e9, *LOCAL.values())
    tj = np.asarray(jheat.update_temperature_local_ref(
        lj, jnp.asarray(temp), jnp.asarray(power), jnp.asarray(elem),
        jnp.asarray(step_time), *args))
    tt = theat.update_temperature_local_ref(lt, torch.tensor(temp), torch.tensor(power),
                                            torch.tensor(elem), step_time, *args).numpy()
    rise = tj - 300.0
    assert rise.max() > 0 and (rise[:n_contact] == 0).all()
    np.testing.assert_allclose(tt - 300.0, rise, rtol=1e-12, atol=1e-12 * rise.max())


def test_local_transient_and_steady_match_akmc_tpu(toy):
    """update_temperature_local (16 substeps) and _steady on their own:
    rtol 1e-12 on the rise; the steady solve takes the same CG path."""
    lat, n_contact, elem, power = toy
    lj = jheat.build_local_heat(lat.neigh_idx, lat.N, n_contact)
    lt = theat.build_local_heat(lat.neigh_idx, lat.N, n_contact)
    temp = 300.0 + np.random.default_rng(5).random(lat.N)
    J = (jnp.asarray(temp), jnp.asarray(power), jnp.asarray(elem))
    T = (torch.tensor(temp), torch.tensor(power), torch.tensor(elem))
    tj = np.asarray(jheat.update_temperature_local(lj, *J, 1e-9, 1e-13, 3e9, *LOCAL.values()))
    tt = theat.update_temperature_local(lt, *T, 1e-9, 1e-13, 3e9, *LOCAL.values()).numpy()
    np.testing.assert_allclose(tt - 300.0, tj - 300.0, rtol=1e-12, atol=1e-12)
    sj = np.asarray(jheat.update_temperature_local_steady(lj, *J, *LOCAL.values()))
    st = theat.update_temperature_local_steady(lt, *T, *LOCAL.values()).numpy()
    rise = sj - 300.0
    np.testing.assert_allclose(st - 300.0, rise, rtol=1e-12,
                               atol=1e-12 * np.abs(rise).max())
