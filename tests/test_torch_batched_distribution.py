"""The batched event loop's law, measured for akmc_tpu_torch: the port's
counterpart of tests/test_batched_distribution.py.

Replicate event loops from one frozen fields state of the toy device give
i.i.d. samples of the loop's two observables, the terminating waiting time and
the executed event count. A two-sample Kolmogorov-Smirnov test holds the
batched sampler (``run_event_loop_batched``) against the serial production
loop (``run_event_loop_native``, the exact residence-time law), both on the
port's own generator (``GeneratorDraws``, one seeded generator per sample).
The samples are drawn once per module.

N_REP = 512 as in akmc_tpu's file, so the critical value is the same: D <
1.949 * sqrt(2 / 512) = 0.1218 at alpha = 1e-3.
"""

import numpy as np
import pytest
import torch
from scipy.stats import ks_2samp

from akmc_tpu.rng import ReferenceRNG as JRNG
from akmc_tpu.state import make_device_state as j_state
from akmc_tpu.state import make_substoichiometric
from akmc_tpu_torch import convert
from akmc_tpu_torch.models.crossbar import toy_device as t_toy_device
from akmc_tpu_torch.models.vcm import VCMModel as TModel
from akmc_tpu_torch.ops.events import (
    GeneratorDraws,
    run_event_loop_batched,
    run_event_loop_native,
)
from akmc_tpu_torch.state import make_device_state as t_state
from tests.util_toy import toy_device

# see tests/test_torch_superstep.py: PyTorch on the calling thread only
torch.set_num_threads(1)

N_REP = 512
# two-sample KS critical D at alpha = 1e-3 with n = m = N_REP:
# c(alpha) * sqrt(2/n), c(1e-3) = sqrt(-ln(alpha/2)/2) = 1.949
KS_CRIT = 1.949 * float(np.sqrt(2.0 / N_REP))


@pytest.fixture(scope="module")
def frozen():
    """One fields pass of the port on the toy device: the frozen rate table
    that every replicate starts from (the toy device as the port makes it,
    which the smoke run on the card uses too)."""
    p, lat = t_toy_device()
    model = TModel(p, lat, device="cpu")
    state = t_state(lat, p.background_temp, "cpu")
    fr = model._fields(state.element, state.charge, state.potential_boundary, state.T_bg, 2.0)
    assert float(fr.P.sum()) > 0.0
    return model, state, fr


@pytest.mark.parametrize("shape", [{}, dict(nx=8, ny=3, nz=3, contact_layers=3, seed=4)],
                         ids=["default", "8x3x3"])
def test_port_toy_device_is_the_tests_toy_device(shape):
    """The port's ``toy_device`` gives the toy device of tests/util_toy.py with a
    fifth of its oxygen made vacancies, parameter for parameter and array for
    array, so the law measured here is that of akmc_tpu's file."""
    p, lat = toy_device(**shape)
    lat.element0[:] = make_substoichiometric(lat.element0, 0.2, JRNG(7))
    want_p, want = convert.params(p), convert.lattice(lat)
    got_p, got = t_toy_device(**shape)
    assert got_p == want_p
    for name, a in vars(want).items():
        b = getattr(got, name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name
    s_want = convert.state(j_state(lat, p.background_temp))
    s_got = t_state(got, got_p.background_temp, "cpu")
    assert torch.equal(s_want.element, s_got.element) and torch.equal(s_want.charge, s_got.charge)


def _sample(frozen, kind, seed, batch=16, **kw):
    model, state, fr = frozen
    t = model.tables
    draws = GeneratorDraws.seeded(seed, "cpu")
    common = dict(act_idx=t.act_idx, abs2act=t.abs2act, ln_S=fr.ln_S)
    times, counts = np.empty(N_REP), np.empty(N_REP, np.int64)
    for i in range(N_REP):
        args = (state.element, fr.charge, fr.P.clone(), fr.etype, t.act_neigh, draws,
                model.params.freq)
        if kind == "serial":
            res = run_event_loop_native(*args, zero_rows=t.act_zero_rows, **common)
        else:
            res = run_event_loop_batched(*args, batch=batch, **common, **kw)
        times[i], counts[i] = res.event_time_h, res.n_events
    assert np.isfinite(times).all(), "rate table died mid-superstep"
    return times, counts


@pytest.fixture(scope="module")
def samples(frozen):
    return {
        "serial": _sample(frozen, "serial", 1),
        "serial-2": _sample(frozen, "serial", 3),
        "eps-1e-3": _sample(frozen, "batched", 2, mass_eps=1e-3),
        "eps-3e-2": _sample(frozen, "batched", 4, mass_eps=3e-2),
        "B4": _sample(frozen, "batched", 5, batch=4, mass_eps=1e-3),
        "clock-f32": _sample(frozen, "batched", 12, mass_eps=1e-3, clock_f32=True),
    }


def _ks(a, b, what):
    d = ks_2samp(a, b).statistic
    assert d < KS_CRIT, f"{what} KS D={d:.4f} >= {KS_CRIT:.4f}"


def _means_agree(c_a, c_b):
    se = np.hypot(c_a.std() / np.sqrt(len(c_a)), c_b.std() / np.sqrt(len(c_b)))
    assert abs(c_a.mean() - c_b.mean()) < 4.0 * se + 1e-12


def test_serial_sampler_is_self_consistent(samples):
    """Two serial samples from different seeds: what the test can resolve."""
    _ks(samples["serial"][0], samples["serial-2"][0], "waiting-time")
    _ks(samples["serial"][1], samples["serial-2"][1], "event-count")
    assert samples["serial"][1].mean() > 1.0          # supersteps of several events


def test_waiting_time_ks_default_eps(samples):
    """Production default mass_eps = 1e-3: the batched terminating-gap law is
    indistinguishable from the serial law (KS at alpha = 1e-3), the event
    counts too (KS is conservative on discrete data), and the mean counts
    agree to sampling error (4 sigma)."""
    (t_ser, c_ser), (t_bat, c_bat) = samples["serial"], samples["eps-1e-3"]
    _ks(t_ser, t_bat, "waiting-time")
    _ks(c_ser, c_bat, "event-count")
    _means_agree(c_ser, c_bat)


def test_waiting_time_ks_bench_eps(samples):
    """mass_eps = 3e-2 (a 3%-per-batch distortion BOUND) stays statistically
    invisible at N = 512: the bound is a worst case."""
    _ks(samples["serial-2"][0], samples["eps-3e-2"][0], "waiting-time")


def test_batched_self_consistency_across_batch_size(samples):
    """B = 4 and B = 16 draw from the same law: the batch size is an
    amortization knob, not a physics knob."""
    _ks(samples["B4"][0], samples["eps-1e-3"][0], "B=4 vs B=16 waiting-time")


def test_waiting_time_ks_clock_f32(samples):
    """clock_f32: the race is exact in law up to f32 rounding, so both
    observables stay indistinguishable from the serial f64 law."""
    (t_ser, c_ser), (t_bat, c_bat) = samples["serial"], samples["clock-f32"]
    _ks(t_ser, t_bat, "waiting-time")
    _ks(c_ser, c_bat, "event-count")
    _means_agree(c_ser, c_bat)
