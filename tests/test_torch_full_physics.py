"""The port's full-physics superstep and driver against akmc_tpu's: the
fused order (power on this superstep's charge, heat over its event time),
both heat models, the power CG's tolerance multiplier, and the two drivers'
``--full-physics`` sweeps on the synthesized n_yz = 6 crossbar.

The toy device is that of ``tests/test_full_physics.py::_full_setup``."""

import json
import os
import re

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)
# one PyTorch thread in a process that runs JAX (ROADMAP §3, "CPU test flake")
torch.set_num_threads(1)

from akmc_tpu.models.vcm import VCMModel as JModel  # noqa: E402
from akmc_tpu.rng import BufferedStream, ReferenceRNG  # noqa: E402
from akmc_tpu.state import make_device_state  # noqa: E402
from akmc_tpu_torch import convert  # noqa: E402
from akmc_tpu_torch.models.vcm import VCMModel as TModel  # noqa: E402
from akmc_tpu_torch.rng import BufferedStream as TStream  # noqa: E402
from akmc_tpu_torch.rng import ReferenceRNG as TRNG  # noqa: E402
from akmc_tpu_torch.runtime import driver as tdriver  # noqa: E402
from akmc_tpu_torch.runtime import golden  # noqa: E402
from tests.test_full_physics import _full_setup  # noqa: E402

DECK = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "decks",
                    "iv_sweep_5nm.txt")
VD = 2.0


def _models(heating):
    p, lat = _full_setup(heating)
    jm = JModel(p, lat, vmax=64, ne_max=512)
    tm = TModel(convert.params(p), convert.lattice(lat), device="cpu", vmax=64, ne_max=512)
    js = jm.update_cb_edge(make_device_state(lat, p.background_temp), VD)
    ts = tm.update_cb_edge(convert.state(make_device_state(lat, p.background_temp)), VD)
    return p, jm, tm, js, ts


@pytest.mark.parametrize("heating", ["global", "local"])
def test_superstep_full_matches_akmc_tpu(heating):
    """Three full-physics supersteps from the same state and stream: events,
    elements and the power CG's counts equal; I_macro to rtol 1e-6 and P_tot
    to 1e-8 (the CGs differ in the order of their sums only; the K-CG may
    stop an iteration apart, which moves the event time by ~2e-7); the heat
    model's rise over 300 K to 1e-6 (T_bg, or the temperature vector, which
    must move). The port runs them through its program (one read a
    superstep) and through the per-loop path (``step_program=False``): the
    two give the same bits."""
    p, jm, tm, js, ts = _models(heating)
    lm = TModel(tm.params, tm.lat, device="cpu", vmax=64, ne_max=512, step_program=False)
    ls = ts
    jstream, tstream, lstream = (BufferedStream(ReferenceRNG(1)), TStream(TRNG(1)),
                                 TStream(TRNG(1)))
    mj = mt = ml = None
    for _ in range(3):
        js, sj, mj = jm.superstep_full(js, VD, jstream, m_prev=mj)
        ts, st, mt = tm.superstep_full(ts, VD, tstream, m_prev=mt)
        ls, sl, ml = lm.superstep_full(ls, VD, lstream, m_prev=ml)
        assert sl == st and torch.equal(ml, mt)
        for name in ("element", "charge", "kmc_time", "power", "temperature", "T_bg"):
            assert torch.equal(getattr(ls, name), getattr(ts, name)), name
        for key in ("n_events", "power_cg_iterations"):
            assert st[key] == sj[key], key
        np.testing.assert_allclose(st["event_time"], sj["event_time"], rtol=1e-6)
        np.testing.assert_allclose(st["I_macro"], sj["I_macro"], rtol=1e-6)
        np.testing.assert_allclose(st["P_tot"], sj["P_tot"], rtol=1e-8)
        np.testing.assert_allclose(st["T_bg"] - 300.0, sj["T_bg"] - 300.0, rtol=1e-6)
        assert float(ts.T_bg) == st["T_bg"]
    assert tm.step_counts["runs"] == 3 and lm.step_counts["per_loop"] == 3
    np.testing.assert_array_equal(ts.element.numpy(), np.asarray(js.element))
    np.testing.assert_allclose(ts.power.numpy(), np.asarray(js.power), rtol=1e-6,
                               atol=1e-8 * np.abs(np.asarray(js.power)).max())
    rise_j = np.asarray(js.temperature) - 300.0
    if heating == "local":
        assert np.abs(rise_j).max() > 0 and st["T_bg"] == 300.0
    else:
        assert st["T_bg"] > 300.0 and np.abs(rise_j).max() == 0.0
    np.testing.assert_allclose(ts.temperature.numpy() - 300.0, rise_j, rtol=1e-6,
                               atol=1e-6 * np.abs(rise_j).max())


def test_fused_order_and_rtol_scale():
    """superstep_full solves the power on THIS superstep's charge: its
    I_macro equals update_power on the charge the fields computed (rtol
    1e-12), not on the stale charge. A tighter rtol_scale (argument or the
    model's power_rtol_scale) runs more power-CG iterations, as many as
    akmc_tpu's, and the tightened currents agree to 1e-6."""
    p, jm, tm, js, ts = _models("global")
    fr = tm.fields(ts, VD)
    _, I_this, _, _ = tm.update_power(ts.replace(charge=fr.charge), VD)
    _, I_stale, _, _ = tm.update_power(ts, VD)
    assert I_this != I_stale
    _, stats, m = tm.superstep_full(ts, VD, TStream(TRNG(1)))
    np.testing.assert_allclose(stats["I_macro"], I_this, rtol=1e-12)
    assert m.shape == (tm.n_atom + 2,)

    _, I_loose, _, it_loose = tm.update_power(ts, VD)
    _, I_tight, _, it_tight = tm.update_power(ts, VD, rtol_scale=1e-4)
    _, _, _, it_tight_j = jm.update_power(js, VD, rtol_scale=1e-4)
    assert it_tight > it_loose and it_tight == it_tight_j
    np.testing.assert_allclose(I_loose, I_tight, rtol=1e-3)
    tm.power_rtol_scale = 1e-4
    _, I_attr, _, it_attr = tm.update_power(ts, VD)
    assert it_attr == it_tight and I_attr == I_tight


def _log_lines(workdir):
    """output1_0.txt without the timing lines (wall clocks)."""
    with open(os.path.join(workdir, "output1_0.txt")) as f:
        return [ln for ln in f.read().splitlines() if "calculation time" not in ln
                and not ln.startswith("Total code")]


# akmc_tpu's own band-against-gather spread of I_macro on this sweep is 1.40e-2
# (tools/full_physics_golden.py --n-yz 6); the port reads 2.79e-2 from akmc_tpu:
# I_macro (1e-14 A here) is a cancellation of virtual potentials that the
# power CG fixes only to its stop tolerance, so two CGs whose sums differ in
# order stop on different currents. The bound is that reading, rounded up.
CURRENT_RTOL_N6 = 5e-2


def test_drivers_full_physics_n6(tmp_path):
    """Both drivers with --full-physics on the whole n_yz = 6 sweep: every log
    line apart from the wall clocks equal, the Current [uA] and Conductance
    [uS] lines at the same places with values within CURRENT_RTOL_N6, events,
    superstep count and final elements exact, KMC times to 1e-10, P_tot to
    1e-8 and the power-CG counts equal."""
    _drivers_full_physics_n6(tmp_path, 1)


def test_drivers_full_physics_n6_steps_per_dispatch(tmp_path):
    """The same with --steps-per-dispatch 2 (superstep_full_multi in both
    drivers; the port's batches run as one program each)."""
    _drivers_full_physics_n6(tmp_path, 2)


def _drivers_full_physics_n6(tmp_path, spd):
    from akmc_tpu.runtime import driver as jdriver

    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jdriver.run(DECK, workdir=str(jdir), synthesize_crossbar=6, committed_parity=False,
                log=False, steps_per_dispatch=spd)
    summary = tdriver.run(DECK, workdir=str(tdir), synthesize_crossbar=6,
                          committed_parity=False, device="cpu", log=False,
                          steps_per_dispatch=spd)
    lj, lt = _log_lines(jdir), _log_lines(tdir)
    value = re.compile(r"^(Current \[uA\]|Conductance \[uS\]): (\S+)$")
    assert len(lj) == len(lt)
    n_current = 0
    for a, b in zip(lj, lt):
        ma, mb = value.match(a), value.match(b)
        if ma:
            n_current += ma.group(1) == "Current [uA]"
            assert mb and mb.group(1) == ma.group(1), (a, b)
            np.testing.assert_allclose(float(mb.group(2)), float(ma.group(2)),
                                       rtol=CURRENT_RTOL_N6)
        else:
            assert a == b
    rj, rt = golden.summarize(str(jdir)), golden.summarize(str(tdir))
    assert n_current == len(rj["supersteps"]) == summary["total_steps"]
    assert golden.compare(rj, rt, 1e-10, current_rtol=CURRENT_RTOL_N6, power_rtol=1e-8) == []
    dist = golden.distance(rj, rt)
    assert all(a == b for a, b in dist["power_cg_iterations"])
    assert [r["power_rtol_scale"] for r in rt["supersteps"]] == [
        r["power_rtol_scale"] for r in rj["supersteps"]]
    assert summary["k_solves"] == len(rt["supersteps"])


def test_driver_full_physics_flags(tmp_path):
    """--wkb-f32 and a fixed --power-rtol-scale are accepted and reach the
    metrics; a global-heating deck writes the power and temperature lines."""
    from akmc_tpu_torch.runtime.synth_deck import write_heating_deck

    common = ["--synthesize-crossbar", "6", "--full-physics", "--device", "cpu",
              "--max-supersteps", "2"]
    tdriver.main([DECK, "--workdir", str(tmp_path / "f32"), "--wkb-f32",
                  "--power-rtol-scale", "0.01"] + common)
    with open(tmp_path / "f32" / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["power_rtol_scale"] for r in rows] == [0.01, 0.01]
    assert all(np.isfinite(r["I_macro"]) and r["P_tot"] > 0 for r in rows)

    deck = write_heating_deck(DECK, str(tmp_path), "global")
    tdriver.main([deck, "--workdir", str(tmp_path / "heat")] + common)
    with open(tmp_path / "heat" / "output1_0.txt") as f:
        text = f.read()
    assert len(re.findall(r"^Total dissipated power \[mW\]: \S+$", text, re.M)) == 2
    temps = re.findall(r"^Global temperature \[K\]: (\d+\.\d{16})$", text, re.M)
    assert len(temps) == 2 and float(temps[-1]) > 300.0
    assert torch.get_default_dtype() == torch.float32
