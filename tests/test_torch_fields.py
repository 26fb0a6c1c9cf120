"""The superstep's fields on every structure: the port's ``VCMModel`` against
akmc_tpu's on the CPU, for each K operator (DIA, banded, ELL) and each
pairwise path (static table, tiled, on-the-fly) a constructor flag can force,
with open and periodic boundaries, through ``_fields``, ``superstep`` and the
driver.

Integer state (charges, event types, events, elements, draws consumed) must be
equal. Potentials agree to 1e-8 and KMC times to 1e-6 where the K-CG of both
packages stops at the same iteration; tests/test_torch_banded.py says why a
stop can move, and the devices here are ones where it does not. The DIA solve
is the exception: the port reduces its dot products in the blocked order of
its fused kernel (tests/test_torch_dia_cg.py), so its count may differ from
akmc_tpu's by a few.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from akmc_tpu.lattice import build_lattice as j_build_lattice
from akmc_tpu.models.crossbar import build_grid_crossbar, synthetic_stack
from akmc_tpu.models.vcm import VCMModel as JModel
from akmc_tpu.rng import BufferedStream as JStream
from akmc_tpu.rng import ReferenceRNG as JRNG
from akmc_tpu.runtime import driver as jdriver
from akmc_tpu.state import make_device_state as j_state
from akmc_tpu.state import make_substoichiometric
from akmc_tpu_torch import convert
from akmc_tpu_torch.models.vcm import VCMModel as TModel
from akmc_tpu_torch.rng import BufferedStream as TStream
from akmc_tpu_torch.rng import ReferenceRNG as TRNG
from akmc_tpu_torch.runtime import driver as tdriver
from akmc_tpu_torch.runtime import golden, synth_deck
from tests.test_driver import _write_toy_deck
from tests.util_toy import toy_device

# see tests/test_torch_superstep.py: PyTorch on the calling thread only
torch.set_num_threads(1)

KMC_RTOL = 1e-6
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

K_FLAGS = {"dia": {}, "banded": dict(use_dia_k=False),
           "ell": dict(use_dia_k=False, use_banded_k=False)}
PAIR_FLAGS = {"table": {}, "tiled": dict(pair_table_budget=0, pair_tiling_min_n=1),
              "on_the_fly": dict(pair_table_budget=0)}


def _toy(pbc=False, cfg=(10, 4, 4, 2, 0.1, 5)):
    nx, ny, nz, cl, conc, seed = cfg
    p, lat = toy_device(nx=nx, ny=ny, nz=nz, contact_layers=cl)
    p = p.replace(pbc=pbc)
    element = make_substoichiometric(lat.element0, conc, JRNG(seed))
    return p, j_build_lattice(element, lat.x, lat.y, lat.z, p)


def _stack():
    """synthetic_stack(n_yz=6) as tests/test_crossbar.py sets it up."""
    from akmc_tpu.config import KMCParameters, Layer

    e, x, y, z, latt, patch = synthetic_stack(
        n_yz=6, contact_slices=3, oxide_slices=6, ti_slices=2,
        vacancy_defect_fraction=0.3, seed=1)
    layers = [
        Layer("contact", 0.0, 0.0, 0.0, 0.76, x.min() - 1, x.min() + 3 * 2.14),
        Layer("oxide", 1.5, 0.1, 1.09, 0.76, x.min() + 3 * 2.14, x.max() - 5 * 2.14),
        Layer("contact", 1.73, 0.0, 0.0, 2.8, x.max() - 5 * 2.14, x.max() + 1),
    ]
    p = KMCParameters(
        lattice=list(latt), nn_dist=2.14 * 1.3, metals=["Ti", "N"],
        num_atoms_first_layer=patch["num_atoms_first_layer"],
        num_layers_contact=patch["num_layers_contact"], layers=layers,
        max_num_neighbors=32, cutoff_radius=8.0, solve_potential=True,
        perturb_structure=True, freq=10e13)
    e = make_substoichiometric(e, 0.1, JRNG(4))
    return p, j_build_lattice(e, x, y, z, p)


def _models(p, lat, **kw):
    return JModel(p, lat, **kw), TModel(convert.params(p), convert.lattice(lat), device="cpu", **kw)


def _choice(jm):
    k = "dia" if jm.dia is not None else "banded" if jm.banded is not None else "ell"
    pair = ("table" if jm.tables.pair_gT is not None
            else "tiled" if jm.tables.pair_tiling is not None else "on_the_fly")
    return k, pair


@pytest.mark.parametrize("pair", list(PAIR_FLAGS))
@pytest.mark.parametrize("kop", list(K_FLAGS))
def test_fields_for_each_operator_and_pairwise_path(kop, pair):
    p, lat = _toy()
    jm, tm = _models(p, lat, **K_FLAGS[kop], **PAIR_FLAGS[pair])
    d = tm.describe()
    assert (d["k_operator"], d["pairwise"]) == _choice(jm) == (kop, pair)
    assert (tm.qmax, tm.vmax, tm.pair_cand_cap) == (jm.qmax, jm.vmax, jm.pair_cand_cap)
    assert isinstance(tm.kop, type(None)) == (jm.kop is None)
    js = j_state(lat, p.background_temp)
    ts = convert.state(js)
    jf = jm._run_fields(js, 2.0)
    tf = tm._fields(ts.element, ts.charge, ts.potential_boundary, ts.T_bg, 2.0)
    np.testing.assert_array_equal(tf.charge.numpy(), np.asarray(jf.charge))
    np.testing.assert_array_equal(tf.etype.numpy(), np.asarray(jf.etype))
    if kop == "dia":
        assert abs(tf.cg_iterations - int(jf.cg_iterations)) <= 3
    else:
        assert tf.cg_iterations == int(jf.cg_iterations)
    # this device's K system is a benign one (35 CG iterations); readings:
    # potentials <= 1.6e-15 apart, rates <= 7.1e-14 relative
    np.testing.assert_allclose(tf.potential_boundary.numpy(), np.asarray(jf.potential_boundary),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(tf.potential_sum.numpy(), np.asarray(jf.potential_sum),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(tf.P.numpy(), np.asarray(jf.P), rtol=1e-9, atol=0)
    assert not (bool(tf.q_overflow) or bool(tf.v_overflow) or bool(tf.c_overflow))
    assert float(tf.P.sum()) > 0


def _run_both(jm, tm, p, lat, biases, seed=1):
    js = j_state(lat, p.background_temp)
    ts = convert.state(js)
    jstream, tstream = JStream(JRNG(seed)), TStream(TRNG(seed))
    jstats, tstats = [], []
    for Vd in biases:
        js, a = jm.superstep(js, Vd, jstream)
        ts, b = tm.superstep(ts, Vd, tstream)
        jstats.append(a)
        tstats.append(b)
        assert b["n_events"] == a["n_events"]
        assert tstream.peek(1)[0] == jstream.peek(1)[0]           # same draws consumed
        np.testing.assert_array_equal(ts.element.numpy(), np.asarray(js.element))
        np.testing.assert_array_equal(ts.charge.numpy(), np.asarray(js.charge))
    return js, ts, jstats, tstats


STRUCTURES = {
    "toy-open-banded": (lambda: _toy(False), dict(use_dia_k=False), "banded"),
    "toy-pbc-banded": (lambda: _toy(True), dict(use_dia_k=False), "banded"),
    "toy-open-ell": (lambda: _toy(False), dict(use_dia_k=False, use_banded_k=False), "ell"),
    "toy-pbc-ell": (lambda: _toy(True), dict(use_dia_k=False, use_banded_k=False), "ell"),
    "toy-pbc-default": (lambda: _toy(True), {}, None),
    # at n_yz=6 the stack still has few enough K offsets for a DIA form
    "stack-n6-default": (_stack, {}, "dia"),
    "stack-n6-banded": (_stack, dict(use_dia_k=False), "banded"),
    "stack-n6-banded-on-the-fly": (_stack, dict(use_dia_k=False, pair_table_budget=0), "banded"),
}


@pytest.mark.parametrize("name", list(STRUCTURES))
def test_supersteps_match(name):
    """Four supersteps from the same state and mt19937 stream: events,
    draws, elements and charges equal; CG counts equal; KMC time to 1e-6."""
    make, kw, want_k = STRUCTURES[name]
    p, lat = make()
    jm, tm = _models(p, lat, **kw)
    assert tm.describe()["k_operator"] == _choice(jm)[0]
    if want_k:
        assert tm.describe()["k_operator"] == want_k
    js, ts, jstats, tstats = _run_both(jm, tm, p, lat, (2.0, 2.0, 3.0, 3.0))
    assert sum(s["n_events"] for s in tstats) >= 4
    if tm.dia is None:
        assert [s["cg_iterations"] for s in tstats] == [s["cg_iterations"] for s in jstats]
    for a, b in zip(jstats, tstats):
        assert b["event_time"] == pytest.approx(a["event_time"], rel=KMC_RTOL)
    assert float(ts.kmc_time) == pytest.approx(float(js.kmc_time), rel=KMC_RTOL)
    np.testing.assert_allclose(ts.potential_charge.numpy(), np.asarray(js.potential_charge),
                               rtol=1e-8, atol=1e-8)


def test_grid_crossbar_production_path():
    """The pinned case of tests/test_crossbar.py: DIA operator, tiled
    pairwise, shifted-exponent rates at 15 V. The events are akmc_tpu's pinned
    ones; the DIA CG counts may move by a few (blocked dot order)."""
    p, lat = build_grid_crossbar(n_yz=8, contact_slices=3, oxide_slices=8, ti_slices=3,
                                 defect_fraction=0.2, vacancy_concentration=0.1, seed=11)
    jm, tm = _models(p, lat, rate_normalize=True, pair_table_budget=0, pair_tiling_min_n=1)
    assert tm.dia is not None and tm.tables.pair_tiling is not None
    assert tm.pair_cand_cap == jm.pair_cand_cap and tm._pair_r_tile == jm._pair_r_tile
    js, ts, jstats, tstats = _run_both(jm, tm, p, lat, (15.0, 15.0, 15.0), seed=2)
    assert [s["n_events"] for s in tstats] == [13, 13, 15]
    for a, b in zip(jstats, tstats):
        assert abs(b["cg_iterations"] - a["cg_iterations"]) <= 3
    assert float(ts.kmc_time) == pytest.approx(457.239148068819, rel=KMC_RTOL)


@pytest.mark.parametrize("pair_f32", [False, True], ids=["f64", "f32-plane"])
def test_tiled_path_f32_plane_runs(pair_f32):
    p, lat = _toy()
    tm = TModel(convert.params(p), convert.lattice(lat), device="cpu", pair_table_budget=0,
                pair_tiling_min_n=1, pair_f32=pair_f32)
    ref = TModel(convert.params(p), convert.lattice(lat), device="cpu")
    s0 = convert.state(j_state(lat, p.background_temp))
    a = tm._fields(s0.element, s0.charge, s0.potential_boundary, s0.T_bg, 2.0)
    b = ref._fields(s0.element, s0.charge, s0.potential_boundary, s0.T_bg, 2.0)
    tol = dict(rtol=2e-5, atol=2e-6) if pair_f32 else dict(rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(a.potential_sum.numpy(), b.potential_sum.numpy(), **tol)
    assert pair_f32 == (not torch.allclose(a.potential_sum, b.potential_sum, rtol=1e-12,
                                           atol=1e-15))      # the flag reaches the plane


def test_caps_grow_and_match():
    """qmax, vmax and the tiled path's candidate cap below the population:
    each overflow is flagged, the cap doubles, the fields are recomputed, and
    the trajectory is the roomy model's (tests/test_cap_growth.py)."""
    p, lat = _toy(cfg=(10, 4, 4, 2, 0.2, 7))
    tp_, tl = convert.params(p), convert.lattice(lat)
    tiled = dict(pair_table_budget=0, pair_tiling_min_n=1, use_dia_k=False)

    def run(model):
        state = convert.state(j_state(lat, p.background_temp))
        stream = TStream(TRNG(1))
        events = []
        for _ in range(4):
            state, stats = model.superstep(state, 2.0, stream)
            events.append(stats["n_events"])
        return state, events

    roomy = TModel(tp_, tl, device="cpu", **tiled)
    small = TModel(tp_, tl, device="cpu", qmax=8, vmax=8, pair_cand_cap=2, **tiled)
    table = TModel(tp_, tl, device="cpu", use_dia_k=False)
    assert roomy.tables.pair_tiling is not None and table.tables.pair_table is not None
    s_r, ev_r = run(roomy)
    s_s, ev_s = run(small)
    s_t, ev_t = run(table)
    assert small.qmax > 8 and small.vmax > 8 and small.pair_cand_cap > 2
    assert ev_s == ev_r == ev_t and sum(ev_r) >= 4
    for s in (s_s, s_t):
        assert torch.equal(s.element, s_r.element) and torch.equal(s.charge, s_r.charge)
    assert float(s_s.kmc_time) == float(s_r.kmc_time)          # same arithmetic once grown
    assert float(s_t.kmc_time) == pytest.approx(float(s_r.kmc_time), rel=1e-12)

    # akmc_tpu grows the same caps on the same device
    jm = JModel(p, lat, qmax=8, vmax=8, pair_cand_cap=2, **tiled)
    js, stream = j_state(lat, p.background_temp), JStream(JRNG(1))
    for _ in range(4):
        js, _ = jm.superstep(js, 2.0, stream)
    assert (small.qmax, small.vmax, small.pair_cand_cap) == (jm.qmax, jm.vmax, jm.pair_cand_cap)
    np.testing.assert_array_equal(s_s.element.numpy(), np.asarray(js.element))


# ---------------------------------------------------------------- drivers
def _compare_runs(jdir, tdir):
    jl = (jdir / "output1_0.txt").read_text().splitlines()
    tl = (tdir / "output1_0.txt").read_text().splitlines()
    assert len(tl) == len(jl)
    for a, b in zip(jl, tl):
        if "calculation time" in a:
            continue
        if a.startswith("KMC time is: "):
            assert float(b.split(": ")[1]) == pytest.approx(float(a.split(": ")[1]), rel=1e-5)
        else:
            assert b == a
    assert golden.compare(golden.summarize(str(jdir)), golden.summarize(str(tdir)), KMC_RTOL) == []
    jm = [json.loads(ln) for ln in (jdir / "metrics.jsonl").read_text().splitlines()]
    tm = [json.loads(ln) for ln in (tdir / "metrics.jsonl").read_text().splitlines()]
    assert [m["cg_iterations"] for m in tm] == [m["cg_iterations"] for m in jm]
    return len(jm)


@pytest.mark.parametrize("pbc", [0, 1], ids=["open", "pbc"])
def test_driver_on_a_structure_file(tmp_path, pbc):
    """A deck with a structure file (tests/test_driver.py::_write_toy_deck),
    open and with ``pbc = 1``, through both drivers: the same log apart from
    the timing lines, the same trajectory and final snapshot."""
    deck, _ = _write_toy_deck(tmp_path, t_switch=1e9)
    text = open(deck).read().replace("pbc = 0", f"pbc = {pbc}")
    with open(deck, "w") as f:
        f.write(text)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jdriver.run(str(deck), workdir=str(jdir), max_supersteps=5, log=False)
    summary = tdriver.run(str(deck), workdir=str(tdir), max_supersteps=5, log=False,
                          device="cpu", pair_f32=True)
    assert summary["model"]["N"] > 0 and summary["model"]["pairwise"] == "table"
    assert _compare_runs(jdir, tdir) >= 2


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(HERE, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_synth_deck_files_identical_and_run(tmp_path):
    """tools/synth5nm_deck.py (akmc_tpu's generator) and the port's writer:
    byte-identical xyz file and deck at n_yz=6 and 8; both drivers then run
    the disordered sweep's first bias points at n_yz=8 (the smallest stack
    without a DIA form) to the same trajectory."""
    tool = _load_tool("synth5nm_deck")
    template = os.path.join(HERE, "decks", "iv_sweep_5nm.txt")
    for n_yz in (6, 8):
        jdeck = tool.write_synth_deck(str(tmp_path / "j"), n_yz=n_yz)
        tdeck = synth_deck.write_synth_deck(template, str(tmp_path / "t"), n_yz=n_yz)
        for name in ("deck.txt", f"synth5nm_n{n_yz}.xyz"):
            assert (tmp_path / "j" / name).read_bytes() == (tmp_path / "t" / name).read_bytes()
    assert "restart_xyz_file = synth5nm_n8.xyz" in open(tdeck).read()
    assert "num_atoms_first_layer = 64\n" in open(tdeck).read()

    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jdriver.run(jdeck, workdir=str(jdir), max_supersteps=4, log=False)
    summary = tdriver.run(tdeck, workdir=str(tdir), max_supersteps=4, log=False, device="cpu")
    assert summary["model"]["k_operator"] == "banded"
    assert _compare_runs(jdir, tdir) == 4

    # the ELL record of the tool follows the same trajectory format
    rec = tool.ell_record(jdeck, bias_points=2)
    assert [r["bias"] for r in rec["supersteps"]][:1] == [1.0]
    assert len(rec["final_elements"]) == len(golden.summarize(str(jdir))["final_elements"])
