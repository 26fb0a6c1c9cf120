"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs a CUDA device (a hand-written kernel has no CPU mode)
and skips without one. The file imports no JAX, so it also runs on a machine
that has only the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from akmc_tpu_torch.lattice import ELEM, metal_mask
from akmc_tpu_torch.models.crossbar import build_grid_crossbar
from akmc_tpu_torch.ops import dia_matvec as mv
from akmc_tpu_torch.solvers.dia import build_dia_k

OFFSET_SETS = [
    [-136, -129, -128, -127, -64, -9, -1, 1, 9, 64, 127, 128, 129, 136],
    [-5000, -4999, -3, -1, 1, 3, 4999, 5000],
    [-2, -1, 1, 2],
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the DIA kernel has no CPU mode")
    return torch.device("cuda")


def _cases():
    p, lat = build_grid_crossbar(n_yz=6, contact_slices=2, oxide_slices=6, ti_slices=2,
                                 defect_fraction=0.3, vacancy_concentration=0.1, seed=3)
    dia, meta = build_dia_k(np.stack([lat.x, lat.y, lat.z], 1), lat.k_neigh_idx,
                            metal_mask(lat.element0, p.metals), p.num_atoms_first_layer,
                            p.high_G, p.low_G)
    assert (lat.element0 == int(ELEM.NULL_ELEMENT)).any()
    yield "crossbar", dia.diags, dia.offsets, meta.val_low, meta.val_high
    rng = np.random.RandomState(0)
    for offs in OFFSET_SETS:
        c = np.where(rng.rand(len(offs), 4000) < 0.6, rng.randint(1, 3, (len(offs), 4000)), 0)
        yield str(offs[0]), torch.tensor(c, dtype=torch.int8), torch.tensor(offs), 1e-8, 1.0


@pytest.mark.cuda
def test_dia_kernel_matches_twin(card):
    rng = np.random.default_rng(1)
    for name, diags, offsets, lo, hi in _cases():
        n = diags.shape[1]
        x = torch.tensor(rng.standard_normal(n) * np.exp(rng.standard_normal(n)))
        xv = torch.tensor(rng.standard_normal(n) * (rng.random(n) < 0.3))
        y0, v0 = mv.dia_combined_matvec(diags, offsets, lo, hi, x, xv)
        before = mv.dia_combined_matvec.launches
        y1, v1 = mv.dia_combined_matvec(diags.to(card), offsets.to(card), lo, hi,
                                        x.to(card), xv.to(card))
        torch.cuda.synchronize()
        assert mv.dia_combined_matvec.launches == before + 1
        # same terms, same order, same roundings: equal bit for bit
        assert torch.equal(y1.cpu(), y0), name
        assert torch.equal(v1.cpu(), v0), name


@pytest.mark.cuda
def test_dia_kernel_refuses_what_it_does_not_take(card):
    _, diags, offsets, lo, hi = next(_cases())
    n = diags.shape[1]
    d, o = diags.to(card), offsets.to(card)
    x = torch.zeros(n, dtype=torch.float64, device=card)
    for bad in (x.float(), x[:-1], torch.zeros(2 * n, dtype=torch.float64, device=card)[::2]):
        with pytest.raises(ValueError):
            mv.dia_combined_matvec(d, o, lo, hi, bad, x)
    with pytest.raises(ValueError):
        mv.dia_combined_matvec(d.cpu(), o, lo, hi, x, x)


@pytest.mark.cuda
def test_dia_operator_writes_into_a_given_output(card):
    _, diags, offsets, lo, hi = next(_cases())
    n = diags.shape[1]
    op = mv.DiaOperator(diags.to(card), offsets.to(card), lo, hi)
    x = torch.tensor(np.random.default_rng(2).standard_normal(n), device=card)
    out = torch.empty((2, n), dtype=torch.float64, device=card)
    y, v = op.matvec(x, x, out=out)
    y0, v0 = mv.dia_combined_matvec(diags, offsets, lo, hi, x.cpu(), x.cpu())
    assert y.data_ptr() == out.data_ptr()
    assert torch.equal(y.cpu(), y0) and torch.equal(v.cpu(), v0)
    with pytest.raises(ValueError):
        op.matvec(x, x, out=out[:, :-1])


def _k_solve_inputs(dev):
    """The toy crossbar's K system at Vd = 5 from a zero start, on ``dev``."""
    from akmc_tpu_torch.solvers.dia import k_system

    p, lat = build_grid_crossbar(n_yz=6, contact_slices=2, oxide_slices=6, ti_slices=2,
                                 defect_fraction=0.3, vacancy_concentration=0.1, seed=3)
    dia, meta = build_dia_k(np.stack([lat.x, lat.y, lat.z], 1), lat.k_neigh_idx,
                            metal_mask(lat.element0, p.metals), p.num_atoms_first_layer,
                            p.high_G, p.low_G)
    dia = dia.to(dev)
    element = torch.as_tensor(lat.element0, dtype=torch.int32, device=dev)
    ks = k_system(dia, meta, element, torch.zeros_like(element),
                  torch.zeros(lat.N, dtype=torch.float64, device=dev), 5.0,
                  p.high_G, p.low_G, p.num_atoms_first_layer)
    return dia.operator(meta), ks, 1e-14 * (lat.N - 2 * p.num_atoms_first_layer)


# The fused CG's cases. The toy crossbar (rows None) takes the register-
# resident kernel; the random K systems (``chip_smoke.py::random_k_system``)
# take the streaming kernel: more chunks than the resident grid holds (about
# 67,000 rows on an H100) or D > 32; N is not a multiple of 256, and each
# block walks several chunks (16 at 1,000,003 rows).
STREAM_D32 = [1, 2, 3, 5, 8, 13, 21, 34, 55, 89, 144, 233, 377, 610, 987, 150000]
STREAM_D36 = STREAM_D32[:-1] + [1597, 2584, 150000]
FUSED_CASES = {
    # name: (rows, positive offsets or None for the toy crossbar, warm, max_iterations)
    "resident": (None, None, False, 10000),
    "resident-warm": (None, None, True, 10000),
    "resident-max10": (None, None, False, 10),
    "resident-max0": (None, None, False, 0),
    "stream-D32": (300_001, STREAM_D32, False, 500),
    "stream-D32-sixteen-chunks-per-block": (1_000_003, STREAM_D32, False, 500),
    "stream-D36": (300_001, STREAM_D36, False, 500),
    "stream-D36-warm": (300_001, STREAM_D36, True, 500),
    "stream-max0": (300_001, STREAM_D32, False, 0),
    "stream-max10": (300_001, STREAM_D32, False, 10),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_cg_matches_twin(card, case):
    """Each of the kernel's two cases against the twin, bit for bit with
    equal iteration counts: cold, warm and cut solves, one launch each."""
    from akmc_tpu_torch.solvers import dia_cg
    from chip_smoke import random_k_system

    n, offsets, warm, max_it = FUSED_CASES[case]
    if offsets is None:
        op, ks, rtol = _k_solve_inputs(card)
    else:
        op, ks = random_k_system(np.random.default_rng(n), n, offsets, card)
        rtol = 1e-10
    if warm:      # start from the solution of a neighbouring right-hand side
        first = dia_cg.dia_cg_solve(op, *ks, rtol, 10000)
        ks = ks._replace(x0=torch.where(ks.is_int, first.x, 0.0), rhs=ks.rhs * 1.01)
    before = dia_cg.dia_cg_solve.launches
    got = dia_cg.dia_cg_solve(op, *ks, rtol, max_it)
    torch.cuda.synchronize()
    assert dia_cg.dia_cg_solve.launches == before + 1
    assert dia_cg.dia_cg_solve.last_grid[1] == case.startswith("resident")
    ref = dia_cg.dia_cg_solve_plain(op, *ks, rtol, max_it)
    # same products, sums and reduction trees in the same order: equal bit for bit
    assert int(got.iterations) == ref.iterations
    if max_it in (0, 10):
        assert ref.iterations == max_it + 1
    else:
        assert 1 < ref.iterations < max_it
    assert torch.equal(got.x, ref.x) and torch.equal(got.r, ref.r)
    assert torch.equal(got.residual_sq, ref.residual_sq)


@pytest.mark.cuda
def test_fused_cg_refuses_what_it_does_not_take(card):
    from akmc_tpu_torch.solvers import dia_cg

    op, ks, rtol = _k_solve_inputs(card)
    n = op.n
    for field, bad in (
        ("rhs", ks.rhs.cpu()),                                        # another device
        ("rhs", ks.rhs.float()),                                      # another type
        ("cvac", ks.cvac.to(torch.uint8)),
        ("x0", ks.x0[:-1]),                                           # another shape
        ("inv_diag", torch.ones(2 * n, dtype=torch.float64, device=card)[::2]),   # strided
    ):
        with pytest.raises(ValueError):
            dia_cg.dia_cg_solve(op, *ks._replace(**{field: bad}), rtol, 100)


# ------------------------------------------------------------------
# the plain-PyTorch operators of the disordered and large-structure paths:
# no hand-written kernel, so the card and the CPU run the same code and must
# agree to reassociation (cuBLAS and the CPU BLAS sum in other orders)

def _disordered_model(dev, **kw):
    """synthetic_stack(n_yz=8) under the 5 nm deck's physics (the smallest
    stack without a DIA form): the port's model on ``dev``."""
    from akmc_tpu_torch.config import KMCParameters
    from akmc_tpu_torch.lattice import build_lattice
    from akmc_tpu_torch.models.crossbar import synthetic_stack
    from akmc_tpu_torch.models.vcm import VCMModel
    from akmc_tpu_torch.rng import ReferenceRNG
    from akmc_tpu_torch.state import make_substoichiometric

    a = 2.131255
    e, x, y, z, lattice, patch = synthetic_stack(n_yz=8, a=a)
    p = KMCParameters(
        lattice=list(lattice), nn_dist=3.5, metals=patch["metals"],
        num_atoms_first_layer=patch["num_atoms_first_layer"],
        num_layers_contact=patch["num_layers_contact"], solve_potential=True,
        perturb_structure=True, freq=10e13,
    )
    e = make_substoichiometric(e, 0.05, ReferenceRNG(5))
    lat = build_lattice(e, x - 10 * a, y, z, p)
    return p, lat, VCMModel(p, lat, device=dev, **kw)


def _first_fields(model, lat, dev, Vd=2.0):
    from akmc_tpu_torch.state import make_device_state

    s = make_device_state(lat, 300.0, torch.device(dev))
    return model._fields(s.element, s.charge, s.potential_boundary, s.T_bg, Vd)


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [
    dict(),                                               # banded, static table
    dict(use_banded_k=False, pair_table_budget=0),        # ELL, on-the-fly
    dict(pair_table_budget=0, pair_tiling_min_n=1),       # banded, tiled
], ids=["banded-table", "ell-on-the-fly", "banded-tiled"])
def test_disordered_fields_card_matches_cpu(card, flags):
    _, lat, m_cpu = _disordered_model("cpu", **flags)
    _, _, m_gpu = _disordered_model(card, **flags)
    assert m_gpu.describe() == m_cpu.describe() and m_cpu.dia is None
    f_cpu = _first_fields(m_cpu, lat, "cpu")
    f_gpu = _first_fields(m_gpu, lat, card)
    assert torch.equal(f_gpu.charge.cpu(), f_cpu.charge)
    assert torch.equal(f_gpu.etype.cpu(), f_cpu.etype)
    # the K-CG stops on a plateau of r.z, so another summation order may move
    # the stop by a few iterations and the potentials within the CG tolerance
    assert abs(f_gpu.cg_iterations - f_cpu.cg_iterations) <= max(3, f_cpu.cg_iterations // 5)
    torch.testing.assert_close(f_gpu.potential_boundary.cpu(), f_cpu.potential_boundary,
                               rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(f_gpu.potential_sum.cpu(), f_cpu.potential_sum,
                               rtol=1e-5, atol=1e-7)


@pytest.mark.cuda
def test_band_matvec_card_matches_cpu(card):
    from akmc_tpu_torch.solvers.banded import band_matvec

    _, lat, m = _disordered_model("cpu")
    x = torch.tensor(np.random.default_rng(3).standard_normal(lat.N))
    y_cpu = band_matvec(m.banded, m.band_meta, x)
    y_gpu = band_matvec(m.banded.to(card), m.band_meta, x.to(card))
    torch.testing.assert_close(y_gpu.cpu(), y_cpu, rtol=1e-13, atol=1e-13)


@pytest.mark.cuda
@pytest.mark.parametrize("plane_f32", [False, True], ids=["f64", "f32-plane"])
def test_pairwise_paths_card_match_cpu(card, plane_f32):
    """Candidate lists equal on both devices (a stable sort keeps list order
    on the card too); potentials to reassociation, f32 plane to f32 roundoff."""
    from akmc_tpu_torch.ops import pairwise as pw

    p, lat, _ = _disordered_model("cpu", pair_table_budget=0)
    rng = np.random.default_rng(5)
    charge = np.zeros(lat.N, np.int32)
    sites = rng.choice(np.nonzero(lat.element0 <= 3)[0], 120, replace=False)
    charge[sites] = rng.choice([2, -2, 1], 120)
    pos = np.stack([lat.x, lat.y, lat.z], 1)
    tiling, r_tile = pw.build_pair_tiling(pos, p.cutoff_radius, tile_edge=p.cutoff_radius / 2)
    phys = (p.cutoff_radius, p.sigma, p.k)
    out = {}
    for dev in ("cpu", card):
        pos_t, q_t = torch.tensor(pos, device=dev), torch.tensor(charge, device=dev)
        _, qv, q_pos, _, _ = pw._charged_list(pos_t, q_t, 256)
        sel, cand, ovf = pw.tile_candidates(tiling.to(dev), r_tile, q_pos, qv, p.cutoff_radius, 64)
        tiled = pw.pairwise_potential_tiled(tiling.to(dev), r_tile, pos_t, q_t, *phys, qmax=256,
                                            cand_cap=64, plane_f32=plane_f32)
        fly = pw.pairwise_potential(pos_t, q_t, *phys, qmax=256)
        out[str(dev)] = [t.cpu() for t in (sel, cand, ovf, tiled[0], tiled[2], fly[0])]
    c, g = out["cpu"], out[str(card)]
    assert torch.equal(g[0], c[0]) and torch.equal(g[1], c[1])
    assert bool(g[2]) == bool(c[2]) and bool(g[4]) == bool(c[4])
    tol = dict(rtol=2e-5, atol=2e-6 * float(c[5].abs().max())) if plane_f32 \
        else dict(rtol=1e-12, atol=1e-18)
    torch.testing.assert_close(g[3], c[3], **tol)
    torch.testing.assert_close(g[5], c[5], rtol=1e-12, atol=1e-18)


# ------------------------------------------------------------------
# the production event loops: plain PyTorch on both devices, fed the same
# replayed uniforms. Everything after the draws is deterministic, so the card
# must fire the CPU's events (this is what catches a scatter that depends on
# write order, or a top-k that breaks ties another way).

def _frozen_table(dev):
    """The toy crossbar's rate table at 15 V with shifted-exponent rates."""
    from akmc_tpu_torch.models.vcm import VCMModel
    from akmc_tpu_torch.state import make_device_state

    p, lat = build_grid_crossbar(n_yz=6, contact_slices=2, oxide_slices=6, ti_slices=2,
                                 defect_fraction=0.3, vacancy_concentration=0.1, seed=3)
    model = VCMModel(p, lat, device=dev, rate_normalize=True)
    state = make_device_state(lat, p.background_temp, torch.device(dev))
    return p, model, state, model._fields_grown(state, 15.0)


def _uniforms(seed, shapes_dtypes):
    rng = np.random.default_rng(seed)
    while True:
        for shape, dtype in shapes_dtypes:
            yield rng.random(shape, dtype=dtype)


def _loop_on(dev, loop, make_draws, **kw):
    from akmc_tpu_torch.ops import events as ev

    p, model, state, fr = _frozen_table("cpu")
    t = model.tables
    to = lambda a: a.to(dev)  # noqa: E731
    fn = getattr(ev, loop)
    return fn(to(state.element), to(fr.charge), fr.P.to(dev, copy=True), to(fr.etype),
              to(t.act_neigh), ev.ReplayDraws(make_draws(fr.P.shape[0])), p.freq,
              act_idx=to(t.act_idx), abs2act=to(t.abs2act), ln_S=to(fr.ln_S), **kw)


def _same_events(g, c, rtol):
    assert g.element.is_cuda and g.P.is_cuda
    assert torch.equal(g.element.cpu(), c.element) and torch.equal(g.charge.cpu(), c.charge)
    assert torch.equal(g.P.cpu() == 0.0, c.P == 0.0)
    assert (g.n_events, g.done) == (c.n_events, c.done) and g.n_events >= 1
    assert g.event_time_h == pytest.approx(c.event_time_h, rel=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("clock_f32", [False, True], ids=["f64-clocks", "f32-clocks"])
@pytest.mark.parametrize("mass_eps", [1e-3, 0.1])
@pytest.mark.parametrize("B", [4, 16])
def test_batched_loop_card_matches_cpu(card, B, mass_eps, clock_f32):
    clock = np.float32 if clock_f32 else np.float64

    def draws(n):
        return _uniforms(B, [(n, clock), (B, np.float64)])

    # 48 batches: with f32 clocks the loop can spin once only rows are left
    # whose shifted rates underflow f32 (their clocks are inf, as in akmc_tpu)
    kw = dict(batch=B, mass_eps=mass_eps, clock_f32=clock_f32, max_batches=48)
    g = _loop_on(card, "run_event_loop_batched", draws, **kw)
    c = _loop_on("cpu", "run_event_loop_batched", draws, **kw)
    _same_events(g, c, 1e-6 if clock_f32 else 1e-12)
    assert (g.n_batches, g.n_cut_conflict, g.n_cut_mass) == (
        c.n_batches, c.n_cut_conflict, c.n_cut_mass)


@pytest.mark.cuda
def test_native_loop_card_matches_cpu(card):
    def draws(n):
        return _uniforms(1, [(2, np.float64)])

    g = _loop_on(card, "run_event_loop_native", draws)
    c = _loop_on("cpu", "run_event_loop_native", draws)
    _same_events(g, c, 1e-12)
    assert g.draws_used == c.draws_used == 2 * g.n_events


@pytest.mark.cuda
def test_topk_smallest_card_matches_cpu(card):
    from akmc_tpu_torch.ops.events import _topk_smallest

    rng = np.random.default_rng(0)
    for n, B in ((1000, 16), (16384, 64)):
        tau = rng.exponential(size=n)
        tau[rng.random(n) < 0.7] = np.inf
        tau[rng.integers(0, n, 40)] = 0.25
        for t in (torch.from_numpy(tau), torch.from_numpy(tau.astype(np.float32))):
            v0, i0 = _topk_smallest(t, B)
            v1, i1 = _topk_smallest(t.to(card), B)
            assert torch.equal(v1.cpu(), v0) and torch.equal(i1.cpu(), i0)


def _full_toy(heating):
    """The full-physics toy of tests/test_full_physics.py, from the port's own
    toy_device (30% vacancies), with its heat constants."""
    from akmc_tpu_torch.models.crossbar import toy_device

    p, lat = toy_device(nx=10, ny=3, nz=3, contact_layers=3, vacancy_fraction=0.3)
    p = p.replace(solve_current=True, solve_heating_global=heating == "global",
                  solve_heating_local=heating == "local", dissipation_constant=1e-13,
                  t_ox=5e-9, A=(12 * 2.0e-10) ** 2, c_p=1.92, delta_t=1e-13,
                  L_char=3.5e-10, k_th_non_vacancy=0.5, k_th_vacancies=5.0,
                  num_atoms_contact=p.num_atoms_first_layer * p.num_layers_contact)
    return p, lat


@pytest.mark.cuda
@pytest.mark.parametrize("heating", ["global", "local"])
def test_full_physics_superstep_card_matches_cpu(card, heating):
    """Three full-physics supersteps on the card and on the CPU from the same
    state and stream: events and power-CG counts equal, I_macro within 1e-6,
    P_tot within 1e-8, the heat model's rise within 1e-6; on the card each K
    solve launched the fused CG once."""
    from akmc_tpu_torch.models.vcm import VCMModel
    from akmc_tpu_torch.rng import BufferedStream, ReferenceRNG
    from akmc_tpu_torch.solvers import dia_cg
    from akmc_tpu_torch.state import make_device_state

    p, lat = _full_toy(heating)
    out = {}
    for where in ("cpu", card):
        m = VCMModel(p, lat, device=where, vmax=64, ne_max=512)
        s = m.update_cb_edge(make_device_state(lat, p.background_temp, torch.device(where)), 2.0)
        stream, mw, rows = BufferedStream(ReferenceRNG(1)), None, []
        launches = dia_cg.dia_cg_solve.launches
        for _ in range(3):
            s, st, mw = m.superstep_full(s, 2.0, stream, m_prev=mw)
            rows.append(st)
        out[str(where)] = (rows, s, m.k_solves, dia_cg.dia_cg_solve.launches - launches)
    (rc, sc, _, _), (rg, sg, k_solves, launches) = out["cpu"], out[str(card)]
    for a, b in zip(rc, rg):
        assert (b["n_events"], b["power_cg_iterations"]) == (a["n_events"], a["power_cg_iterations"])
        np.testing.assert_allclose(b["I_macro"], a["I_macro"], rtol=1e-6)
        np.testing.assert_allclose(b["P_tot"], a["P_tot"], rtol=1e-8)
        np.testing.assert_allclose(b["T_bg"] - 300.0, a["T_bg"] - 300.0, rtol=1e-6)
    assert torch.equal(sg.element.cpu(), sc.element)
    rise = sc.temperature - 300.0
    np.testing.assert_allclose((sg.temperature.cpu() - 300.0).numpy(), rise.numpy(), rtol=1e-6,
                               atol=1e-6 * float(rise.abs().max()))
    assert launches == k_solves == 3


@pytest.mark.cuda
@pytest.mark.parametrize("f32", [False, True], ids=["f64", "wkb_f32"])
def test_wkb_blocks_card_match_cpu(card, f32):
    """build_power_system on the card against the CPU on the toy's atoms with
    a synthetic CB-edge profile of +-1 eV: the W blocks within 1e-12 (f64) or
    2e-6 of each entry with a floor of 1e-7 of the largest (f32), the
    energy-loop bound equal."""
    from akmc_tpu_torch.config import EV_TO_J
    from akmc_tpu_torch.solvers.current import build_current_tables, build_power_system

    p, lat = _full_toy("global")
    n_src = p.num_atoms_first_layer
    ct = build_current_tables(lat.element0, np.stack([lat.x, lat.y, lat.z], 1),
                              np.asarray(p.lattice), False, p.nn_dist, p.metals, n_src, n_src,
                              p.num_layers_contact, p.max_num_neighbors)
    n_atom = ct.atom_ind.numel()
    rng = np.random.RandomState(2)
    elem = torch.as_tensor(lat.element0[ct.atom_ind.numpy()])
    charge = torch.where((elem == int(ELEM.VACANCY)) & torch.tensor(rng.rand(n_atom) < 0.5), 2, 0)
    cb = torch.tensor((np.linspace(1.0, -1.0, n_atom) + 0.05 * rng.randn(n_atom)) * EV_TO_J)
    built = {}
    for where in ("cpu", card):
        built[str(where)] = build_power_system(
            ct.to(where), elem.to(where), charge.to(where), cb.to(where),
            torch.tensor(np.asarray(p.lattice, np.float64), device=where), False, p.nn_dist,
            p.high_G * 1e5, p.low_G, p.high_G * 1e7, p.q * 0.01, p.m_e, p.V0,
            vmax=64, ne_max=512, wkb_f32=f32)
    (pc, stc), (pg, stg) = built["cpu"], built[str(card)]
    assert stc == stg and stc.ct_bounds[0] > 1
    for name in ("W_tt", "W_ct", "W_cc", "diag"):
        a, b = getattr(pc, name), getattr(pg, name).cpu()
        scale = float(a.abs().max())
        if f32:
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-6, atol=1e-7 * scale)
        else:
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-12, atol=1e-12 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("ranks", [2, 3, 4])
def test_row_window_kernel_matches_twin(card, ranks):
    """Each rank's row window of the matvec (its own slab of codes, x and xv
    whole): bit-equal to the window twin and to the full twin's rows, at
    chunk-aligned ranges with a ragged last one and at a window that starts
    mid-chunk (byte loads of the codes)."""
    from akmc_tpu_torch.parallel.mesh import Mesh
    from akmc_tpu_torch.solvers.dia_cg import CHUNK

    rng = np.random.default_rng(ranks)
    for name, diags, offsets, lo, hi in _cases():
        n = diags.shape[1]
        x = torch.tensor(rng.standard_normal(n) * np.exp(rng.standard_normal(n)))
        xv = torch.tensor(rng.standard_normal(n) * (rng.random(n) < 0.3))
        yf, vf = mv.dia_combined_matvec_plain(diags, offsets.tolist(), lo, hi, x, xv)
        ranges = Mesh(0, ranks, card, "gloo").split(n, CHUNK) + [(5, n - 3)]
        for r0, r1 in ranges:
            slab = diags[:, r0:r1].clone()
            before = mv.dia_combined_matvec.launches
            op = mv.DiaOperator(slab.to(card), offsets.to(card), lo, hi, row0=r0, n=n)
            y1, v1 = op.matvec(x.to(card), xv.to(card))
            torch.cuda.synchronize()
            assert mv.dia_combined_matvec.launches == before + 1
            y0, v0 = mv.dia_combined_matvec_plain(slab, offsets.tolist(), lo, hi, x, xv, row0=r0)
            assert torch.equal(y1.cpu(), y0) and torch.equal(v1.cpu(), v0), (name, r0, r1)
            assert torch.equal(y0, yf[r0:r1]) and torch.equal(v0, vf[r0:r1]), (name, r0, r1)


def _sharded_superstep_rank(mesh):
    """Three supersteps of the n_yz=6 crossbar on this rank (the card, ranks
    sharing it over gloo); rank 0's state and every rank's launch counts."""
    from akmc_tpu_torch.models.vcm import VCMModel
    from akmc_tpu_torch.parallel.mesh import check_replicas, replicate_state, shard_model
    from akmc_tpu_torch.rng import BufferedStream, ReferenceRNG
    from akmc_tpu_torch.state import make_device_state

    p, lat = build_grid_crossbar(n_yz=6, contact_slices=2, oxide_slices=6, ti_slices=2,
                                 defect_fraction=0.3, vacancy_concentration=0.1, seed=3)
    model = VCMModel(p, lat, device=mesh.device)
    state = make_device_state(lat, p.background_temp, mesh.device)
    shard_model(model, mesh)
    state = replicate_state(state, mesh)
    stream = BufferedStream(ReferenceRNG(1))
    mv.dia_combined_matvec.launches = 0
    for _ in range(3):
        state, _ = model.superstep(state, 2.0, stream)
        check_replicas(state, mesh)
    torch.cuda.synchronize()
    return (state.potential_charge.cpu(), float(state.kmc_time), mv.dia_combined_matvec.launches,
            model.k_solves + model.k_iterations)


@pytest.mark.cuda
def test_sharded_superstep_on_one_card_matches_one_rank(card):
    """Four ranks sharing the card (gloo, collectives staged through the host)
    give the one-rank supersteps bit for bit; each rank launched the row
    window once per K-CG iteration and once per solve."""
    from akmc_tpu_torch.models.vcm import VCMModel
    from akmc_tpu_torch.parallel.launch import spawn
    from akmc_tpu_torch.rng import BufferedStream, ReferenceRNG
    from akmc_tpu_torch.state import make_device_state

    p, lat = build_grid_crossbar(n_yz=6, contact_slices=2, oxide_slices=6, ti_slices=2,
                                 defect_fraction=0.3, vacancy_concentration=0.1, seed=3)
    model = VCMModel(p, lat, device=card)
    state = make_device_state(lat, p.background_temp, card)
    stream = BufferedStream(ReferenceRNG(1))
    for _ in range(3):
        state, _ = model.superstep(state, 2.0, stream)
    outs = spawn(_sharded_superstep_rank, 4, "cuda:0", "gloo", timeout=300)
    assert torch.equal(outs[0][0], state.potential_charge.cpu())
    assert outs[0][1] == float(state.kmc_time)
    assert all(o[2] == o[3] for o in outs)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["neighbors", "k_adjacency_pbc", "cutoff"])
def test_lattice_device_builder_card_matches_kdtree(card, kind):
    """The on-card list builder equals the k-d tree entry for entry on the
    disordered stand-in's generator at n_yz = 12 (7,772 sites), in blocks of
    500 rows and in the block the card's free memory gives."""
    from akmc_tpu_torch import lattice, lattice_device
    from akmc_tpu_torch.models.crossbar import synthetic_stack

    e, x, y, z, dims, _ = synthetic_stack(n_yz=12)
    pos = np.stack([x, y, z], 1)
    dims = np.asarray(dims, np.float64)
    for block in (500, None):
        if kind == "cutoff":
            got, gmax = lattice_device.build_cutoff_list_device(pos, e, 20.0, device=card,
                                                                block=block)
            want, wmax = lattice.build_cutoff_list(pos, e, 20.0)
            assert gmax == wmax
        else:
            args = (pos, 3.5, 52) + ((dims, True) if kind == "k_adjacency_pbc" else ())
            got = lattice_device.build_neighbor_list_device(*args, device=card, block=block)
            want = lattice.build_neighbor_list(*args)
        np.testing.assert_array_equal(got, want)


def pair_at_a_rounding_of_the_cutoff():
    """Sites 0 and 1 and a cutoff c with sqrt(d2) == c but d2 < c * c once
    rounded (d2 as ``lattice._dist2`` forms it): the k-d tree's rule
    (``site_dist < c``) leaves the pair out, the squared rule keeps it. Site
    2 lies 1.0 from site 0 and beyond c from site 1."""
    rng = np.random.default_rng(2)
    while True:
        v = rng.uniform(1.0, 2.0, 3)
        d2 = v[0] * v[0] + v[1] * v[1] + v[2] * v[2]
        c = float(np.sqrt(d2))
        if d2 < c * c:
            return np.array([[0.0, 0.0, 0.0], v, [-1.0, 0.0, 0.0]]), c


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["neighbors", "cutoff"])
def test_lattice_device_builder_card_rule_at_the_cutoff(card, kind):
    """On a pair at a rounding of the cutoff (sqrt(d2) equal to it, d2 below
    its square once rounded) the card keeps the k-d tree's rule: the pair is
    left out, as ``site_dist < cutoff`` leaves it
    (``tests/test_torch_lattice_device.py`` holds the same on the CPU)."""
    from akmc_tpu_torch import lattice, lattice_device

    pos, c = pair_at_a_rounding_of_the_cutoff()
    if kind == "neighbors":
        got = lattice_device.build_neighbor_list_device(pos, c, 3, device=card)
        want = lattice.build_neighbor_list(pos, c, 3)
    else:
        e = np.array([int(lattice.ELEM.O)] * 3, np.int32)
        got, _ = lattice_device.build_cutoff_list_device(pos, e, c, device=card)
        want, _ = lattice.build_cutoff_list(pos, e, c)
    np.testing.assert_array_equal(got, want)
    assert 1 not in got[0] and got[0, 0] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("n_yz, oxide", [(6, 6), (16, 22)], ids=["one-block", "18-blocks"])
def test_incremental_selection_card_matches_fresh(card, n_yz, oxide):
    """The serial loop with carried block sums equals the fresh selection to
    the bit on the card (rate table of one and of 18 blocks of 256 rows),
    and fires the events the CPU fires."""
    from akmc_tpu_torch.models.vcm import VCMModel
    from akmc_tpu_torch.ops import events as ev
    from akmc_tpu_torch.rng import ReferenceRNG
    from akmc_tpu_torch.state import make_device_state

    p, lat = build_grid_crossbar(n_yz=n_yz, contact_slices=2, oxide_slices=oxide, ti_slices=2,
                                 defect_fraction=0.3, vacancy_concentration=0.1, seed=3)
    rand = torch.from_numpy(ReferenceRNG(7).uniform(8192))
    model = VCMModel(p, lat, device="cpu", rate_normalize=True)
    t = model.tables
    fr = model.fields(make_device_state(lat, p.background_temp, torch.device("cpu")), 8.0)
    element = torch.as_tensor(lat.element0)
    res = {}
    for dev in (card, torch.device("cpu")):
        for inc in (False, True):
            res[dev.type, inc] = ev.run_event_loop(
                element.to(dev), fr.charge.to(dev), fr.P.to(dev, copy=True), fr.etype.to(dev),
                t.act_neigh.to(dev), rand.to(dev), p.freq, t.act_idx.to(dev),
                t.abs2act.to(dev), t.act_zero_rows.to(dev), ln_S=fr.ln_S.to(dev),
                incremental_select=inc)
    f, i = res["cuda", False], res["cuda", True]
    assert (i.n_events, i.draws_used, i.done) == (f.n_events, f.draws_used, f.done)
    assert i.n_events >= 3
    for a, b in ((i.element, f.element), (i.charge, f.charge), (i.P, f.P),
                 (i.event_time, f.event_time)):
        assert torch.equal(a, b)
    c = res["cpu", True]
    assert (c.n_events, c.draws_used) == (i.n_events, i.draws_used)
    assert torch.equal(c.element, i.element.cpu())


# ------------------------------------------- the event loops as CUDA graphs
def _capture_and_replay(fn, *inputs):
    """``fn(*inputs)`` captured into a CUDA graph (after one eager warm-up on
    a side stream) and replayed once: (the graph's output, an eager one)."""
    eager = fn(*inputs)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*inputs)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = fn(*inputs)
    g.replay()
    torch.cuda.synchronize()
    return out, eager


def _index_put_rows(P, rows, vals):
    Q = P.clone()
    Q[rows] = vals
    return Q


def _index_fill(n, idx):
    hit = torch.zeros(n, dtype=torch.bool, device=idx.device)
    hit.index_fill_(0, idx, True)
    return hit


def _scan(v):
    from akmc_tpu_torch.ops.events import _cumsum

    return _cumsum(v)


# torch.cumsum of a long vector is not among them: CUB's decoupled look-back
# associates its floats by timing, so a replay and an eager run differ in the
# last bits (seen on an H100 at 20,000 entries); the loops scan with
# ops/events.py::_cumsum
_CAPTURED_OPS = {
    "sort_stable": lambda v, *_: torch.sort(v, stable=True),
    "searchsorted": lambda v, *_: torch.searchsorted(_scan(v), v[:7] * 10, right=True),
    "cumsum_in_rows": lambda v, *_: _scan(v),
    "cumsum_of_rows": lambda v, P, rows: torch.cumsum(P, dim=1),
    "cumprod_int32": lambda v, *_: torch.cumprod((v > 0.3).to(torch.int32), 0),
    "index_put_repeated_rows": lambda v, P, rows: _index_put_rows(P, rows, P[rows] * 0.5),
    "index_fill": lambda v, P, rows: _index_fill(P.shape[0] + 1, rows),
    "take": lambda v, P, rows: torch.take(P, rows),
    "index_select_0d_cursor": lambda v, *_: v.index_select(
        0, torch.stack([torch.ones((), dtype=torch.int64, device=v.device)] * 2)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("op", sorted(_CAPTURED_OPS))
def test_event_loop_ops_capture_and_replay_in_a_graph(card, op):
    """Each operation of the event loops that could synchronise or allocate
    in a way a capture forbids, captured on the card and replayed: the same
    bits as run eagerly."""
    rng = np.random.default_rng(0)
    v = torch.tensor(rng.random(20000), device=card)
    v[rng.integers(0, 20000, 50)] = 0.5                       # ties for the stable sort
    P = torch.tensor(rng.random((300, 9)), device=card)
    rows = torch.tensor(rng.integers(0, 300, 70), device=card)  # repeated rows
    out, eager = _capture_and_replay(_CAPTURED_OPS[op], v, P, rows)
    for a, b in zip(out if isinstance(out, tuple) else (out,),
                    eager if isinstance(eager, tuple) else (eager,)):
        assert torch.equal(a, b), op


@pytest.mark.cuda
def test_a_capture_that_synchronises_raises(card):
    """A loop body that reads the host cannot be captured: the capture
    raises, and nothing runs the body another way. In a process of its own:
    a failed capture may leave its CUDA context unusable."""
    code = ("import torch\n"
            "from akmc_tpu_torch.ops.device_loop import StepProgram\n"
            "x = torch.zeros(4, device='cuda')\n"
            "StepProgram(lambda: x.add_(float(x.sum())), x.device).capture()\n")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert run.returncode != 0 and "during capture" in run.stderr, run.stderr[-2000:]


def _card_frozen(card):
    p, model, state, fr = _frozen_table(card)
    return p, model.tables, state, fr


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 64])
def test_graph_loops_match_plain_loops_on_card(card, k):
    """The three device loops, captured and replayed on the card, against
    their plain host loops on the card from the same fields and uniforms:
    equal to the bit; each replay reads the host once."""
    from akmc_tpu_torch.ops import events as ev
    from akmc_tpu_torch.ops.device_loop import FIRST_K, LoopGraphs
    from akmc_tpu_torch.rng import ReferenceRNG

    p, t, state, fr = _card_frozen(card)
    rand = torch.from_numpy(ReferenceRNG(7).uniform(8192)).to(card)
    common = dict(act_idx=t.act_idx, abs2act=t.abs2act, ln_S=fr.ln_S)
    graphs = LoopGraphs()

    def args(draws):
        return (state.element, fr.charge, fr.P.clone(), fr.etype, t.act_neigh, draws, p.freq)

    for inc in (False, True):
        a = ev.run_event_loop_plain(*args(rand), t.act_idx, t.abs2act, t.act_zero_rows,
                                    ln_S=fr.ln_S, incremental_select=inc)
        b = ev.run_event_loop(*args(rand), t.act_idx, t.abs2act, t.act_zero_rows, ln_S=fr.ln_S,
                              incremental_select=inc, k=k, graphs=graphs)
        assert (a.n_events, a.draws_used, a.done, a.event_time_h) == (
            b.n_events, b.draws_used, b.done, b.event_time_h) and a.n_events >= 3
        for x, y in ((a.element, b.element), (a.charge, b.charge), (a.P, b.P),
                     (a.event_time, b.event_time)):
            assert torch.equal(x, y)
    a = ev.run_event_loop_native_plain(*args(ev.GeneratorDraws.seeded(3, card)),
                                       zero_rows=t.act_zero_rows, **common)
    b = ev.run_event_loop_native(*args(ev.GeneratorDraws.seeded(3, card)),
                                 zero_rows=t.act_zero_rows, k=k, graphs=graphs, **common)
    assert (a.n_events, a.done, a.event_time_h) == (b.n_events, b.done, b.event_time_h)
    assert torch.equal(a.element, b.element) and torch.equal(a.P, b.P)
    for clock_f32, max_b in ((False, 1 << 14), (True, 40)):
        ga, gb = ev.GeneratorDraws.seeded(5, card), ev.GeneratorDraws.seeded(5, card)
        kw = dict(batch=8, clock_f32=clock_f32, max_batches=max_b, **common)
        a = ev.run_event_loop_batched_plain(*args(ga), **kw)
        ev.reset_loop_counts()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                b = ev.run_event_loop_batched(*args(gb), k=k, graphs=graphs, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        reads = sum("synchroniz" in str(w.message) for w in caught
                    if w.filename.endswith(("events.py", "device_loop.py")))
        first = min(FIRST_K, k)          # the first replay's steps
        assert reads == ev.LOOP_COUNTS["batched"]["replays"] == 1 + -(
            -max(b.n_batches - first, 0) // k)
        assert (a.n_events, a.n_batches, a.done, a.n_cut_conflict, a.n_cut_mass,
                a.event_time_h) == (b.n_events, b.n_batches, b.done, b.n_cut_conflict,
                                    b.n_cut_mass, b.event_time_h)
        assert torch.equal(a.element, b.element) and torch.equal(a.P, b.P)
        assert torch.equal(ga.uniform((3,), torch.float64, card),
                           gb.uniform((3,), torch.float64, card))
    assert all(p.graph is not None for prog in graphs.programs.values()
               for p in prog.loop.programs.values())
