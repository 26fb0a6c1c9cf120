"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs a CUDA device (a hand-written kernel has no CPU mode)
and skips without one. The file imports no JAX, so it also runs on a machine
that has only the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import contextlib
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


# the tiled pairwise kernel (csrc/pair_tiled.cu) against its plain twin:
# (n_yz, oxide slices, charged share, qmax past the charged count, cand_cap,
# tiles share)
PAIR_CASES = {
    "fits": (12, 8, 0.05, 100, None, None),
    "cap_overflow": (12, 8, 0.05, 100, 16, None),
    "cap_past_ring": (16, 8, 0.3, 100, 4096, None),     # > 512 candidates a tile
    "qmax_overflow": (12, 8, 0.05, -20, None, None),
    "rank_share": (12, 8, 0.05, 100, None, (1, 4)),     # the second of four ranks
    # a long stack: 40,454 charged sites, so list positions past the
    # kernel's 32,768-entry window, and tiles with hits in both windows
    "list_windows": (16, 300, 0.4, 100, 4096, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("plane_f32", [False, True], ids=["f64", "f32-plane"])
@pytest.mark.parametrize("case", list(PAIR_CASES))
def test_pair_tiled_kernel_matches_twin(card, case, plane_f32):
    """Potential and both flags bit-equal to the twin, one launch a call."""
    from akmc_tpu_torch.ops import pairwise as pw

    n_yz, oxide, share, extra, cap, part = PAIR_CASES[case]
    p, lat = build_grid_crossbar(n_yz=n_yz, contact_slices=2, oxide_slices=oxide, ti_slices=2,
                                 defect_fraction=0.3, vacancy_concentration=0.1, seed=3)
    pos = np.stack([lat.x, lat.y, lat.z], 1)
    rng = np.random.default_rng(n_yz)
    slots = np.nonzero(lat.element0 != int(ELEM.NULL_ELEMENT))[0]
    m = int(share * len(slots))
    charge = np.zeros(lat.N, np.int32)
    charge[rng.choice(slots, m, replace=False)] = rng.choice([2, -2, 1, -1], m)
    tiling, r_tile = pw.build_pair_tiling(pos, p.cutoff_radius, tile_edge=p.cutoff_radius / 2)
    if part is not None:
        T = tiling.tile_sites.shape[0]
        s0, s1 = T * part[0] // part[1], T * (part[0] + 1) // part[1]
        tiling = type(tiling)(*(a[s0:s1].clone() for a in tiling))
    tiling = tiling.to(card)
    qmax = m + extra
    args = (tiling, r_tile, torch.tensor(pos, device=card), torch.tensor(charge, device=card),
            p.cutoff_radius, p.sigma, p.k)
    kw = dict(qmax=qmax, cand_cap=qmax if cap is None else cap, plane_f32=plane_f32)
    before = pw.pairwise_potential_tiled.launches
    got = pw.pairwise_potential_tiled(*args, **kw)
    assert pw.pairwise_potential_tiled.launches == before + 1
    want = pw.pairwise_potential_tiled_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]), int((got[0] != want[0]).sum())
    assert [bool(f) for f in got[1:]] == [bool(f) for f in want[1:]]
    assert bool(got[1]) == (case == "qmax_overflow")
    assert bool(got[2]) == (case == "cap_overflow")
    assert got[0].abs().max() > 0
    if case == "rank_share":
        inside = torch.zeros(lat.N, dtype=torch.bool, device=card)
        inside[tiling.tile_sites[tiling.tile_sites >= 0]] = True
        assert bool((got[0][~inside] == 0).all()) and bool((got[0][inside] != 0).any())
    if case in ("cap_past_ring", "list_windows"):
        _, qv, q_pos, _, _ = pw._charged_list(args[2], args[3], qmax)
        sel, cand, _ = pw.tile_candidates(tiling, r_tile, q_pos, qv, p.cutoff_radius,
                                          kw["cand_cap"])
        assert int(sel.sum(dim=1).max()) > 512
        if case == "list_windows":
            both = ((cand < 32768) & sel).any(dim=1) & ((cand >= 32768) & sel).any(dim=1)
            assert bool(both.any())


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
    # the CG harness's transposed scatter: repeated indices, added in order
    "index_put_accumulate_repeated": lambda v, P, rows: torch.zeros(
        300, dtype=v.dtype, device=v.device).index_put_((rows,), v[:70], accumulate=True),
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


@pytest.mark.cuda
def test_a_dropped_program_is_not_freed_inside_a_capture(card):
    """A program's graphs sit in a reference cycle (its steps are bound
    methods of the program), so a dropped program waits for the cyclic
    collector, which may run at any allocation; the collector is off while
    a capture runs, so it cannot destroy a graph inside one. Here the body
    sets it to run at every allocation. In a process of its own: a failed
    capture may leave its CUDA context unusable."""
    code = ("import gc, torch\n"
            "from akmc_tpu_torch.ops.device_loop import GraphLoop, StepProgram\n"
            "x, f = torch.zeros(4, device='cuda'), torch.zeros(2, device='cuda')\n"
            "class Program:\n"
            "    def __init__(self):\n"
            "        self.loop = GraphLoop(self.body, 2, x.device, f, 1)\n"
            "    def body(self, n):\n"
            "        f.zero_()\n"
            "Program()\n"
            "def body():\n"
            "    x.add_(1.0)\n"
            "    gc.set_threshold(1, 1, 1)\n"
            "    return [[] for _ in range(1000)]\n"
            "StepProgram(body, x.device).capture(warm=False)\n"
            "torch.cuda.synchronize()\n"
            "print('captured')\n")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0 and "captured" in run.stdout, run.stderr[-2000:]
    assert "not permitted when stream is capturing" not in run.stderr, run.stderr[-2000:]


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


# ----------------------------------------------------------------------------
# the CG device loops (solvers/cg.py)
# ----------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("n", [31_088, 409_600])
@pytest.mark.parametrize("dot", ["torch.dot", "f64_vdot"])
def test_cg_dots_are_the_same_bits_in_a_graph(card, n, dot):
    """The CG's two dots (cuBLAS ``ddot``; multiply + sum) give the same bits
    replayed in a graph as run eagerly, at the disordered stand-in's and the
    409,600-slot crossbar's lengths."""
    from akmc_tpu_torch.solvers.cg import f64_vdot

    fn = torch.dot if dot == "torch.dot" else f64_vdot
    rng = np.random.default_rng(n)
    a, b = (torch.tensor(rng.standard_normal(n), device=card) for _ in range(2))
    out, eager = _capture_and_replay(fn, a, b)
    assert torch.equal(out, eager)


@contextlib.contextmanager
def _cg_as(mode, graphs_seen):
    """Every single-device caller's CG as the host loop (``mode`` "plain")
    or as the device loop at k = ``mode`` (None: the default on a card),
    each result appended to the yielded list and each programs' cache to
    ``graphs_seen``."""
    from akmc_tpu_torch.solvers import banded, cg, cg_harness, current, heat, poisson

    log, saved = [], []

    def wrap(name):
        device, plain = getattr(cg, name), getattr(cg, name + "_plain")

        def run(*args, graphs=None, **kw):
            if mode == "plain":
                res = plain(*args, **kw)
            else:
                graphs_seen.append(graphs)
                res = device(*args, graphs=graphs, k=mode, **kw)
            log.append(res)
            return res
        return run

    for mod in (banded, poisson, current, heat, cg_harness):
        for name in ("jacobi_cg", "symscaled_cg"):
            if hasattr(mod, name):
                saved.append((mod, name, getattr(mod, name)))
                setattr(mod, name, wrap(name))
    try:
        yield log
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _cg_toy(dev, **model_kw):
    from akmc_tpu_torch.models.crossbar import toy_device
    from akmc_tpu_torch.models.vcm import VCMModel
    from akmc_tpu_torch.state import make_device_state

    p, lat = toy_device(nx=10, ny=3, nz=3, contact_layers=3, vacancy_fraction=0.3)
    model = VCMModel(p, lat, device=dev, use_dia_k=False, **model_kw)
    state = make_device_state(lat, p.background_temp, torch.device(dev))
    return model, state.replace(potential_boundary=torch.full_like(state.potential_boundary,
                                                                   0.1))


def _cg_caller(name, dev):
    """A function that runs ``name``'s CG solves on the toy and returns what
    they give back."""
    from akmc_tpu_torch.solvers import cg_harness
    from akmc_tpu_torch.solvers.heat import build_local_heat, update_temperature_local_steady

    if name == "harness":
        return lambda: [cg_harness.run(n=4096, devices=1, contrast=1e8, device=dev),
                        cg_harness.run_split(n=4096, n_sub=592, devices=1, device=dev)]
    model, state = _cg_toy(dev, use_banded_k=name != "ell")
    el, q, pb = state.element, state.charge, state.potential_boundary
    if name in ("banded", "ell"):
        # at 0 V from a nonzero start b = 0 and r.z / b.b is infinite: the
        # solve runs to its cut, its iterates underflowing towards 0 / 0
        return lambda: [model._solve_boundary(el, q, pb, 2.0),
                        model._solve_boundary(el, q, pb, 0.0, max_iterations=50)]
    if name == "banded_carry":
        def carried():
            out, carry = [], None
            for _ in range(3):
                pot, res, carry = model._solve_boundary_carry(el, q, pb, 2.0, carry)
                out += [pot, res, carry.r]
            return out
        return carried
    if name == "cb_edge":
        model.step_program = False      # the CG's own loop (a program's is a while node)
        return lambda: [model.update_cb_edge(state, Vd).cb_edge for Vd in (2.0, 3.0)]
    if name.startswith("power"):
        if name == "power_gather":
            model._power_band_built = True
        s = model.update_cb_edge(state, 2.0)
        return lambda: [model.update_power(s, Vd, rtol_scale=r)[1:]
                        for Vd, r in ((2.0, 1.0), (2.0, 1e-3))]
    lat = model.lat
    lh = build_local_heat(lat.neigh_idx, lat.N, model.params.num_atoms_first_layer * 3).to(dev)
    power = torch.linspace(0.0, 1e-9, state.temperature.shape[0], dtype=torch.float64,
                           device=dev)
    return lambda: [update_temperature_local_steady(
        lh, state.temperature, w, el, 300.0, 3.5e-10, 0.725, 5.0, graphs=model.cg_graphs)
        for w in (power, 0.0 * power)]


def _same_bits(a, b) -> bool:
    """Equal to the bit, NaNs included."""
    if a.dtype == torch.float64:
        a, b = a.view(torch.int64), b.view(torch.int64)
    return torch.equal(a, b)


def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    if isinstance(out, dict):
        return [v for k, v in sorted(out.items()) if k != "wall_s"]
    return [out]


@pytest.mark.cuda
@pytest.mark.parametrize("caller", ["banded", "banded_carry", "ell", "cb_edge", "power_band",
                                    "power_gather", "heat", "harness"])
def test_cg_device_loops_match_plain_on_card(card, caller):
    """Each single-device caller's CG replayed on the card (k = 3, and the
    default) against its host loop on the card from the same inputs: x, r,
    residual, iteration count and every output equal to the bit. Then one
    replay and one eager step of each program it used with host reads made
    errors: no hidden read is left inside a step."""
    from akmc_tpu_torch.solvers import cg

    solve = _cg_caller(caller, card)
    with _cg_as("plain", []) as ref_log:
        ref = solve()
    seen = []
    for k in (3, None):
        cg.reset_cg_counts()
        with _cg_as(k, seen) as log:
            out = solve()
        assert [r.iterations for r in log] == [r.iterations for r in ref_log], k
        for a, b in zip(log, ref_log):
            for f in ("x", "r", "residual_sq"):
                assert _same_bits(getattr(a, f), getattr(b, f)), (caller, k, f)
        for a, b in zip(_tensors(out), _tensors(ref)):
            assert _same_bits(a, b) if isinstance(a, torch.Tensor) else a == b, (caller, k)
        steps = sum(c["steps"] for c in cg.CG_COUNTS.values())
        assert steps >= sum(max(r.iterations - 1, 0) for r in log)
    progs = [p for g in seen if g is not None for prog in g.programs.values()
             for p in prog.loop.programs.values()]
    assert progs and all(p.graph is not None for p in progs)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for p in progs:
            p.run()
            p.body()
    finally:
        torch.cuda.set_sync_debug_mode(0)


# ----------------------------------------------------------------------------
# the superstep as one CUDA graph (ops/device_loop.py::while_loop,
# csrc/graph_while.cu, models/step_program.py)
# ----------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 1000])
def test_while_node_runs_a_counter_loop(card, n):
    """A conditional while node captured into a graph runs its body n times
    at every replay (0 passes when the flag is false at entry), with the
    body's temporaries in the bodies' pool."""
    from akmc_tpu_torch.ops import device_loop

    runtime, driver = device_loop.cuda_versions()
    assert runtime >= 12030 and driver >= 12030, (runtime, driver)
    count = torch.zeros((), dtype=torch.int64, device=card)
    limit = torch.zeros((), dtype=torch.int64, device=card)
    live = torch.zeros((), dtype=torch.bool, device=card)
    acc = torch.zeros(4, dtype=torch.float64, device=card)

    def body():
        twice = (acc + 1.0) * 2.0          # temporaries made and dropped in the body
        acc.copy_(twice / 2.0)
        count.add_(1)
        live.copy_(count < limit)

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        live.copy_(count < limit)
        device_loop.while_loop(live, body)
    for _ in range(2):
        count.zero_()
        acc.zero_()
        limit.fill_(n)
        graph.replay()
        torch.cuda.synchronize()
        assert int(count) == n
        assert acc.tolist() == [float(n)] * 4


@pytest.mark.cuda
def test_a_while_body_that_reads_raises(card):
    """A body that reads a value back cannot be captured: the capture raises."""
    from akmc_tpu_torch.ops import device_loop

    live = torch.zeros((), dtype=torch.bool, device=card)
    x = torch.ones((), device=card)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError):
        with torch.cuda.graph(graph):
            device_loop.while_loop(live, lambda: live.copy_(torch.tensor(float(x) > 2.0)))
    torch.cuda.synchronize()


def _graph_cases():
    """(name, params, lattice, model options) of the two small structures."""
    from akmc_tpu_torch.models.crossbar import toy_device

    p, lat = build_grid_crossbar(n_yz=6, contact_slices=2, oxide_slices=6, ti_slices=2,
                                 defect_fraction=0.3, vacancy_concentration=0.1, seed=3)
    yield "crossbar-n6", p, lat, {}
    p, lat = toy_device()
    yield "toy-banded", p, lat, dict(use_dia_k=False)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["crossbar-n6", "toy-banded"])
def test_superstep_graph_matches_per_loop_path(card, case):
    """Supersteps as one graph replay each equal the per-loop path's to the
    bit (state, stats, draws, K solves and iterations), with one host read a
    superstep; k = 3 per dispatch reads once for the three."""
    from akmc_tpu_torch.models.vcm import VCMModel
    from akmc_tpu_torch.rng import BufferedStream, ReferenceRNG
    from akmc_tpu_torch.state import make_device_state

    name, p, lat, kw = next(c for c in _graph_cases() if c[0] == case)
    runs = []
    for programmed in (False, True, True):
        m = VCMModel(p, lat, device=card, step_program=programmed, **kw)
        s = make_device_state(lat, p.background_temp, m.device)
        stream = BufferedStream(ReferenceRNG(1))
        stats, reads = [], []
        for i in range(4):
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    s, st = m.superstep(s, 2.0, stream)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            stats.append(st)
            reads.append(sum("synchroniz" in str(w.message) for w in caught))
        if programmed:
            assert reads[1:] == [1, 1, 1], reads       # the first call also captures
        more = []
        for i in range(2):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    s, sl = m.superstep_multi(s, 2.0, stream, k=3)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            more += sl
            if programmed and i:
                assert sum("synchroniz" in str(w.message) for w in caught) == 1
        runs.append((s, stats + more, stream.peek(1)[0], m.k_solves, m.k_iterations))
    a, b, c = runs
    for field in ("element", "charge", "potential_boundary", "potential_charge", "kmc_time"):
        assert torch.equal(getattr(a[0], field), getattr(b[0], field)), field
        assert torch.equal(getattr(b[0], field), getattr(c[0], field)), field
    assert a[1:] == b[1:] == c[1:]


# ----------------------------------------------------------------------------
# the production supersteps as one CUDA graph each, drawing from the threefry
# key on the card (models/step_program.py::ProductionProgram, csrc/threefry.cu)
# ----------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("batch", [0, 8], ids=["native", "batched"])
@pytest.mark.parametrize("case", ["crossbar-n6", "toy-banded"])
def test_production_graph_matches_per_loop_path(card, case, batch):
    """``superstep_native`` / ``superstep_native_batched`` on a ``KeyDraws``
    source as one graph replay each equal the per-loop path (device loops
    drawing in their steps) to the bit: state, stats and the key; one host read a superstep after the capture; the threefry
    kernel launched once a superstep plus once a batch or event pass, and
    the while node's condition once more per loop."""
    from akmc_tpu_torch.models.vcm import VCMModel
    from akmc_tpu_torch.ops import device_loop, threefry
    from akmc_tpu_torch.state import make_device_state

    name, p, lat, kw = next(c for c in _graph_cases() if c[0] == case)
    runs = []
    for programmed in (False, True, True):
        m = VCMModel(p, lat, device=card, step_program=programmed, **kw)
        s = make_device_state(lat, p.background_temp, m.device)
        draws = threefry.KeyDraws.seeded(5, card)
        stats, reads, pb_prev2 = [], [], None
        launches0 = threefry.draw_step.launches, device_loop.while_loop.launches
        for Vd in (2.0, 2.0, 3.0, 3.0):
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    pb = s.potential_boundary
                    if batch:
                        s, st = m.superstep_native_batched(s, Vd, draws, batch=batch,
                                                           pb_prev2=pb_prev2, k_extrap=0.5)
                    else:
                        s, st = m.superstep_native(s, Vd, draws)
                    pb_prev2 = pb
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            stats.append(st)
            reads.append(sum("synchroniz" in str(w.message) for w in caught))
        if programmed:
            assert reads[1:] == [1, 1, 1], reads          # the first call also captures
            assert m.step_counts["runs"] == 4 and m.step_counts["redos"] == 0
            steps = sum(x.get("n_batches", x["n_events"]) for x in stats)
            # per superstep: the split, then one launch per batch or event
            # (k = 1 a pass) and one for the pass that finds the loop dead
            assert threefry.draw_step.launches - launches0[0] >= 4 + steps
            assert device_loop.while_loop.launches > launches0[1]
        runs.append((s, stats, draws.key.tolist()))
    ref = runs[0]
    for r in runs[1:]:
        for field in ("element", "charge", "potential_boundary", "potential_charge",
                      "kmc_time"):
            assert torch.equal(getattr(ref[0], field), getattr(r[0], field)), field
        assert r[1:] == ref[1:]


# ----------------------------------------------------------------------------
# spans inside the programs (runtime/profiling.py, the stamp kernels of
# csrc/graph_while.cu)
# ----------------------------------------------------------------------------
def _spanned_batched(card, spans, n=3):
    """``n`` batched production supersteps on the n_yz = 6 crossbar with the
    model's spans ``spans``: (states, stats, each dispatch's spans, the
    counted launches of the threefry kernel, the while nodes' condition
    kernel and the fused CG)."""
    from akmc_tpu_torch.models.vcm import VCMModel
    from akmc_tpu_torch.ops import device_loop, threefry
    from akmc_tpu_torch.solvers import dia_cg
    from akmc_tpu_torch.state import make_device_state

    name, p, lat, kw = next(c for c in _graph_cases() if c[0] == "crossbar-n6")
    m = VCMModel(p, lat, device=card, **kw)
    m.spans = spans
    s = make_device_state(lat, p.background_temp, m.device)
    m.warmup(s, 2.0, batched=8)
    draws = threefry.KeyDraws.seeded(5, card)
    fns = (threefry.draw_step, dia_cg.dia_cg_solve)
    before = [f.launches for f in fns] + [device_loop.while_loop.launches]
    states, stats, tables = [], [], []
    for _ in range(n):
        s, st = m.superstep_native_batched(s, 2.0, draws, batch=8)
        states.append(s)
        stats.append(st)
        tables.append(m.last_spans)
    after = [f.launches for f in fns] + [device_loop.while_loop.launches]
    return states, stats, tables, [a - b for a, b in zip(after, before)]


@pytest.mark.cuda
def test_spans_off_launch_the_same_kernels_and_bits(card):
    """A program captured with spans off launches the kernels it launched
    before spans existed (counted launches of the threefry kernel, the fused
    CG and the while nodes' condition) and gives the bits of one captured
    with spans on; with spans off no dispatch reads a table."""
    off = _spanned_batched(card, False)
    on = _spanned_batched(card, True)
    assert off[3] == on[3] and off[3][0] > 0
    assert off[1] == on[1] and all(t == {} for t in off[2])
    for a, b in zip(off[0], on[0]):
        for f in ("element", "charge", "potential_boundary", "potential_charge", "kmc_time"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    spans = on[2][-1]
    assert spans["batch.race"]["n"] == on[1][-1]["n_batches"] == spans["batch.resolve"]["n"]
    assert spans["k_solve"]["n"] == spans["superstep"]["n"] == 1


@pytest.mark.cuda
def test_aligned_spans_fall_inside_their_dispatch(card):
    """Under ``torch.profiler`` each dispatch's anchor puts its device spans on
    the profile's clock: ``superstep`` opens after the host's ``launch``
    began and closes before its ``read`` ended; the anchors' offsets agree
    to 20 µs; ``%globaltimer`` steps by no more than a microsecond."""
    from akmc_tpu_torch.runtime import profiling

    _spanned_batched(card, True, n=1)          # builds and captures
    with profiling.collecting() as got, torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        _spanned_batched(card, True)
        torch.cuda.synchronize()
    aligned = profiling.align(prof, got)
    host = {}
    for s, e, name in profiling.host_ranges(prof, "akmc.production."):
        host.setdefault(name.rsplit(".", 1)[-1], []).append((s, e))
    launch, read = sorted(host["launch"]), sorted(host["read"])
    steps = [(n, a, b, k) for n, _, a, b, _, k in aligned.spans if n == "superstep"]
    assert len(steps) == len(got) == len(launch) == len(read)
    for n, a, b, k in steps:
        assert launch[k][0] <= a < b <= read[k][1], (k, a, b, launch[k], read[k])
    assert aligned.offset_spread_us <= 20.0, aligned.offsets_us
    res = profiling.clock_resolution_ns(card)
    assert res["min_step_ns"] is not None and 0 < res["min_step_ns"] <= 1000, res


# ----------------------------------------------------------------------------
# the full-physics superstep as one CUDA graph (models/step_program.py::FullProgram)
# ----------------------------------------------------------------------------
def _full_case(case):
    """(params, lattice, model options, heating model) of a full-physics case."""
    name, p, lat, kw = next(c for c in _graph_cases() if c[0] == case.split(":")[0])
    heating = case.split(":")[1]
    p = p.replace(
        solve_current=True, solve_heating_global=heating == "global",
        solve_heating_local=heating.startswith("local"), dissipation_constant=1e-13,
        t_ox=5e-9, A=(12 * 2.0e-10) ** 2, c_p=1.92,
        delta_t=1e-3 if heating == "local-transient" else 1e-13, L_char=3.5e-10,
        k_th_non_vacancy=0.5, k_th_vacancies=5.0,
        num_atoms_contact=p.num_atoms_first_layer * p.num_layers_contact)
    return p, lat, dict(kw, ne_max=64)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["crossbar-n6:global", "toy-banded:global",
                                  "toy-banded:local-steady", "toy-banded:local-transient"])
def test_full_graph_matches_per_loop_path(card, case):
    """``superstep_full`` as one graph replay each (captured under
    ``refuse_syncs``) equals the per-loop path to the bit: state, stats, the
    power solve's warm start and the stream; one host read a superstep after
    the capture, and one for a ``superstep_full_multi`` batch of 2."""
    from akmc_tpu_torch.models.vcm import VCMModel
    from akmc_tpu_torch.rng import BufferedStream, ReferenceRNG
    from akmc_tpu_torch.state import make_device_state

    p, lat, kw = _full_case(case)

    def reads_of(fn):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return out, sum("synchroniz" in str(w.message) for w in caught)

    runs = []
    for programmed in (False, True, True):
        m = VCMModel(p, lat, device=card, step_program=programmed, **kw)
        s = m.update_cb_edge(make_device_state(lat, p.background_temp, m.device), 5.0)
        stream = BufferedStream(ReferenceRNG(1))
        stats, reads, mw = [], [], None
        for i in range(3):
            (s, st, mw), n = reads_of(lambda: m.superstep_full(
                s, 5.0, stream, m_prev=mw, rtol_scale=1e-2 if i % 2 else 1.0))
            stats.append(st)
            reads.append(n)
        for i in range(2):
            (s, more, mw), n = reads_of(lambda: m.superstep_full_multi(s, 5.0, stream, 2,
                                                                        m_prev=mw))
            stats += more
            reads.append(n)
        if programmed:
            assert m.step_counts["per_loop"] == 0 and m.step_counts["discards"] == 0
            assert reads[1:3] == [1, 1] and reads[4] == 1, reads   # first calls capture
        runs.append((s, stats, mw, stream.peek(1)[0]))
    ref = runs[0]
    for r in runs[1:]:
        for field in ("element", "charge", "potential_boundary", "potential_charge",
                      "kmc_time", "power", "temperature", "T_bg"):
            assert torch.equal(getattr(ref[0], field), getattr(r[0], field)), field
        assert torch.equal(ref[2], r[2])
        assert r[1] == ref[1] and r[3] == ref[3]


# ----------------------------------------------------------------------------
# the deck modes and the per-bias CB edge as one CUDA graph each
# (models/step_program.py: FieldsProgram, EventsOnlyProgram, CbEdgeProgram)
# ----------------------------------------------------------------------------
def _reads_of(fn):
    """(fn's result, the host reads it made)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchroniz" in str(w.message) for w in caught)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fields", "events_only", "cb_edge"])
@pytest.mark.parametrize("case", ["crossbar-n6", "toy-banded"])
def test_deck_programs_match_per_loop_path(card, case, kind):
    """``fields_only``, ``superstep_events_only`` (on the stale fields at
    8 V) and ``update_cb_edge`` as one graph replay a call equal the per-loop
    path to the bit, with one host read a call after the capture (more only
    for a continuation); on the DIA operator both kernels launch from inside
    ``FieldsProgram``'s graph once per K solve."""
    from akmc_tpu_torch.models.vcm import VCMModel
    from akmc_tpu_torch.ops import dia_matvec
    from akmc_tpu_torch.rng import BufferedStream, ReferenceRNG
    from akmc_tpu_torch.solvers import dia_cg
    from akmc_tpu_torch.state import make_device_state

    name, p, lat, kw = next(c for c in _graph_cases() if c[0] == case)
    s0 = make_device_state(lat, p.background_temp, card)
    if kind == "events_only":
        s0, _ = VCMModel(p, lat, device=card, step_program=False, **kw).fields_only(s0, 8.0)
    runs = []
    for programmed in (False, True, True):
        m = VCMModel(p, lat, device=card, step_program=programmed, **kw)
        s, stream = s0, BufferedStream(ReferenceRNG(1))
        stats, reads = [], []
        launches0 = dia_matvec.dia_combined_matvec.launches, dia_cg.dia_cg_solve.launches
        for Vd in (2.0, 3.0, 3.0):
            if kind == "fields":
                (s, st), n = _reads_of(lambda: m.fields_only(s, Vd))
            elif kind == "events_only":
                (s, st), n = _reads_of(lambda: m.superstep_events_only(s, stream))
            else:
                s, n = _reads_of(lambda: m.update_cb_edge(s, Vd))
                st = {"cg_iterations": m.cb_iterations}
            stats.append(st)
            reads.append(n)
        if programmed:
            counts = m.cb_counts if kind == "cb_edge" else m.step_counts
            assert counts["runs"] == 3 and counts["per_loop"] == 0, counts
            if not m.step_counts["continues"]:
                assert reads[1:] == [1, 1], reads       # the first call also captures
            if kind == "fields" and m.dia is not None:
                assert (dia_matvec.dia_combined_matvec.launches - launches0[0],
                        dia_cg.dia_cg_solve.launches - launches0[1]) == (m.k_solves,) * 2
        runs.append((s, stats, stream.peek(1)[0]))
    ref = runs[0]
    for r in runs[1:]:
        for field in ("element", "charge", "potential_boundary", "potential_charge",
                      "kmc_time", "cb_edge"):
            a, b = getattr(ref[0], field), getattr(r[0], field)
            if a.dtype == torch.float64:
                a, b = a.view(torch.int64), b.view(torch.int64)
            assert torch.equal(a, b), field
        assert r[1:] == ref[1:]


@pytest.mark.cuda
def test_program_bindings_live_and_poisoned_memory_unread(card, monkeypatch):
    """Every program kind captured with the binding trace on binds only
    spans inside live blocks of the caching allocator, and replays the same
    bits after every free block (the default pool, its own, the while
    bodies') was filled with NaN bytes."""
    from akmc_tpu_torch.models.vcm import VCMModel
    from akmc_tpu_torch.ops import device_loop
    from akmc_tpu_torch.ops.threefry import KeyDraws
    from akmc_tpu_torch.rng import BufferedStream, ReferenceRNG
    from akmc_tpu_torch.solvers import dia_cg
    from akmc_tpu_torch.state import make_device_state

    monkeypatch.setattr(device_loop, "TRACE_BINDINGS", True)
    p, lat, kw = _full_case("crossbar-n6:global")
    m = VCMModel(p, lat, device=card, **kw)
    s = m.update_cb_edge(make_device_state(lat, p.background_temp, card), 5.0)
    stream, draws = BufferedStream(ReferenceRNG(1)), KeyDraws.seeded(3, card)
    s, _ = m.superstep(s, 5.0, stream)
    s, _ = m.superstep_native_batched(s, 5.0, draws, batch=8)
    s, _, _ = m.superstep_full(s, 5.0, stream)
    s, _ = m.fields_only(s, 5.0)
    s, _ = m.superstep_events_only(s, stream)
    kinds = set()
    for prog in m.step_graphs.programs.values():
        assert prog.bound and not device_loop.stale_bindings(prog.bound, card)

        def replay():
            with dia_cg.iterations_total_kept(card):
                prog.graph.replay()
            torch.cuda.synchronize()
            out, stats, _ = prog.captured
            return [t.clone() for t in (*out.values(), stats) if isinstance(t, torch.Tensor)]

        before = replay()
        assert device_loop.poison_free_blocks(
            card, [prog.graph.pool(), *device_loop.private_pools(card)]) > 0
        after = replay()
        for a, b in zip(before, after):
            if a.dtype == torch.float64:
                a, b = a.view(torch.int64), b.view(torch.int64)
            assert torch.equal(a, b), type(prog).__name__
        kinds.add(type(prog).__name__)
    assert kinds == {"SuperstepProgram", "ProductionProgram", "FullProgram", "FieldsProgram",
                     "EventsOnlyProgram", "CbEdgeProgram"}
