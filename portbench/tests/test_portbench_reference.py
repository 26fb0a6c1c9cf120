"""The plain reference's layers on toy structures against hand-worked values."""

import math

import pytest
import torch

from portbench.reference import events, fields, lattice, streams

f64 = torch.float64


def test_threefry_known_answers():
    # Random123's known-answer vectors for threefry2x32_20 (counter, key -> output)
    cases = [((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
             ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
             ((0x243F6A88, 0x85A308D3), (0x13198A2E, 0x03707344), (0xC4923A9C, 0x483DF7A0))]
    for (c0, c1), (k0, k1), want in cases:
        t = lambda v: torch.tensor([v], dtype=torch.int64)
        got = streams.threefry2x32(k0, k1, t(c0), t(c1))
        assert (int(got[0]), int(got[1])) == want


def test_mt19937_known_answer_and_doubles():
    u = streams.mt19937_uniforms(5489, 0, 2)
    # std::mt19937's first outputs for its default seed 5489
    w0, w1, w2, w3 = 3499211612, 581869302, 3890346734, 3586334585
    assert u[0] == (w0 + w1 * 4294967296.0) / 18446744073709551616.0
    assert u[1] == (w2 + w3 * 4294967296.0) / 18446744073709551616.0
    assert streams.mt19937_uniforms(5489, 1, 1)[0] == u[1]


def test_uniform_bits():
    k = streams.key(42, "cpu")
    u64, u32 = streams.uniform(k, 1000, f64), streams.uniform(k, 1000, torch.float32)
    assert 0.0 <= float(u64.min()) and float(u64.max()) < 1.0
    assert 0.0 <= float(u32.min()) and float(u32.max()) < 1.0
    assert abs(float(u64.mean()) - 0.5) < 0.05


def test_neighbors_on_a_chain_and_an_excluded_site():
    pos = torch.tensor([[0.0, 0, 0], [1.0, 0, 0], [2.0, 0, 0], [3.0, 0, 0]], dtype=f64)
    excl = torch.tensor([False, False, False, True])
    nbr = lattice.neighbors(pos, 1.5, excl)
    assert nbr.tolist() == [[1, -1], [0, 2], [1, -1], [-1, -1]]
    # strictly inside the radius
    assert lattice.neighbors(pos, 1.0, excl).tolist() == [[-1], [-1], [-1], [-1]]


def test_layer_ids_last_match_wins():
    lay = [dict(start_x=0.0, end_x=2.0), dict(start_x=2.0, end_x=4.0)]
    assert lattice.layer_ids(torch.tensor([0.0, 2.0, 3.0], dtype=f64), lay).tolist() == [0, 1, 1]


def test_charge_rules():
    E = lattice.ELEM
    # chain: Ti, V, V, V, O, Od ; site 1 touches the metal, site 2 has two
    # vacancy neighbors, site 3 one, site 5 (Od) no metal
    element = torch.tensor([E["Ti"], E["VACANCY"], E["VACANCY"], E["VACANCY"], E["O"],
                            E["OXYGEN_DEFECT"]], dtype=torch.int32)
    nbr = torch.tensor([[1, -1], [0, 2], [1, 3], [2, 4], [3, 5], [4, -1]])
    metal = element == E["Ti"]
    q = fields.charges(element, torch.zeros(6, dtype=torch.int32), nbr, metal)
    assert q.tolist() == [0, 0, 0, 2, 0, -2]


def test_k_system_on_a_chain():
    E = lattice.ELEM
    element = torch.full((5,), E["O"], dtype=torch.int32)
    charge = torch.zeros(5, dtype=torch.int32)
    nbr = torch.tensor([[1, -1], [0, 2], [1, 3], [2, 4], [3, -1]])
    metal = torch.zeros(5, dtype=torch.bool)
    ks = fields.KSystem(element, charge, nbr, metal, 1, 2.0, 1.0, 1e-8)
    # every edge low_G g: 2 x1 - x2 = -g V/2 / g ... the potential is linear
    assert ks.diag.tolist() == pytest.approx([2e-8] * 3)
    assert ks.rhs.tolist() == pytest.approx([-1e-8, 0.0, 1e-8])
    x, iters = ks.solve(torch.zeros(5, dtype=f64))
    assert x.tolist() == pytest.approx([0.0, -0.5, 0.0, 0.5, 0.0], abs=1e-12)
    assert ks.residual_ratio(x) < 1.0
    assert ks.residual_ratio(torch.zeros(5, dtype=f64)) > 1e6


def test_pairwise_of_two_charges():
    pos = torch.tensor([[0.0, 0, 0], [5.0, 0, 0], [30.0, 0, 0]], dtype=f64)
    charge = torch.tensor([2, 0, -2], dtype=torch.int32)
    sigma, k = 3.5e-10, 8.987552e9 / 23.0
    got = fields.pairwise(torch.arange(3), pos, charge, 20.0, sigma, k)
    d = 5e-10
    want1 = 2 * math.erfc(d / (sigma * math.sqrt(2))) * k * 1.60217663e-19 / d
    assert float(got[1]) == pytest.approx(want1, rel=1e-14)
    assert float(got[0]) == 0.0 and float(got[2]) == 0.0   # beyond the cutoff, no self term


def _two_pair_table(E):
    # sites: 0 DEFECT, 1 O, 2 V ; 0-1 and 1-2 are neighbors
    element = torch.tensor([E["DEFECT"], E["O"], E["VACANCY"]], dtype=torch.int32)
    pos = torch.tensor([[0.0, 0, 0], [2.0, 0, 0], [4.0, 0, 0]], dtype=f64)
    nbr = torch.tensor([[1, -1], [0, 2], [1, -1]])
    layer = torch.zeros(3, dtype=torch.int64)
    return element, pos, nbr, layer


def test_rates_of_a_generation_and_a_diffusion():
    E = lattice.ELEM
    element, pos, nbr, layer = _two_pair_table(E)
    t = events.Table(element, pos, nbr, layer, 3.5e-10, 8.987552e9 / 23.0)
    assert t.rows == 256 and t.act.tolist() == [0, 1, 2]
    charge = torch.tensor([0, 0, 2], dtype=torch.int32)
    pot = torch.tensor([0.1, 0.0, 0.3], dtype=f64)
    en = {"gen": [1.0], "rec": [0.5], "vdiff": [0.8], "odiff": [0.7]}
    P, ety, ln_S = t.rates(element, charge, pot, 300.0, en, 1e13, False)
    kT = 8.617333262e-5 * 300.0
    gen = 1e13 / (math.exp((1.0 - 2 * 0.1) / kT) + 1e-200)
    s2 = float(t.s2[2, 0])
    ea_v = 0.8 - 2.0 * (0.3 + 1.0 * s2)
    vdiff = 1e13 / (math.exp(ea_v / kT) + 1e-200)
    assert float(P[0, 0]) == pytest.approx(gen, rel=1e-13) and int(ety[0, 0]) == events.GEN
    assert float(P[2, 0]) == pytest.approx(vdiff, rel=1e-13) and int(ety[2, 0]) == events.VDIFF
    assert float(P[1].sum()) == 0.0 and ln_S is None
    Pn, _, ln_S = t.rates(element, charge, pot, 300.0, en, 1e13, True)
    assert float(Pn.max()) == 1.0
    assert math.log(float(Pn[0, 0])) + ln_S == pytest.approx(math.log(gen), rel=1e-12)


def test_serial_loop_fires_the_drawn_event_and_stops():
    E = lattice.ELEM
    element, pos, nbr, layer = _two_pair_table(E)
    t = events.Table(element, pos, nbr, layer, 3.5e-10, 8.987552e9 / 23.0)
    charge = torch.tensor([0, 0, 2], dtype=torch.int32)
    P = torch.zeros(t.rows, t.nbr.shape[1], dtype=f64)
    P[0, 0], P[2, 0] = 1.0, 3.0              # generation 0->1, diffusion 2->1
    ety = torch.full_like(P, events.NULL_EVENT, dtype=torch.int64)
    ety[0, 0], ety[2, 0] = events.GEN, events.VDIFF
    # u1 = 0.5: target 2.0 lies in row 2's mass -> the diffusion fires; the
    # waiting time -ln(u2)/4 reaches 1/freq at once, so the loop stops
    el, q, n, tm = events.serial(t, element, charge, P, ety, None, 1.0, [0.5, math.exp(-8.0)])
    assert n == 1 and tm == pytest.approx(2.0)
    assert el.tolist() == [E["DEFECT"], E["VACANCY"], E["O"]] and q.tolist() == [0, 2, 0]
