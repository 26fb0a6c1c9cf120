"""The contact-trap block's kernel (``csrc/wkb_ct.cu``) and its plain twin.

The kernel gives each (contact, trap) pair a lane that sums the pair's terms
in a register up to the pair's own energy window; the plain twin
(``solvers/current.py::wkb_block_plain``, the build on the CPU and under
``wkb_f32``) runs every pair of a chunk to the chunk's shared bound, adding
exact zeros past each pair's window. The CPU tests hold the kernel's algorithm, written here as a
plain per-pair loop in the kernel's order, to the twin bit for bit; the tests
marked ``cuda`` hold the kernel itself to the twin on the card. The file
imports no JAX, so the card's tests run on a machine with the port's
dependencies alone:

    python -m pytest --noconftest -m cuda tests/test_torch_wkb_kernel.py
"""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from akmc_tpu_torch.config import EV_TO_J
from akmc_tpu_torch.solvers import current as tcur

F64 = torch.float64
DE_STEP = EV_TO_J * 0.01
M_E, V0 = 9.10938356e-31, 1.6       # the 5 nm deck's barrier: E2 changes sign past 1.6 eV
TOL = EV_TO_J * 0.01
NN_DIST = 3.5
KTABLE = 1024                       # csrc/wkb_ct.cu's kTable: energy steps a shared table holds
# ATen's CPU pow is two functions: a vector body (SLEEF) and a scalar tail
# (std::pow), which differ in the last bit at about one value in seventy
# (its square root's vector body is not std::sqrt either).
# The twin's planes here hold a multiple of 16 values and at most 32,768
# (one task), so every E2^1.5 of theirs is the vector body's, and its
# (steps, 1, 1) table of E1^1.5 the scalar path's. The per-pair loop below
# evaluates its E2^1.5 and exponentials in chunks of this many values, padded
# to a multiple of 16: the vector body for every value, whatever the CPU.
_CHUNK = 16384


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the wkb_ct kernel has no CPU mode")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# the kernel's order as a plain per-pair loop (CPU)
# ---------------------------------------------------------------------------
def _vector_body(fn, values: list) -> list:
    """``fn`` of each value as ATen's vector body computes it (see _CHUNK)."""
    out = []
    for s in range(0, len(values), _CHUNK):
        part = values[s:s + _CHUNK]
        pad = -len(part) % 16
        t = torch.tensor(part + [1.0] * pad, dtype=F64)
        out.extend(fn(t).tolist()[:len(part)])
    return out


def _pair_d2(pa, pb, lattice, pbc: bool) -> float:
    """One pair's squared distance, in the kernel's order of operations."""
    dx, dy, dz = pa[0] - pb[0], pa[1] - pb[1], pa[2] - pb[2]
    if pbc:
        dy = dy / lattice[1]
        dy = (dy - round(dy)) * lattice[1]
        dz = dz / lattice[2]
        dz = (dz - round(dz)) * lattice[2]
    return (dx * dx + dy * dy) + dz * dz


def _kernel_order(dist, dE, ok, ne_max: int):
    """The kernel's sums, pair by pair: an eligible pair (``ok``) runs s = 0,
    1, ... while s < its own bound min(ceil(dE / dE_step) + 1, ne_max) and
    iv = s * dE_step < dE, adding exp(q (E1^1.5 - E2^1.5)) (E2 > 0) or
    exp(q E1^1.5) in ascending s, E1^1.5 from a per-step table. Returns
    (sums (R, C), each pair's bound (R, C), terms added)."""
    R, C = dE.shape
    prefac, E0, inv_step = tcur._prefac(M_E), EV_TO_J * V0, 1.0 / DE_STEP
    table = {}           # s -> (iv, E1, E1^1.5): the twin's table goes through std::pow
    bound = np.zeros((R, C), np.int64)
    plan = []            # (i, j, q, E1^1.5, E2 if E2 > 0 else None), s ascending a pair
    for i in range(R):
        for j in range(C):
            if not ok[i, j]:
                continue
            d, e = float(dist[i, j]), float(dE[i, j])
            q = prefac * (d / e)
            n = min(math.ceil(e * inv_step) + 1, ne_max)
            bound[i, j] = n
            for s in range(n):
                if s not in table:
                    iv = s * DE_STEP
                    table[s] = (iv, E0 + iv, math.pow(E0 + iv, 1.5))
                iv, e1, e1p = table[s]
                if not iv < e:
                    break
                e2 = e1 - e
                plan.append((i, j, q, e1p, e2 if e2 > 0 else None))
    powers = iter(_vector_body(lambda t: t ** 1.5, [x[4] for x in plan if x[4] is not None]))
    expos = [q * (e1p - next(powers)) if e2 is not None else q * e1p
             for _, _, q, e1p, e2 in plan]
    sums = np.zeros((R, C))
    for (i, j, *_), term in zip(plan, _vector_body(torch.exp, expos)):
        sums[i, j] += term
    return torch.tensor(sums), bound, len(plan)


def _pairs(seed=0, shape=(24, 40), max_steps=300):
    """Distances [m] and |dE| [J] whose windows take 1..max_steps steps: past
    160 steps (V0) E2 changes sign inside the window."""
    rng = np.random.default_rng(seed)
    dist = (3.0 + 10.0 * rng.random(shape)) * 1e-10
    dE = DE_STEP * (0.3 + (max_steps - 1.3) * rng.random(shape))
    return dist, dE


@pytest.mark.parametrize("n", [1, 100, 161, 250, 301, 2048])
def test_kernel_order_equals_the_integral(n):
    """Each pair to its own window, capped at n (the chunk's bound or the
    cap), equals ``_wkb_contact_trap`` run to the shared bound n, bit for
    bit: with the bound inside most windows, at the sign change of E2, and
    past every window."""
    dist, dE = _pairs()
    got, _, _ = _kernel_order(dist, dE, np.ones(dE.shape, bool), n)
    want = tcur._wkb_contact_trap(torch.tensor(dist), torch.tensor(dE), M_E, V0, n)
    assert torch.equal(got, want), n


@pytest.mark.parametrize("n", [90, 301])
def test_kernel_order_equals_the_integral_masked(n):
    """A masked block: pairs out of the mask give exact zeros and take no
    step; the rest equal ``_wkb_contact_trap(mask=)`` bit for bit."""
    dist, dE = _pairs(seed=1, shape=(16, 36))
    ok = np.random.default_rng(2).random(dE.shape) < 0.7
    got, bound, _ = _kernel_order(dist, dE, ok, n)
    want = tcur._wkb_contact_trap(torch.tensor(dist), torch.tensor(dE), M_E, V0, n,
                                  mask=torch.tensor(ok))
    assert torch.equal(got, want)
    assert (got[~torch.tensor(ok)] == 0).all() and (bound[~ok] == 0).all()


@pytest.mark.parametrize("ne_max", [0, 1, 50, 2048])
def test_pair_bounds_give_the_loop_bound(ne_max):
    """The kernel's by-product: the largest pair bound of a chunk's eligible
    pairs (min(1, ne_max) where none is) equals ``_ct_loop_bound``."""
    dist, dE = _pairs(seed=3)
    rng = np.random.default_rng(4)
    for share in (0.0, 0.05, 1.0):
        ok = rng.random(dE.shape) < share
        _, bound, _ = _kernel_order(dist, dE, ok, ne_max)
        want = int(tcur._ct_loop_bound(torch.tensor(dE), torch.tensor(ok), ne_max))
        assert max(min(1, ne_max), int(bound.max())) == want, share


def _synthetic(n_con=56, pad_con=8, n_vac=36, pad_vac=4, volts=3.0, seed=0,
               lattice=(40.0, 12.0, 12.0), pbc=False, ne_max=2048) -> tuple:
    """(WkbInputs, contacts, vacancies) on the CPU: two electrodes' contacts
    in atom order, each at its side's CB edge (+- volts / 2, 0.02 eV apart),
    traps between them on a linear drop with 0.3 eV of scatter, pads as
    ``build_power_system`` pads (the first atom's place, mask False, index
    -1), one trap on a contact's atom index; some pairs lie within the
    neighbor distance."""
    rng = np.random.default_rng(seed)
    Lx, Ly, Lz = lattice

    def place(x, n):
        return np.stack([x, rng.uniform(0, Ly, n), rng.uniform(0, Lz, n)], 1)

    half = n_con // 2
    xc = np.concatenate([np.sort(rng.uniform(0, 5, half)), np.sort(rng.uniform(Lx - 5, Lx, n_con - half))])
    xv = np.sort(rng.uniform(5, Lx - 5, n_vac))
    cb_c = np.where(xc < Lx / 2, volts / 2, -volts / 2) + 0.02 * rng.standard_normal(n_con)
    cb_v = volts / 2 - volts * xv / Lx + 0.3 * rng.standard_normal(n_vac)
    idx_v = n_con + np.arange(n_vac)
    idx_v[n_vac // 2] = 3

    def sites(pos, cb, idx, pad):
        pos = np.concatenate([pos, np.repeat(pos[:1], pad, 0)])
        cb = np.concatenate([cb, np.repeat(cb[:1], pad)]) * EV_TO_J
        return tcur.Sites(torch.tensor(pos), torch.tensor(cb),
                          torch.arange(len(idx) + pad) < len(idx),
                          torch.tensor(np.concatenate([idx, -np.ones(pad, np.int64)])))

    w = tcur.WkbInputs(torch.tensor(lattice, dtype=F64), pbc, NN_DIST, TOL, M_E, V0, ne_max,
                       False)
    return (w, sites(place(xc, n_con), cb_c, np.arange(n_con), pad_con),
            sites(place(xv, n_vac), cb_v, idx_v, pad_vac))


def _block_in_kernel_order(w, a, b, chunk: int):
    """The integrated block of rows ``a`` and columns ``b`` in the kernel's
    order: each pair's geometry and eligibility, then ``_kernel_order``;
    (block, each chunk's bound, terms)."""
    R, C = a.pos.shape[0], b.pos.shape[0]
    lat, pa, pb = w.lattice.tolist(), a.pos.tolist(), b.pos.tolist()
    d2 = [_pair_d2(pa[i], pb[j], lat, w.pbc) for i in range(R) for j in range(C)]
    # the CPU's square root is a library's too: its vector body, as the twin's plane
    d = np.array(_vector_body(torch.sqrt, d2)).reshape(R, C)
    dE = np.abs(a.cb.numpy()[:, None] - b.cb.numpy()[None, :])
    ok = (a.mask.numpy()[:, None] & b.mask.numpy()[None, :]
          & (a.idx.numpy()[:, None] != b.idx.numpy()[None, :]) & ~(d < w.nn_dist) & (dE > w.tol))
    dist = 1e-10 * d
    sums, bound, terms = _kernel_order(dist, dE, ok, w.ne_max)
    chunks = [max(min(1, w.ne_max), int(bound[:, s:s + chunk].max(initial=0)))
              for s in range(0, max(1, C), chunk)]
    return sums, chunks, terms


@pytest.mark.parametrize("chunked", [False, True], ids=["direct", "chunks"])
@pytest.mark.parametrize("pbc", [False, True], ids=["open", "pbc"])
def test_block_in_kernel_order_equals_the_plain_build(monkeypatch, pbc, chunked):
    """The kernel's whole chain per pair (geometry with the PBC fold,
    eligibility, factor, its own window) against ``wkb_block``'s plain
    integrated build on the CPU, direct and in chunks of 16 trap columns
    with a ragged last one: the block bit for bit, each chunk's bound equal."""
    if chunked:
        monkeypatch.setattr(tcur, "_WKB_ROW_BLOCK", 16)
    w, con, vac = _synthetic(pbc=pbc)
    bounds = []
    want = tcur.wkb_block(w, con, vac, True, bounds)
    cols = vac.pos.shape[0]
    chunk = 16 if chunked else cols
    got, chunks, _ = _block_in_kernel_order(w, con, vac, chunk)
    assert len(bounds) == -(-cols // chunk)
    assert torch.equal(got, want)
    assert [int(b) for b in bounds] == chunks
    assert (got[~con.mask] == 0).all() and (got[:, ~vac.mask] == 0).all()


def test_block_in_kernel_order_past_one_table():
    """Windows longer than the kernel's shared table (|dE| > 10.24 eV, a
    14 V drop): the per-pair loop still equals the plain build bit for bit,
    and the chunk's bound passes ``KTABLE``."""
    w, con, vac = _synthetic(volts=14.0, n_con=16, pad_con=2, n_vac=12, pad_vac=2)
    bounds = []
    want = tcur.wkb_block_plain(w, con, vac, True, bounds)
    got, chunks, _ = _block_in_kernel_order(w, con, vac, vac.pos.shape[0])
    assert [int(b) for b in bounds] == chunks and chunks[0] > KTABLE
    assert torch.equal(got, want)


def test_cpu_and_f32_take_the_plain_build(monkeypatch):
    """The kernel is the integrated block's on CUDA tensors in f64 only: on
    the CPU, in f64 and under ``wkb_f32``, the build never calls it."""
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel ran on the CPU")

    monkeypatch.setattr(tcur, "wkb_contact_trap_kernel", refuse)
    for f32 in (False, True):
        w, con, vac = _synthetic(volts=1.0)
        w = w._replace(f32=f32)
        bounds = []
        T = tcur.wkb_block(w, con, vac, True, bounds)
        assert T.dtype == (torch.float32 if f32 else F64) and len(bounds) == 1
    card_like = SimpleNamespace(is_cuda=True)
    assert tcur._ct_on_card(card_like, False) and not tcur._ct_on_card(card_like, True)
    assert not tcur._ct_on_card(torch.zeros(1), False)


# ---------------------------------------------------------------------------
# the kernel on the card
# ---------------------------------------------------------------------------
def _on(sites, dev):
    return tcur.Sites(*(t.to(dev) for t in sites))


def _twin_and_kernel(w, a, b, dev):
    """(twin's block and bounds, kernel's block and bounds, kernel launches)
    of the integrated block on the card."""
    w = w._replace(lattice=w.lattice.to(dev))
    a, b = _on(a, dev), _on(b, dev)
    tb = []
    twin = tcur.wkb_block_plain(w, a, b, True, tb)
    before = tcur.wkb_contact_trap_kernel.launches
    kb = []
    got = tcur.wkb_block(w, a, b, True, kb)
    torch.cuda.synchronize()
    return (twin, [int(x) for x in tb]), (got, [int(x) for x in kb]), \
        tcur.wkb_contact_trap_kernel.launches - before


CARD_CASES = {
    # name: (_synthetic keywords, _WKB_ROW_BLOCK or None for the default)
    "small": (dict(), None),
    "pbc": (dict(pbc=True, volts=6.0), None),
    "ne_max_biting": (dict(volts=8.0, ne_max=100), None),
    "sign_change": (dict(volts=5.0, n_con=200, pad_con=56, n_vac=300, pad_vac=20), 64),
    # 1,280 contact rows x 3,500 traps: four chunks of 1,024, the last 428 wide
    "ragged_chunks": (dict(volts=8.0, n_con=1200, pad_con=80, n_vac=3450, pad_vac=50,
                           lattice=(60.0, 46.0, 46.0), pbc=True, seed=5), None),
    # windows up to 1,256 steps: a block builds its table twice, and a pair's
    # loop carries on from the first table into the second
    "past_the_table": (dict(volts=14.0), None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_wkb_kernel_matches_twin(card, monkeypatch, case):
    """The kernel's W_ct and chunk bounds equal the plain twin's on the card
    bit for bit (same library pow and exp), in one launch."""
    kw, block = CARD_CASES[case]
    if block is not None:
        monkeypatch.setattr(tcur, "_WKB_ROW_BLOCK", block)
    w, con, vac = _synthetic(**kw)
    e0 = EV_TO_J * V0
    dE = (con.cb[:, None] - vac.cb[None, :]).abs()[con.mask][:, vac.mask]
    assert (dE > e0).any() and (dE < e0).any()        # E2 of both signs in the windows
    (twin, tb), (got, kb), launches = _twin_and_kernel(w, con, vac, card)
    assert launches == 1
    assert tb == kb and len(kb) >= 1
    if w.ne_max < 2048:
        assert max(kb) == w.ne_max                    # the cap bites
    if case == "past_the_table":
        assert max(kb) > KTABLE
    assert torch.equal(got, twin), (
        f"{int((got != twin).sum())} entries differ, max abs {float((got - twin).abs().max()):.3e}")


@pytest.mark.cuda
@pytest.mark.parametrize("ranks", [2, 3, 4])
def test_wkb_kernel_row_windows(card, monkeypatch, ranks):
    """Each rank's window of contact rows (``Mesh.split``'s cuts): the
    kernel equals the twin on those rows, their bounds included."""
    from akmc_tpu_torch.parallel.mesh import Mesh

    monkeypatch.setattr(tcur, "_WKB_ROW_BLOCK", 32)
    w, con, vac = _synthetic(volts=5.0, n_con=300, pad_con=20, n_vac=150, pad_vac=10, pbc=True)
    mesh = Mesh(0, ranks, card, "gloo")
    for a, b in mesh.split(con.pos.shape[0]):
        (twin, tb), (got, kb), launches = _twin_and_kernel(w, con.rows(slice(a, b)), vac,
                                                         card)
        assert launches == 1 and tb == kb
        assert torch.equal(got, twin), (ranks, a, b)


@pytest.mark.cuda
def test_wkb_kernel_counts_terms(card):
    """The kernel's counters after a reset: the terms it evaluated are the
    per-pair loop's, and the lane-steps it issued whole warps of 32 at
    least as many."""
    w, con, vac = _synthetic(volts=4.0, n_con=60, pad_con=4, n_vac=40, pad_vac=0)
    _, _, terms = _block_in_kernel_order(w, con, vac, vac.pos.shape[0])
    tcur.reset_wkb_ct_counts(card)
    _twin_and_kernel(w, con, vac, card)
    got_terms, issued = tcur.wkb_ct_counts(card)
    assert got_terms == terms and issued >= terms and issued % 32 == 0


@pytest.mark.cuda
def test_wkb_kernel_in_the_power_system(card, monkeypatch):
    """``build_power_system`` on the toy's atoms with a +-1 eV CB edge: the
    kernel's build equals the plain build on the card in every block, the
    diagonal and ``WkbStats``, with one launch a build."""
    from akmc_tpu_torch.lattice import ELEM
    from akmc_tpu_torch.models.crossbar import toy_device

    p, lat = toy_device(nx=10, ny=3, nz=3, contact_layers=3, vacancy_fraction=0.3)
    n_src = p.num_atoms_first_layer
    ct = tcur.build_current_tables(lat.element0, np.stack([lat.x, lat.y, lat.z], 1),
                                   np.asarray(p.lattice), False, p.nn_dist, p.metals, n_src,
                                   n_src, p.num_layers_contact, p.max_num_neighbors).to(card)
    n_atom = ct.atom_ind.numel()
    rng = np.random.RandomState(2)
    elem = torch.as_tensor(lat.element0[ct.atom_ind.cpu().numpy()])
    charge = torch.where((elem == int(ELEM.VACANCY)) & torch.tensor(rng.rand(n_atom) < 0.5), 2, 0)
    cb = torch.tensor((np.linspace(1.0, -1.0, n_atom) + 0.05 * rng.randn(n_atom)) * EV_TO_J)
    args = (ct, elem.to(card), charge.to(card), cb.to(card),
            torch.tensor(np.asarray(p.lattice, np.float64), device=card), False, p.nn_dist,
            p.high_G * 1e5, p.low_G, p.high_G * 1e7, p.q * 0.01, p.m_e, p.V0)
    with monkeypatch.context() as m:
        m.setattr(tcur, "wkb_block", tcur.wkb_block_plain)
        want, ws = tcur.build_power_system(*args, vmax=64, ne_max=512)
    before = tcur.wkb_contact_trap_kernel.launches
    got, gs = tcur.build_power_system(*args, vmax=64, ne_max=512)
    torch.cuda.synchronize()
    assert tcur.wkb_contact_trap_kernel.launches - before == 1
    assert [int(b) for b in gs.ct_bounds] == [int(b) for b in ws.ct_bounds]
    for name in ("W_tt", "W_ct", "W_cc", "diag", "G_nbr", "vac_idx"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.cuda
def test_wkb_kernel_refuses_what_it_does_not_take(card):
    w, con, vac = _synthetic()
    a, b = _on(con, card), _on(vac, card)
    with pytest.raises(ValueError):
        tcur.wkb_contact_trap_kernel(w, a, b, 64)                   # the lattice on the CPU
    w = w._replace(lattice=w.lattice.to(card))
    with pytest.raises(ValueError):
        tcur.wkb_contact_trap_kernel(w, a._replace(cb=a.cb.float()), b, 64)
    with pytest.raises(ValueError):
        tcur.wkb_contact_trap_kernel(w, a, b._replace(pos=b.pos.t().contiguous().t()), 64)
