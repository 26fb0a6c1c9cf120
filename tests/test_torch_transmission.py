"""The transmission system of the benchmark's ``tsys102k`` configuration at a
small width, on the CPU: the blocked plain reference
(``portbench/reference/transmission.py``) against the dense one
(``portbench/reference/current.py``), the port's full-physics superstep
against the blocked reference on seeded states, and the ``cb_edge`` span in
the port's span table. No JAX: the port, the
benchmark's builder and its plain reference."""

import dataclasses
import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import check, harness  # noqa: E402
from portbench.reference import current as ref_current  # noqa: E402
from portbench.reference import fields as ref_fields  # noqa: E402
from portbench.reference import transmission  # noqa: E402

torch.set_num_threads(2)

N_YZ = 6
SEED = 2**31 + 11


def _config():
    with open(os.path.join(ROOT, "portbench", "configs", "tsys102k.json")) as f:
        config = json.load(f)
    config["builder_args"] = {**config["builder_args"], "n_yz": N_YZ}
    return config


@pytest.fixture(scope="module")
def built():
    """The configuration's builder at n_yz = 6 on the CPU: (Setup, the
    reference's tables of its structure)."""
    config = _config()
    setup = harness.module("builders", config["builder"]).build(config, "cpu", config["model"],
                                                                {})
    physics = {**setup.physics, "rate_normalize": True}
    return setup, check.Reference(setup.structure, physics, "cpu")


def _state(ref, Vd):
    element = ref.element0.clone()
    charge = ref_fields.charges(element, torch.zeros_like(element), ref.nbr, ref.metal)
    cb = ref_current.cb_solve(ref.element0, ref.nbr, ref.metal, ref.L, Vd,
                              float(ref.ph["G_coeff"]))
    return element, charge, cb


@pytest.mark.parametrize("Vd", [1.0, 8.0])
def test_blocked_reference_equals_the_dense_one(built, monkeypatch, Vd):
    """Row blocks of a few rows (the block size cut so that every tunnel
    block takes several): the neighbor part is the dense coupling's, and
    the W blocks are its tunnel part to rounding (the CPU's vector and
    scalar paths of one operation may differ in the last bit, and a block's
    shape decides which path an entry takes); the row sums, the product,
    the residual, I_macro and the atom power of one solution agree to
    rounding, and each reference's solution meets the other's stop rule."""
    _, ref = built
    monkeypatch.setattr(transmission, "BLOCK_ELEMENTS", 4096)
    element, charge, cb = _state(ref, Vd)
    dense = ref_current.Current(ref.element0, ref.pos, ref.nbr, ref.metal, ref.L, ref.ph)
    tr = transmission.Transmission(ref.element0, ref.pos, ref.nbr, ref.metal, ref.L, ref.ph)
    C = dense.coupling(element, charge, cb)
    B = tr.coupling(element, charge, cb)
    assert B.vac.numel() > 0 and B.con.numel() > 0
    G = torch.zeros_like(C)
    real = tr.nbr >= 0
    G[torch.nonzero(real)[:, 0], tr.nbr[real]] = B.G[real]
    assert torch.equal(G[G != 0], C[G != 0])
    T = C - G      # the tunnel part: no neighbor pair tunnels
    for got, want in ((B.W_tt, T[B.vac][:, B.vac]), (B.W_cc, T[B.con][:, B.con]),
                      (B.W_ct, T[B.con][:, B.vac])):
        assert torch.equal(got == 0, want == 0)
        assert torch.allclose(got, want, rtol=1e-13, atol=0)
    assert float(B.W_ct.max()) > 0.0
    assert torch.allclose(B.rowsum, C.sum(dim=1), rtol=1e-13, atol=0)
    v = torch.linspace(-1.0, 1.0, tr.n, dtype=torch.float64)
    assert torch.allclose(tr.matvec(B, v), C @ v, rtol=1e-12, atol=1e-12 * float(C.abs().max()))

    m0 = torch.zeros(tr.n + 2, dtype=torch.float64)
    m_d = dense.solve(C, Vd, m0, 1.0)
    m_b = tr.solve(B, Vd, m0, 1.0)
    assert tr.residual_ratio(B, Vd, m_d, 1.0) <= 1.5 and dense.residual_ratio(C, Vd, m_b, 1.0) <= 1.5
    assert tr.residual_ratio(B, Vd, m_b, 1.0) == pytest.approx(
        dense.residual_ratio(C, Vd, m_b, 1.0), rel=1e-6)
    I_d, p_d = dense.outputs(C, Vd, m_b)
    I_b, p_b = tr.outputs(B, Vd, m_b)
    assert I_b == I_d and I_b != 0.0
    assert float((p_b - p_d).abs().max()) <= 1e-12 * float(p_d.abs().max())
    assert float(p_d.abs().max()) > 0.0


def _run(setup, step_program=True, steps=2, biases=(7.0, 8.0)):
    """The cell's mix on the port at n_yz = 6, spans on: per bias the CB
    edge, then ``steps`` full supersteps warm-started across the pass:
    (the model, each step as (pre, post, stats, Vd, m_prev, m), each step's
    span table and each CB edge's)."""
    from akmc_tpu_torch.models.vcm import VCMModel
    from akmc_tpu_torch.rng import BufferedStream, ReferenceRNG
    from akmc_tpu_torch.state import make_device_state

    model = VCMModel(setup.model.params, setup.model.lat, device="cpu", rate_normalize=True,
                     step_program=step_program)
    model.spans = True
    state = make_device_state(model.lat, model.params.background_temp, model.device)
    stream = BufferedStream(ReferenceRNG(SEED))
    out, tables, cb_tables = [], [], []
    m = None
    for Vd in biases:
        state = model.update_cb_edge(state, Vd)
        cb_tables.append(dict(model.last_spans))
        for _ in range(steps):
            new, stats, m_new = model.superstep_full(state, Vd, stream, m_prev=m)
            out.append((state, new, stats, Vd, m, m_new))
            tables.append(model.last_spans)
            state, m = new, m_new
    return model, out, tables, cb_tables


@pytest.fixture(scope="module", params=[True, False], ids=["program", "per_loop"])
def mixed(request, built):
    return _run(built[0], step_program=request.param)


def test_port_full_superstep_against_the_blocked_reference(built, mixed):
    """Each superstep of the mix (both biases, cold and warm power starts),
    on the program and on the per-loop path: the port's power solution meets
    the blocked reference's stop rule, as the reference's own solution from
    the same warm start does, and gives the reference's I_macro and site
    power; the two I_macro agree to the stop rule's room."""
    _, ref = built
    _, steps, _, _ = mixed
    tr = transmission.Transmission(ref.element0, ref.pos, ref.nbr, ref.metal, ref.L, ref.ph)
    for pre, post, stats, Vd, m_prev, m in steps:
        element = pre.element
        charge = ref_fields.charges(element, pre.charge, ref.nbr, ref.metal)
        B = tr.coupling(element, charge, pre.cb_edge)
        assert tr.residual_ratio(B, Vd, m, 1.0) <= 1.5
        m0 = torch.zeros(tr.n + 2, dtype=torch.float64) if m_prev is None else m_prev
        m_ref = tr.solve(B, Vd, m0, 1.0)
        assert tr.residual_ratio(B, Vd, m_ref, 1.0) <= 1.0
        I_r, p_r = tr.outputs(B, Vd, m)
        assert stats["I_macro"] == pytest.approx(I_r, rel=1e-12) and abs(I_r) > 0.0
        assert tr.outputs(B, Vd, m_ref)[0] == pytest.approx(I_r, rel=1e-6)
        site = torch.zeros(element.shape[0], dtype=torch.float64)
        site[tr.atom] = p_r
        assert float((post.power - site).abs().max()) <= 1e-12 * float(site.abs().max())


def test_cb_edge_span_in_the_span_table(mixed):
    """The CB edge's dispatch holds its ``cb_edge`` span once, under the
    dispatch's own ``superstep``; the supersteps' tables do not hold it (the
    benchmark's entry hands it on, ``portbench/entries/full_supersteps.py``)."""
    _, steps, tables, cb_tables = mixed
    assert len(cb_tables) == 2 and len(tables) == len(steps)
    for cb in cb_tables:
        assert cb["cb_edge"]["clock"] == "device" and cb["cb_edge"]["n"] == 1
        assert cb["cb_edge"]["parent"] == "superstep"
        assert cb["cb_edge"]["ms"] <= cb["superstep"]["ms"]
    assert not any("cb_edge" in table for table in tables)


def test_builder_patches_the_deck_as_the_stand_in_deck_writer(tmp_path):
    """The builder's in-memory deck is the one ``write_synth_deck`` writes
    from the same template, but for the structure file it leaves unread."""
    from akmc_tpu_torch.config import KMCParameters
    from akmc_tpu_torch.models.crossbar import synthetic_stack
    from akmc_tpu_torch.runtime.synth_deck import write_synth_deck

    config = _config()
    builder = harness.module("builders", config["builder"])
    template = os.path.join(ROOT, "portbench", "configs", config["deck"])
    *_, lattice, patch = synthetic_stack(n_yz=N_YZ)
    with open(template) as f:
        mine = KMCParameters.from_string(builder.deck_text(f.read(), N_YZ, lattice, patch))
    theirs = KMCParameters.from_file(write_synth_deck(template, str(tmp_path), n_yz=N_YZ))
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert mine.V_switch == [7.0, 8.0] and mine.rnd_seed == 5 and mine.pristine
