"""akmc_tpu_torch host layer against akmc_tpu: deck parsing, the mt19937
streams, lattice and neighbor lists, the grid-native crossbar generators,
substoichiometric placement and the carry-across helpers of ``convert.py``.
Everything here is exact: the two packages must build the same arrays.

Also the port's package rules: no module of it (nor ``chip_smoke.py``)
imports JAX or akmc_tpu, and its entry points refuse to run without CUDA
unless asked for the CPU."""

import ast
import dataclasses
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import akmc_tpu.config as jcfg
import akmc_tpu.lattice as jlat
import akmc_tpu.models.crossbar as jxb
import akmc_tpu.rng as jrng
import akmc_tpu.state as jstate
import akmc_tpu_torch.config as tcfg
import akmc_tpu_torch.lattice as tlat
import akmc_tpu_torch.models.crossbar as txb
import akmc_tpu_torch.rng as trng
import akmc_tpu_torch.state as tstate
from akmc_tpu_torch import convert


# PyTorch's CPU worker threads, when first started in a process where JAX is
# also computing, were seen to return one thread's whole chunk of an
# elementwise op up to 1e-9 off (about one process in 40; never the calling
# thread's chunk). The comparisons below run PyTorch on the calling thread.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
DECK = str(REPO / "decks" / "iv_sweep_5nm.txt")
LAT_FIELDS = ("element0", "x", "y", "z", "lattice", "neigh_idx", "k_neigh_idx", "site_layer")


def _assert_params_equal(a, b):
    for f in dataclasses.fields(tcfg.KMCParameters):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if f.name == "layers":
            assert [dataclasses.asdict(l) for l in va] == [dataclasses.asdict(l) for l in vb]
        else:
            assert list(va) == list(vb) if isinstance(va, (list, tuple)) else va == vb, f.name


def _assert_lattice_equal(jl, tl):
    for name in LAT_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(tl, name)),
                                      np.asarray(getattr(jl, name)), err_msg=name)
    assert (tl.pbc, tl.nn_dist) == (jl.pbc, jl.nn_dist)
    assert tl.grid == (None if jl.grid is None else tuple(jl.grid))


def test_config_from_file_equal():
    assert {f.name for f in dataclasses.fields(tcfg.KMCParameters)} == {
        f.name for f in dataclasses.fields(jcfg.KMCParameters)
    }
    _assert_params_equal(jcfg.KMCParameters.from_file(DECK), tcfg.KMCParameters.from_file(DECK))


@pytest.mark.parametrize("seed", [1, 5, 2**31 + 7])
def test_rng_streams_bit_equal(seed):
    a, b = jrng.MT19937(seed), trng.MT19937(seed)
    for count in (1, 700, 2000):
        np.testing.assert_array_equal(b.next_uint32(count), a.next_uint32(count))
    ra, rb = jrng.ReferenceRNG(seed), trng.ReferenceRNG(seed)
    assert [ra.one() for _ in range(500)] == [rb.one() for _ in range(500)]
    np.testing.assert_array_equal(rb.uniform(1000), ra.uniform(1000))
    sa, sb = jrng.BufferedStream(jrng.ReferenceRNG(seed)), trng.BufferedStream(trng.ReferenceRNG(seed))
    for n, used in ((100, 37), (5000, 4999), (10, 0), (700, 700)):
        np.testing.assert_array_equal(sb.peek(n), sa.peek(n))
        sa.advance(used)
        sb.advance(used)


def test_neighbor_list_and_lattice_equal():
    rng = np.random.default_rng(4)
    # jittered cubic grid with coincident and boundary-distance pairs
    g = np.stack(np.meshgrid(*[np.arange(7)] * 3, indexing="ij"), -1).reshape(-1, 3) * 1.7
    pos = g + rng.normal(scale=0.2, size=g.shape)
    pos[5] = pos[4]
    for cap in (26, 40):
        np.testing.assert_array_equal(
            tlat.build_neighbor_list(pos, 2.5, cap), jlat.build_neighbor_list(pos, 2.5, cap)
        )
    with pytest.raises(ValueError):
        tlat.build_neighbor_list(pos, 4.0, 4)

    p = tcfg.KMCParameters.from_file(DECK)
    x = (pos[:, 0] - pos[:, 0].min()) * (90.0 / np.ptp(pos[:, 0]))   # inside the deck's layers
    elem = np.where(rng.random(len(x)) < 0.2, int(tlat.ELEM.Ti), int(tlat.ELEM.O)).astype(np.int32)
    elem[rng.random(len(x)) < 0.1] = int(tlat.ELEM.DEFECT)
    pj = jcfg.KMCParameters.from_file(DECK)
    jl = jlat.build_lattice(elem, x, pos[:, 1], pos[:, 2], pj)
    tl = tlat.build_lattice(elem, x, pos[:, 1], pos[:, 2], p)
    _assert_lattice_equal(jl, tl)
    np.testing.assert_array_equal(tlat.metal_mask(elem, p.metals), jlat.metal_mask(elem, pj.metals))
    assert {int(e): n for e, n in tlat.ELEMENT_NAMES.items()} == {
        int(e): n for e, n in jlat.ELEMENT_NAMES.items()
    }
    assert [(e.name, int(e)) for e in tlat.EVENT] == [(e.name, int(e)) for e in jlat.EVENT]


def test_xyz_io_equal(tmp_path):
    rng = np.random.default_rng(9)
    n = 50
    elem = rng.choice([int(e) for e in tlat.ELEMENT_NAMES], n).astype(np.int32)
    xyz = [rng.normal(size=n) * 10 for _ in range(3)]
    pot, pw = rng.normal(size=n), rng.random(n) * 1e-9
    jlat.write_xyz_snapshot(tmp_path / "j.xyz", elem, *xyz, pot, pw)
    tlat.write_xyz_snapshot(tmp_path / "t.xyz", elem, *xyz, pot, pw)
    assert (tmp_path / "t.xyz").read_bytes() == (tmp_path / "j.xyz").read_bytes()
    for a, b in zip(tlat.read_xyz(str(tmp_path / "t.xyz")), jlat.read_xyz(str(tmp_path / "j.xyz"))):
        np.testing.assert_array_equal(a, b)


def test_crossbar_generators_equal():
    kw = dict(n_yz=6, contact_slices=2, oxide_slices=6, ti_slices=2,
              defect_fraction=0.3, vacancy_concentration=0.1, seed=3)
    pj, jl = jxb.build_grid_crossbar(**kw)
    pt, tl = txb.build_grid_crossbar(**kw)
    _assert_params_equal(pj, pt)
    _assert_lattice_equal(jl, tl)

    for a, b in zip(jxb.grid_stack(6, contact_slices=2, oxide_slices=5, ti_slices=2, seed=1),
                    txb.grid_stack(6, contact_slices=2, oxide_slices=5, ti_slices=2, seed=1)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    assert [dataclasses.asdict(l) for l in txb.crossbar_layers(3, 7, 2)] == [
        dataclasses.asdict(l) for l in jxb.crossbar_layers(3, 7, 2)
    ]

    n_yz, nx, a = tl.grid
    null = tl.element0 == int(tlat.ELEM.NULL_ELEMENT)
    np.testing.assert_array_equal(
        txb.grid_neighbor_list(n_yz, nx, a, pt.nn_dist, pt.max_num_neighbors, null),
        jxb.grid_neighbor_list(n_yz, nx, a, pj.nn_dist, pj.max_num_neighbors, null),
    )
    is_metal = tlat.metal_mask(tl.element0, pt.metals)
    pos = np.stack([tl.x, tl.y, tl.z], 1)
    args = (n_yz, nx, a, pt.nn_dist, is_metal, pt.num_atoms_first_layer, pt.high_G, pt.low_G, pos)
    jd, jm = jxb.grid_dia_k(*args, null_mask=null)
    td, tm = txb.grid_dia_k(*args, null_mask=null)
    assert tuple(tm) == tuple(jm)
    cd, _ = convert.dia(jd, jm)
    for f in dataclasses.fields(td):
        np.testing.assert_array_equal(getattr(td, f.name).numpy(), getattr(cd, f.name).numpy(),
                                      err_msg=f.name)


def test_synthesize_deck_structure_and_substoichiometry_equal():
    pj0, pt0 = jcfg.KMCParameters.from_file(DECK), tcfg.KMCParameters.from_file(DECK)
    pj, *jarr = jxb.synthesize_deck_structure(pj0, 6)
    pt, *tarr = txb.synthesize_deck_structure(pt0, 6)
    _assert_params_equal(pj, pt)
    for a, b in zip(jarr, tarr):
        np.testing.assert_array_equal(b, a)
    ej = jstate.make_substoichiometric(jarr[0], pj.initial_vacancy_concentration,
                                       jrng.ReferenceRNG(pj.rnd_seed))
    et = tstate.make_substoichiometric(tarr[0], pt.initial_vacancy_concentration,
                                       trng.ReferenceRNG(pt.rnd_seed))
    assert (et == int(tlat.ELEM.VACANCY)).sum() > 0
    np.testing.assert_array_equal(et, ej)

    jl = jlat.build_lattice(ej, *jarr[1:], pj, precomputed_lists=None)
    tl = tlat.build_lattice(et, *tarr[1:], pt)
    jxb.mask_null_slots(jl)
    txb.mask_null_slots(tl)
    _assert_lattice_equal(jl, tl)


def test_convert_carries_objects_across():
    from akmc_tpu.models.vcm import VCMModel as JModel

    pj, jl = jxb.build_grid_crossbar(n_yz=6, contact_slices=2, oxide_slices=6, ti_slices=2,
                                     defect_fraction=0.3, vacancy_concentration=0.1, seed=3)
    _assert_params_equal(pj, convert.params(pj))
    _assert_lattice_equal(jl, convert.lattice(jl))

    js = jstate.make_device_state(jl, pj.background_temp)
    ts = convert.state(js)
    for f in dataclasses.fields(ts):
        v = getattr(ts, f.name)
        assert v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), np.asarray(getattr(js, f.name)), err_msg=f.name)
    assert ts.element.dtype == torch.int32 and ts.potential_boundary.dtype == torch.float64

    jm = JModel(pj, jl)
    tt = convert.tables(jm.tables)
    assert tt.pair_tiling is None                      # the static table fits here
    for f in dataclasses.fields(tt):
        v = getattr(tt, f.name)
        if f.name != "pair_tiling":
            assert v.dtype in (torch.int64, torch.float64, torch.bool), f.name
    np.testing.assert_array_equal(tt.pair_table.numpy(), np.asarray(jm.tables.pair_gT.full))
    np.testing.assert_array_equal(tt.act_zero_rows.numpy(), np.asarray(jm.tables.act_zero_rows))
    np.testing.assert_array_equal(tt.k_neigh_idx.numpy(), np.asarray(jm.tables.k_neigh_idx))
    np.testing.assert_array_equal(tt.metal_edge.numpy(), np.asarray(jm.tables.metal_edge))

    # without the table: the tiling comes across instead
    jm = JModel(pj, jl, pair_table_budget=0, pair_tiling_min_n=1)
    tt = convert.tables(jm.tables)
    assert tt.pair_table is None
    for name in jm.tables.pair_tiling._fields:
        np.testing.assert_array_equal(getattr(tt.pair_tiling, name).numpy(),
                                      np.asarray(getattr(jm.tables.pair_tiling, name)))


def _imports(path):
    for node in ast.walk(ast.parse(Path(path).read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_no_akmc_tpu():
    files = sorted((REPO / "akmc_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    bad = []
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "akmc_tpu"):
                bad.append(f"{f.relative_to(REPO)}: {mod}")
    assert not bad, bad


def test_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run on it")
    from akmc_tpu_torch.models.vcm import VCMModel
    from akmc_tpu_torch.runtime.driver import run

    p, lat = txb.build_grid_crossbar(n_yz=6, contact_slices=2, oxide_slices=6, ti_slices=2,
                                     defect_fraction=0.3, vacancy_concentration=0.1, seed=3)
    with pytest.raises(RuntimeError, match="CUDA"):
        VCMModel(p, lat)
    with pytest.raises(RuntimeError, match="CUDA"):
        run(DECK, workdir=str(tmp_path), synthesize_crossbar=6, log=False)
    assert not (tmp_path / "output1_0.txt").exists()
    assert VCMModel(p, lat, device="cpu").device == torch.device("cpu")
