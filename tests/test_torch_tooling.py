"""The port's host helpers and tooling against akmc_tpu's, on the CPU.

* ``sort_by_x``, ``sort_by_xyz``, ``count_contact_sites``,
  ``build_cutoff_list`` and ``models/crossbar.py::sort_crossbar``
  (tests/test_lattice.py:97, :117; tests/test_postprocessing.py:99), and the
  ``utils`` namespace.
* ``postprocessing/extract.py`` on a log the port's driver wrote.
* ``postprocessing/matrices.py::assemble_k_coo`` on the port's model
  (tests/test_matrices_tooling.py:20): akmc_tpu's matrix, and the port's K
  operator's product.
* The snapshot writer, byte for byte akmc_tpu's.
* ``runtime/profiling.py`` on the CPU.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import akmc_tpu.utils as jutils
from akmc_tpu import lattice as jlat
from akmc_tpu.models.crossbar import build_grid_crossbar
from akmc_tpu.models.crossbar import sort_crossbar as j_sort_crossbar
from akmc_tpu.models.vcm import VCMModel as JModel
from akmc_tpu.postprocessing import extract as jextract
from akmc_tpu.postprocessing.matrices import assemble_k_coo as j_assemble
from akmc_tpu.rng import ReferenceRNG as JRNG
from akmc_tpu.state import make_substoichiometric
import akmc_tpu_torch.utils as tutils
from akmc_tpu_torch import convert
from akmc_tpu_torch import lattice as tlat
from akmc_tpu_torch.lattice import ELEM
from akmc_tpu_torch.models.crossbar import sort_crossbar as t_sort_crossbar
from akmc_tpu_torch.models.vcm import VCMModel as TModel
from akmc_tpu_torch.ops.charge import update_charge_compact
from akmc_tpu_torch.postprocessing import extract as textract
from akmc_tpu_torch.postprocessing.matrices import (
    assemble_k_coo,
    check_row_sum_invariant,
    dump_matrix_txt,
)
from akmc_tpu_torch.runtime import driver as tdriver
from akmc_tpu_torch.runtime import profiling
from akmc_tpu_torch.solvers.poisson import edge_conductance
from tests.test_driver import _write_toy_deck
from tests.util_toy import toy_device

# see tests/test_torch_superstep.py: PyTorch on the calling thread only
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def toy():
    p, lat = toy_device(nx=8, ny=3, nz=3)
    lat.element0[:] = make_substoichiometric(lat.element0, 0.2, JRNG(3))
    return p, lat


def _same(a, b):
    assert len(a) == len(b)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)
        assert np.asarray(u).dtype == np.asarray(v).dtype


def test_sorts_and_contact_counts():
    rng = np.random.default_rng(4)
    n = 200
    e = rng.integers(0, 9, n).astype(np.int32)
    # ties in x (and in x, y) so that the stable order and the later keys decide
    x = rng.integers(0, 6, n).astype(np.float64)
    y = rng.integers(0, 4, n).astype(np.float64)
    z = rng.normal(size=n)
    _same(tlat.sort_by_x(e, x, y, z), jlat.sort_by_x(e, x, y, z))
    _same(tlat.sort_by_xyz(e, x, y, z), jlat.sort_by_xyz(e, x, y, z))
    e[:7] = [int(ELEM.Ti), int(ELEM.DEFECT), int(ELEM.N), int(ELEM.DEFECT), int(ELEM.DEFECT),
             int(ELEM.O), int(ELEM.Ti)]
    e[-3:] = int(ELEM.DEFECT)
    for num in (0, 1, 2, 3, 50, n + 5):
        for side in ("left", "right"):
            assert tlat.count_contact_sites(e, num, side) == jlat.count_contact_sites(
                e, num, side), (num, side)
    assert tlat.count_contact_sites(np.zeros(4, np.int32), 2, "left") == 4


def test_cutoff_list(toy):
    p, lat = toy
    pos = np.stack([lat.x, lat.y, lat.z], axis=1)
    for cutoff in (p.cutoff_radius, 3.0):
        t_idx, t_n = tlat.build_cutoff_list(pos, lat.element0, cutoff)
        j_idx, j_n = jlat.build_cutoff_list(pos, lat.element0, cutoff)
        assert t_n == j_n > 0
        np.testing.assert_array_equal(t_idx, j_idx)
        assert t_idx.dtype == j_idx.dtype


def test_sort_crossbar():
    p, lat = build_grid_crossbar(n_yz=6, contact_slices=2, oxide_slices=4, ti_slices=2,
                                 defect_fraction=0.3, vacancy_concentration=0.1, seed=3)
    keep = lat.element0 != int(ELEM.NULL_ELEMENT)
    args = (lat.element0[keep], lat.x[keep], lat.y[keep], lat.z[keep])
    split = (float(np.median(lat.y)), float(np.median(lat.z)))
    out = t_sort_crossbar(*args, *split)
    _same(out, j_sort_crossbar(*args, *split))
    assert sorted(out[1].tolist()) == sorted(args[1].tolist())


def test_utils_namespace():
    assert tutils.__all__ == jutils.__all__
    assert all(hasattr(tutils, name) for name in tutils.__all__)
    assert tutils.sort_by_x is tlat.sort_by_x


def test_parse_output_of_the_port(tmp_path):
    """The port's full-physics log and metrics, parsed by both packages'
    extractors: the same RunData and the same rows."""
    deck, _ = _write_toy_deck(tmp_path, full=True, t_switch=1e3)
    tdriver.run(str(deck), workdir=str(tmp_path), max_supersteps=2, log=False, device="cpu",
                committed_parity=False)
    log = str(tmp_path / "output1_0.txt")
    t, j = textract.parse_output_txt(log), jextract.parse_output_txt(log)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert len(t.kmc_times) == len(t.currents_uA) == len(t.temperatures_K) == 2
    assert t.voltages == [2.0] and all(v > 300.0 for v in t.temperatures_K)
    rows = textract.parse_metrics_jsonl(str(tmp_path / "metrics.jsonl"))
    assert rows == jextract.parse_metrics_jsonl(str(tmp_path / "metrics.jsonl"))
    assert [r["kmc_time"] for r in rows] == pytest.approx(t.kmc_times, rel=1e-5)


def test_k_coo_matches_akmc_tpu_and_the_operator(tmp_path, toy):
    p, lat = toy
    tm = TModel(convert.params(p), convert.lattice(lat), device="cpu")
    jm = JModel(p, lat)
    elem = torch.as_tensor(lat.element0, dtype=torch.int32)
    q = update_charge_compact(elem, torch.zeros(lat.N, dtype=torch.int32),
                              tm.tables.neigh_idx, tm.tables.any_metal_nbr, 64)
    Vd = 2.0
    A, rhs = assemble_k_coo(tm, elem, q, Vd)
    Aj, rhsj = j_assemble(jm, lat.element0, q.numpy(), Vd)
    np.testing.assert_array_equal(A.toarray(), Aj.toarray())
    np.testing.assert_array_equal(rhs, rhsj)

    # A @ v against the port's matrix-free K rows on the interface
    L = p.num_atoms_first_layer
    v = np.random.default_rng(0).normal(size=A.shape[0])
    G = edge_conductance(elem, q, tm.tables.k_neigh_idx, tm.tables.metal_edge,
                         p.high_G, p.low_G).numpy()
    nbr = lat.k_neigh_idx
    j = np.clip(nbr, 0, None)
    full = np.concatenate([np.zeros(L), v, np.zeros(L)])
    Av = (np.where(nbr >= 0, G, 0.0).sum(1) * full - np.where(nbr >= 0, G * full[j], 0.0).sum(1))
    np.testing.assert_allclose(A @ v, Av[L:lat.N - L], rtol=1e-12, atol=1e-12 * np.abs(Av).max())

    lsum_rsum = np.where((nbr >= 0) & ((j < L) | (j >= lat.N - L)), G, 0).sum(1)[L:lat.N - L]
    assert check_row_sum_invariant(A, lsum_rsum)
    path = str(tmp_path / "K.txt")
    dump_matrix_txt(A, path)
    header = open(path).readline().split()
    assert int(header[0]) == A.shape[0] and int(header[1]) == A.nnz


def test_snapshot_bytes_equal_akmc_tpu(tmp_path):
    rng = np.random.default_rng(1)
    n = 64
    codes = [int(e) for e in ELEM if e != ELEM.NULL_ELEMENT]
    e = rng.choice(codes, n).astype(np.int32)
    x = rng.normal(size=n) * 40.0
    y = rng.normal(size=n) * 1e-5
    z = rng.normal(size=n) * 1e6
    pot = rng.normal(size=n)
    power = np.zeros(n)
    pot[:8] = [-0.0, np.nan, 1e-5, -1.23456789e-5, 1e6, -9.9999995e5, np.inf, 123456.5]
    x[:3] = [-0.0, np.nan, 1e-300]
    power[::7] = rng.normal(size=len(power[::7])) * 1e-9
    tlat.write_xyz_snapshot(str(tmp_path / "t.xyz"), e, x, y, z, pot, power)
    jlat.write_xyz_snapshot(str(tmp_path / "j.xyz"), e, x, y, z, pot, power)
    assert (tmp_path / "t.xyz").read_bytes() == (tmp_path / "j.xyz").read_bytes()
    writer = tlat.SnapshotWriter(x, y, z)       # one writer, many snapshots
    writer.write(str(tmp_path / "w.xyz"), torch.as_tensor(e).numpy(), pot, power)
    assert (tmp_path / "w.xyz").read_bytes() == (tmp_path / "j.xyz").read_bytes()
    e[3] = int(ELEM.NULL_ELEMENT)
    with pytest.raises(KeyError):
        writer.write(str(tmp_path / "bad.xyz"), e, pot, power)
    with pytest.raises(ValueError):
        writer.write(str(tmp_path / "bad.xyz"), e[:-1], pot[:-1], power[:-1])


def test_profiling_on_the_cpu(tmp_path):
    with profiling.trace(str(tmp_path / "trace")) as prof:
        torch.ones(8).sum()
    files = list((tmp_path / "trace").glob("trace_*.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
    json.loads(files[0].read_text())
    assert prof.key_averages() is not None
    assert profiling.device_memory_stats("cpu") is None
    out = {"a": [torch.ones(2)], "b": 3}
    assert profiling.pull_sync(out) is out
