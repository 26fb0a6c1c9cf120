"""Scale-out of the port (``akmc_tpu_torch/parallel``) against the port on one
device and against ``akmc_tpu`` on its 8-device virtual CPU mesh.

One group of four gloo ranks on the CPU (``parallel/launch.py::spawn``) runs
every scenario of ``tests/torch_shard_ranks.py`` once; each test reads its
scenario. The structures are those of ``tests/test_sharding.py`` (the toy
device padded to a multiple of 8 sites, as ``_padded_toy(8)`` pads it) and
the small grid-native crossbar of ``tests/test_torch_superstep.py``.

What is held:
* against the port's one-device run: events, elements, charges, K-CG
  counts, potentials and ``kmc_time`` bit for bit on every K operator. The
  sharded DIA K-CG computes the fused kernel's dot order exactly
  (``solvers/dia_cg.py::dia_cg_solve_sharded``); the banded and ELL solves
  shard their product only and keep the one-device vectors and dots. Full
  physics adds the W_ct column sums and W_ct^T v_c over ranks in rank order
  (``Mesh.sum_partials``), another order than one device's: held at
  ``tests/test_sharding.py``'s I_macro rtol 1e-5, T_bg 1e-12, power rtol 1e-8;
  the tiled path at its potentials 1e-6;
* against ``akmc_tpu`` on ``make_mesh(8)``: each case of
  ``tests/test_sharding.py`` at that file's own tolerances;
* every rank holds rank 0's state after every superstep
  (``parallel/mesh.py::check_replicas``, checksums gathered on every rank;
  a rank whose state differs stops the run).

The ranks run PyTorch on one thread, and so does this process.
"""

import jax
import numpy as np
import pytest
import torch

from akmc_tpu.models.vcm import VCMModel as JModel
from akmc_tpu.parallel.mesh import ConcernGroups as JGroups
from akmc_tpu.parallel.mesh import make_mesh as j_make_mesh
from akmc_tpu.parallel.mesh import pad_lattice as j_pad_lattice
from akmc_tpu.parallel.mesh import replicate_state as j_replicate
from akmc_tpu.parallel.mesh import shard_model as j_shard
from akmc_tpu.rng import BufferedStream as JStream
from akmc_tpu.rng import ReferenceRNG as JRNG
from akmc_tpu.state import make_device_state as j_state
from akmc_tpu_torch.ops.dia_matvec import DiaOperator, dia_combined_matvec_plain
from akmc_tpu_torch.parallel import mesh as tmesh
from akmc_tpu_torch.parallel.launch import spawn
from akmc_tpu_torch.solvers import dia_cg
from tests import torch_shard_ranks as R
from tests.test_sharding import _padded_toy

torch.set_num_threads(1)
RANKS = 4
POT_TOL = 1e-6          # tests/test_sharding.py: sharded potentials
KMC_RTOL = 1e-9         # tests/test_sharding.py: sharded kmc_time
NAMES = list(R.SCENARIOS) + ["divergence"]


@pytest.fixture(scope="module")
def sharded():
    """{scenario: [rank 0's result, rank 1's, ...]} from one group of ranks."""
    outs = spawn(R.scenarios, RANKS, "cpu", "gloo", NAMES, timeout=400)
    return {name: [o[name] for o in outs] for name in NAMES}


@pytest.fixture(scope="module")
def one_device():
    """The same scenarios on one device in this process (memoized)."""
    cache = {}

    def get(name):
        if name not in cache:
            fn, kw = R.SCENARIOS[name]
            cache[name] = fn(None, **kw)
        return cache[name]

    return get


def _bit_equal(a, b, keys=("element", "charge", "potential_boundary", "potential_charge",
                           "power")):
    for k in keys:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["kmc_time"] == b["kmc_time"] and a["T_bg"] == b["T_bg"]
    assert a["rows"] == b["rows"]


def _jax_run(kind, mesh_n=8, **model_kw):
    """akmc_tpu's counterpart of ``tests/test_sharding.py``'s runs: (state,
    per-step events)."""
    p, lat = _padded_toy(8)
    model = JModel(p, lat, **model_kw)
    state = j_state(lat, p.background_temp)
    stream = JStream(JRNG(1))
    if mesh_n > 1:
        mesh = j_make_mesh(mesh_n)
        j_shard(model, mesh)
        state = j_replicate(state, mesh)
    if kind == "multi":
        state, stats = model.superstep_multi(state, 2.0, stream, k=2, rand_chunk=512)
        return state, [s["n_events"] for s in stats]
    ev = []
    for _ in range(3):
        state, stats = model.superstep(state, 2.0, stream)
        ev.append(stats["n_events"])
    return state, ev


def test_toy_structure_is_akmc_tpus():
    """The port's padded toy is ``tests/test_sharding.py``'s, site for site."""
    p, lat = R.structure("toy")
    jp, jlat = _padded_toy(8)
    for k in ("element0", "x", "y", "z", "neigh_idx", "k_neigh_idx", "site_layer"):
        np.testing.assert_array_equal(getattr(lat, k), getattr(jlat, k), err_msg=k)


@pytest.mark.parametrize("multiple", [3, 4, 8, 16])
def test_pad_lattice_matches_akmc_tpu(multiple):
    from akmc_tpu_torch.models.crossbar import toy_device

    p, lat = toy_device(nx=12, ny=4, nz=4)
    from tests.util_toy import toy_device as j_toy

    jp, jlat = j_toy(nx=12, ny=4, nz=4)
    got, n = tmesh.pad_lattice(lat, multiple)
    want, jn = j_pad_lattice(jlat, multiple)
    assert n == jn == lat.N and got.N == want.N and got.N % multiple == 0
    for k in ("x", "y", "z", "neigh_idx", "k_neigh_idx", "site_layer"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
    assert got.grid is None and (got.N == lat.N) == (multiple in (4, 8, 16))


def test_split_is_whole_units_with_a_ragged_last_range():
    m = tmesh.Mesh(0, 4, "cpu", "gloo")
    assert m.split(58_752, 256) == [(0, 14592), (14592, 29440), (29440, 44032),
                                    (44032, 58752)]
    for n, unit in ((10, 1), (3, 1), (1000, 256), (409_600, 256)):
        r = m.split(n, unit)
        assert r[0][0] == 0 and r[-1][1] == n
        assert all(a <= b == c for (a, b), (c, _) in zip(r, r[1:]))
        assert all(a % unit == 0 for a, _ in r)


def test_make_mesh_refuses_more_ranks_than_the_group():
    with pytest.raises(ValueError, match="gloo ranks"):
        tmesh.make_mesh(4)


@pytest.mark.parametrize("ranks", [2, 3, 4])
def test_row_window_twin_is_the_full_twins_rows(ranks):
    """The window twin on a rank's own slab equals the full-N twin's rows bit
    for bit, at every rank's 256-row chunk range (the last ragged)."""
    from akmc_tpu_torch.models.crossbar import build_grid_crossbar, grid_dia_k
    from akmc_tpu_torch.lattice import ELEM, metal_mask

    p, lat = build_grid_crossbar(n_yz=6, contact_slices=2, oxide_slices=6, ti_slices=2,
                                 defect_fraction=0.3, vacancy_concentration=0.1, seed=3)
    dia, meta = grid_dia_k(*lat.grid, p.nn_dist, metal_mask(lat.element0, p.metals),
                           p.num_atoms_first_layer, p.high_G, p.low_G,
                           np.stack([lat.x, lat.y, lat.z], 1),
                           null_mask=lat.element0 == int(ELEM.NULL_ELEMENT))
    rng = np.random.default_rng(ranks)
    n = lat.N
    x = torch.tensor(rng.standard_normal(n))
    xv = torch.where(torch.tensor(rng.random(n) < 0.2), x, 0.0)
    offs = meta.offsets
    yf, vf = dia_combined_matvec_plain(dia.diags, offs, meta.val_low, meta.val_high, x, xv)
    for r0, r1 in tmesh.Mesh(0, ranks, "cpu", "gloo").split(n, dia_cg.CHUNK):
        op = DiaOperator(dia.diags[:, r0:r1].clone(), dia.offsets, meta.val_low,
                         meta.val_high, row0=r0, n=n)
        y, v = op.matvec(x, xv)
        assert torch.equal(y, yf[r0:r1]) and torch.equal(v, vf[r0:r1])


def test_row_window_operator_refuses_rows_outside_the_operator():
    with pytest.raises(ValueError, match="outside"):
        DiaOperator(torch.zeros((2, 10), dtype=torch.int8), torch.tensor([-1, 1]), 1.0, 2.0,
                    row0=5, n=12)
    op = DiaOperator(torch.zeros((2, 10), dtype=torch.int8), torch.tensor([-1, 1]), 1.0, 2.0,
                     row0=2, n=12)
    with pytest.raises(ValueError, match="whole operator"):
        dia_cg.dia_cg_solve(op, *([torch.zeros(12)] * 7), 1e-10, 5)


@pytest.mark.parametrize("n", [1, 255, 256, 3672, 58_752])
def test_chunk_sums_then_finish_is_blocked_vdot(n):
    """The sharded dot: each rank's chunk sums, gathered in order, finished
    on every rank, is the fused kernel's blocked dot to the bit."""
    rng = np.random.default_rng(n)
    a, b = (torch.tensor(rng.standard_normal(n) * np.exp(3 * rng.standard_normal(n)))
            for _ in range(2))
    ranges = tmesh.Mesh(0, 4, "cpu", "gloo").split(n, dia_cg.CHUNK)
    parts = [dia_cg.chunk_sums(a[r0:r1], b[r0:r1]) for r0, r1 in ranges]
    assert torch.equal(dia_cg.finish_chunks(torch.cat(parts)), dia_cg.blocked_vdot(a, b))


# ----------------------------------------------------------------------
# the cases of tests/test_sharding.py
# ----------------------------------------------------------------------
def test_sharded_superstep_matches_single_device(sharded, one_device):
    got = sharded["superstep"][0]
    _bit_equal(got, one_device("superstep"))
    assert got["describe"]["k_operator"] == "dia"
    js, jev = _jax_run("superstep")
    assert [r["n_events"] for r in got["rows"]] == jev
    np.testing.assert_array_equal(got["element"], np.asarray(js.element))
    np.testing.assert_array_equal(got["charge"], np.asarray(js.charge))
    np.testing.assert_allclose(got["potential_charge"], np.asarray(js.potential_charge),
                               rtol=POT_TOL, atol=POT_TOL)
    assert got["kmc_time"] == pytest.approx(float(js.kmc_time), rel=KMC_RTOL)


def test_sharded_full_physics_matches_single_device(sharded, one_device):
    got, one = sharded["full"][0], one_device("full")
    for a, b in zip(got["rows"], one["rows"]):
        assert (a["n_events"], a["cg_iterations"]) == (b["n_events"], b["cg_iterations"])
        np.testing.assert_allclose(a["I_macro"], b["I_macro"], rtol=1e-5)
        np.testing.assert_allclose(a["T_bg"], b["T_bg"], rtol=1e-12)
    np.testing.assert_array_equal(got["element"], one["element"])
    np.testing.assert_allclose(got["power"], one["power"], rtol=1e-8, atol=1e-30)

    p, lat = _padded_toy(8)
    p = p.replace(**R.FULL)
    model = JModel(p, lat, vmax=64, ne_max=256)
    j_shard(model, j_make_mesh(8))
    state = j_replicate(j_state(lat, p.background_temp), model.mesh)
    stream = JStream(JRNG(1))
    state = model.update_cb_edge(state, 2.0)
    m = None
    jrows = []
    for _ in range(2):
        state, stats, m = model.superstep_full(state, 2.0, stream, m_prev=m)
        jrows.append(stats)
    assert [r["n_events"] for r in got["rows"]] == [r["n_events"] for r in jrows]
    np.testing.assert_array_equal(got["element"], np.asarray(state.element))
    np.testing.assert_allclose(got["rows"][-1]["I_macro"], jrows[-1]["I_macro"], rtol=1e-5)
    np.testing.assert_allclose(got["rows"][-1]["T_bg"], jrows[-1]["T_bg"], rtol=1e-12)
    np.testing.assert_allclose(got["power"], np.asarray(state.power), rtol=1e-8, atol=1e-30)


def test_sharded_batched_dispatch_matches_single_device(sharded, one_device):
    got = sharded["multi"][0]
    _bit_equal(got, one_device("multi"))
    js, jev = _jax_run("multi")
    assert [r["n_events"] for r in got["rows"]] == jev
    np.testing.assert_array_equal(got["element"], np.asarray(js.element))
    np.testing.assert_array_equal(got["charge"], np.asarray(js.charge))
    assert got["kmc_time"] == pytest.approx(float(js.kmc_time), rel=KMC_RTOL)


def test_concern_group_split_matches_sequential(sharded, one_device):
    got, one = sharded["concern"][0], one_device("concern")
    assert got["groups"] == ([0], [1, 2, 3])
    for k in ("first_charge", "first_pot_b", "first_pot_sum"):
        np.testing.assert_array_equal(got[k], one[k], err_msg=k)
    assert got["first_cg"] == one["first_cg"] > 0
    _bit_equal(got, one)

    p, lat = _padded_toy(8)
    model = JModel(p, lat)
    state = j_state(lat, p.background_temp)
    groups = JGroups(model, ratio=(1, 3))
    charge, pot_b, pot_sum, cg, *_ = groups.fields(
        state.element, state.charge, state.potential_boundary, state.T_bg, 2.0)
    # akmc_tpu holds its groups to its own sequential fields at 1e-10; across
    # the packages the two K-CGs (their dot orders differ) agree to the
    # sharded tolerance, as the one-device comparisons do
    np.testing.assert_array_equal(got["first_charge"], np.asarray(charge))
    assert got["first_cg"] == int(cg)
    np.testing.assert_allclose(got["first_pot_b"], np.asarray(pot_b), rtol=POT_TOL,
                               atol=POT_TOL)
    np.testing.assert_allclose(got["first_pot_sum"], np.asarray(pot_sum), rtol=POT_TOL,
                               atol=POT_TOL)


def test_sharded_tiled_pairwise_matches_single_device(sharded, one_device):
    got, one = sharded["tiled"][0], one_device("tiled")
    assert got["describe"]["pairwise"] == "tiled"
    assert got["rows"] == one["rows"]
    np.testing.assert_array_equal(got["element"], one["element"])
    np.testing.assert_allclose(got["potential_charge"], one["potential_charge"],
                               rtol=POT_TOL, atol=POT_TOL)
    js, jev = _jax_run("superstep", pair_table_budget=0, pair_tiling_min_n=1)
    assert [r["n_events"] for r in got["rows"]] == jev
    np.testing.assert_array_equal(got["element"], np.asarray(js.element))
    np.testing.assert_allclose(got["potential_charge"], np.asarray(js.potential_charge),
                               rtol=POT_TOL, atol=POT_TOL)
    assert got["kmc_time"] == pytest.approx(float(js.kmc_time), rel=KMC_RTOL)


def test_sharded_power_system_bytes_divide_across_mesh(sharded, one_device):
    """Each rank holds about a quarter of the W blocks, of G_nbr, of the
    pair table and of the DIA codes: measured on the tensors each rank
    holds; the per-rank bytes add up to the one-device bytes."""
    per = sharded["bytes"]
    one = one_device("bytes")
    for name in ("W_tt", "W_ct", "W_cc", "G_nbr", "pair_table", "dia_codes"):
        counts = [r[name] for r in per]
        assert sum(counts) == one[name], (name, counts, one[name])
        if name != "dia_codes":       # whole 256-row chunks: the toy's 208 rows are one
            assert max(counts) <= -(-one[name] // RANKS) * 1.1, (name, counts, one[name])


# ----------------------------------------------------------------------
# beyond tests/test_sharding.py
# ----------------------------------------------------------------------
def test_dia_crossbar_sharded_is_bit_equal(sharded, one_device):
    got = sharded["crossbar"][0]
    assert got["describe"]["k_operator"] == "dia"
    _bit_equal(got, one_device("crossbar"))


@pytest.mark.parametrize("name", ["native", "batched", "fields_only", "events_only",
                                  "on_the_fly", "full_crossbar"])
def test_other_paths_sharded_are_bit_equal(sharded, one_device, name):
    _bit_equal(sharded[name][0], one_device(name))


@pytest.mark.parametrize("name", ["banded", "ell", "banded_carry"])
def test_banded_and_ell_sharded_are_bit_equal(sharded, one_device, name):
    """The banded and ELL K solves shard their product only: each rank
    computes its rows, the product is gathered whole, and the CG's vectors
    and dots are the one-device ones on every rank."""
    got, one = sharded[name][0], one_device(name)
    op = {"banded": "banded", "ell": "ell", "banded_carry": "banded"}[name]
    assert got["describe"]["k_operator"] == op
    _bit_equal(got, one)


@pytest.mark.parametrize("name", ["superstep", "crossbar", "full", "concern", "batched"])
def test_every_rank_holds_rank_0s_state(sharded, name):
    sums = [r["checksum"] for r in sharded[name]]
    assert all(np.array_equal(s, sums[0]) for s in sums)


def test_a_rank_that_diverges_stops_every_rank(sharded):
    assert sharded["divergence"] == [True] * RANKS
