"""The port's on-card list builders (``akmc_tpu_torch/lattice_device.py``),
run here on the CPU, against the port's k-d tree builders and against
``akmc_tpu.lattice_jax``: the same tables entry for entry (same candidates,
same ascending order, same -1 padding), in one row block and in ragged ones.
``build_lattice`` takes them on a CUDA device and the k-d tree elsewhere."""

import numpy as np
import pytest
import torch

from akmc_tpu.lattice_jax import build_cutoff_list_device as j_cutoff
from akmc_tpu.lattice_jax import build_neighbor_list_device as j_neighbor
from akmc_tpu.rng import ReferenceRNG
from akmc_tpu.state import make_substoichiometric
from akmc_tpu_torch import convert, lattice, lattice_device
from akmc_tpu_torch.models.crossbar import synthetic_stack
from tests.test_torch_cuda import pair_at_a_rounding_of_the_cutoff
from tests.util_toy import toy_device

# the JAX-comparing files run PyTorch on the calling thread (test_torch_ops.py)
torch.set_num_threads(1)

BLOCKS = [None, 7, 64]        # the default (one block here), ragged blocks


@pytest.fixture(scope="module")
def toy():
    p, lat = toy_device(nx=9, ny=4, nz=4)
    e = make_substoichiometric(lat.element0, 0.2, ReferenceRNG(11))
    return p, np.stack([lat.x, lat.y, lat.z], 1), e


@pytest.mark.parametrize("block", BLOCKS)
def test_neighbor_list_matches_kdtree_and_akmc_tpu(toy, block):
    p, pos, e = toy
    got = lattice_device.build_neighbor_list_device(pos, p.nn_dist, p.max_num_neighbors,
                                                    device="cpu", block=block)
    assert got.dtype == np.int32 and got.shape == (len(pos), p.max_num_neighbors)
    np.testing.assert_array_equal(got, lattice.build_neighbor_list(pos, p.nn_dist,
                                                                   p.max_num_neighbors))
    np.testing.assert_array_equal(got, j_neighbor(pos, p.nn_dist, p.max_num_neighbors))
    assert (got >= 0).sum() > len(pos)


@pytest.mark.parametrize("block", BLOCKS)
def test_neighbor_list_pbc_matches_kdtree_and_akmc_tpu(toy, block):
    p, pos, e = toy
    dims = np.array(p.lattice)
    got = lattice_device.build_neighbor_list_device(pos, p.nn_dist, p.max_num_neighbors, dims,
                                                    pbc=True, device="cpu", block=block)
    np.testing.assert_array_equal(
        got, lattice.build_neighbor_list(pos, p.nn_dist, p.max_num_neighbors, dims, pbc=True))
    np.testing.assert_array_equal(
        got, j_neighbor(pos, p.nn_dist, p.max_num_neighbors, dims, pbc=True))
    # the wrap adds neighbors across the y/z faces
    open_ = lattice.build_neighbor_list(pos, p.nn_dist, p.max_num_neighbors)
    assert (got >= 0).sum() > (open_ >= 0).sum()


@pytest.mark.parametrize("block", BLOCKS)
def test_cutoff_list_matches_kdtree_and_akmc_tpu(toy, block):
    p, pos, e = toy
    got, gmax = lattice_device.build_cutoff_list_device(pos, e, p.cutoff_radius, device="cpu",
                                                        block=block)
    want, wmax = lattice.build_cutoff_list(pos, e, p.cutoff_radius)
    jt, jmax = j_cutoff(pos, e, p.cutoff_radius)
    assert gmax == wmax == jmax
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jt)


def test_strict_overflow_raises_and_truncates_otherwise(toy):
    p, pos, e = toy
    cap = 3
    with pytest.raises(ValueError, match="max_num_neighbors=3"):
        lattice_device.build_neighbor_list_device(pos, p.nn_dist, cap, device="cpu")
    with pytest.raises(ValueError):
        lattice.build_neighbor_list(pos, p.nn_dist, cap)
    # not strict: the first `cap` columns of each row, as the reference truncates
    got = lattice_device.build_neighbor_list_device(pos, p.nn_dist, cap, strict=False,
                                                    device="cpu", block=10)
    full = lattice.build_neighbor_list(pos, p.nn_dist, p.max_num_neighbors)
    np.testing.assert_array_equal(got, full[:, :cap])
    np.testing.assert_array_equal(
        got, j_neighbor(pos, p.nn_dist, cap, strict=False))


@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("pbc", [False, True], ids=["open", "pbc"])
def test_disordered_stack_matches_kdtree(pbc, order):
    """``synthetic_stack``, the disordered stand-in's generator, at n_yz = 8
    (3,452 sites, interstitials off the lattice): the scan over blocks of
    500 rows equals the k-d tree entry for entry, with the sites in x order
    (each block scans a narrow window of columns) and shuffled (every
    block's window spans the structure)."""
    e, x, y, z, dims, _ = synthetic_stack(n_yz=8)
    pos = np.stack([x, y, z], 1)
    if order == "shuffled":
        pos = pos[np.random.default_rng(5).permutation(len(pos))]
    dims = np.asarray(dims, np.float64)
    got = lattice_device.build_neighbor_list_device(pos, 3.5, 52, dims, pbc, device="cpu",
                                                    block=500)
    np.testing.assert_array_equal(got, lattice.build_neighbor_list(pos, 3.5, 52, dims, pbc))


def test_row_block_stays_in_its_budget(monkeypatch):
    """On the host the block follows the available pages as on the card the
    free memory: 256 MiB available, an eighth of it for the temporaries."""
    cpu = torch.device("cpu")
    pages = {"SC_AVPHYS_PAGES": 1 << 16, "SC_PAGE_SIZE": 4096}
    monkeypatch.setattr(lattice_device.os, "sysconf", pages.__getitem__)
    n = 10_000
    b = lattice_device.row_block(n, cpu)
    assert b == (1 << 28) // 8 // (lattice_device.BYTES_PER_PAIR * n) == 139
    assert lattice_device.row_block(10, cpu) == 10
    assert lattice_device.row_block(1000, cpu) == 1000
    assert lattice_device.row_block(2000, cpu) == 699
    assert lattice_device.row_block(100, cpu) == 100
    assert lattice_device.row_block(10**9, cpu) == 1
    monkeypatch.setattr(lattice_device.os, "sysconf", {**pages, "SC_AVPHYS_PAGES": 1 << 30}
                        .__getitem__)
    assert lattice_device.row_block(n, cpu) == lattice_device.MAX_BLOCK


@pytest.mark.parametrize("kind", ["neighbors", "cutoff"])
def test_rule_at_the_cutoff_is_the_kdtree_one(kind):
    """The scan keeps a pair by the k-d tree's rule, so the lists do not
    depend on the device that built them, also on a pair that the squared
    rule (``build_neighbor_list(squared=True)``) keeps."""
    pos, c = pair_at_a_rounding_of_the_cutoff()
    unit = (0.0, 1.0, 1.0)
    assert lattice.site_dist(pos[0], pos[1], unit, False) == c
    assert lattice._dist2(pos[0], pos[1], unit, False) < c * c
    if kind == "neighbors":
        got = lattice_device.build_neighbor_list_device(pos, c, 3, device="cpu")
        want = lattice.build_neighbor_list(pos, c, 3)
        assert 1 in lattice.build_neighbor_list(pos, c, 3, squared=True)[0]
    else:
        e = np.array([int(lattice.ELEM.O)] * 3, np.int32)
        got, _ = lattice_device.build_cutoff_list_device(pos, e, c, device="cpu")
        want, _ = lattice.build_cutoff_list(pos, e, c)
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == 2 and 1 not in got[0] and 0 not in got[1]


@pytest.mark.parametrize("pbc", [False, True], ids=["open", "pbc"])
def test_build_lattice_builds_by_the_device_it_is_given(toy, monkeypatch, pbc):
    """On a CUDA device ``build_lattice`` calls the scan builders (run here
    on the CPU in their place), on the host the k-d tree; the lists are the
    same and so is the cache file's content."""
    p, pos, e = toy
    p = convert.params(p)
    p.pbc = pbc
    calls = []
    real_nn = lattice_device.build_neighbor_list_device
    real_cut = lattice_device.build_cutoff_list_device

    def nn(*a, **kw):
        calls.append(("nn", kw.pop("device")))
        return real_nn(*a, device="cpu", **kw)

    def cut(*a, **kw):
        calls.append(("cut", kw.pop("device")))
        return real_cut(*a, device="cpu", **kw)

    monkeypatch.setattr(lattice_device, "build_neighbor_list_device", nn)
    monkeypatch.setattr(lattice_device, "build_cutoff_list_device", cut)
    host = lattice.build_lattice(e, *pos.T, p, need_cutoff_table=True)
    assert not calls
    card = lattice.build_lattice(e, *pos.T, p, need_cutoff_table=True, device="cuda")
    assert [c[0] for c in calls] == ["nn"] * (1 + pbc) + ["cut"]
    assert all(str(c[1]) == "cuda" for c in calls)
    for name in ("neigh_idx", "k_neigh_idx", "cutoff_idx"):
        np.testing.assert_array_equal(getattr(card, name), getattr(host, name))
    assert host.cutoff_idx.shape[1] > 0
    assert lattice.build_lattice(e, *pos.T, p).cutoff_idx.shape == (len(pos), 0)
