"""The neighbor-list cache of ``lattice.build_lattice`` (``--cache-dir``): the
port and akmc_tpu key, name and fill the same ``lists_<hash>.npz`` files, so
each reads what the other wrote (akmc_tpu/lattice.py:371-460).

* A cache that akmc_tpu wrote is read by the port, and one that the port
  wrote is read by akmc_tpu: neither builds its lists then.
* The tables read from either equal a fresh build entry for entry.
* A moved position misses the cache; precomputed lists are never cached.
* Both drivers, run twice on one cache directory, share one file.
"""

import sys

import numpy as np
import pytest

import akmc_tpu.lattice as jlat
from akmc_tpu import native
from akmc_tpu.state import make_substoichiometric
from akmc_tpu.rng import ReferenceRNG as JRNG
from akmc_tpu.runtime import driver as jdriver
from akmc_tpu_torch import convert
from akmc_tpu_torch import lattice as tlat
from akmc_tpu_torch.runtime import driver as tdriver
from tests.test_driver import _write_toy_deck
from tests.util_toy import toy_device

LISTS = ("neigh_idx", "k_neigh_idx", "cutoff_idx")


@pytest.fixture(scope="module")
def structure():
    p, lat = toy_device()
    e = make_substoichiometric(lat.element0, 0.2, JRNG(7))
    return p, e, lat.x, lat.y, lat.z


def _forbid(monkeypatch, module, names):
    """Make the list builders of ``module`` fail: a cache hit never calls them."""
    def refuse(*a, **k):
        raise AssertionError("the lists were built, not read from the cache")

    for name in names:
        monkeypatch.setattr(module, name, refuse)


def _equal_lists(a, b):
    for name in LISTS:
        np.testing.assert_array_equal(np.asarray(getattr(a, name)), np.asarray(getattr(b, name)))


@pytest.mark.parametrize("pbc", [False, True], ids=["open", "pbc"])
def test_akmc_tpu_cache_is_read_by_the_port(tmp_path, structure, monkeypatch, pbc):
    """With akmc_tpu's full cutoff table in the file: the port keeps it."""
    p, e, x, y, z = structure
    p = p.replace(pbc=pbc)
    tp = convert.params(p)
    jl = jlat.build_lattice(e, x, y, z, p, cache_dir=str(tmp_path), need_cutoff_table=True)
    files = list(tmp_path.glob("lists_*.npz"))
    assert len(files) == 1
    fresh = tlat.build_lattice(e, x, y, z, tp)
    cutoff, _ = tlat.build_cutoff_list(np.stack([x, y, z], axis=1), e, p.cutoff_radius)
    _forbid(monkeypatch, tlat, ["build_neighbor_list", "build_cutoff_list"])
    cached = tlat.build_lattice(e, x, y, z, tp, cache_dir=str(tmp_path))
    _equal_lists(cached, jl)
    for name in ("neigh_idx", "k_neigh_idx"):
        np.testing.assert_array_equal(getattr(cached, name), getattr(fresh, name))
    assert cutoff.shape[1] > 0
    np.testing.assert_array_equal(cached.cutoff_idx, cutoff)
    assert list(tmp_path.glob("lists_*.npz")) == files


def test_port_cache_is_read_by_akmc_tpu(tmp_path, structure, monkeypatch):
    p, e, x, y, z = structure
    tp = convert.params(p)
    tl = tlat.build_lattice(e, x, y, z, tp, cache_dir=str(tmp_path))
    files = list(tmp_path.glob("lists_*.npz"))
    assert len(files) == 1 and tl.cutoff_idx.shape == (len(e), 0)
    with np.load(files[0]) as d:
        assert sorted(d.files) == sorted(LISTS)
        assert all(d[name].dtype == np.int32 for name in LISTS)
    fresh = jlat.build_lattice(e, x, y, z, p)
    _forbid(monkeypatch, jlat, ["build_neighbor_list", "build_cutoff_list", "build_k_adjacency"])
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setitem(sys.modules, "akmc_tpu.lattice_jax", None)
    cached = jlat.build_lattice(e, x, y, z, p, cache_dir=str(tmp_path))
    _equal_lists(cached, tl)
    _equal_lists(cached, fresh)


def test_moved_position_misses_the_cache(tmp_path, structure):
    p, e, x, y, z = structure
    tp = convert.params(p)
    tlat.build_lattice(e, x, y, z, tp, cache_dir=str(tmp_path))
    x2 = x.copy()
    x2[5] += 1e-9
    moved = tlat.build_lattice(e, x2, y, z, tp, cache_dir=str(tmp_path))
    assert len(list(tmp_path.glob("lists_*.npz"))) == 2
    _equal_lists(moved, tlat.build_lattice(e, x2, y, z, tp))
    # the same positions under akmc_tpu's key: its file is the port's second one
    jlat.build_lattice(e, x2, y, z, p, cache_dir=str(tmp_path))
    assert len(list(tmp_path.glob("lists_*.npz"))) == 2


def test_precomputed_lists_are_not_cached(tmp_path, structure):
    p, e, x, y, z = structure
    tp = convert.params(p)
    nl = tlat.build_lattice(e, x, y, z, tp).neigh_idx
    tlat.build_lattice(e, x, y, z, tp, cache_dir=str(tmp_path), precomputed_lists=(nl, nl))
    assert not tmp_path.exists() or not list(tmp_path.glob("*"))


def test_drivers_share_one_cache(tmp_path):
    """akmc_tpu's driver writes the file, the port's driver finds it (and
    writes none), and both runs give the same log."""
    deck, _ = _write_toy_deck(tmp_path, t_switch=1e3)
    cache = tmp_path / "cache"
    jdriver.run(str(deck), workdir=str(tmp_path / "j"), max_supersteps=2, log=False,
                cache_dir=str(cache))
    files = sorted(cache.glob("lists_*.npz"))
    assert len(files) == 1
    stamp = files[0].stat().st_mtime_ns
    tdriver.run(str(deck), workdir=str(tmp_path / "t"), max_supersteps=2, log=False,
                device="cpu", cache_dir=str(cache))
    tdriver.run(str(deck), workdir=str(tmp_path / "t2"), max_supersteps=2, log=False,
                device="cpu", cache_dir=str(cache))
    assert sorted(cache.glob("lists_*.npz")) == files and files[0].stat().st_mtime_ns == stamp
    assert (tmp_path / "t" / "metrics.jsonl").read_text().count("\n") == 2
    kmc = [ln for ln in (tmp_path / "t" / "output1_0.txt").read_text().splitlines()
           if ln.startswith("KMC time is:")]
    assert kmc == [ln for ln in (tmp_path / "t2" / "output1_0.txt").read_text().splitlines()
                   if ln.startswith("KMC time is:")]
    assert kmc == [ln for ln in (tmp_path / "j" / "output1_0.txt").read_text().splitlines()
                   if ln.startswith("KMC time is:")]
