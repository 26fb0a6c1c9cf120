"""The driver's scale-out options on the CPU: ``--devices 4 --device cpu`` (four
gloo ranks) and ``--concern-split 1:3``, on the toy deck of
``tests/test_driver.py`` and on the I-V deck with ``--synthesize-crossbar 6``,
against the port's one-device run and against ``akmc_tpu --devices 4`` (its
8-device virtual CPU platform, ``tests/conftest.py``).

* The crossbar (3,672 slots, no padding, DIA operator): the 4-rank and the
  concern-split runs give the one-device metrics rows exactly (``superstep_s``
  aside) and the same final snapshot; ``akmc_tpu --devices 4``'s KMC times
  within 1e-4, ``akmc_tpu``'s own spread between its sharded and one-device
  runs (``tests/test_driver_flags.py::test_devices_mesh_driver``).
* The toy deck (94 sites): four ranks pad it to 96 as ``akmc_tpu`` does (the
  same ``Mesh padding:`` and ``Device mesh:`` lines), so its K system has
  other rows than the one-device run's: the final elements are the same and
  KMC times agree within that 1e-4; the concern split, which does not pad,
  gives the one-device rows exactly.
"""

import json
import re

import numpy as np
import pytest
import torch

from akmc_tpu.runtime import driver as jdriver
from akmc_tpu_torch.lattice import read_xyz
from akmc_tpu_torch.parallel import launch
from akmc_tpu_torch.runtime import driver as tdriver
from tests.test_driver import _write_toy_deck

torch.set_num_threads(1)
DECK = "decks/iv_sweep_5nm.txt"
SPREAD = 1e-4           # akmc_tpu's --devices against one device
LIMIT = 300.0           # seconds a group of ranks may take here


def _rows(workdir):
    with open(workdir / "metrics.jsonl") as f:
        return [{k: v for k, v in json.loads(line).items() if k != "superstep_s"}
                for line in f]


def _log(workdir):
    return (workdir / "output1_0.txt").read_text()


def _kmc(workdir):
    return [float(t) for t in re.findall(r"KMC time is: ([\d.eE+-]+)", _log(workdir))]


def _mesh_lines(workdir):
    return [ln for ln in _log(workdir).splitlines()
            if ln.startswith(("Mesh padding:", "Device mesh:", "Concern groups:"))]


def _final_snapshot(workdir):
    snaps = sorted(workdir.glob("Results_*/snapshot_*.xyz"),
                   key=lambda p: (p.parent.name, int(re.findall(r"_(\d+)\.xyz", p.name)[0])
                                  if p.name != "snapshot_init.xyz" else -1))
    return snaps[-1]


@pytest.fixture(scope="module")
def crossbar_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("xbar")
    kw = dict(synthesize_crossbar=6, max_supersteps=6, log=False)
    one = tdriver.run(DECK, workdir=str(tmp / "one"), device="cpu", **kw)
    four = tdriver.run(DECK, workdir=str(tmp / "four"), device="cpu", devices=4,
                       rank_timeout=LIMIT, **kw)
    split = tdriver.run(DECK, workdir=str(tmp / "split"), device="cpu", concern_split=(1, 3),
                        rank_timeout=LIMIT, **kw)
    jdriver.run(DECK, workdir=str(tmp / "jax4"), devices=4, **kw)
    return tmp, one, four, split


def test_crossbar_devices_4_equals_one_device(crossbar_runs):
    tmp, one, four, _ = crossbar_runs
    assert _rows(tmp / "four") == _rows(tmp / "one") and len(_rows(tmp / "one")) == 6
    assert _final_snapshot(tmp / "four").read_bytes() == _final_snapshot(tmp / "one").read_bytes()
    assert [r["k_iterations"] for r in four["ranks"]] == [one["k_iterations"]] * 4
    assert [r["replica_checks"] for r in four["ranks"]] == [6] * 4
    assert four["model"]["ranks"] == 4 and four["model"]["k_operator"] == "dia"


def test_crossbar_devices_4_matches_akmc_tpu(crossbar_runs):
    tmp = crossbar_runs[0]
    assert _mesh_lines(tmp / "four") == _mesh_lines(tmp / "jax4") == [
        "Device mesh: 4 device(s) over the `sites` axis (N=3672, row-sharded tables, "
        "replicated fields)"]
    np.testing.assert_allclose(_kmc(tmp / "four"), _kmc(tmp / "jax4"), rtol=SPREAD)
    e4, *_ = read_xyz(str(_final_snapshot(tmp / "four")))
    ej, *_ = read_xyz(str(_final_snapshot(tmp / "jax4")))
    np.testing.assert_array_equal(e4, ej)


def test_crossbar_concern_split_equals_one_device(crossbar_runs):
    tmp, one, _, split = crossbar_runs
    assert _rows(tmp / "split") == _rows(tmp / "one")
    assert _mesh_lines(tmp / "split") == [
        "Concern groups: 1 K-solve device(s) + 3 pairwise device(s)"]
    # the K solves ran on the K group's one rank only
    assert [r["k_solves"] for r in split["ranks"]] == [one["k_solves"], 0, 0, 0]


def test_toy_deck_devices_and_concern_split(tmp_path, capsys, monkeypatch):
    spawn = launch.spawn             # the command line sets no limit; the test does
    monkeypatch.setattr(launch, "spawn", lambda *a, timeout=None: spawn(*a, timeout=LIMIT))
    deck, _ = _write_toy_deck(tmp_path, t_switch=1e3)
    common = [str(deck), "--device", "cpu", "--max-supersteps", "3"]
    tdriver.main(common + ["--workdir", str(tmp_path / "one")])
    tdriver.main(common + ["--workdir", str(tmp_path / "four"), "--devices", "4"])
    tdriver.main(common + ["--workdir", str(tmp_path / "split"), "--concern-split", "1:3"])
    assert capsys.readouterr().out.count("Total code execution time") == 3
    jdriver.run(str(deck), workdir=str(tmp_path / "jax4"), max_supersteps=3, log=False,
                devices=4)
    assert _mesh_lines(tmp_path / "four") == _mesh_lines(tmp_path / "jax4") == [
        "Mesh padding: 2 inert site(s) appended (site axis 96 over 4 devices)",
        "Device mesh: 4 device(s) over the `sites` axis (N=96, row-sharded tables, "
        "replicated fields)"]
    np.testing.assert_allclose(_kmc(tmp_path / "four"), _kmc(tmp_path / "one"), rtol=SPREAD)
    np.testing.assert_allclose(_kmc(tmp_path / "four"), _kmc(tmp_path / "jax4"), rtol=SPREAD)
    # padding sites stay out of the snapshots
    e1, x1, *_ = read_xyz(str(_final_snapshot(tmp_path / "one")))
    e4, x4, *_ = read_xyz(str(_final_snapshot(tmp_path / "four")))
    np.testing.assert_array_equal(e1, e4)
    np.testing.assert_array_equal(x1, x4)
    assert _rows(tmp_path / "split") == _rows(tmp_path / "one")


def test_sharded_checkpoint_resume_is_the_uninterrupted_run(tmp_path):
    """Under --devices rank 0 writes the checkpoint and every rank reads it:
    an interrupted 4-rank run resumed gives the uninterrupted rows."""
    kw = dict(synthesize_crossbar=6, log=False, device="cpu", devices=4, rank_timeout=LIMIT)
    tdriver.run(DECK, workdir=str(tmp_path / "a"), max_supersteps=4, **kw)
    tdriver.run(DECK, workdir=str(tmp_path / "b"), max_supersteps=2, checkpoint_every=1, **kw)
    tdriver.run(DECK, workdir=str(tmp_path / "b"), max_supersteps=2,
                resume_from=str(tmp_path / "b" / "checkpoint.npz"), **kw)
    assert _rows(tmp_path / "b") == _rows(tmp_path / "a") and len(_rows(tmp_path / "a")) == 4


def test_devices_on_cuda_need_a_card_per_rank():
    if torch.cuda.is_available() and torch.cuda.device_count() >= 64:
        pytest.skip("this machine has 64 cards")
    with pytest.raises((ValueError, RuntimeError), match="CUDA device|cards"):
        tdriver.run(DECK, synthesize_crossbar=6, devices=64)
