"""The driver's deck modes and options that the port gained last, on the CPU,
against akmc_tpu's driver on the same toy deck (tests/test_driver.py's).

* ``perturb_structure = 0`` (fields only) and ``solve_potential = 0`` (events
  on the stale potential): the counterparts of
  tests/test_driver_flags.py::test_fields_only_mode and
  ::test_events_without_potential, with ``output1_0.txt`` equal to
  akmc_tpu's line for line apart from the timing values.
* ``--steps-per-dispatch``: the counterpart of
  tests/test_driver.py::test_driver_steps_per_dispatch, read with the port's
  own ``postprocessing/extract.py``; the full-physics branch; the overshoot
  of ``t_switch`` by up to k - 1 supersteps; checkpoints on batch boundaries.
* ``--warmup``: the counterpart of tests/test_driver_flags.py::test_warmup_flag.
* akmc_tpu's command line with ``--cache-dir``, ``--steps-per-dispatch`` and
  ``--warmup`` runs on the port.
"""

import json
import re

import numpy as np
import pytest
import torch

from akmc_tpu.models.crossbar import build_grid_crossbar
from akmc_tpu.models.vcm import VCMModel as JModel
from akmc_tpu.runtime import driver as jdriver
from akmc_tpu.state import make_device_state as j_state
from akmc_tpu_torch import convert
from akmc_tpu_torch.lattice import read_xyz
from akmc_tpu_torch.models.vcm import VCMModel as TModel
from akmc_tpu_torch.postprocessing.extract import parse_output_txt
from akmc_tpu_torch.runtime import driver as tdriver
from tests.test_driver import _write_toy_deck
from tests.util_toy import toy_device

# see tests/test_torch_superstep.py: PyTorch on the calling thread only
torch.set_num_threads(1)

KMC_RTOL = 1e-12


def _run(deck, workdir, **kw):
    return tdriver.run(str(deck), workdir=str(workdir), log=False, device="cpu", **kw)


def _log(workdir):
    """output1_0.txt with the timing values taken off their lines."""
    lines = (workdir / "output1_0.txt").read_text().splitlines()
    return [re.sub(r"[-+.0-9e]+$", "", ln) if ln.startswith("Z - calculation time") else ln
            for ln in lines]


def _rows(workdir):
    rows = [json.loads(ln) for ln in (workdir / "metrics.jsonl").read_text().splitlines()]
    for r in rows:
        r.pop("superstep_s")
    return rows


def _same_logs(jdir, tdir):
    """Line for line, timing values aside; KMC times to KMC_RTOL."""
    jl, tl = _log(jdir), _log(tdir)
    assert len(tl) == len(jl)
    for a, b in zip(jl, tl):
        if a.startswith("KMC time is: "):
            assert float(b.split(": ")[1]) == pytest.approx(float(a.split(": ")[1]),
                                                            rel=KMC_RTOL, abs=0.0)
        else:
            assert b == a


def _column(path, k):
    return [ln.split()[k] for ln in path.read_text().splitlines()[2:] if ln.strip()]


def test_fields_only_mode(tmp_path):
    deck, _ = _write_toy_deck(tmp_path, perturb=0, t_switch=1e-9)
    summary = _run(deck, tmp_path / "t")
    jdriver.run(str(deck), workdir=str(tmp_path / "j"), log=False)
    assert summary["total_steps"] == 2
    out = (tmp_path / "t" / "output1_0.txt").read_text()
    assert "kmc events" not in out and "potential from boundaries" in out
    assert parse_output_txt(str(tmp_path / "t" / "output1_0.txt")).kmc_times == [0.0, 1e-9]
    folder = tmp_path / "t" / "Results_2.000000"
    e0, *_ = read_xyz(str(folder / "snapshot_init.xyz"))
    e1, *_ = read_xyz(str(folder / "snapshot_2.xyz"))
    np.testing.assert_array_equal(e0, e1)
    _same_logs(tmp_path / "j", tmp_path / "t")
    assert _rows(tmp_path / "t") == _rows(tmp_path / "j")
    assert [r["n_events"] for r in _rows(tmp_path / "t")] == [0, 0]
    final = "Results_2.000000/snapshot_2.xyz"
    pot_t = np.array(_column(tmp_path / "t" / final, 4), float)
    pot_j = np.array(_column(tmp_path / "j" / final, 4), float)
    assert np.abs(pot_j).max() > 0
    np.testing.assert_allclose(pot_t, pot_j, rtol=1e-8, atol=1e-9)


def test_fields_only_model():
    """``VCMModel.fields_only`` against akmc_tpu's from one state: charges
    exact, CG count equal, potentials within the superstep tests' bounds, and
    nothing but the charge and the potentials replaced."""
    p, lat = toy_device()
    jm = JModel(p, lat)
    tm = TModel(convert.params(p), convert.lattice(lat), device="cpu")
    js = j_state(lat, p.background_temp)
    ts = convert.state(js)
    for Vd in (2.0, 3.0):
        js, jst = jm.fields_only(js, Vd)
        ts2, tst = tm.fields_only(ts, Vd)
        assert tst == jst
        np.testing.assert_array_equal(ts2.charge.numpy(), np.asarray(js.charge))
        for name in ("potential_boundary", "potential_charge"):
            np.testing.assert_allclose(getattr(ts2, name).numpy(), np.asarray(getattr(js, name)),
                                       rtol=1e-8, atol=1e-9)
        for name in ("element", "power", "temperature", "cb_edge", "T_bg", "kmc_time"):
            assert getattr(ts2, name) is getattr(ts, name)
        ts = ts2


def test_events_without_potential(tmp_path):
    deck, _ = _write_toy_deck(tmp_path, solve_potential=0, t_switch=1e3)
    # the first superstep's waiting time on the zero potential already passes
    # 1e-12; a long t_switch gives three supersteps
    summary = _run(deck, tmp_path / "t", max_supersteps=3)
    jdriver.run(str(deck), workdir=str(tmp_path / "j"), max_supersteps=3, log=False)
    assert summary["total_steps"] == 3
    out = (tmp_path / "t" / "output1_0.txt").read_text()
    assert "potential from boundaries" not in out and "charge [s]" not in out
    assert "kmc events" in out
    times = parse_output_txt(str(tmp_path / "t" / "output1_0.txt")).kmc_times
    assert len(times) == 3 and all(t > 0 for t in times)
    _same_logs(tmp_path / "j", tmp_path / "t")
    rt, rj = _rows(tmp_path / "t"), _rows(tmp_path / "j")
    assert [(r["n_events"], r["cg_iterations"]) for r in rt] == [
        (r["n_events"], r["cg_iterations"]) for r in rj]
    assert sum(r["n_events"] for r in rt) >= 3
    np.testing.assert_allclose([r["kmc_time"] for r in rt], [r["kmc_time"] for r in rj],
                               rtol=KMC_RTOL, atol=0)
    final = "Results_2.000000/snapshot_3.xyz"
    assert _column(tmp_path / "t" / final, 0) == _column(tmp_path / "j" / final, 0)
    assert _column(tmp_path / "t" / final, 0) != _column(
        tmp_path / "t" / "Results_2.000000/snapshot_init.xyz", 0)


def test_driver_steps_per_dispatch(tmp_path):
    """k = 2 supersteps per batch: the single-step driver's trajectory, and
    akmc_tpu's batched driver's."""
    deck, _ = _write_toy_deck(tmp_path, t_switch=1e3)
    _run(deck, tmp_path / "a", max_supersteps=4)
    _run(deck, tmp_path / "b", max_supersteps=4, steps_per_dispatch=2)
    jdriver.run(str(deck), workdir=str(tmp_path / "j"), max_supersteps=4, log=False,
                steps_per_dispatch=2)
    da = parse_output_txt(str(tmp_path / "a" / "output1_0.txt"))
    db = parse_output_txt(str(tmp_path / "b" / "output1_0.txt"))
    assert len(da.kmc_times) == len(db.kmc_times) == 4
    assert db.kmc_times == da.kmc_times
    assert _rows(tmp_path / "b") == _rows(tmp_path / "a")
    _same_logs(tmp_path / "j", tmp_path / "b")
    # the two supersteps of a batch share its wall time
    sb = [json.loads(ln)["superstep_s"]
          for ln in (tmp_path / "b" / "metrics.jsonl").read_text().splitlines()]
    assert sb[0] == sb[1] and sb[2] == sb[3]


def test_steps_per_dispatch_overshoots_t_switch(tmp_path):
    """The bias loop reads the clock between batches only: with k = 3 a bias
    point whose clock passes t_switch after one superstep still runs the
    batch's three, as akmc_tpu's driver does."""
    deck, _ = _write_toy_deck(tmp_path, t_switch=1e-9)
    single = _run(deck, tmp_path / "a")
    batched = _run(deck, tmp_path / "b", steps_per_dispatch=3)
    jdriver.run(str(deck), workdir=str(tmp_path / "j"), log=False, steps_per_dispatch=3)
    assert single["total_steps"] < 3 and batched["total_steps"] == 3
    assert _rows(tmp_path / "b")[:single["total_steps"]] == _rows(tmp_path / "a")
    _same_logs(tmp_path / "j", tmp_path / "b")


def test_full_physics_steps_per_dispatch(tmp_path):
    """--full-physics with k = 2: the rows of the single-step run (I_macro,
    P_tot, T_bg, power-CG counts and tolerance policy included)."""
    deck, _ = _write_toy_deck(tmp_path, full=True, t_switch=1e3)
    _run(deck, tmp_path / "a", max_supersteps=2, committed_parity=False)
    _run(deck, tmp_path / "b", max_supersteps=2, committed_parity=False, steps_per_dispatch=2)
    rows = _rows(tmp_path / "b")
    assert rows == _rows(tmp_path / "a") and len(rows) == 2
    assert all("I_macro" in r and "power_rtol_scale" in r for r in rows)
    assert _log(tmp_path / "b") == _log(tmp_path / "a")


def test_checkpoints_land_on_batch_boundaries(tmp_path):
    """``checkpoint_every`` 1 with k = 2: a checkpoint after every batch, at
    an even step count, and a resumed run goes on as the uninterrupted one."""
    deck, _ = _write_toy_deck(tmp_path, t_switch=1e3)
    _run(deck, tmp_path / "a", max_supersteps=4)
    _run(deck, tmp_path / "b", max_supersteps=2, steps_per_dispatch=2, checkpoint_every=1)
    with np.load(tmp_path / "b" / "checkpoint.npz") as d:
        assert int(d["kmc_step_count"]) == 2
    _run(deck, tmp_path / "b", max_supersteps=2, steps_per_dispatch=2,
         resume_from=str(tmp_path / "b" / "checkpoint.npz"))
    assert _rows(tmp_path / "b") == _rows(tmp_path / "a")


def test_warmup_flag(tmp_path):
    deck, _ = _write_toy_deck(tmp_path, t_switch=1e3)
    s1 = _run(deck, tmp_path / "w", max_supersteps=2, warmup=True)
    s2 = _run(deck, tmp_path / "n", max_supersteps=2)
    out_w = (tmp_path / "w" / "output1_0.txt").read_text()
    assert re.search(r"^AOT warmup: [0-9.]+ s \(.*\)$", out_w, re.M)
    assert "AOT warmup:" not in (tmp_path / "n" / "output1_0.txt").read_text()
    assert s1["total_steps"] == s2["total_steps"] == 2
    assert [ln for ln in _log(tmp_path / "w") if not ln.startswith("AOT warmup:")] == _log(
        tmp_path / "n")
    assert _rows(tmp_path / "w") == _rows(tmp_path / "n")


def test_warmup_builds_the_lazy_tables():
    """``VCMModel.warmup`` under full physics: the current tables, the power
    band and the local heat tables are built, the state is left alone, and
    a batched warmup draws from a generator of its own."""
    p, lat = toy_device()
    p.solve_heating_local = True
    tm = TModel(convert.params(p), convert.lattice(lat), device="cpu")
    ts = convert.state(j_state(lat, p.background_temp))
    before = {k: v.clone() for k, v in vars(ts).items()}
    items = tm.warmup(ts, 2.0, full_physics=True, batched=8)
    assert set(items) == {"current_tables", "power_band", "local_heat", "batched_B8"}
    assert all(v >= 0 for v in items.values())
    assert tm._current_tables is not None and tm._power_band_built
    assert tm._local_heat is not None
    assert all(torch.equal(getattr(ts, k), v) for k, v in before.items())
    assert tm.k_solves == 0        # no K solve on the CPU: there is no kernel to load


def test_kernel_loading_solve_is_counted():
    """The solve that loads the DIA kernels on a card stops after its entry
    matvec and counts as a K solve of one iteration, as the card's kernel
    counts it on the device."""
    p, lat = build_grid_crossbar(n_yz=6, contact_slices=2, oxide_slices=6, ti_slices=2,
                                 defect_fraction=0.3, vacancy_concentration=0.1, seed=3)
    tm = TModel(convert.params(p), convert.lattice(lat), device="cpu")
    ts = convert.state(j_state(lat, p.background_temp))
    assert tm.dia is not None
    tm._empty_dia_solve(ts, 2.0)
    assert (tm.k_solves, tm.k_iterations) == (1, 1)


def test_akmc_tpu_command_line_runs(tmp_path, capsys):
    deck, _ = _write_toy_deck(tmp_path, t_switch=1e3)
    cache = tmp_path / "cache"
    tdriver.main([str(deck), "--device", "cpu", "--max-supersteps", "2",
                  "--workdir", str(tmp_path / "w"), "--cache-dir", str(cache),
                  "--steps-per-dispatch", "2", "--warmup"])
    assert "Total code execution time" in capsys.readouterr().out
    assert len(list(cache.glob("lists_*.npz"))) == 1
    assert len(_rows(tmp_path / "w")) == 2
    assert "AOT warmup:" in (tmp_path / "w" / "output1_0.txt").read_text()


def test_cli_has_every_option_of_akmc_tpu(monkeypatch, capsys):
    """Every option of akmc_tpu's driver is an option of the port's."""
    def options(main, argv):
        with pytest.raises(SystemExit):
            main(argv)
        return set(re.findall(r"--[a-z][a-z0-9-]*", capsys.readouterr().out))

    monkeypatch.setattr("sys.argv", ["driver", "--help"])
    theirs = options(lambda argv: jdriver.main(), None)
    ours = options(tdriver.main, ["--help"])
    assert "--cache-dir" in theirs and "--concern-split" in theirs
    assert theirs <= ours, theirs - ours
