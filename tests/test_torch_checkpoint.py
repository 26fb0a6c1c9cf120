"""Checkpoints and the driver's production flags in akmc_tpu_torch, on the CPU.

* A serial run of the port that is interrupted, checkpointed and resumed is
  bit-identical to an uninterrupted one (the counterpart of
  tests/test_checkpoint.py), through the model and through the driver.
* The npz file has akmc_tpu's field names, dtypes and shapes: a checkpoint
  written by akmc_tpu loads in the port and the other way round, field for
  field, and the mt19937 stream goes on with the same draws.
* ``--module-timing``, ``--batched-events`` (with ``--clock-f32``,
  ``--mass-eps``, ``--k-extrap``), ``--checkpoint-every`` and
  ``--resume-from`` on the toy deck: the counterparts of
  tests/test_driver_flags.py's module-timing and batched-events tests and of
  tests/test_driver.py's resume test.
"""

import json
import re

import numpy as np
import pytest
import torch

from akmc_tpu.models.vcm import VCMModel as JModel
from akmc_tpu.rng import BufferedStream as JStream
from akmc_tpu.rng import ReferenceRNG as JRNG
from akmc_tpu.runtime import checkpoint as jckpt
from akmc_tpu.runtime import driver as jdriver
from akmc_tpu.state import make_device_state as j_state
from akmc_tpu.state import make_substoichiometric
from akmc_tpu_torch import convert
from akmc_tpu_torch.lattice import ELEM
from akmc_tpu_torch.models.vcm import VCMModel as TModel
from akmc_tpu_torch.rng import BufferedStream as TStream
from akmc_tpu_torch.rng import ReferenceRNG as TRNG
from akmc_tpu_torch.runtime import checkpoint as tckpt
from akmc_tpu_torch.runtime import driver as tdriver
from tests.test_driver import _write_toy_deck
from tests.util_toy import toy_device

# see tests/test_torch_superstep.py: PyTorch on the calling thread only
torch.set_num_threads(1)

STATE_FIELDS = ("element", "charge", "potential_boundary", "potential_charge", "power",
                "temperature", "cb_edge", "T_bg", "kmc_time")


@pytest.fixture(scope="module")
def toy():
    p, lat = toy_device()
    lat.element0[:] = make_substoichiometric(lat.element0, 0.2, JRNG(7))
    return p, lat


def _steps(model, state, stream, n):
    for _ in range(n):
        state, _ = model.superstep(state, 2.0, stream)
    return state


def test_checkpoint_resume_bit_identical(tmp_path, toy):
    p, lat = toy
    model = TModel(convert.params(p), convert.lattice(lat), device="cpu")
    s0 = convert.state(j_state(lat, p.background_temp))

    whole = _steps(model, s0, TStream(TRNG(1)), 4)           # uninterrupted

    st2 = TStream(TRNG(1))
    s2 = _steps(model, s0, st2, 2)                           # interrupted after two
    ck = str(tmp_path / "ck.npz")
    tckpt.save_checkpoint(ck, s2, st2, vt_counter=0, kmc_step_count=2, extra={"Vd": 2.0})
    assert sorted(f.name for f in tmp_path.iterdir()) == ["ck.npz"]      # no temporary left
    s3, st3, vt, steps, extra = tckpt.load_checkpoint(ck, "cpu")
    assert (vt, steps, extra) == (0, 2, {"Vd": 2.0})
    s3 = _steps(model, s3, st3, 2)

    for name in STATE_FIELDS:
        assert torch.equal(getattr(s3, name), getattr(whole, name)), name
    assert float(whole.kmc_time) > 0


def test_load_checkpoint_defaults_to_the_card(tmp_path, toy):
    p, lat = toy
    ck = str(tmp_path / "ck.npz")
    tckpt.save_checkpoint(ck, convert.state(j_state(lat, p.background_temp)), TStream(TRNG(1)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tckpt.load_checkpoint(ck)


@pytest.fixture(scope="module")
def two_steps_in(toy):
    """akmc_tpu's state and stream after two supersteps, with the same in the
    port's types."""
    p, lat = toy
    jm = JModel(p, lat)
    js, jstream = j_state(lat, p.background_temp), JStream(JRNG(1))
    for _ in range(2):
        js, _ = jm.superstep(js, 2.0, jstream)
    return js, jstream, jm


def test_checkpoint_files_have_the_same_layout(tmp_path, two_steps_in):
    js, jstream, _ = two_steps_in
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jckpt.save_checkpoint(jpath, js, jstream, vt_counter=1, kmc_step_count=2, extra={"Vd": 2.0})
    tckpt.save_checkpoint(tpath, convert.state(js), convert.stream(jstream), vt_counter=1,
                          kmc_step_count=2, extra={"Vd": 2.0})
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype and a[name].shape == b[name].shape, name
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_akmc_tpu_checkpoint_loads_in_the_port(tmp_path, two_steps_in, toy):
    p, lat = toy
    js, jstream, jm = two_steps_in
    path = str(tmp_path / "j.npz")
    jckpt.save_checkpoint(path, js, jstream, vt_counter=3, kmc_step_count=2, extra={"Vd": 2.0})
    ts, tstream, vt, steps, extra = tckpt.load_checkpoint(path, "cpu")
    assert (vt, steps, extra) == (3, 2, {"Vd": 2.0})
    want = convert.state(js)
    for name in STATE_FIELDS:
        got = getattr(ts, name)
        assert got.dtype == getattr(want, name).dtype and torch.equal(got, getattr(want, name)), name
    mt, mti, buf = tstream.get_state()
    np.testing.assert_array_equal(mt, jstream._rng._mt.mt)
    assert mti == jstream._rng._mt.mti
    np.testing.assert_array_equal(buf, jstream._buf)
    n = len(buf) + 700                       # past the buffered draws and one twist
    np.testing.assert_array_equal(tstream.peek(n), JStream.peek(jstream, n))

    # and goes on as akmc_tpu does: two more supersteps in both packages
    tm = TModel(convert.params(p), convert.lattice(lat), device="cpu")
    ts = _steps(tm, ts, tstream, 2)
    js2, jstream2, *_ = jckpt.load_checkpoint(path)
    for _ in range(2):
        js2, _ = jm.superstep(js2, 2.0, jstream2)
    np.testing.assert_array_equal(ts.element.numpy(), np.asarray(js2.element))
    assert float(ts.kmc_time) == pytest.approx(float(js2.kmc_time), rel=1e-7)


def test_port_checkpoint_loads_in_akmc_tpu(tmp_path, two_steps_in):
    js, jstream, _ = two_steps_in
    path = str(tmp_path / "t.npz")
    tckpt.save_checkpoint(path, convert.state(js), convert.stream(jstream), vt_counter=1,
                          kmc_step_count=7, extra={"Vd": -3.0})
    js2, jstream2, vt, steps, extra = jckpt.load_checkpoint(path)
    assert (vt, steps, extra) == (1, 7, {"Vd": -3.0})
    for name in STATE_FIELDS:
        a, b = np.asarray(getattr(js2, name)), np.asarray(getattr(js, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    n = len(jstream._buf) + 700
    np.testing.assert_array_equal(jstream2.peek(n), JStream.peek(jstream, n))


# ------------------------------------------------------------ the driver
def _rows(workdir):
    rows = [json.loads(ln) for ln in (workdir / "metrics.jsonl").read_text().splitlines()]
    for r in rows:
        r.pop("superstep_s")
    return rows


def _kmc_times(workdir):
    return [float(m) for m in re.findall(r"KMC time is: ([\d.eE+-]+)",
                                         (workdir / "output1_0.txt").read_text())]


def _run(deck, workdir, **kw):
    return tdriver.run(str(deck), workdir=str(workdir), log=False, device="cpu", **kw)


def test_driver_checkpoint_resume(tmp_path):
    """An interrupted serial run resumed from its checkpoint, in its own
    workdir: the same metrics rows and the same final snapshot, byte for byte,
    as the uninterrupted run."""
    deck, _ = _write_toy_deck(tmp_path, t_switch=1e3)
    _run(deck, tmp_path / "a", max_supersteps=5)
    _run(deck, tmp_path / "b", max_supersteps=3, checkpoint_every=3)
    assert (tmp_path / "b" / "checkpoint.npz").exists()
    summary = _run(deck, tmp_path / "b", max_supersteps=2,
                   resume_from=str(tmp_path / "b" / "checkpoint.npz"))
    assert summary["total_steps"] == 2
    assert _rows(tmp_path / "b") == _rows(tmp_path / "a") and len(_rows(tmp_path / "a")) == 5
    final = "Results_2.000000/snapshot_5.xyz"
    assert (tmp_path / "b" / final).read_bytes() == (tmp_path / "a" / final).read_bytes()
    log = (tmp_path / "b" / "output1_0.txt").read_text()
    assert "Resumed from checkpoint" in log and _kmc_times(tmp_path / "b") == _kmc_times(tmp_path / "a")


def test_driver_resumes_an_akmc_tpu_checkpoint(tmp_path):
    """A checkpoint of akmc_tpu's driver continued by the port's: supersteps
    3 and 4 of akmc_tpu's uninterrupted run."""
    deck, _ = _write_toy_deck(tmp_path, t_switch=1e3)
    jdriver.run(str(deck), workdir=str(tmp_path / "a"), max_supersteps=4, log=False)
    jdriver.run(str(deck), workdir=str(tmp_path / "b"), max_supersteps=2, log=False,
                checkpoint_every=1)
    _run(deck, tmp_path / "b2", max_supersteps=2,
         resume_from=str(tmp_path / "b" / "checkpoint.npz"))
    np.testing.assert_allclose(_kmc_times(tmp_path / "b2"), _kmc_times(tmp_path / "a")[2:4],
                               rtol=1e-6)
    assert [r["step"] for r in _rows(tmp_path / "b2")] == [3, 4]


def _hysteresis_deck(tmp_path):
    """The toy deck with a bias ladder that comes back to its first value."""
    deck, _ = _write_toy_deck(tmp_path, t_switch=1e-12)
    text = open(deck).read()
    text = text.replace("V_switch = 2.0\n", "V_switch = 2.0 3.0 2.0\n")
    text = text.replace("t_switch = 1e-12\n", "t_switch = 1e-12 1e-12 1e-12\n")
    assert "2.0 3.0 2.0" in text and "1e-12 1e-12 1e-12" in text
    with open(deck, "w") as f:
        f.write(text)
    return deck


def _folders(workdir):
    return sorted(f.name for f in workdir.iterdir() if f.name.startswith("Results_"))


def test_resumed_hysteresis_sweep_keeps_its_folder_names(tmp_path):
    """Where the port departs from akmc_tpu on purpose: a resumed run counts
    the bias points it skips as visited, so the second visit of a bias value
    goes to ``Results_<V>_<index>`` as it does in the uninterrupted run, and
    the resumed serial run equals it row for row and byte for byte.
    akmc_tpu's driver forgets the skipped points (its ``visited_biases``
    starts empty on resume), so its resumed run writes the second visit into
    the first visit's folder."""
    deck = _hysteresis_deck(tmp_path)
    _run(deck, tmp_path / "a")
    rows = _rows(tmp_path / "a")
    assert [r["bias"] for r in rows][0] == 2.0 and [r["bias"] for r in rows][-1] == 2.0
    stop = next(i for i, r in enumerate(rows) if r["bias"] == 3.0) + 1   # inside the second point
    _run(deck, tmp_path / "b", max_supersteps=stop, checkpoint_every=1)
    _run(deck, tmp_path / "b", resume_from=str(tmp_path / "b" / "checkpoint.npz"))
    assert _rows(tmp_path / "b") == rows
    assert _folders(tmp_path / "b") == _folders(tmp_path / "a") == [
        "Results_2.000000", "Results_2.000000_2", "Results_3.000000"]
    last = f"Results_2.000000_2/snapshot_{rows[-1]['step']}.xyz"
    assert (tmp_path / "b" / last).read_bytes() == (tmp_path / "a" / last).read_bytes()

    # akmc_tpu on the same deck and the same interruption
    jdriver.run(str(deck), workdir=str(tmp_path / "ja"), log=False)
    jdriver.run(str(deck), workdir=str(tmp_path / "jb"), max_supersteps=stop, log=False,
                checkpoint_every=1)
    jdriver.run(str(deck), workdir=str(tmp_path / "jb"), log=False,
                resume_from=str(tmp_path / "jb" / "checkpoint.npz"))
    assert _folders(tmp_path / "ja") == _folders(tmp_path / "a")
    assert _folders(tmp_path / "jb") == ["Results_2.000000", "Results_3.000000"]


def test_module_timing_lines(tmp_path):
    """--module-timing: the four Z-lines carry per-module measured values
    (not one repeated superstep total: the dispatch's spans) and the
    trajectory is unchanged; each row of metrics.jsonl holds the span table."""
    deck, _ = _write_toy_deck(tmp_path, t_switch=1e3)
    _run(deck, tmp_path / "a", max_supersteps=3)
    _run(deck, tmp_path / "b", max_supersteps=3, module_timing=True)
    assert _kmc_times(tmp_path / "b") == _kmc_times(tmp_path / "a")
    ra, rb = _rows(tmp_path / "a"), _rows(tmp_path / "b")
    times = ("t_charge", "t_boundary", "t_pairwise", "t_rates", "t_events", "spans")
    assert [{k: v for k, v in r.items() if k not in times} for r in rb] == ra
    assert all(r["spans"]["superstep"]["n"] == 1 for r in rb)
    per_step = re.findall(
        r"charge \[s\]([\d.eE+-]+)\n"
        r"Z - calculation time - potential from boundaries \[s\]([\d.eE+-]+)\n"
        r"Z - calculation time - potential from charges \[s\]([\d.eE+-]+)\n"
        r"Z - calculation time - kmc events \[s\]([\d.eE+-]+)",
        (tmp_path / "b" / "output1_0.txt").read_text(),
    )
    assert len(per_step) == 3
    for vals in per_step:
        vals = [float(v) for v in vals]
        assert all(v > 0 for v in vals)
        assert len(set(vals)) > 1, "module timings identical: not measured"
    # without the flag every line carries the superstep total
    same = re.findall(r"charge \[s\]([\d.eE+-]+)\nZ - calculation time - potential from "
                      r"boundaries \[s\]([\d.eE+-]+)", (tmp_path / "a" / "output1_0.txt").read_text())
    assert same and all(a == b for a, b in same)


def _species(workdir, name):
    elems = [ln.split()[0] for ln in (workdir / name).read_text().splitlines()[2:] if ln.strip()]
    c = {e: elems.count(e) for e in set(elems)}
    return (c.get("V", 0) - c.get("Od", 0), c.get("O", 0) + c.get("V", 0),
            c.get("d", 0) + c.get("Od", 0))


@pytest.mark.parametrize("more", [{}, dict(batched_clock_f32=True, batched_mass_eps=0.1,
                                           batched_k_extrap=1.0)],
                         ids=["defaults", "f32-clocks-eps-0.1-k-extrap"])
def test_batched_events_driver(tmp_path, more):
    """--batched-events B: the production mode runs end to end from a
    generator seeded with the deck's rnd_seed_kmc: events execute, the clock
    advances, species are conserved, the log schema is intact, and the same
    command gives the same run."""
    deck, _ = _write_toy_deck(tmp_path, t_switch=1e3)
    summary = _run(deck, tmp_path / "out", max_supersteps=3, batched_events=8, **more)
    assert summary["total_steps"] == 3
    times = _kmc_times(tmp_path / "out")
    assert len(times) == 3 and all(t > 0 for t in times) and times == sorted(times)
    assert "kmc events" in (tmp_path / "out" / "output1_0.txt").read_text()
    rows = _rows(tmp_path / "out")
    assert all(r["n_events"] >= 1 and r["n_batches"] >= 1 and r["done"] for r in rows)
    assert {"n_cut_conflict", "n_cut_mass", "cg_iterations"} <= set(rows[0])
    folder = "Results_2.000000/"
    assert _species(tmp_path / "out", folder + "snapshot_3.xyz") == _species(
        tmp_path / "out", folder + "snapshot_init.xyz")
    _run(deck, tmp_path / "again", max_supersteps=3, batched_events=8, **more)
    assert _rows(tmp_path / "again") == rows


def test_batched_run_resumes(tmp_path):
    """A batched run goes on from a checkpoint (its generator is reseeded,
    as akmc_tpu's key is): it completes and conserves species."""
    deck, _ = _write_toy_deck(tmp_path, t_switch=1e3)
    _run(deck, tmp_path / "b", max_supersteps=2, batched_events=8, checkpoint_every=2)
    _run(deck, tmp_path / "b", max_supersteps=2, batched_events=8,
         resume_from=str(tmp_path / "b" / "checkpoint.npz"))
    rows = _rows(tmp_path / "b")
    assert [r["step"] for r in rows] == [1, 2, 3, 4]
    times = [r["kmc_time"] for r in rows]
    assert times == sorted(times) and np.isfinite(times).all()
    folder = "Results_2.000000/"
    assert _species(tmp_path / "b", folder + "snapshot_4.xyz") == _species(
        tmp_path / "b", folder + "snapshot_init.xyz")


def test_command_line_flags(tmp_path, capsys):
    deck, _ = _write_toy_deck(tmp_path, t_switch=1e3)
    common = [str(deck), "--device", "cpu", "--max-supersteps", "2"]
    tdriver.main(common + ["--workdir", str(tmp_path / "w"), "--batched-events", "8",
                           "--clock-f32", "--mass-eps", "0.1", "--k-extrap", "1.0",
                           "--checkpoint-every", "1"])
    assert "Total code execution time" in capsys.readouterr().out
    assert (tmp_path / "w" / "checkpoint.npz").exists()
    with np.load(tmp_path / "w" / "checkpoint.npz") as d:
        assert int(d["kmc_step_count"]) == 2 and int(d["vt_counter"]) == 0
        assert (d["element"] == int(ELEM.VACANCY)).sum() > 0
    tdriver.main(common + ["--workdir", str(tmp_path / "w"), "--module-timing",
                           "--resume-from", str(tmp_path / "w" / "checkpoint.npz")])
    assert [r["step"] for r in _rows(tmp_path / "w")] == [1, 2, 3, 4]
    # the scale-out options are ported; together they are refused, as in akmc_tpu
    with pytest.raises(ValueError, match="exclusive"):
        tdriver.main(common + ["--workdir", str(tmp_path / "x"), "--devices", "2",
                               "--concern-split", "1:3"])
