"""The port's plots (``akmc_tpu_torch/postprocessing/plots.py``) and
``matrices.spy_plot`` against akmc_tpu's on the same inputs: the counterparts
of tests/test_postprocessing.py's plot tests, plus ``spy_plot``, the snapshot
reader and the ``main`` command line. Both packages draw with the same
matplotlib, so each PNG must equal akmc_tpu's byte for byte."""

import sys

import numpy as np
import pytest
import scipy.sparse as sp

pytest.importorskip("matplotlib")

from akmc_tpu.postprocessing import matrices as jmatrices  # noqa: E402
from akmc_tpu.postprocessing import plots as jplots  # noqa: E402
from akmc_tpu_torch.lattice import ELEM, write_xyz_snapshot  # noqa: E402
from akmc_tpu_torch.postprocessing import matrices as tmatrices  # noqa: E402
from akmc_tpu_torch.postprocessing import plots as tplots  # noqa: E402
from tests.test_postprocessing import LOG  # noqa: E402

TIMELINE = ["plot_iv", "plot_kmc_timeline", "plot_temperature", "plot_current",
            "plot_conductance", "plot_power", "plot_temperature_current"]


@pytest.fixture()
def logfile(tmp_path):
    p = tmp_path / "output1_0.txt"
    p.write_text(LOG)
    return str(p)


@pytest.fixture()
def snapshot(tmp_path):
    e = np.array(
        [int(ELEM.Ti), int(ELEM.VACANCY), int(ELEM.O), int(ELEM.OXYGEN_DEFECT), int(ELEM.N)],
        np.int32,
    )
    x = np.arange(5.0)
    snap = str(tmp_path / "snapshot_0.xyz")
    write_xyz_snapshot(snap, e, x, x * 0.5, x * 0.25, x * 0.1, x * 0.01)
    return snap


def _same_png(tmp_path, fn_port, fn_ref, *inputs, name="plot"):
    a, b = str(tmp_path / f"{name}_port.png"), str(tmp_path / f"{name}_ref.png")
    assert fn_port(*inputs, a) == a
    assert fn_ref(*inputs, b) == b
    with open(a, "rb") as fa, open(b, "rb") as fb:
        got, want = fa.read(), fb.read()
    assert len(got) > 0 and got == want


@pytest.mark.parametrize("name", TIMELINE)
def test_timeline_plot_equals_akmc_tpu(logfile, tmp_path, name):
    _same_png(tmp_path, getattr(tplots, name), getattr(jplots, name), logfile, name=name)


@pytest.mark.parametrize("name", ["plot_device", "plot_device_top"])
def test_device_view_equals_akmc_tpu(snapshot, tmp_path, name):
    _same_png(tmp_path, getattr(tplots, name), getattr(jplots, name), snapshot, name=name)


def test_bond_current_plot_equals_akmc_tpu(tmp_path):
    e = np.full(4, int(ELEM.Ti), np.int32)
    x = np.arange(4.0)
    snap = str(tmp_path / "snap.xyz")
    write_xyz_snapshot(snap, e, x, x, x, np.zeros(4), np.zeros(4))
    X = -np.abs(np.random.default_rng(0).normal(size=(4, 4))) - 0.1
    xf = str(tmp_path / "X.txt")
    np.savetxt(xf, X)
    _same_png(tmp_path, tplots.plot_bond_current, jplots.plot_bond_current, snap, xf)


def test_snapshot_reader_equals_akmc_tpu(snapshot, tmp_path):
    got, want = tplots._read_snapshot_full(snapshot), jplots._read_snapshot_full(snapshot)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # a bare xyz file (no field columns) reads zeros there
    bare = tmp_path / "bare.xyz"
    bare.write_text("2\n\nTi 0 0 0\nO 1 2 3\n")
    got, want = tplots._read_snapshot_full(str(bare)), jplots._read_snapshot_full(str(bare))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert not got[4].any() and not got[5].any()


def test_spy_plot_equals_akmc_tpu(tmp_path):
    A = sp.random(60, 60, density=0.05, random_state=np.random.default_rng(1), format="coo")
    A = A + A.T + sp.eye(60)
    _same_png(tmp_path, lambda out: tmatrices.spy_plot(A, out),
              lambda out: jmatrices.spy_plot(A, out))


@pytest.mark.parametrize("kind", ["iv", "power", "device_top"])
def test_main_equals_akmc_tpu(logfile, snapshot, tmp_path, monkeypatch, capsys, kind):
    src = snapshot if kind.startswith("device") else logfile
    outs = []
    for pkg, main in (("port", tplots.main), ("ref", jplots.main)):
        out = str(tmp_path / f"{kind}_{pkg}.png")
        monkeypatch.setattr(sys, "argv", ["plots", kind, src, out])
        main()
        assert capsys.readouterr().out.strip() == out
        outs.append(out)
    with open(outs[0], "rb") as a, open(outs[1], "rb") as b:
        assert a.read() == b.read()


def test_main_without_arguments_prints_usage(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["plots"])
    with pytest.raises(SystemExit) as e:
        tplots.main()
    assert e.value.code == 1
    assert "python -m akmc_tpu_torch.postprocessing.plots" in capsys.readouterr().out
