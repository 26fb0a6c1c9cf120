"""Whole runs on the CPU at tiny sizes: each cell comes out correct; with
the timed path broken underneath, or with the control in the program's
place, it comes out not correct; the import check; a configuration, a mix,
a cell and a metric added as files alone. Besides the manifest's cells, the
5 nm deck's staircase cells run from a tree that adds them as files
(``conftest.make_tree``), so that the deck builder and the staircase entry
stay proven for the cells that wait on the device's own structure file."""

import ast
import hashlib
import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import ROOT, TINY, make_tree
from portbench import check, control, harness, runner

CELLS = sorted(TINY)
STEP = {"batched_supersteps": "superstep_native_batched", "superstep": "superstep",
        "full": "superstep_full"}


def _step_name(cell):
    traffic = harness.load("traffic", harness.cell_entry(cell)["traffic"])
    return STEP[traffic.get("mode", traffic["entry"])]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_cpu(tree_of, cell):
    tree_of(cell)
    out = runner.execute(cell, 2**31 + 5, 0.5, False, "cpu", overrides=TINY[cell])
    assert out["correct"], out["checks"]
    assert "step_ms" in out["metrics"] and "setup_s" in out["metrics"]
    assert list(out["checks"])[-1] == "steps_checked"


def _broken(monkeypatch, cell, fault):
    from akmc_tpu_torch.models.vcm import VCMModel

    name = _step_name(cell)
    real = getattr(VCMModel, name)

    def step(self, state, *args, **kw):
        new, stats, *more = real(self, state, *args, **kw)
        if fault == "unchanged":
            return (state, stats, *more)
        # an answer altered where it is produced: one site's element
        element = new.element.clone()
        element[int(torch.nonzero(element == 3)[0])] = 2
        return (new.replace(element=element), stats, *more)

    monkeypatch.setattr(VCMModel, name, step)


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, tree_of, cell, fault):
    tree_of(cell)
    _broken(monkeypatch, cell, fault)
    out = runner.execute(cell, 2**31 + 5, 0.5, False, "cpu", overrides=TINY[cell])
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(tree_of, cell):
    tree_of(cell)
    got = control.readings(cell, 7, 0.5, "cpu", TINY[cell])
    limits = harness.load("workloads", cell)["limits"]
    prog_ok, _ = check.verdict(got["program"], limits, got["steps_checked"])
    ctrl_ok, _ = check.verdict(got["control"], limits, got["steps_checked"])
    assert prog_ok and not ctrl_ok, got


def test_forbidden_modules_are_compared_by_whole_top_level_name(monkeypatch):
    sys.path.insert(0, os.path.join(ROOT, "portbench"))
    import run

    monkeypatch.setitem(sys.modules, "akmc_tpu_torch_probe.x", sys)
    assert run.forbidden_modules() == [m for m in run.forbidden_modules()
                                       if m.split(".")[0] in run.FORBIDDEN]
    assert "akmc_tpu_torch_probe.x" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "akmc_tpu.probe", sys)
    assert "akmc_tpu.probe" in run.forbidden_modules()


def test_nothing_the_benchmark_runs_imports_jax_or_akmc_tpu():
    bad = ("jax", "jaxlib", "flax", "akmc_tpu")
    for dirpath, _, files in os.walk(os.path.join(ROOT, "portbench")):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            tree = ast.parse(open(path).read())
            for node in ast.walk(tree):
                names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                         else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                for name in names:
                    assert name.split(".")[0] not in bad, (path, name)
                    if os.path.basename(dirpath) == "reference":
                        assert name.split(".")[0] != "akmc_tpu_torch", (path, name)
    # and a whole run leaves none loaded
    code = ("import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
            "from portbench import runner; import run\n"
            "runner.execute('crossbar40.batched', 3, 0.2, False, 'cpu', overrides=%r)\n"
            "print(run.forbidden_modules())") % (ROOT, os.path.join(ROOT, "portbench"),
                                                 TINY["crossbar40.batched"])
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_a_run_exits_nonzero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", "crossbar40.batched",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert res.returncode != 0 and res.stdout == ""


def _digests(top):
    out = {}
    for dirpath, dirs, files in os.walk(top):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            path = os.path.join(dirpath, f)
            out[os.path.relpath(path, top)] = hashlib.sha256(open(path, "rb").read()).hexdigest()
    return out


def test_a_configuration_a_cell_a_mix_and_a_metric_are_added_as_files_alone(tmp_path):
    # a configuration (a deck with its structure file), two mixes and their
    # cells (make_tree), then one more mix, cell and metric
    make_tree(str(tmp_path))
    pb = tmp_path / "portbench"
    traffic = json.loads((pb / "traffic" / "iv_potential.json").read_text())
    traffic["V_switch"], traffic["t_switch"] = traffic["V_switch"][:8], traffic["t_switch"][:8]
    (pb / "traffic" / "iv_up.json").write_text(json.dumps(traffic))
    (pb / "workloads" / "synth5nm.iv_up.json").write_text(
        (pb / "workloads" / "synth5nm.iv_potential.json").read_text())
    (pb / "metrics" / "events_per_step.py").write_text(
        "def read(ctx):\n"
        "    return sum(s.stats['n_events'] for s in ctx.window.steps) / len(ctx.window.steps)\n")
    m = json.loads((tmp_path / "BENCHMARK.json").read_text())
    m["workloads"].append({"name": "synth5nm.iv_up", "config": "synth5nm", "traffic": "iv_up",
                           "chips": 1, "why": "the up branch"})
    m["per_layer"].append({"name": "events_per_step", "unit": "events/step", "better": "higher",
                           "source": "program_counter", "layer": "events: ops/events.py",
                           "moves": "step_ms", "workloads": ["synth5nm.iv_up"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    # every file the benchmark had is as it was: only files were added
    before, after = _digests(os.path.join(ROOT, "portbench")), _digests(str(pb))
    assert all(after[path] == digest for path, digest in before.items())
    code = ("import sys, json; sys.path.insert(0, %r); sys.path.insert(1, %r)\n"
            "from portbench import runner\n"
            "out = runner.execute('synth5nm.iv_up', 3, 0.2, True, 'cpu', overrides=%r)\n"
            "print(json.dumps({'correct': out['correct'], 'metrics': out['metrics'],\n"
            "                  'count': out['device']['count']}))"
            ) % (str(tmp_path), ROOT, TINY["synth5nm.iv_potential"])
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["metrics"]["events_per_step"]["value"] >= 1.0
    assert out["count"] == 1
