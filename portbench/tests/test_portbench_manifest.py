"""The manifest, and every cell, configuration, mix and metric by file."""

import json
import re

import pytest

from portbench import harness, runner

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_loads_with_the_contract_keys():
    m = harness.manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert m["command"] == ["python3", "portbench/run.py"] and m["paths"] == ["portbench"]
    assert 1 <= m["run_seconds"] <= 51
    assert any(x["name"] == "setup_s" for x in m["end_to_end"])
    for x in m["end_to_end"]:
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in m[k]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for x in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
    assert len(json.dumps(m)) < 64 * 1024


def test_every_cell_resolves_by_file_name():
    m = harness.manifest()
    configs = {c["name"]: c for c in m["configs"]}
    for w in m["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        cfg = harness.load("configs", w["config"])
        assert configs[w["config"]]["file"] == f"portbench/configs/{w['config']}.json"
        assert configs[w["config"]]["source"] == cfg["source"]
        assert configs[w["config"]]["reduced"] == cfg["reduced"]
        assert callable(harness.module("builders", cfg["builder"]).build)
        traffic = harness.load("traffic", w["traffic"])
        entry = harness.module("entries", traffic["entry"])
        assert all(callable(getattr(entry, f)) for f in ("steps", "warm_kwargs", "first_bias",
                                                         "replay"))
        work = harness.load("workloads", w["name"])
        assert {"check", "limits", "profile_steps"} <= set(work)
        reported = runner.metrics_for(w["name"], False)
        assert "setup_s" in {x["name"] for x in reported} and len(reported) >= 2
        assert runner.metrics_for(w["name"], True)


@pytest.mark.parametrize("metric", [x["name"] for k in ("end_to_end", "per_layer")
                                    for x in harness.manifest()[k]])
def test_every_metric_has_a_reader(metric):
    assert callable(runner.metric_module(metric).read)
