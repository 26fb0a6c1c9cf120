"""CPU tests of the benchmark (``python -m pytest portbench/tests``). Tests
that need the card carry the ``cuda`` marker and take the ``cuda_device``
fixture, which decides at run time whether a card is there."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the port on the card")
    return torch.device("cuda:0")


# tiny sizes of each cell for CPU runs: the same builders, entries and checks
TINY = {
    "crossbar40.batched": {"builder_args": {"n_yz": 8},
                           "workload": {"check": {"steps": 2, "among_first": 3, "pair_sites": 512}}},
    "synth5nm.iv_full": {"traffic": {"V_switch": [1.0, 8.0, 1.0], "t_switch": [1e-12] * 3},
                         "workload": {"check": {"steps": 1, "among_first": 1, "pair_sites": 512}}},
    "synth5nm.iv_potential": {"workload": {"check": {"steps": 4, "among_first": 10,
                                                     "pair_sites": 512}}},
}

# the upstream 5 nm device's physics as decks/iv_sweep_5nm.txt states it
DECK_PHYSICS = {
    "nn_dist": 3.5, "cutoff_radius": 20.0, "sigma": 3.5e-10, "epsilon": 23.0, "freq": 1e14,
    "G_coeff": 1.0, "background_temp": 300.0, "metals": ["Ti", "N"], "pbc": 0,
    "layers": [[0.0, 0.0, 0.0, 0.76, -22.0, 0.0], [3.93, 0.0, 1.09, 0.76, 0.0, 3.0],
               [3.93, 0.0, 1.09, 0.76, 3.0, 48.1431], [1.66, 0.0, 1.09, 0.76, 48.1431, 52.6431],
               [1.73, 0.0, 0.0, 2.8, 52.6431, 90.0]],
    "m_r": 0.85, "V0": 1.6, "num_layers_contact": 10,
}
STAIRCASE = [1, 2, 3, 4, 5, 6, 7, 8, 7, 6, 5, 4, 3, 2, 1]
LIMITS = {"k_res": 3.0, "pair_err": 1e-10, "elem_mm": 0, "charge_mm": 0, "events_mm": 0,
          "time_err": 1e-9}
FULL_LIMITS = {"cb_res": 1e7, "power_res": 3.0, "imacro_err": 1e-9, "power_err": 1e-9}


def make_tree(dest: str) -> str:
    """A copy of the benchmark (``BENCHMARK.json`` and ``portbench/``) under
    ``dest`` with a configuration added as files alone: ``synth5nm``, a deck
    of the upstream's format with its own structure file (the 5 nm deck
    over a small disordered stand-in), read by ``builders/deck.py``; its two
    mixes (the staircase on the committed-parity superstep and under full
    physics) and their cells. Returns ``dest``."""
    from akmc_tpu_torch.runtime.synth_deck import write_synth_deck

    pb = os.path.join(dest, "portbench")
    shutil.copytree(os.path.join(ROOT, "portbench"), pb,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), os.path.join(dest, "BENCHMARK.json"))
    deck = write_synth_deck(os.path.join(ROOT, "decks", "iv_sweep_5nm.txt"),
                            os.path.join(pb, "configs", "synth5nm"), n_yz=8)
    config = {"source": "decks/iv_sweep_5nm.txt over a small disordered stand-in",
              "reduced": [], "builder": "deck",
              "deck": os.path.relpath(deck, os.path.join(pb, "configs")),
              "model": {"rate_normalize": True, "pair_f32": False},
              "precision": {"k": "float64", "pair": "float64", "events": "float64",
                            "current": "float64"},
              "physics": DECK_PHYSICS}
    files = {
        ("configs", "synth5nm"): config,
        ("traffic", "iv_potential"): {"entry": "staircase", "mode": "superstep",
                                      "V_switch": STAIRCASE, "t_switch": [1e-12] * 15},
        ("traffic", "iv_full"): {"entry": "staircase", "mode": "full",
                                 "V_switch": STAIRCASE, "t_switch": [1e-12] * 15},
        ("workloads", "synth5nm.iv_potential"): {
            "check": {"steps": 48, "among_first": 600, "pair_sites": 32768},
            "profile_steps": 60, "limits": LIMITS},
        ("workloads", "synth5nm.iv_full"): {
            "check": {"steps": 6, "among_first": 60, "pair_sites": 32768},
            "profile_steps": 8, "limits": {**LIMITS, **FULL_LIMITS}},
    }
    for (kind, name), data in files.items():
        with open(os.path.join(pb, kind, f"{name}.json"), "w") as f:
            json.dump(data, f)
    with open(os.path.join(dest, "BENCHMARK.json")) as f:
        m = json.load(f)
    m["configs"].append({"name": "synth5nm", "source": config["source"],
                         "file": "portbench/configs/synth5nm.json", "reduced": [],
                         "why": "test stand-in"})
    for mix in ("iv_potential", "iv_full"):
        m["workloads"].append({"name": f"synth5nm.{mix}", "config": "synth5nm",
                               "traffic": mix, "chips": 1, "why": "test cell"})
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)
    return dest


@pytest.fixture(scope="session")
def deck_tree(tmp_path_factory):
    return make_tree(str(tmp_path_factory.mktemp("deck_tree")))


@pytest.fixture
def tree_of(monkeypatch, deck_tree):
    """Points the harness at the tree that holds a cell."""
    from pathlib import Path

    from portbench import harness

    def use(cell):
        if cell.startswith("synth5nm."):
            monkeypatch.setattr(harness, "HERE", Path(deck_tree) / "portbench")
            monkeypatch.setattr(harness, "ROOT", Path(deck_tree))
    return use


def pytest_configure(config):
    import torch

    torch.set_num_threads(2)
