"""The benchmark's harness: configurations, traffic, the measured window.

Everything that belongs to one configuration, one traffic mix, one cell or
one metric is a file of its own, found by name:

* ``configs/<config>.json``: the deployment (source, cuts, the builder that
  makes the structure and its arguments, the model's options, the physics
  the reference needs);
* ``builders/<builder>.py``: ``build(config, device, model_opts, params)``,
  the structure and the program's model of a configuration;
* ``traffic/<traffic>.json``: the mix (its ``entry`` and parameters);
* ``entries/<entry>.py``: ``steps`` (one pass of the mix, step by step),
  ``warm_kwargs``, ``first_bias``, and what the check needs of the entry:
  ``replay`` (the step's events in the reference) and, where the entry
  has more layers to judge, ``judge_extra`` and ``control_extra``;
* ``workloads/<cell>.json``: what the cell checks (samples, limits) and
  how much of its traced run the profiler sees;
* ``metrics/<metric>.py``: a reader of one metric.

A run builds the configuration (the same structure in every run: a seed
drawn from it changed the work more than two runs of one seed differ) and
every pass's random stream from ``--seed``, warms the cell's shapes with one
whole pass, then drives passes in a closed loop for ``--seconds``. Each pass starts
again from the seeded initial state on its own stream, drawn from
(seed, pass), so the work is stationary: a faster program completes more
passes, not a later stretch of one trajectory. The steps a cell's check
samples (drawn from the seed before the window) keep their input and output
tensors for the reference, which runs after the window has closed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import importlib.util
import json
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` under the benchmark's folder."""
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark's folder, imported from its
    file: a builder, an entry or a metric's reader."""
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}",
                                                  HERE / kind / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell_entry(name: str) -> dict:
    for w in manifest()["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def mix(seed: int, *tags, bits: int = 32) -> int:
    """A seed of ``bits`` bits for one use of the run's seed (``tags`` name
    the use: the structure, a pass's stream, the check's sample)."""
    h = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << bits) - 1)


@dataclasses.dataclass
class Setup:
    """What a configuration's builder returns: the program's model and
    initial state, and the raw structure that the reference starts from."""

    model: object
    state0: object
    structure: dict            # pos (N,3) f64, element0 (N,) int32, L, excluded (N,) bool
    physics: dict              # the configuration's physics, for the reference
    parts: dict                # host seconds of the set-up's parts


@dataclasses.dataclass
class Step:
    """One dispatch of the window: what it took and what it gave."""

    index: int
    pass_index: int
    seconds: float
    stats: dict
    Vd: float
    stream: dict               # where the step's draws start: seed and offset or step in pass
    pre: Optional[object] = None
    post: Optional[object] = None


# ----------------------------------------------------------------------
# helpers of the builders
# ----------------------------------------------------------------------
def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(parts: dict, name: str, dev, fn):
    """``fn()``, its host seconds (synchronised) kept as ``parts[name]``."""
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    parts[name] = time.perf_counter() - t0
    return out


def check_physics(p, physics: dict) -> None:
    """The program's parameters are the configuration file's."""
    want = {
        "nn_dist": p.nn_dist, "cutoff_radius": p.cutoff_radius, "sigma": p.sigma,
        "epsilon": p.epsilon, "freq": p.freq, "G_coeff": p.G_coeff,
        "background_temp": p.background_temp, "metals": list(p.metals), "pbc": int(bool(p.pbc)),
        "layers": [[l.E_gen_0, l.E_rec_1, l.E_diff_2, l.E_diff_3, l.start_x, l.end_x]
                   for l in p.layers],
        "m_r": p.m_r, "V0": p.V0, "num_layers_contact": p.num_layers_contact,
    }
    for key, value in want.items():
        if key not in physics:
            continue
        stated = physics[key]
        same = (np.allclose(np.asarray(stated, float), np.asarray(value, float), rtol=1e-12, atol=0)
                if key not in ("metals",) else stated == value)
        if not same:
            raise ValueError(f"configuration states {key} = {stated}, the program runs {value}")


# ----------------------------------------------------------------------
# a run
# ----------------------------------------------------------------------
@dataclasses.dataclass
class Window:
    steps: List[Step]
    seconds: float
    samples: List[Step]
    passes: int
    last_post: object = None
    last_Vd: float = 0.0


class Recorder:
    """The traced run's instruments: CUDA events around each dispatch, host
    synchronisations counted over the window (``count_syncs``), and the
    profiler over its first ``profile_steps`` steps."""

    def __init__(self, dev, profile_steps: int):
        from portbench import timing

        self.dev, self.profile_steps = dev, profile_steps
        self.events = []
        self.prof = None
        self.prof_s = None
        self._timing = timing
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        self.syncs = self._stack.enter_context(self._timing.count_syncs(self.dev))
        if self.profile_steps:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                             if self.dev.type == "cuda" else [])
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            self._prof_t0 = time.perf_counter()
        return self

    def around(self, i: int, fn):
        if self.dev.type == "cuda":
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            out = fn()
            b.record()
            self.events.append((a, b))
        else:
            out = fn()
        if self.prof is not None and i + 1 == self.profile_steps:
            self.stop_profiler()
        return out

    def stop_profiler(self):
        if self.prof is not None and self.prof_s is None:
            sync(self.dev)
            self.prof_s = time.perf_counter() - self._prof_t0
            self.prof.__exit__(None, None, None)

    def __exit__(self, *exc):
        self.stop_profiler()
        self._stack.close()
        return False


def run_window(setup: Setup, traffic: dict, seed: int, seconds: float, sample_at: set,
               recorder: Optional[Recorder] = None) -> Window:
    """Passes in a closed loop until ``seconds`` have gone by; the steps
    whose index is in ``sample_at`` keep their states."""
    entry = module("entries", traffic["entry"])
    dev = setup.model.device
    steps: List[Step] = []
    samples: List[Step] = []
    last = (None, 0.0)
    sync(dev)
    t0 = time.perf_counter()
    pass_index = 0
    done = False
    while not done:
        gen = entry.steps(setup, traffic, seed, pass_index)
        while True:
            ts = time.perf_counter()
            i = len(steps)
            try:
                if recorder is None:
                    pre, post, stats, Vd, where = next(gen)
                else:
                    pre, post, stats, Vd, where = recorder.around(i, lambda: next(gen))
            except StopIteration:
                break
            te = time.perf_counter()
            step = Step(i, pass_index, te - ts, stats, Vd, where)
            steps.append(step)
            last = (post, Vd)
            if i in sample_at:
                step.pre, step.post = pre, post
                samples.append(step)
            if te - t0 >= seconds:
                done = True
                break
        pass_index += 1
    sync(dev)
    return Window(steps, time.perf_counter() - t0, samples, pass_index, *last)


def sample_indices(seed: int, check: dict) -> set:
    """The window's step indices whose results the check compares: drawn
    from the seed among the first ``among_first`` steps."""
    rng = np.random.default_rng(mix(seed, "check"))
    n = int(check["among_first"])
    k = min(int(check["steps"]), n)
    return set(int(i) for i in rng.choice(n, size=k, replace=False))


def prepare(cell: str, seed: int, device, overrides: Optional[dict] = None):
    """(cell entry, config, traffic, workload, Setup): set-up up to the
    warm pass. ``overrides`` (tests) replaces keys of the config's
    ``builder_args`` / top level and of the traffic."""
    overrides = overrides or {}
    entry = cell_entry(cell)
    config = load("configs", entry["config"])
    traffic = load("traffic", entry["traffic"])
    work = load("workloads", cell)
    config = {**config, **overrides.get("config", {})}
    if "builder_args" in overrides:
        config["builder_args"] = {**config["builder_args"], **overrides["builder_args"]}
    traffic = {**traffic, **overrides.get("traffic", {})}
    work = {**work, **overrides.get("workload", {})}
    t0 = time.perf_counter()
    builder = module("builders", config["builder"])
    setup = builder.build(config, device, config["model"], traffic.get("params", {}))
    dev = setup.model.device
    entry_mod = module("entries", traffic["entry"])
    warm = timed(setup.parts, "warmup_s", dev,
                 lambda: setup.model.warmup(setup.state0, entry_mod.first_bias(traffic),
                                            **entry_mod.warm_kwargs(traffic)))
    setup.parts["warmup_parts"] = warm

    def warm_pass():
        for _ in entry_mod.steps(setup, traffic, seed, "warm"):
            pass
    timed(setup.parts, "warm_pass_s", dev, warm_pass)
    setup.parts["setup_s"] = time.perf_counter() - t0
    return entry, config, traffic, work, setup
