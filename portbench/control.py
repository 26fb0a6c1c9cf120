"""The control of a cell's check: the reference put in the program's place
in the nearest precision below the one the configuration states (f32 for
f64; bf16 for the f32 pair plane), judged by the same numbers as the
program. Run on the card at the cell's own size; the benchmark's own runs
never run it.

    python3 portbench/control.py --workload <cell> --seeds 11 12 13 [--seconds 5]

For each seed it sets up the cell, drives a short window of the cell's own
traffic to get the program's sampled steps (the control follows the same
steps from the same states), frees the program, and prints one JSON line:
the program's numbers and the control's, side by side.
"""

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOWER = {"float64": "float32", "float32": "bfloat16"}


def readings(cell: str, seed: int, seconds: float, device, overrides=None) -> dict:
    import torch

    from portbench import check, harness

    entry, config, traffic, work, setup = harness.prepare(cell, seed, device, overrides)
    setup.physics = {**setup.physics, "rate_normalize": bool(config["model"]["rate_normalize"])}
    dev = setup.model.device
    window = harness.run_window(setup, traffic, seed, seconds,
                                harness.sample_indices(seed, work["check"]))
    window.last_post = None
    setup.model = setup.state0 = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    entry_mod = harness.module("entries", traffic["entry"])
    ref = check.Reference(setup.structure, setup.physics, dev)
    sites = check.pair_sites(ref, harness.mix(seed, "sites"), int(work["check"]["pair_sites"]))
    dtypes = {k: getattr(torch, LOWER[v]) for k, v in config["precision"].items()}
    prog, ctrl = [], []
    t0 = time.perf_counter()
    for s in window.samples:
        prog.append(check.judge(ref, entry_mod, traffic, s, sites,
                                check.program_outputs(s, sites)))
        ctrl.append(check.judge(ref, entry_mod, traffic, s, sites,
                                check.control_outputs(ref, entry_mod, traffic, s, sites,
                                                      dtypes)))
    return {"cell": cell, "seed": seed, "steps_checked": len(window.samples),
            "program": check.worst(prog), "control": check.worst(ctrl),
            "control_dtypes": {k: str(v) for k, v in dtypes.items()},
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.seconds, "cuda:0")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
