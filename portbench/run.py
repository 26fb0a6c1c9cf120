"""Run one cell of the port's benchmark on one CUDA card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the card (name, count, power limit) on standard error, then, as its
last lines there, each number that decided ``correct`` beside its limit;
the last line of standard output is the result: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and ``checks`` last. Without a CUDA card it exits 2 and
prints no result; if the process holds ``jax``, ``jaxlib``, ``flax`` or
``akmc_tpu`` once the window has closed, it exits 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "akmc_tpu")


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is forbidden,
    compared whole (``akmc_tpu_torch`` is not ``akmc_tpu``)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache of the program at a fixed place inside the checkout
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "portbench",
                                                               "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "portbench", "triton"))
    sys.path.insert(0, ROOT)
    import torch

    from portbench import harness, runner

    chips = int(harness.cell_entry(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s): this benchmark measures the port on the card and "
              "does not fall back to the CPU", file=sys.stderr)
        return 2
    print(f"device: {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
          f"nvidia-smi name,power.limit: {power_limit()}", file=sys.stderr, flush=True)

    out = runner.execute(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0",
                         t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    info = out.pop("_info")
    print(f"info: {json.dumps(info)}", file=sys.stderr)
    checks = out.pop("checks")
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    out["checks"] = checks
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
