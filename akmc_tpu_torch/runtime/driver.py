"""Simulation driver: bias-point sweep + superstep loop + logging.

Reference: kmc_main.cpp:56-603. The output files follow the reference's
format exactly (the postprocessing scrapers regex-match these strings —
plot_IV.py:26-38, extract_data.py:17-31), byte for byte the same lines as
``akmc_tpu/runtime/driver.py``, plus structured JSONL metrics.

Usage:
    python -m akmc_tpu_torch.runtime.driver <parameters.txt> \
        [--synthesize-crossbar N_YZ] [--pair-f32] [--workdir DIR] [--device cuda|cpu]

Without ``--synthesize-crossbar`` the deck's structure files are read
(``restart_xyz_file``, or the atom and interstitial files), with ``pbc = 1``
decks included; the model then picks the K operator and the pairwise path the
structure supports (models/vcm.py).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np

from akmc_tpu_torch.config import KMCParameters
from akmc_tpu_torch.device import resolve_device
from akmc_tpu_torch.lattice import (
    ELEM,
    build_lattice,
    read_xyz,
    translate_cell,
    write_xyz_snapshot,
)
from akmc_tpu_torch.models.vcm import VCMModel
from akmc_tpu_torch.rng import BufferedStream, ReferenceRNG
from akmc_tpu_torch.state import make_device_state, make_substoichiometric

# options of akmc_tpu's driver that this port does not run yet, with the
# value that leaves them off and the ROADMAP item that ports them
_NOT_PORTED = {
    "batched_events": (0, "the batched event loop"),
    "steps_per_dispatch": (1, "an on-device event/CG loop"),
    "module_timing": (False, "an on-device event/CG loop"),
    "devices": (0, "torch.distributed scale-out"),
    "concern_split": (None, "torch.distributed scale-out"),
    "checkpoint_every": (0, "checkpoints"),
    "resume_from": (None, "checkpoints"),
    "wkb_f32": (False, "full physics"),
    "warmup": (False, "an on-device event/CG loop"),
}


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP queue 1, '{item}'")


class OutputLog:
    """Buffered text log matching the reference's outputBuffer/outputFile
    behavior (kmc_main.cpp:118-121, 520-527)."""

    def __init__(self, path: str):
        self._f = open(path, "w")
        self._buf: list[str] = []

    def write(self, s: str) -> None:
        self._buf.append(s)

    def flush(self) -> None:
        self._f.write("".join(self._buf))
        self._f.flush()
        self._buf.clear()

    def close(self) -> None:
        self.flush()
        self._f.close()


def load_structure(p: KMCParameters, base_dir: str = "."):
    """Read the initial structure (restart or atoms+interstitials files),
    reference: kmc_main.cpp:127-148 + Device ctor."""
    if p.restart:
        files = [p.restart_xyz_file]
    else:
        files = [p.atom_xyz_file, p.interstitial_xyz_file]
    parts = [read_xyz(os.path.join(base_dir, f)) for f in files]
    e, x, y, z = (np.concatenate([part[k] for part in parts]) for k in range(4))
    if p.shift:
        x, y, z = translate_cell(x, y, z, p.lattice, p.shifts)
    return e, x, y, z


def run(
    param_file: str,
    workdir: str = ".",
    max_supersteps: Optional[int] = None,
    log: bool = True,
    committed_parity: bool = True,
    synthesize_crossbar: Optional[int] = None,
    rate_normalize: Optional[bool] = None,
    dia_stacked: bool = False,
    dia_pallas: bool = False,
    pair_f32: bool = False,
    device=None,
    **not_ported,
) -> dict:
    """Run the full bias sweep on ``device`` (default: the CUDA card).
    Returns summary metrics.

    ``dia_stacked`` / ``dia_pallas`` are accepted for command-line parity
    with akmc_tpu and select nothing: the port has one f64 DIA matvec (the
    CUDA kernel on the card, its plain twin on the CPU). ``pair_f32``: the
    tiled pairwise plane in f32 (large structures only). The other options
    of akmc_tpu's ``run`` raise NotImplementedError unless left off."""
    del dia_stacked, dia_pallas
    device = resolve_device(device)
    for name, value in not_ported.items():
        if name not in _NOT_PORTED:
            raise TypeError(f"run() got an unexpected keyword argument {name!r}")
        off, item = _NOT_PORTED[name]
        if value != off:
            raise _not_ported(f"--{name.replace('_', '-')}", item)

    p = KMCParameters.from_file(param_file)
    base_dir = os.path.dirname(os.path.abspath(param_file))
    full_physics = p.solve_current and not committed_parity
    if full_physics:
        raise _not_ported("--full-physics", "full physics")
    if not p.perturb_structure:
        raise _not_ported("a fields-only deck (perturb_structure = 0)", "an on-device event/CG loop")
    if not p.solve_potential:
        raise _not_ported("an events-only deck (solve_potential = 0)", "an on-device event/CG loop")

    os.makedirs(workdir, exist_ok=True)
    out = OutputLog(os.path.join(workdir, "output1_0.txt"))
    metrics = open(os.path.join(workdir, "metrics.jsonl"), "w")
    try:
        if synthesize_crossbar:
            from akmc_tpu_torch.models.crossbar import synthesize_deck_structure

            p, element, x, y, z = synthesize_deck_structure(p, synthesize_crossbar)
            out.write(
                f"Synthesized crossbar structure: {len(element)} slots "
                f"(n_yz={synthesize_crossbar}; deck structure files are stripped "
                "from the reference snapshot)\n"
            )
        else:
            element, x, y, z = load_structure(p, base_dir)
            if p.restart:
                out.write(f"Restarting from {p.restart_xyz_file}\n")

        if p.pristine:
            element = make_substoichiometric(
                element, p.initial_vacancy_concentration, ReferenceRNG(p.rnd_seed)
            )

        lat = build_lattice(element, x, y, z, p)
        if synthesize_crossbar:
            from akmc_tpu_torch.models.crossbar import mask_null_slots

            mask_null_slots(lat)

        if rate_normalize is None:
            # shifted-exponent rates at high bias, as akmc_tpu's driver selects
            rate_normalize = bool(p.V_switch) and max(abs(v) for v in p.V_switch) >= 8.0
        model = VCMModel(p, lat, device=device, rate_normalize=rate_normalize,
                         pair_f32=pair_f32)
        state = make_device_state(lat, p.background_temp, model.device)
        kmc_stream = BufferedStream(ReferenceRNG(p.rnd_seed_kmc))

        # snapshots carry physical sites only (no NULL placeholder slots)
        snap_sel = np.asarray(lat.element0) != int(ELEM.NULL_ELEMENT)
        if snap_sel.all():
            snap_sel = slice(None)

        snapshot_s = 0.0     # host time in the snapshots, device-to-host copies included

        def snapshot(path):
            nonlocal snapshot_s
            t_snap = time.perf_counter()
            write_xyz_snapshot(
                path,
                state.element.cpu().numpy()[snap_sel], lat.x[snap_sel],
                lat.y[snap_sel], lat.z[snap_sel],
                state.potential_charge.cpu().numpy()[snap_sel],
                state.power.cpu().numpy()[snap_sel],
            )
            snapshot_s += time.perf_counter() - t_snap

        total_steps = 0
        supersteps_s = 0.0
        t_code_start = time.perf_counter()
        visited_biases = set()

        for vt_counter, Vd in enumerate(p.V_switch):
            t_bias = p.t_switch[vt_counter]
            out.write("--------------------------------\n")
            out.write(f"Applied Voltage = {_g(Vd)} V\n")
            out.write("--------------------------------\n")

            folder = os.path.join(workdir, f"Results_{Vd:.6f}")
            # hysteresis sweeps revisit bias values: suffix repeat visits
            # with the bias-point index
            if Vd in visited_biases:
                folder = os.path.join(workdir, f"Results_{Vd:.6f}_{vt_counter}")
            visited_biases.add(Vd)
            os.makedirs(folder, exist_ok=True)
            out.write(f"Created folder: {os.path.basename(folder)}\n")
            snapshot(os.path.join(folder, "snapshot_init.xyz"))

            kmc_time = 0.0
            kmc_step_count = 0
            state = state.replace(kmc_time=state.kmc_time * 0.0)

            while kmc_time < t_bias:
                t0 = time.perf_counter()
                state, stats = model.superstep(state, Vd, kmc_stream)
                dt = time.perf_counter() - t0
                supersteps_s += dt

                kmc_time += stats["event_time"]
                # one fused superstep: each module's timing line carries
                # the superstep total
                out.write(f"Z - calculation time - charge [s]{_g(dt)}\n")
                out.write(f"Z - calculation time - potential from boundaries [s]{_g(dt)}\n")
                out.write(f"Z - calculation time - potential from charges [s]{_g(dt)}\n")
                out.write(f"Z - calculation time - kmc events [s]{_g(dt)}\n")
                out.write(f"KMC time is: {_g(kmc_time)}\n")

                if kmc_step_count % p.output_freq == 0:
                    out.flush()
                kmc_step_count += 1
                total_steps += 1

                out.write(f"Z - calculation time - KMC superstep [s]: {_g(dt)}\n")
                out.write("--------------------------------------\n")
                metrics.write(json.dumps({
                    "bias": Vd, "step": kmc_step_count, "kmc_time": kmc_time,
                    "superstep_s": dt, **stats,
                }) + "\n")
                if log:
                    print(
                        f"[Vd={Vd}] step {kmc_step_count}: kmc_time={kmc_time:.5e} "
                        f"events={stats['n_events']} cg={stats['cg_iterations']} "
                        f"wall={dt:.3f}s"
                    )
                if max_supersteps and total_steps >= max_supersteps:
                    break

            snapshot(os.path.join(folder, f"snapshot_{kmc_step_count}.xyz"))
            if max_supersteps and total_steps >= max_supersteps:
                break
        total_time = time.perf_counter() - t_code_start
    finally:
        out.close()
        metrics.close()
    return {
        "total_steps": total_steps,
        "total_time_s": total_time,
        # where the loop's time went: the supersteps, the xyz snapshots, and
        # (the rest) the text log, the metrics file and the folders
        "supersteps_s": supersteps_s,
        "snapshot_s": snapshot_s,
        "final_kmc_time": float(state.kmc_time),
        "model": model.describe(),
    }


def _g(v: float) -> str:
    """C++ default ostream double formatting (6 significant digits)."""
    return f"{float(v):.6g}"


def main(argv=None):
    ap = argparse.ArgumentParser(description="akmc_tpu_torch KMC driver (runKMC equivalent)")
    ap.add_argument("parameters", help="path to parameters.txt")
    ap.add_argument("--workdir", default=".")
    ap.add_argument("--max-supersteps", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda; 'cpu' runs "
                         "the plain PyTorch path)")
    ap.add_argument(
        "--synthesize-crossbar", type=int, default=None, metavar="N_YZ",
        help="synthesize a grid-native crossbar structure for this deck "
             "instead of reading its xyz files; N_YZ sets the y/z cross-section",
    )
    ap.add_argument("--dia-pallas", action="store_true",
                    help="accepted for parity with akmc_tpu; selects nothing "
                         "(one f64 DIA matvec: the CUDA kernel)")
    ap.add_argument("--dia-stacked", action="store_true",
                    help="accepted for parity with akmc_tpu; selects nothing")
    ap.add_argument("--pair-f32", action="store_true",
                    help="evaluate the tiled-pairwise plane in f32 (large "
                         "structures; the f64 plane is the default)")
    ap.add_argument("--full-physics", action="store_true", help="not ported yet")
    # akmc_tpu options this port does not run yet: accepted, and refused
    # with the ROADMAP item that ports them
    ap.add_argument("--batched-events", type=int, default=0, help="not ported yet")
    ap.add_argument("--steps-per-dispatch", type=int, default=1, help="not ported yet")
    ap.add_argument("--module-timing", action="store_true", help="not ported yet")
    ap.add_argument("--devices", type=int, default=0, help="not ported yet")
    ap.add_argument("--concern-split", default=None, help="not ported yet")
    ap.add_argument("--checkpoint-every", type=int, default=0, help="not ported yet")
    ap.add_argument("--resume-from", default=None, help="not ported yet")
    ap.add_argument("--wkb-f32", action="store_true", help="not ported yet")
    ap.add_argument("--warmup", action="store_true", help="not ported yet")
    args = ap.parse_args(argv)
    summary = run(
        args.parameters,
        workdir=args.workdir,
        max_supersteps=args.max_supersteps,
        committed_parity=not args.full_physics,
        synthesize_crossbar=args.synthesize_crossbar,
        dia_stacked=args.dia_stacked,
        dia_pallas=args.dia_pallas,
        pair_f32=args.pair_f32,
        device=args.device,
        **{name: getattr(args, name) for name in _NOT_PORTED},
    )
    print(f"Total code execution time: {summary['total_time_s']:.6g} s")


if __name__ == "__main__":
    main()
