"""Simulation driver: bias-point sweep + superstep loop + logging.

Reference: kmc_main.cpp:56-603. The output files follow the reference's
format exactly (the postprocessing scrapers regex-match these strings —
plot_IV.py:26-38, extract_data.py:17-31), byte for byte the same lines as
``akmc_tpu/runtime/driver.py``, plus structured JSONL metrics.

Usage:
    python -m akmc_tpu_torch.runtime.driver <parameters.txt> \
        [--synthesize-crossbar N_YZ] [--pair-f32] [--workdir DIR] [--device cuda|cpu] \
        [--full-physics [--wkb-f32] [--power-rtol-scale auto|S]] \
        [--batched-events B [--clock-f32] [--mass-eps E] [--k-extrap C]] \
        [--module-timing] [--checkpoint-every N] [--resume-from checkpoint.npz] \
        [--steps-per-dispatch K] [--warmup] [--cache-dir DIR] \
        [--devices N | --concern-split K:P]

Without ``--synthesize-crossbar`` the deck's structure files are read
(``restart_xyz_file``, or the atom and interstitial files), with ``pbc = 1``
decks included; the model then picks the K operator and the pairwise path the
structure supports (models/vcm.py).

Scale-out (the reference is born distributed, ``mpirun runKMC``).
``--devices N`` runs the deck on N ranks, one process each
(``parallel/launch.py``): on CUDA one card per rank over NCCL, which needs N
visible cards; with ``--device cpu`` N gloo ranks. The tables row-shard and
the fields replicate (``parallel/mesh.py``); every other option runs as on one
device. ``--concern-split K:P`` runs the K solve and the pairwise solve on two
disjoint groups of ranks (``parallel/mesh.py::ConcernGroups``), over the
visible cards (on the CPU, K + P ranks). Rank 0 alone writes the log, the
metrics, the snapshots and the checkpoints; ``run_on_mesh`` is what each rank
runs.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from akmc_tpu_torch.config import KMCParameters
from akmc_tpu_torch.device import resolve_device
from akmc_tpu_torch.lattice import (
    ELEM,
    SnapshotWriter,
    build_lattice,
    read_xyz,
    translate_cell,
)
from akmc_tpu_torch.models.vcm import VCMModel
from akmc_tpu_torch.ops.events import GeneratorDraws
from akmc_tpu_torch.parallel.mesh import check_replicas
from akmc_tpu_torch.rng import BufferedStream, ReferenceRNG
from akmc_tpu_torch.runtime.checkpoint import load_checkpoint, save_checkpoint
from akmc_tpu_torch.state import make_device_state, make_substoichiometric

class _NullLog:
    """The log of a rank other than 0: it writes nothing."""

    def write(self, s: str) -> None:
        pass

    flush = close = lambda self: None


class OutputLog:
    """Buffered text log matching the reference's outputBuffer/outputFile
    behavior (kmc_main.cpp:118-121, 520-527)."""

    def __init__(self, path: str, append: bool = False):
        self._f = open(path, "a" if append else "w")
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
    cache_dir: Optional[str] = None,
    log: bool = True,
    committed_parity: bool = True,
    checkpoint_every: int = 0,
    resume_from: Optional[str] = None,
    steps_per_dispatch: int = 1,
    module_timing: bool = False,
    synthesize_crossbar: Optional[int] = None,
    rate_normalize: Optional[bool] = None,
    batched_events: int = 0,
    batched_mass_eps: float = 1e-3,
    batched_clock_f32: bool = False,
    batched_k_extrap: float = 0.0,
    dia_stacked: bool = False,
    dia_pallas: bool = False,
    pair_f32: bool = False,
    wkb_f32: bool = False,
    power_rtol_scale="auto",
    warmup: bool = False,
    device=None,
    devices: int = 0,
    concern_split=None,
    rank_timeout: Optional[float] = None,
) -> dict:
    """Run the full bias sweep on ``device`` (default: the CUDA card).
    Returns summary metrics.

    ``dia_stacked`` / ``dia_pallas`` are accepted for command-line parity
    with akmc_tpu and select nothing: the port has one f64 DIA matvec (the
    CUDA kernel on the card, its plain twin on the CPU). ``pair_f32``: the
    tiled pairwise plane in f32 (large structures only).

    ``batched_events`` B > 0 runs the production event path
    (``superstep_native_batched``: B-candidate exponential-race batches from
    a device generator seeded with the deck's ``rnd_seed_kmc``; not
    reference-stream parity), with ``batched_mass_eps`` the killed-mass
    staleness bound, ``batched_clock_f32`` f32 race clocks and
    ``batched_k_extrap`` the K-solve warm-start extrapolation coefficient.
    ``module_timing`` runs each physics module apart so that the per-module
    timing lines carry measured values. ``checkpoint_every`` N saves
    ``checkpoint.npz`` in the workdir every N supersteps; ``resume_from``
    continues such a file (appending to the workdir's logs), bit-identically
    for the serial loop; the batched generator is not in a checkpoint and is
    seeded from ``rnd_seed_kmc`` again, and the bias points skipped count as
    visited (akmc_tpu forgets them, and a resumed hysteresis sweep then writes
    a second visit into the first visit's folder).

    ``steps_per_dispatch`` k > 1 runs the serial and the full-physics
    supersteps k at a time (``superstep_multi``, ``superstep_full_multi``):
    the bias loop reads the clock between batches only, so a batch may pass
    ``t_switch`` by up to k - 1 supersteps, and checkpoints land on batch
    boundaries, as akmc_tpu does. ``warmup`` builds the kernels and the lazy
    tables before superstep 0 (``VCMModel.warmup``) and logs an ``AOT
    warmup:`` line. ``cache_dir`` keeps the neighbor lists in
    ``lists_<hash>.npz`` files that akmc_tpu reads and writes too
    (``lattice.build_lattice``). Decks with ``perturb_structure = 0`` run the
    fields only, two passes per bias point; decks with ``solve_potential =
    0`` run the events on the state's stale potential.

    ``devices`` N > 1 runs the sweep on N ranks and ``concern_split`` (K, P)
    on two rank groups (the module docstring): on CUDA over ``nccl``, one
    card per rank (N visible cards needed; ``concern_split`` takes them
    all), on the CPU over ``gloo`` (``concern_split``: K + P ranks).
    ``rank_timeout`` bounds the whole run in seconds (None: no bound; a
    collective still fails after ``parallel/launch.py``'s own limit). The
    summary is rank 0's, with every rank's under ``"ranks"``."""
    options = dict(
        workdir=workdir, max_supersteps=max_supersteps, cache_dir=cache_dir, log=log,
        committed_parity=committed_parity, checkpoint_every=checkpoint_every,
        resume_from=resume_from, steps_per_dispatch=steps_per_dispatch,
        module_timing=module_timing, synthesize_crossbar=synthesize_crossbar,
        rate_normalize=rate_normalize, batched_events=batched_events,
        batched_mass_eps=batched_mass_eps, batched_clock_f32=batched_clock_f32,
        batched_k_extrap=batched_k_extrap, pair_f32=pair_f32, wkb_f32=wkb_f32,
        power_rtol_scale=power_rtol_scale, warmup=warmup,
    )
    del dia_stacked, dia_pallas
    if devices and devices > 1 and concern_split is not None:
        raise ValueError("--devices and --concern-split are exclusive")
    if not (devices and devices > 1) and concern_split is None:
        return run_on_mesh(None, param_file, device=resolve_device(device), **options)

    from akmc_tpu_torch.parallel.launch import spawn

    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if concern_split is None:
        ranks = devices
    elif dev.type == "cuda":
        ranks = torch.cuda.device_count()
    else:
        ranks = sum(concern_split)
    if dev.type == "cuda":
        # build every kernel once, here, before the ranks start: ranks must not
        # race nvcc on one build directory
        from akmc_tpu_torch.ops import cuda_build, dia_matvec
        from akmc_tpu_torch.solvers import dia_cg

        cuda_build.build([dia_matvec._KERNEL, dia_cg._KERNEL])
    outs = spawn(run_on_mesh, ranks, str(dev), backend, param_file,
                 dict(options, concern_split=concern_split), timeout=rank_timeout)
    return {**outs[0], "ranks": outs}


def run_on_mesh(mesh, param_file: str, options: Optional[dict] = None, **kw) -> dict:
    """The sweep of ``run`` on one rank of ``mesh`` (None: one device, the
    ``device`` option). ``options`` (or keywords): ``run``'s, with
    ``concern_split`` and without the other scale-out ones. The rank's
    summary carries its kernel launches and K solves."""
    return _run(mesh, param_file, **{**(options or {}), **kw})


def _run(
    mesh,
    param_file: str,
    workdir: str = ".",
    max_supersteps: Optional[int] = None,
    cache_dir: Optional[str] = None,
    log: bool = True,
    committed_parity: bool = True,
    checkpoint_every: int = 0,
    resume_from: Optional[str] = None,
    steps_per_dispatch: int = 1,
    module_timing: bool = False,
    synthesize_crossbar: Optional[int] = None,
    rate_normalize: Optional[bool] = None,
    batched_events: int = 0,
    batched_mass_eps: float = 1e-3,
    batched_clock_f32: bool = False,
    batched_k_extrap: float = 0.0,
    pair_f32: bool = False,
    wkb_f32: bool = False,
    power_rtol_scale="auto",
    warmup: bool = False,
    device=None,
    concern_split=None,
) -> dict:
    from akmc_tpu_torch.ops.dia_matvec import dia_combined_matvec

    if mesh is not None:
        device = mesh.device
    root = mesh is None or mesh.rank == 0
    sharded = mesh is not None and concern_split is None
    p = KMCParameters.from_file(param_file)
    base_dir = os.path.dirname(os.path.abspath(param_file))
    full_physics = p.solve_current and not committed_parity

    if root:
        os.makedirs(workdir, exist_ok=True)
        out = OutputLog(os.path.join(workdir, "output1_0.txt"), append=bool(resume_from))
        metrics = open(os.path.join(workdir, "metrics.jsonl"), "a" if resume_from else "w")
    else:
        out, metrics, log = _NullLog(), _NullLog(), False
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

        t_lat = time.perf_counter()
        if mesh is not None and cache_dir and not root:
            mesh.barrier()                  # rank 0 writes the list file, the others read it
        lat = build_lattice(element, x, y, z, p, cache_dir=cache_dir, device=device)
        if mesh is not None and cache_dir and root:
            mesh.barrier()
        lattice_s = time.perf_counter() - t_lat
        if synthesize_crossbar:
            from akmc_tpu_torch.models.crossbar import mask_null_slots

            mask_null_slots(lat)

        # --devices N: the site axis padded with inert sites to a multiple of
        # the ranks, as akmc_tpu pads it
        n_real = lat.N
        if sharded and lat.N % mesh.size:
            from akmc_tpu_torch.parallel.mesh import pad_lattice

            lat, n_real = pad_lattice(lat, mesh.size)
            out.write(
                f"Mesh padding: {lat.N - n_real} inert site(s) appended "
                f"(site axis {lat.N} over {mesh.size} devices)\n"
            )
        if rate_normalize is None:
            # shifted-exponent rates at high bias, as akmc_tpu's driver selects
            rate_normalize = bool(p.V_switch) and max(abs(v) for v in p.V_switch) >= 8.0
        # the event table keeps its one-device padding (akmc_tpu pads it to
        # 256 x devices for even shards; uneven rank ranges gather as well here,
        # and the batched loop then draws what it draws on one device)
        model = VCMModel(p, lat, device=device, rate_normalize=rate_normalize,
                         pair_f32=pair_f32, wkb_f32=wkb_f32)
        state = make_device_state(lat, p.background_temp, model.device)
        if sharded:
            from akmc_tpu_torch.parallel.mesh import replicate_state, shard_model

            shard_model(model, mesh)
            state = replicate_state(state, mesh)
            out.write(
                f"Device mesh: {mesh.size} device(s) over the `sites` axis "
                f"(N={lat.N}, row-sharded tables, replicated fields"
                + ("; ranks share one card over gloo, collectives staged through host "
                   "buffers" if mesh.staged else "") + ")\n"
            )
        kmc_stream = BufferedStream(ReferenceRNG(p.rnd_seed_kmc))
        batch_draws = (GeneratorDraws.seeded(p.rnd_seed_kmc, model.device)
                       if batched_events else None)
        batched_pb_prev2 = None   # the previous superstep's K solution (extrapolated warm start)
        m_warm = None             # the power solve's warm start across supersteps
        # power-CG tolerance policy: I_macro is an extraction-rail
        # cancellation, so a sub-nA superstep tightens the next solve 100x
        # ("auto"); a float fixes the multiplier
        rtol_auto = power_rtol_scale == "auto"
        rtol_fixed = 1.0 if rtol_auto else float(power_rtol_scale)
        last_I_macro = None

        if warmup and p.V_switch and p.perturb_structure and p.solve_potential:
            t_warm = time.perf_counter()
            warm_s = model.warmup(state, float(p.V_switch[0]), full_physics=full_physics,
                                  batched=batched_events, clock_f32=batched_clock_f32)
            out.write(
                f"AOT warmup: {time.perf_counter() - t_warm:.1f} s ("
                + ", ".join(f"{k} {v:.0f}s" for k, v in warm_s.items())
                + ")\n"
            )

        groups = None
        if concern_split is not None:
            # the K solve and the pairwise solve on disjoint rank groups
            # (reference split=true, KMC_comm.h:132-223, default ratio {8,24})
            from akmc_tpu_torch.parallel.mesh import ConcernGroups, replicate_state

            if mesh is None:
                raise ValueError("concern-group splitting needs >= 2 devices")
            state = replicate_state(state, mesh)
            groups = ConcernGroups(model, mesh, ratio=tuple(concern_split))
            out.write(
                f"Concern groups: {groups.mesh_k.size} K-solve device(s) + "
                f"{groups.mesh_pair.size} pairwise device(s)\n"
            )

        # snapshots carry physical sites only (no NULL placeholder slots, no
        # mesh-padding sites)
        snap_sel = np.asarray(lat.element0) != int(ELEM.NULL_ELEMENT)
        snap_sel[n_real:] = False
        if snap_sel.all():
            snap_sel = slice(None)
        writer = SnapshotWriter(lat.x[snap_sel], lat.y[snap_sel], lat.z[snap_sel])

        snapshot_s = 0.0     # host time in the snapshots, device-to-host copies included

        def snapshot(path):
            nonlocal snapshot_s
            if not root:
                return
            t_snap = time.perf_counter()
            writer.write(
                path,
                state.element.cpu().numpy()[snap_sel],
                state.potential_charge.cpu().numpy()[snap_sel],
                state.power.cpu().numpy()[snap_sel],
            )
            snapshot_s += time.perf_counter() - t_snap

        resume_vt = 0
        resume_steps = 0
        if resume_from:
            state, kmc_stream, resume_vt, resume_steps, _ = load_checkpoint(
                resume_from, model.device)
            if state.element.shape[0] != lat.N:
                raise ValueError(f"{resume_from} holds {state.element.shape[0]} sites, the run "
                                 f"{lat.N}")
            out.write(f"Resumed from checkpoint {resume_from}\n")

        total_steps = 0
        replica_checks = 0   # supersteps after which every rank's state was rank 0's
        supersteps_s = 0.0
        t_code_start = time.perf_counter()
        visited_biases = set()

        for vt_counter, Vd in enumerate(p.V_switch):
            if vt_counter < resume_vt:
                visited_biases.add(Vd)      # keeps a later visit's folder name
                continue
            t_bias = p.t_switch[vt_counter]
            out.write("--------------------------------\n")
            out.write(f"Applied Voltage = {_g(Vd)} V\n")
            out.write("--------------------------------\n")

            if full_physics:
                state = model.update_cb_edge(state, Vd)

            folder = os.path.join(workdir, f"Results_{Vd:.6f}")
            # hysteresis sweeps revisit bias values: suffix repeat visits
            # with the bias-point index
            if Vd in visited_biases:
                folder = os.path.join(workdir, f"Results_{Vd:.6f}_{vt_counter}")
            visited_biases.add(Vd)
            if root:
                os.makedirs(folder, exist_ok=True)
            out.write(f"Created folder: {os.path.basename(folder)}\n")
            snapshot(os.path.join(folder, "snapshot_init.xyz"))

            if vt_counter == resume_vt and resume_steps:
                kmc_time = float(state.kmc_time)
                kmc_step_count = resume_steps
            else:
                kmc_time = 0.0
                kmc_step_count = 0
                state = state.replace(kmc_time=state.kmc_time * 0.0)

            while kmc_time < t_bias:
                t0 = time.perf_counter()
                if not p.perturb_structure:
                    # fields only ("turn off to only calculate fields",
                    # kmc_main.cpp:506-511): no events; once kmc_step_count > 0
                    # the clock jumps to t_switch, so two passes are logged
                    if p.solve_potential:
                        state, stats = model.fields_only(state, Vd)
                    else:
                        stats = {"cg_iterations": 0}
                    stats_list = [{**stats, "n_events": 0, "event_time": 0.0}]
                    if kmc_step_count > 0:
                        kmc_time = t_bias
                elif full_physics:
                    # charge -> potentials -> power -> events -> heat
                    # (kmc_main.cpp:334-508; the power sees THIS superstep's charge)
                    rscale = rtol_fixed
                    if rtol_auto and last_I_macro is not None and abs(last_I_macro) < 1e-9:
                        rscale = 1e-2
                    if steps_per_dispatch > 1:
                        state, stats_list, m_warm = model.superstep_full_multi(
                            state, Vd, kmc_stream, k=steps_per_dispatch, m_prev=m_warm,
                            rtol_scale=rscale)
                    else:
                        state, stats, m_warm = model.superstep_full(
                            state, Vd, kmc_stream, m_prev=m_warm, rtol_scale=rscale)
                        stats_list = [stats]
                    last_I_macro = stats_list[-1]["I_macro"]
                    for stats in stats_list:
                        stats["power_rtol_scale"] = rscale
                elif not p.solve_potential:
                    # events on the stale potential (kmc_main.cpp gates every
                    # field module on solve_potential, the event step only on
                    # perturb_structure)
                    state, stats = model.superstep_events_only(state, kmc_stream)
                    stats_list = [stats]
                elif module_timing:
                    state, stats = model.superstep_timed(state, Vd, kmc_stream)
                    stats_list = [stats]
                elif batched_events:
                    # production throughput mode: the multi-event batched
                    # loop on its own generator (not reference-stream parity;
                    # waiting-time staleness bounded by batched_mass_eps per batch)
                    pb_before = state.potential_boundary
                    state, stats = model.superstep_native_batched(
                        state, Vd, batch_draws, batch=batched_events,
                        mass_eps=batched_mass_eps, clock_f32=batched_clock_f32,
                        pb_prev2=batched_pb_prev2, k_extrap=batched_k_extrap,
                    )
                    batched_pb_prev2 = pb_before
                    stats_list = [stats]
                elif steps_per_dispatch > 1:
                    state, stats_list = model.superstep_multi(state, Vd, kmc_stream,
                                                              k=steps_per_dispatch)
                elif groups is not None:
                    state, stats = groups.superstep(state, Vd, kmc_stream)
                    stats_list = [stats]
                else:
                    state, stats = model.superstep(state, Vd, kmc_stream)
                    stats_list = [stats]
                if mesh is not None:
                    # the event loop ran on every rank: their states must agree
                    check_replicas(state, mesh)
                    replica_checks += 1
                batch_s = time.perf_counter() - t0
                supersteps_s += batch_s
                dt = batch_s / len(stats_list)

                for stats in stats_list:
                    # the clock is tracked on the host; state.kmc_time stays
                    # authoritative for checkpoints
                    kmc_time += stats["event_time"]
                    # per-module timing lines, each gated on its module as the
                    # reference gates it: measured per module under
                    # module_timing, else each line carries the superstep total
                    if p.solve_potential:
                        out.write("Z - calculation time - charge [s]"
                                  f"{_g(stats.get('t_charge', dt))}\n")
                        out.write("Z - calculation time - potential from boundaries [s]"
                                  f"{_g(stats.get('t_boundary', dt))}\n")
                        out.write("Z - calculation time - potential from charges [s]"
                                  f"{_g(stats.get('t_pairwise', dt))}\n")
                    if p.perturb_structure:
                        out.write("Z - calculation time - kmc events [s]"
                                  f"{_g(stats.get('t_events', dt))}\n")
                    I_macro = stats.get("I_macro")
                    if I_macro is not None:
                        # scraper schema (postprocessing/plot_IV.py:33,
                        # plot_conductance.py:34, plot_power.py:37; strings from
                        # current_solver.cpp:277-278, 375)
                        out.write(f"Current [uA]: {_g(I_macro * 1e6)}\n")
                        out.write(f"Conductance [uS]: {_g(abs(I_macro / Vd) * 1e6)}\n")
                        if p.solve_heating_global or p.solve_heating_local:
                            out.write(f"Total dissipated power [mW]: {_g(stats['P_tot'] * 1e3)}\n")
                    if full_physics and p.solve_heating_global:
                        out.write(f"Global temperature [K]: {stats['T_bg']:.16f}\n")
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
                # checkpoints land on batch boundaries (state and stream agree there)
                if checkpoint_every and kmc_step_count % checkpoint_every < len(stats_list):
                    save_checkpoint(
                        os.path.join(workdir, "checkpoint.npz"), state, kmc_stream,
                        vt_counter=vt_counter, kmc_step_count=kmc_step_count,
                        extra={"Vd": Vd}, mesh=mesh,
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
        # host time of the neighbor lists (read from the cache, or built)
        "lattice_s": lattice_s,
        "final_kmc_time": float(state.kmc_time),
        "model": model.describe(),
        # K-system solves of the run and their CG iterations (every DIA
        # kernel launch belongs to one of them); under a mesh, this rank's
        "k_solves": model.k_solves,
        "k_iterations": model.k_iterations,
        "rank": 0 if mesh is None else mesh.rank,
        "dia_matvec_launches": dia_combined_matvec.launches,
        "replica_checks": replica_checks,
        "held_bytes": model.held_bytes(),
    }


def _g(v: float) -> str:
    """C++ default ostream double formatting (6 significant digits)."""
    return f"{float(v):.6g}"


def main(argv=None):
    ap = argparse.ArgumentParser(description="akmc_tpu_torch KMC driver (runKMC equivalent)")
    ap.add_argument("parameters", help="path to parameters.txt")
    ap.add_argument("--workdir", default=".")
    ap.add_argument("--max-supersteps", type=int, default=None)
    ap.add_argument("--cache-dir", default=".cache",
                    help="directory of the neighbor-list cache (lists_<hash>.npz, the "
                         "files akmc_tpu writes and reads); akmc_tpu also keeps its JAX "
                         "compile cache there, which has no counterpart here")
    ap.add_argument("--steps-per-dispatch", type=int, default=1, metavar="K",
                    help="run the serial and the full-physics supersteps K at a time "
                         "on one rand cursor (the bias loop may overshoot t_switch by "
                         "up to K-1 supersteps; checkpoints land on batch boundaries)")
    ap.add_argument("--warmup", action="store_true",
                    help="build the CUDA kernels, load each once, and build the lazy "
                         "tables the run uses before the first superstep")
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
    ap.add_argument("--batched-events", type=int, default=0, metavar="B",
                    help="production throughput mode: the multi-event batched "
                         "residence-time loop with B-candidate exponential-race "
                         "batches (device generator seeded with rnd_seed_kmc; "
                         "not reference-stream parity)")
    ap.add_argument("--clock-f32", action="store_true",
                    help="batched loop: draw and transform the per-row race "
                         "clocks in f32 (exact in law up to ~1e-6 relative gap "
                         "rounding, far below --mass-eps)")
    ap.add_argument("--mass-eps", type=float, default=1e-3,
                    help="batched loop's killed-mass staleness bound: relative "
                         "waiting-time distortion per batch (looser = more "
                         "events per batch)")
    ap.add_argument("--k-extrap", type=float, default=0.0, metavar="C",
                    help="batched loop: K-solve warm start x0 = pb + C*(pb - "
                         "pb_prev); the converged tolerance is unchanged; 0 = "
                         "plain warm start")
    ap.add_argument("--module-timing", action="store_true",
                    help="run each physics module apart so that the per-module "
                         "'Z - calculation time' lines carry measured values "
                         "(slower: one device synchronisation per module)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="save a full checkpoint (checkpoint.npz in the "
                         "workdir) every N supersteps, counted per bias point")
    ap.add_argument("--resume-from", default=None,
                    help="resume from a checkpoint.npz: bit-identical for the "
                         "serial event loop. A checkpoint does not hold the "
                         "--batched-events generator, which starts again from "
                         "rnd_seed_kmc, so a resumed batched run replays the "
                         "uniforms the run began with. Bias points skipped on "
                         "resume count as visited, so a repeated bias value "
                         "keeps its Results_<V>_<index> folder")
    ap.add_argument("--full-physics", action="store_true",
                    help="run the current/power/heating branch on decks with "
                         "solve_current = 1: CB edge per bias point, the current "
                         "and dissipated power each superstep, the deck's heat model")
    ap.add_argument("--wkb-f32", action="store_true",
                    help="full physics: evaluate the WKB transmission planes "
                         "(W_tt/W_ct/W_cc) in f32 (Kahan-compensated integral; f64 "
                         "is the default)")
    ap.add_argument("--power-rtol-scale", default="auto", metavar="S",
                    help="full physics: the power CG's tolerance multiplier, 'auto' "
                         "(default: 100x tighter after a sub-nA superstep) or a float")
    ap.add_argument(
        "--devices", type=int, default=0, metavar="N",
        help="run the deck on N ranks, one process each (row-sharded tables, "
             "replicated fields, dots over gathered partial sums: the reference's "
             "`mpirun runKMC` row decomposition). On CUDA one card per rank over "
             "NCCL (N visible cards needed); with --device cpu N gloo ranks. Pads the "
             "site axis with inert sites when N_sites %% N != 0.",
    )
    ap.add_argument(
        "--concern-split", default=None, metavar="K:P",
        help="run the K and the pairwise solves on disjoint rank groups in ratio K:P "
             "(reference split=true, KMC_comm.h:132-223; their default 8:24) over the "
             "visible cards (with --device cpu: K + P gloo ranks). Needs >= 2 ranks; "
             "the plain superstep path only; exclusive with --devices.",
    )
    args = ap.parse_args(argv)
    concern_split = None
    if args.concern_split:
        a, b = args.concern_split.split(":")
        concern_split = (int(a), int(b))
    summary = run(
        args.parameters,
        workdir=args.workdir,
        max_supersteps=args.max_supersteps,
        cache_dir=args.cache_dir,
        committed_parity=not args.full_physics,
        checkpoint_every=args.checkpoint_every,
        resume_from=args.resume_from,
        steps_per_dispatch=args.steps_per_dispatch,
        module_timing=args.module_timing,
        synthesize_crossbar=args.synthesize_crossbar,
        batched_events=args.batched_events,
        batched_mass_eps=args.mass_eps,
        batched_clock_f32=args.clock_f32,
        batched_k_extrap=args.k_extrap,
        dia_stacked=args.dia_stacked,
        dia_pallas=args.dia_pallas,
        pair_f32=args.pair_f32,
        wkb_f32=args.wkb_f32,
        power_rtol_scale=args.power_rtol_scale,
        warmup=args.warmup,
        device=args.device,
        devices=args.devices,
        concern_split=concern_split,
    )
    print(f"Total code execution time: {summary['total_time_s']:.6g} s")


if __name__ == "__main__":
    main()
