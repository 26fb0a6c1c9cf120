"""Smoke run of akmc_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero before the last
line is printed):

1. build   the hand-written kernels from their sources in
           ``akmc_tpu_torch/csrc`` (one ``nvcc`` per source, started together,
           for sm_90a; loaded with ctypes);
2. kernels each kernel's wrapper on tensors on the card at the main path's
           shapes, held against its plain PyTorch twin on the same inputs.
           ``dia_combined_matvec``: the n_yz=24 crossbar's operator
           (N = 58,752, D = 32) plus three random offset sets, bit-equal (and
           within 1e-12 of the largest entry), then timed beside the twin,
           beside one PyTorch sparse product computing the same function (a
           yardstick only) and beside an empty kernel on the same grid, with
           the host side of a call split into its parts.
           ``dia_cg_solve`` (the whole K-solve CG in one cooperative launch):
           the crossbar's K system from a cold start at two of the deck's
           biases, a warm start, a solve cut off by ``max_iterations``, and
           two random symmetric systems (a small one with far offsets; one
           with D = 36 > 32 and N = 300,000, which takes the kernel's
           streaming case with several chunks per block): iteration count equal and
           ``x``, ``r``, ``residual_sq`` bit-equal to ``dia_cg_solve_plain``;
           then timed per solve and per iteration (CUDA events; one solve on
           the host clock beside it) beside the host-loop CG (``jacobi_cg``
           over the kernel matvec, one host read per iteration), beside the
           same number of grid syncs with no work between them (the sync
           floor) and beside the streaming bound of an iteration
           (``cg_bound``), with the share of it reached;
3. sweep   the port's main path through its driver: the whole 15-point I-V
           sweep of ``decks/iv_sweep_5nm.txt`` on a synthesized grid-native
           crossbar at n_yz=24 (58,752 slots), with every launch counter set
           to 0 just before and read just after. Each K solve must have
           launched the fused CG once and the matvec once (the
           conductive-vacancy degrees), the iterations the fused kernel
           counted on the device must sum to the ``cg_iterations`` of
           ``metrics.jsonl``, every superstep must be finite, and events,
           superstep count and final elements must equal the committed golden
           of ``akmc_tpu`` on the same command; KMC times within
           GOLDEN_KMC_RTOL.
4. disordered  the superstep on a structure with no DIA form, at the 5 nm
           device's size: ``synthetic_stack(n_yz=24)`` (N = 31,088) written as
           an xyz file with a copy of the deck that points at it
           (``runtime/synth_deck.py``), run through the driver. The model must
           have taken the banded K operator and the static pair table, and no
           DIA kernel may have been launched. Events, superstep count and
           final elements must equal the committed golden of ``akmc_tpu`` on
           the same files; KMC times within SYNTH_KMC_RTOL, and within
           SYNTH_KMC_RTOL_SAME_STOP where the K-CG stopped at the golden's
           iteration. Beside it, on the
           sweep's first state at 1 V, one cold K solve through each of the
           banded and the ELL operator, open and with ``pbc = 1``: potentials
           within BANDED_ELL_RTOL/ATOL of each other, iteration counts and
           times printed, with both dot products (``torch.dot`` and
           multiply + sum), and the whole sweep once more with the other dot.
           The driver builds this structure file's lists on the card
           (``lattice_device.py``); beside the sweep, that builder against
           the k-d tree on ``synthetic_stack`` at n_yz = 24 (neighbor list,
           periodic K adjacency, cutoff list) and at n_yz = 96 (497,648
           sites: the first two), equal entry for entry, both timed.
5. tiled   the pairwise paths at a size that needs them: three supersteps of
           the deck on a synthesized crossbar at n_yz=32 (104,448 slots, pair
           table past its 8e9-byte budget). The model must have taken the tiled
           path and the DIA operator, both kernels must have been launched,
           every superstep finite. On the first superstep's charges the tiled
           potential is held against the on-the-fly plane (f64: rtol 1e-12;
           f32 plane: rtol 2e-5 off the cutoff shell), and both are timed.

6. batched the production event path, in three parts.
           replay: on one frozen fields state of the n_yz=24 crossbar at 8 V
           and at 15 V (shifted-exponent rates), ``run_event_loop_batched``
           (B = 64; B = 16 with f32 clocks) on the card and on the CPU from
           the same seeded numpy uniforms: elements, charges, event, batch and
           cut counts and the rate table's zero pattern equal, ``event_time``
           within rtol 1e-12 (f32 clocks: 1e-6).
           law: on the toy device's frozen table, 512 replicates of the
           batched loop (B = 16, ``mass_eps`` 1e-3) against 512 of
           ``run_event_loop_native`` on the card with the device generator:
           two-sample KS on waiting time and on event count below the
           alpha = 1e-3 critical value 0.1218.
           crossbar: ``build_grid_crossbar(n_yz=64, 10/22/8 slices)``, 409,600
           slots, at 15 V with shifted-exponent rates; DIA operator and tiled
           pairwise asserted. First both kernels once more against their
           twins, on this crossbar's own operator and first K system (cold
           start, the fused CG's streaming kernel: rows not in registers):
           bit-equal, equal iteration count, timed, with the bounds from this
           shape (the matvec beside the sparse product assembled on the card,
           the fused CG per iteration beside its sync floor and streaming
           bound); the ``kernels`` line carries these readings per kernel
           under ``crossbar_path``. One serial superstep (cold CG), six
           ``superstep_native_batched`` (B = 64, ``mass_eps`` 1e-3), six more
           with the f32 plane, f32 clocks, ``mass_eps`` 0.1 and ``k_extrap`` 1,
           one module-timed superstep. Every superstep fires an event and ends
           done, species sums are conserved, ``kmc_time`` is finite and
           grows, each kernel's launches equal the K solves the model
           counted and the iterations the fused kernel counted on the device
           equal theirs, and the event loops, kept on the card (k steps per
           CUDA-graph replay), read the device once per replay: at most
           ceil(batches / k) + 1 times in a batched superstep, no more than
           their replays in a serial one (the fields' own reads are told
           apart by their source file); each superstep's replays and dead
           steps go into its row. At n_yz=64, after those, on the last
           state's fields (``loop_turns``): the serial loop (on 4,096 draws of
           the mt19937 stream), the native loop and the batched loop, each as
           its plain host loop and as its device loop in turns plain, device,
           device, plain, every run bit-equal to the first (integer state,
           rate table, waiting time, draws, every counter), timed on the host
           clock and by CUDA events, with its capture time, replays, dead
           steps and host reads; then one batched superstep with each loop
           (``superstep_turns``: the same result, timed in turns, and one of
           each under ``torch.profiler`` for the device's idle share). Then
           one serial superstep from the initial state with
           ``event_select_incremental`` on and one with it off, from the same
           stream: bit-equal in events, waiting time, CG iterations, draws
           used and every tensor of the new state.
           Then the driver on the n_yz=24 sweep: a serial run
           stopped by ``max_supersteps`` and resumed from its checkpoint must
           give the uninterrupted sweep's metrics rows and final snapshot; the
           same with ``batched_events=64`` must complete and conserve species.
           The crossbar part then runs once more at n_yz=104 (1,081,600
           slots) with three supersteps of each batched kind, under the same
           checks. ``--crossbar-n-yz N[,N]`` picks other widths (the first at
           full depth).

7. full    the full physics (``--full-physics``: CB edge, WKB tunnel blocks,
           power CG, heat models). The whole n_yz=24 sweep through the driver,
           held to ``akmc_tpu_torch/golden/iv_sweep_5nm_n24_full.json``
           (``tools/full_physics_golden.py``): events, superstep count and final
           elements exactly, KMC times within GOLDEN_KMC_RTOL, each superstep's
           P_tot within FULL_POWER_RTOL and I_macro within FULL_CURRENT_ATOL,
           one 'Current [uA]' line per superstep, DIA launches equal to the
           model's K solves. Then three supersteps with ``--wkb-f32`` (the f64
           run's events; P_tot within akmc_tpu's f32-against-f64 spread,
           I_macro within FULL_CURRENT_ATOL); one power solve at 8 V and
           rtol_scale 1, 1e-2, 1e-4 on the sweep's first state and on the
           disordered stand-in's (whose CB edge is finite, so that its W blocks
           tunnel); three full-physics supersteps of the stand-in through the
           driver; four supersteps each with ``solve_heating_global = 1`` and
           ``solve_heating_local = 1`` (deck copies from
           ``runtime/synth_deck.py::write_heating_deck``): events and elements
           exact, T_bg and each site's temperature within ``heat_close``. The
           bounds are akmc_tpu's own band-against-gather spread or, where the
           card read more, the reading rounded up (their constants say which).
           Per superstep: the CB-edge solves, the WKB build in ms and its
           energy-loop bounds, the power solve in ms and per iteration, host
           reads, peak memory.

8. driver  the deck modes and options of the driver, on the sizes above
           (``runtime/synth_deck.py`` writes the deck copies), against
           ``akmc_tpu_torch/golden/iv_sweep_5nm_n24_modes.json``. Fields only
           (``perturb_structure = 0``): the whole sweep, 30 passes, pass count,
           events (none) and elements exact, each pass's CG count and every
           potential of the final snapshot within akmc_tpu's own spread
           between its two matvecs, each bias point's sum of |potential|
           within FIELDS_POT_SUM_RTOL, DIA launches equal to the K solves.
           Events only (``solve_potential = 0``): at most the sweep's 24
           supersteps, events, superstep count and elements exact, KMC times
           within EVENTS_KMC_RTOL, no K solve and no launch.
           ``--steps-per-dispatch 4``: the sweep (every bias point runs whole
           batches, so it passes ``t_switch`` by up to three supersteps; the
           rows before the first such overshoot are the sweep phase's), and,
           on a copy of the deck whose ``t_switch`` lets ``max_supersteps``
           end the run, 24 serial and 4 full-physics supersteps equal to
           single supersteps row for row (``superstep_s`` aside). On the
           stand-in, ``superstep_multi`` 3 x 4 from one state with the
           carried-residual K solve and without: events, CG counts, elements
           and ``kmc_time`` equal. ``--warmup`` on three full-physics
           supersteps: output equal to the run without it (timing aside),
           the first superstep's time with and without it and the warmup's
           items printed. ``--cache-dir`` on the stand-in twice: the second
           run reads the list file (building the lists would raise) and gives the
           first run's rows and final snapshot; both list times printed.
           ``runtime/profiling.py::trace`` around one superstep writes a
           non-empty trace; ``device_memory_stats`` goes into the line. Every
           path that solves on the DIA operator launches each kernel once per
           K solve the model counted, with the iterations counted on the
           device equal to the model's.

9. sharded  scale-out over torch.distributed, with 2 and 4 ranks sharing this
           card over gloo (NCCL refuses two ranks on one card; the gloo
           collectives are staged through host buffers): correctness and
           launches, not speed. The row-window matvec against its twin (its
           own slab, x and xv whole) at the first, a middle and the last
           rank's 256-row-chunk window of N = 58,752 split 2 and 4 ways and of
           409,600 split 4 ways, bit-equal, then timed beside the twin and a
           sparse product on the window's rows. Through the driver's per-rank
           function (``runtime/driver.py::run_on_mesh``): the sweep phase's
           24 supersteps on 2 and 4 ranks, every metrics row and the final
           elements equal to one rank's, the golden within GOLDEN_KMC_RTOL,
           each rank's row-window launches equal to its K-CG iterations plus
           one per solve, every rank's state equal to rank 0's after every
           superstep, per-rank bytes of the pair table and the DIA codes about
           1/ranks; concern groups 1:1 and 1:3 (fields and three supersteps
           equal to one rank's to the bit); on 4 ranks, three batched
           supersteps at 409,600 slots (integer state and counts equal to one
           rank's, peak memory per rank), four full-physics supersteps
           (against one rank: events, elements and power-CG counts exact, KMC
           times within SHARDED_KMC_RTOL, P_tot within SHARDED_P_TOT_RTOL,
           I_macro within SHARDED_I_MACRO_ATOL, T_bg within 1e-12; against
           the golden's first four supersteps: the full phase's bounds; W
           bytes per rank about a quarter of one rank's), three supersteps of
           the disordered stand-in (against one rank: events, elements and CG
           counts exact, KMC times within SHARDED_SYNTH_KMC_RTOL; against its
           golden: the disordered phase's bounds) and the CG harness (K-class at n = 100,000, T-class at the
           reference's 102,722 / 14,854: rel L2 error below 1e-8, iterations
           within 2 of one rank's).

10. flagship the 40 nm crossbar of ``tools/bench_crossbar.py 215``:
           ``build_grid_crossbar(n_yz=215, 10/22/8 slices, defect 0.1,
           vacancies 0.05, seed 0)``, 4,622,500 slots, at 15 V with
           ``VCMModel(rate_normalize, pair_f32, event_select_incremental)``,
           the configuration ``BENCH_crossbar_r05.json`` records; DIA
           operator and tiled pairwise asserted. ``warmup`` (the kernels
           are built and loaded when the script starts), both kernels against
           their twins on its operator and first K system
           (``crossbar_kernels``: bit-equal ``x``, ``r``, residual and
           iteration count), then one cold serial superstep with the incremental
           selection and three ``superstep_native_batched`` (B = 64,
           ``mass_eps`` 0.1; f64 clocks, as FLAGSHIP_CLOCK_F32 says why)
           under the crossbar checks (an event each, ended done, launches
           equal to the K solves, one host read per replay of the loops); on
           the last state's fields ``loop_turns`` and ``superstep_turns`` as
           at n_yz=64, with the device loops also at k = 16, 32, 64 batches
           and 32, 64, 128 events (LOOP_KS); and one batched loop on those
           fields replayed on the CPU from the same uniforms (integer state
           exact, ``event_time`` within 1e-12). On the fields the first
           batched superstep raced: the rate scale (``rate_scale``: the largest rate's event, the pair
           potentials at the sites of the 64 largest rates against a plain
           f64 sum within 1e-3 V, ln_S with the f64 plane, and the cold
           fields' ln_S), and the loop with f32 clocks cut at 1,500 batches.
           Build times (structure with lists, model with its tables),
           warmup, each superstep's seconds, events, batches, CG iterations
           and host reads, and the peak memory go into its line.

Output: a ``kernels`` JSON line, one JSON line each for ``sweep``,
``disordered``, ``tiled``, ``batched``, ``full``, ``driver``, ``sharded`` and
``flagship``, a ``loops`` line (``loop_turns`` at n_yz=64 and at the
flagship), the card's name and power limit from nvidia-smi, and last
``{"ok": true, "device": {...}}``. ``--only PHASE[,PHASE]`` (of kernels,
sweep, disordered, tiled, batched, full, driver, sharded, flagship) runs a
part of it while developing;
``--only nccl`` (never run by default) runs the sharded phase's sweep and
batched path, under the same checks, on 2 and 4 ranks with a card each over
NCCL, on a machine with four cards. ``--only schedules`` (never run by
default) compiles copies of csrc/dia_cg.cu with the streaming case's other
schedules (CG_SCHEDULES), holds each bit-equal to the twin and times each on
the crossbars' cold K systems at n_yz = 64, 104 and 215. Needs one card, no
network, and no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import shutil
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
DECK = os.path.join(HERE, "decks", "iv_sweep_5nm.txt")
GOLDEN = os.path.join(HERE, "akmc_tpu_torch", "golden", "iv_sweep_5nm_n24.json")
WORKDIR = os.path.join(HERE, "build", "chip_smoke", "iv_sweep_n24")
N_YZ = 24
KERNELS = ("dia_matvec", "dia_cg")
MATVEC_RTOL = 1e-12
CG_BIASES = (1.0, 8.0)           # the deck's first and highest bias
# Each KMC time is an exponential of potentials the CG returns only to its
# stop tolerance (rtol 1e-14 * n_int on a kappa ~ 1e8 system), so any change
# of reduction order moves it: akmc_tpu's own f64 XLA and two-f32 Pallas
# formulations are 2.78e-4 apart on this sweep, and that spread is the bound.
# The port reads 2.75e-4 from the golden on the H100 with the fused CG's
# blocked dot products (bit-identical run to run); with torch.sum dots in a
# host-loop CG it read 5.7e-5 on the card and 1.4e-4 on the CPU.
GOLDEN_KMC_RTOL = 2.78e-4
SYNTH_GOLDEN = os.path.join(HERE, "akmc_tpu_torch", "golden", "iv_sweep_synth5nm_n24.json")
SYNTH_DIR = os.path.join(HERE, "build", "chip_smoke", "synth5nm_n24")
SYNTH_N = 31_088
# The K-CG stops at r.z / b.b <= (1e-14 n_int)^2 on a kappa ~ 1e8 system, which
# fixes the potentials to about 1e-5 V only, and on the low-bias solves r.z
# passes that threshold on a plateau, so a last-ulp change of a dot product
# moves the stop by tens of iterations. akmc_tpu's own banded and ELL operators
# (near-identical arithmetic) are 1.69e-3 apart in KMC time on this sweep where
# their stops differ (232 against 317 iterations) and <= 6.0e-5 elsewhere
# (CPU; tools/synth5nm_deck.py --ell-record). The port on the H100 reads
# 1.12e-2 from the golden where its stop differs from the golden's (5 of the 16
# cold solves) and 1.40e-3 where it does not, with either dot product; events,
# superstep count and final elements are exact. The bounds are those readings,
# rounded up.
SYNTH_KMC_RTOL = 2e-2                # supersteps whose CG stopped elsewhere than the golden's
SYNTH_KMC_RTOL_SAME_STOP = 2e-3      # supersteps with the golden's CG iteration count
# banded against ELL, one cold solve: rtol of tests/test_banded.py; its atol
# of 1e-7 holds at N = 172 only. At N = 31,088 akmc_tpu's own two solves are
# 2.5e-7 V apart (open, 317 and 317 iterations) and 9.5e-6 V (pbc = 1, 205 and
# 203) on the CPU; the port's on the H100 1.66e-5 V and 1.78e-5 V.
BANDED_ELL_RTOL, BANDED_ELL_ATOL = 1e-5, 5e-5
TILED_DIR = os.path.join(HERE, "build", "chip_smoke", "tiled_n32")
TILED_N_YZ = 32
TILED_N = 32 * 32 * 102
BATCHED_DIR = os.path.join(HERE, "build", "chip_smoke", "batched")
# crossbar widths: n_yz^2 x (10 + 22 + 8 + 10 slices) x 2 sublattices = 409,600 and
# 1,081,600 slots; the first at six supersteps of each batched kind, the rest at three
CROSSBAR_N_YZ = (64, 104)
CROSSBAR_VD = 15.0
N_REP = 512
# two-sample KS critical D at alpha = 1e-3 with n = m = N_REP: 1.949 * sqrt(2 / n)
KS_CRIT = 1.949 * math.sqrt(2.0 / N_REP)
FULL_GOLDEN = os.path.join(HERE, "akmc_tpu_torch", "golden", "iv_sweep_5nm_n24_full.json")
FULL_DIR = os.path.join(HERE, "build", "chip_smoke", "full_n24")
# Full physics against akmc_tpu (tools/full_physics_golden.py). The yardstick
# is akmc_tpu's own spread between its band and gather power operators; where
# the port missed it on the H100 the bound is set from the reading (PERF.md §2,
# ROADMAP §3): those two operators share every dot product and tunnel-block
# product, the port's reductions differ from them all.
# The crossbar sweep's P_tot: spread 3.92e-5, reading 3.22e-5.
FULL_POWER_RTOL = 3.93e-5
# The crossbar sweep's I_macro (and --wkb-f32's), absolute: every current there
# is a power-CG stopping point of at most 5e-12 A (the CB edge is NaN on the
# interface, nothing tunnels), -6.75e-15 A in the golden where the port reads
# 8.36e-14 (13.4 relative). Spread 3.93e-14 A, readings 9.03e-14 and 7.3e-14 A.
FULL_CURRENT_ATOL = 2e-13
# One power solve at 8 V per rtol_scale 1, 1e-2, 1e-4. Crossbar (kappa of its
# power system ~3e16 at n_yz = 6): I_macro within the spread at each
# tolerance; P_tot spread 1.6e-9, 3.6e-6, 6.4e-6, readings 3.4e-9, 3.5e-6,
# 3.7e-5. Disordered stand-in (resolved current, 252.7 uA): readings I_macro
# 1.4e-9, 1.1e-11, 4.9e-12 and P_tot 2.1e-11, 1.9e-12, 9.3e-13 against spreads
# of 4.2e-10 to 5.9e-13 and 1.2e-10 to 8.8e-15; both bounds lie below what the
# tolerance itself moves (I_macro 1.2e-7, P_tot 1.5e-7 between 1 and 1e-2).
CROSSBAR_SOLVE_POWER_RTOL = (1e-8, 1e-5, 1e-4)
STANDIN_SOLVE_CURRENT_RTOL = 1e-8
STANDIN_SOLVE_POWER_RTOL = 1e-10
# Three stand-in supersteps through the driver: I_macro within the spread on
# them (8.0e-3; reading 1.9e-3); P_tot spread 4.80e-7, reading 5.24e-7.
STANDIN_STEP_POWER_RTOL = 1e-6
# A heated temperature against akmc_tpu's: its rise over the background is
# linear in the power, so it is held to the sweep's P_tot bound, plus a few
# units in the last place of T itself (a 1e-11 K rise at 300 K is a few hundred
# of them)
HEAT_T_ULPS = 4
MODES_GOLDEN = os.path.join(HERE, "akmc_tpu_torch", "golden", "iv_sweep_5nm_n24_modes.json")
DRIVER_DIR = os.path.join(HERE, "build", "chip_smoke", "driver")
N_SWEEP = 24                     # the sweep's supersteps: the events-only run's cap
SPD = 4                          # --steps-per-dispatch of the driver phase
# events-only KMC times against akmc_tpu's (rates on the zero potential, no
# CG): an H100 80GB HBM3 at 700 W and the port on the CPU read 2.01e-16; a few
# ulps more
EVENTS_KMC_RTOL = 1e-15
# fields-only sweep against its golden (iv_sweep_5nm_n24_modes.json): each
# pass's CG count and every potential of the final snapshot within
# akmc_tpu's own spread between its two matvecs (the golden's "spread": 1
# iteration, 2.65e-5 V; the H100 reads 1 and 2.63e-5), and each bias point's
# sum of |potential| within FIELDS_POT_SUM_RTOL: that spread is 3.55e-7, the
# H100 (and the port on the CPU) reads 4.30e-7 at 1 V, where it stops at the
# golden's 312 iterations and the other matvec at 311 (the sum moves with
# where the CG stops); the reading rounded up
FIELDS_POT_SUM_RTOL = 5e-7
HBM_BYTES_PER_S = 3.35e12        # H100 SXM
F64_FLOP_PER_S = 34e12           # H100 SXM, f64 outside the tensor cores


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def import_port():
    """The port from this checkout, and nothing else: a script copied alone
    into an empty directory must fail here."""
    sys.path.insert(0, HERE)
    import akmc_tpu_torch

    pkg = os.path.dirname(os.path.abspath(akmc_tpu_torch.__file__))
    if pkg != os.path.join(HERE, "akmc_tpu_torch"):
        fail(f"akmc_tpu_torch imported from {pkg}, not from this checkout")
    return akmc_tpu_torch


def cuda_time_ms(fn, reps: int, warmup: int = 10) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 200):
    """Device time per call from the profiler: the summed time of every
    kernel ``fn`` launches, over ``reps`` calls (no host gaps). None when
    the profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages())
    return total_us / reps / 1e3 if total_us > 0 else None


def crossbar_dia(n_yz: int):
    """The DIA operator that ``runtime/driver.py`` builds for the deck at ``n_yz``, with the
    parameters and the lattice it came from."""
    from akmc_tpu_torch.config import KMCParameters
    from akmc_tpu_torch.lattice import build_lattice, metal_mask
    from akmc_tpu_torch.models.crossbar import mask_null_slots, synthesize_deck_structure
    from akmc_tpu_torch.rng import ReferenceRNG
    from akmc_tpu_torch.solvers.dia import build_dia_k
    from akmc_tpu_torch.state import make_substoichiometric

    p, element, x, y, z = synthesize_deck_structure(KMCParameters.from_file(DECK), n_yz)
    element = make_substoichiometric(element, p.initial_vacancy_concentration,
                                     ReferenceRNG(p.rnd_seed))
    lat = build_lattice(element, x, y, z, p)
    mask_null_slots(lat)
    built = build_dia_k(np.stack([lat.x, lat.y, lat.z], 1), lat.k_neigh_idx,
                        metal_mask(lat.element0, p.metals), p.num_atoms_first_layer,
                        p.high_G, p.low_G)
    if built is None:
        fail(f"the n_yz={n_yz} crossbar has no DIA operator")
    return built[0], built[1], p, lat


def library_product(diags, offsets, val_low, val_high, dev):
    """One block-diagonal CSR matrix [[W, 0], [0, adjacency]] assembled on the
    card from the codes: ``M @ [x; xv]`` is the DIA function in one PyTorch
    sparse product. ``nonzero`` over the transposed codes lists the edges by
    row, then by ascending offset, which is CSR's column order."""
    D, n = diags.shape
    codes = diags.to(dev)
    rows, d_idx = torch.nonzero(codes.t() != 0, as_tuple=True)
    cols = rows + offsets.to(dev)[d_idx]
    keep = (cols >= 0) & (cols < n)
    rows, d_idx, cols = rows[keep], d_idx[keep], cols[keep]
    hi, lo = (torch.tensor(v, dtype=torch.float64, device=dev) for v in (val_high, val_low))
    w = torch.where(codes[d_idx, rows] == 2, hi, lo)
    ends = torch.cumsum(torch.bincount(rows, minlength=n), 0)
    zero = torch.zeros(1, dtype=ends.dtype, device=dev)
    crow = torch.cat([zero, ends, ends[-1] + ends])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # "sparse CSR support is in beta"
        return torch.sparse_csr_tensor(
            crow, torch.cat([cols, cols + n]), torch.cat([w, torch.ones_like(w)]),
            size=(2 * n, 2 * n), dtype=torch.float64, check_invariants=True,
        )


def host_us(fn, reps: int = 2000) -> float:
    """Host time of one call of ``fn`` in microseconds (the device is idle
    before and drained after)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def check_dia_kernel(dev, dia, meta) -> dict:
    import ctypes

    from akmc_tpu_torch.ops import cuda_build
    from akmc_tpu_torch.ops import dia_matvec as mv

    rng = np.random.default_rng(2024)
    diags, offsets = dia.diags.to(dev), dia.offsets.to(dev)
    D, n = diags.shape
    cases = [("n_yz=24 crossbar", diags, offsets, meta.val_low, meta.val_high)]
    for name, offs in (
        ("clustered", [-136, -129, -128, -127, -64, -9, -1, 1, 9, 64, 127, 128, 129, 136]),
        ("far", [-5000, -4999, -3, -1, 1, 3, 4999, 5000]),
        ("tight", [-2, -1, 1, 2]),
        ("D=40", [o for o in range(-20, 21) if o]),      # more than one group of 32 diagonals
    ):
        c = np.where(rng.random((len(offs), 4000)) < 0.6, rng.integers(1, 3, (len(offs), 4000)), 0)
        cases.append((name, torch.tensor(c, dtype=torch.int8, device=dev),
                      torch.tensor(offs, dtype=torch.int64, device=dev), 1e-8, 1.0))

    max_abs = max_rel = 0.0
    for name, d_t, o_t, lo, hi in cases:
        m = d_t.shape[1]
        x = torch.tensor(rng.standard_normal(m) * np.exp(rng.standard_normal(m)), device=dev)
        xv = torch.tensor(rng.standard_normal(m) * (rng.random(m) < 0.3), device=dev)
        y, v = mv.dia_combined_matvec(d_t, o_t, lo, hi, x, xv)
        y0, v0 = mv.dia_combined_matvec_plain(d_t, o_t.tolist(), lo, hi, x, xv)
        torch.cuda.synchronize()
        if not (torch.equal(y, y0) and torch.equal(v, v0)):
            # the kernel adds the twin's terms in the twin's order with the
            # same roundings; another order (e.g. contracted into FMAs) stays
            # within the bound below but moves the CG's trajectory
            fail(f"DIA kernel is not bit-equal to its twin on {name}")
        for got, ref in ((y, y0), (v, v0)):
            err = float((got - ref).abs().max())
            scale = float(ref.abs().max())
            if not math.isfinite(err) or err > MATVEC_RTOL * scale:
                fail(f"DIA kernel disagrees with its twin on {name}: max err {err:.3e}, "
                     f"max |ref| {scale:.3e}")
            max_abs, max_rel = max(max_abs, err), max(max_rel, err / scale)
        print(f"chip_smoke: dia_combined_matvec == twin on {name} (D={d_t.shape[0]}, N={m})")

    # timing at the main path's shapes, on CG-shaped inputs; the working set
    # (3.8 MB) stays in the 50 MB L2 between calls, as it does inside the CG
    x = torch.tensor(rng.standard_normal(n), device=dev)
    xv = torch.where(torch.tensor(rng.random(n) < 0.05, device=dev), x, 0.0)
    offs_list = offsets.tolist()
    lib = library_product(diags, offsets, meta.val_low, meta.val_high, dev)
    xcat = torch.cat([x, xv])
    y, v = mv.dia_combined_matvec(diags, offsets, meta.val_low, meta.val_high, x, xv)
    yl = lib @ xcat
    lib_err = float((yl - torch.cat([y, v])).abs().max() / torch.cat([y, v]).abs().max())
    if lib_err > MATVEC_RTOL:
        fail(f"the library yardstick computes another function (rel err {lib_err:.3e})")
    op = mv.DiaOperator(diags, offsets, meta.val_low, meta.val_high)
    out = torch.empty((2, n), dtype=torch.float64, device=dev)
    empty = cuda_build.load("dia_matvec").dia_empty_launch
    empty.argtypes, empty.restype = [ctypes.c_longlong, ctypes.c_void_p], ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    if empty(n, stream) != 0:
        fail("the empty kernel did not launch")
    calls = {
        # one call of the function: the operator is checked every time
        "kernel": lambda: mv.dia_combined_matvec(diags, offsets, meta.val_low,
                                                 meta.val_high, x, xv),
        # the operator checked once, as the K solve holds it
        "operator": lambda: op.matvec(x, xv),
        "operator_out": lambda: op.matvec(x, xv, out=out),
        "empty": lambda: empty(n, stream),
        "plain": lambda: mv.dia_combined_matvec_plain(diags, offs_list, meta.val_low,
                                                      meta.val_high, x, xv),
        "library": lambda: lib @ xcat,
    }
    call_ms = {k: cuda_time_ms(f, reps=50 if k == "plain" else 1000) for k, f in calls.items()}
    dev_ms = {k: device_ms(f) for k, f in calls.items()}
    times = {k: dev_ms[k] if dev_ms[k] is not None else call_ms[k] for k in calls}

    def enter_device():
        with torch.cuda.device(dev):
            pass

    # the host side of one operator call, part by part (microseconds)
    op_arg, launch = op._op_ref, op._launch
    px, pv, po = x.data_ptr(), xv.data_ptr(), out.data_ptr()
    host_path_us = {
        "check x and xv": host_us(lambda: (
            mv.require_tensor("x", x, torch.float64, (n,), dev),
            mv.require_tensor("xv", xv, torch.float64, (n,), dev))),
        "torch.empty((2, N))": host_us(lambda: torch.empty((2, n), dtype=torch.float64,
                                                           device=dev)),
        "three data_ptr()": host_us(lambda: (x.data_ptr(), xv.data_ptr(), out.data_ptr())),
        "current_device()": host_us(torch.cuda.current_device),
        "current_stream().cuda_stream": host_us(
            lambda: torch.cuda.current_stream(dev).cuda_stream),
        "with torch.cuda.device(dev)": host_us(enter_device),
        "ctypes call + launch, matvec": host_us(lambda: launch(op_arg, px, pv, po, stream)),
        "ctypes call + launch, empty kernel": host_us(lambda: empty(n, stream)),
        "out.unbind(0)": host_us(lambda: out.unbind(0)),
        "current_raw_stream()": host_us(lambda: mv.current_raw_stream(dev.index)),
        "whole op.matvec(x, xv)": host_us(calls["operator"]),
        "whole dia_combined_matvec(...)": host_us(calls["kernel"]),
        "library: lib @ xcat": host_us(calls["library"]),
    }
    print("host_path_us " + json.dumps(host_path_us))

    nnz = int((diags != 0).sum())
    bound = matvec_bound(D, n, nnz)
    return {
        "name": "dia_combined_matvec",
        "route": "cuda",
        "source": "akmc_tpu_torch/csrc/dia_matvec.cu",
        "replaces": "akmc_tpu/ops/pallas_dia.py:196",
        "launches": None,                      # filled in from the sweep
        "max_abs_err": max_abs,
        "max_rel_err": max_rel,
        "bitwise_equal_to_twin": True,
        "ms": times["kernel"],
        "plain_ms": times["plain"],
        "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"],
        "library_ms": times["library"],
        "library": "torch.sparse_csr_tensor @ vector, block-diagonal [[W, 0], [0, adjacency]]",
        "empty_kernel_ms": times["empty"],     # the floor of one launch on this grid
        "time_source": "profiler device time" if dev_ms["kernel"] is not None else "CUDA events",
        "call_ms": call_ms,                    # back-to-back calls, host launch gaps included
        "host_path_us": host_path_us,
        "shape": bound["shape"],
    }


def matvec_bound(D: int, n: int, nnz: int) -> dict:
    """The least time of one DIA matvec: its bytes over the memory rate or its
    f64 operations over the peak rate, whichever is larger."""
    n_bytes = D * n + D * 8 + 2 * n * 8 + 2 * n * 8   # codes + offsets + x, xv in + y, v out
    n_ops = 2 * nnz + 3 * n                           # A/B add + V add per code; 2 mul + 1 add per row
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / F64_FLOP_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "shape": {"D": D, "N": n, "nnz": nnz, "bytes": n_bytes, "ops": n_ops}}


def cg_bound(D: int, n: int, nnz: int, nnz_cv: int, k: int) -> dict:
    """The least time of one fused K solve that ran ``k`` iterations."""
    # in: codes, offsets, two masks, five vectors; out: x and r
    n_bytes = D * n + D * 8 + 2 * n + 5 * n * 8 + 2 * n * 8
    # A is applied k times (2 flops per edge, 1 per conductive-vacancy edge, 4
    # per row), and each of the k - 1 iterations adds 11 flops per row
    n_ops = k * (2 * nnz + nnz_cv + 4 * n) + (k - 1) * 11 * n
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / F64_FLOP_PER_S * 1e3
    # what an iteration streams if nothing stays on the chip: the operator as
    # the kernel packs it once per solve (three 32-bit words per row and group
    # of 32 diagonals, and is_int) and eleven passes over f64 vectors
    iter_bytes = (4 * 3 * -(-D // 32) + 1) * n + 11 * n * 8
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "iteration_bytes_bound_ms": iter_bytes / HBM_BYTES_PER_S * 1e3,
            "shape": {"D": D, "N": n, "nnz": nnz, "nnz_into_cvac": nnz_cv, "bytes": n_bytes,
                      "ops": n_ops, "iteration_bytes": iter_bytes}}


def crossbar_state(p, lat, dev):
    """Elements and charges of the crossbar as the first superstep's K solve
    sees them."""
    from akmc_tpu_torch.lattice import ELEM, metal_mask
    from akmc_tpu_torch.ops.charge import update_charge_compact

    element = torch.as_tensor(lat.element0, dtype=torch.int32, device=dev)
    nbr = torch.as_tensor(lat.neigh_idx, dtype=torch.int64, device=dev)
    is_metal = metal_mask(lat.element0, p.metals)
    any_metal = torch.as_tensor(
        (is_metal[np.clip(lat.neigh_idx, 0, None)] & (lat.neigh_idx >= 0)).any(axis=1), device=dev)
    n_vac = int((lat.element0 == int(ELEM.VACANCY)).sum())
    charge = update_charge_compact(element, torch.zeros_like(element), nbr, any_metal,
                                   vmax=2 * n_vac + 256)
    return element, charge


def random_k_system(rng, n, positive_offsets, dev):
    """A random symmetric, diagonally dominant system in the K solve's form:
    (operator, KSystem). Edge (i, i+o) and its mirror carry the same code."""
    from akmc_tpu_torch.ops.dia_matvec import DiaOperator
    from akmc_tpu_torch.solvers.dia import KSystem

    offs = sorted([-o for o in positive_offsets] + list(positive_offsets))
    codes = np.zeros((len(offs), n), np.int8)
    for o in positive_offsets:
        c = np.where(rng.random(n - o) < 0.5, rng.integers(1, 3, n - o), 0)
        codes[offs.index(o), : n - o] = c
        codes[offs.index(-o), o:] = c
    lo, hi = 1e-3, 1.0
    op = DiaOperator(torch.tensor(codes, device=dev),
                     torch.tensor(offs, dtype=torch.int64, device=dev), lo, hi)
    cvac = torch.tensor(rng.random(n) < 0.05, device=dev)
    cv = cvac.to(torch.float64)
    deg, vdeg = op.matvec(torch.ones(n, dtype=torch.float64, device=dev), cv)
    idx = torch.arange(n, device=dev)
    is_int = (idx >= 100) & (idx < n - 100)
    diag_i = torch.where(is_int, deg + (hi - lo) * torch.where(cvac, vdeg, 0.0) + 0.05, 1.0)
    dgc = torch.where(cvac, torch.tensor(hi - lo, dtype=torch.float64, device=dev), 0.0)
    rhs = torch.tensor(rng.standard_normal(n), device=dev) * is_int
    x0 = torch.tensor(rng.standard_normal(n), device=dev) * is_int
    return op, KSystem(cvac=cvac, is_int=is_int, diag_i=diag_i, dgc=dgc,
                       inv_diag=torch.where(is_int, 1.0 / diag_i, 1.0), rhs=rhs, x0=x0)


def compare_cg(name, op_c, ks, tol, max_it, want_regs):
    """One fused K solve held bit-equal to ``dia_cg_solve_plain`` on the same
    system: (the fused result, iterations, blocks, the twin's wall ms)."""
    from akmc_tpu_torch.solvers import dia_cg

    got = dia_cg.dia_cg_solve(op_c, *ks, tol, max_it)
    blocks, regs = dia_cg.dia_cg_solve.last_grid
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = dia_cg.dia_cg_solve_plain(op_c, *ks, tol, max_it)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    k = int(got.iterations)
    if regs != want_regs:
        fail(f"dia_cg_solve on {name}: rows in registers = {regs}, expected {want_regs}")
    if k != ref.iterations:
        fail(f"dia_cg_solve on {name}: {k} iterations, twin {ref.iterations}")
    err = float((got.x - ref.x).abs().max())
    same = (torch.equal(got.x, ref.x) and torch.equal(got.r, ref.r)
            and torch.equal(got.residual_sq, ref.residual_sq))
    if not same or not math.isfinite(err):
        fail(f"dia_cg_solve is not bit-equal to its twin on {name}: max |x - x_twin| "
             f"{err:.3e}, max |r - r_twin| {float((got.r - ref.r).abs().max()):.3e}")
    print(f"chip_smoke: dia_cg_solve == twin on {name} (D={op_c.D}, N={op_c.n}, "
          f"{k} iterations, {blocks} blocks, rows in registers: {regs})")
    return got, k, blocks, plain_ms


def check_dia_cg(dev, dia, meta, p, lat) -> dict:
    from akmc_tpu_torch.ops.dia_matvec import dia_combined_matvec
    from akmc_tpu_torch.solvers import dia_cg
    from akmc_tpu_torch.solvers.cg import f64_vdot, jacobi_cg
    from akmc_tpu_torch.solvers.dia import k_system

    rng = np.random.default_rng(7)
    dia = dia.to(dev)
    op = dia.operator(meta)
    n, D = op.n, op.D
    element, charge = crossbar_state(p, lat, dev)
    geom = (p.high_G, p.low_G, p.num_atoms_first_layer)
    rtol = 1e-14 * (n - 2 * p.num_atoms_first_layer)     # the K solve's stop tolerance
    zeros = torch.zeros(n, dtype=torch.float64, device=dev)

    systems = {Vd: k_system(dia, meta, element, charge, zeros, Vd, *geom) for Vd in CG_BIASES}
    cold = {Vd: compare_cg(f"n_yz={N_YZ} crossbar, cold, Vd={Vd}", op, ks, rtol, 10000, True)
            for Vd, ks in systems.items()}
    warm_ks = k_system(dia, meta, element, charge, cold[CG_BIASES[0]][0].x, 2.0, *geom)
    compare_cg(f"n_yz={N_YZ} crossbar, warm from Vd={CG_BIASES[0]}, Vd=2.0", op, warm_ks,
               rtol, 10000, True)
    _, k_cut, _, _ = compare_cg(f"n_yz={N_YZ} crossbar, max_iterations=10", op,
                                systems[CG_BIASES[0]], rtol, 10, True)
    if k_cut != 11:
        fail(f"a solve cut at max_iterations=10 must return k=11, got {k_cut}")
    compare_cg("random, far offsets", *random_k_system(rng, 4000, [1, 3, 1999, 2000], dev),
               1e-10, 500, True)
    big = [1, 2, 3, 5, 8, 13, 21, 34, 55, 89, 144, 233, 377, 610, 987, 1597, 2584, 150000]
    compare_cg("random, D=36, several chunks per block", *random_k_system(rng, 300_000, big, dev),
               1e-10, 500, False)

    # timing on the first cold solve of the sweep's operator
    Vd = CG_BIASES[0]
    ks, (_, k, blocks, _) = systems[Vd], cold[Vd]

    def fused():
        return dia_cg.dia_cg_solve(op, *ks, rtol, 10000)

    def host_loop():
        """The K-CG as it ran before the fused kernel: one matvec launch,
        about a dozen small PyTorch kernels and one host read per iteration."""
        def A(v):
            mv, corr = dia_combined_matvec(op.diags, op.offsets, op.val_low, op.val_high,
                                           v, torch.where(ks.cvac, v, 0.0))
            return torch.where(ks.is_int, ks.diag_i * v - mv - ks.dgc * corr, v)
        return jacobi_cg(A, ks.rhs, ks.x0, ks.inv_diag, rtol, 10000, dot_fn=f64_vdot)

    def wall_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            res = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3, res

    # one solve is one kernel of milliseconds: back-to-back solves by CUDA
    # events time it, at every shape (cg_readings checks it on the host clock)
    ms = cuda_time_ms(fused, reps=20, warmup=2)
    host_ms, host_res = wall_ms(host_loop, 2)
    plain_ms, _ = wall_ms(lambda: dia_cg.dia_cg_solve_plain(op, *ks, rtol, 10000), 1)
    one_it_ms = cuda_time_ms(lambda: dia_cg.dia_cg_solve(op, *ks, rtol, 0), reps=200)
    bound, readings = cg_readings(dev, op, ks, rtol, k, blocks, True, ms)
    return {
        "name": "dia_cg_solve",
        "route": "cuda",
        "source": "akmc_tpu_torch/csrc/dia_cg.cu",
        "replaces": "akmc_tpu/ops/pallas_dia.py:196",
        "launches": None,                      # filled in from the sweep
        "max_abs_err": 0.0,
        "bitwise_equal_to_twin": True,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"],
        "library_ms": None,
        "library": None,                       # no single PyTorch call computes a CG
        "host_loop_ms": host_ms,               # jacobi_cg over the kernel matvec, same inputs
        "host_loop_iterations": host_res.iterations,
        "host_loop_ms_per_iteration": host_ms / host_res.iterations,
        **readings,
        "launch_only_call_ms": one_it_ms,      # max_iterations=0: start, two dots, no iteration
        "timed_case": f"n_yz={N_YZ} crossbar, cold start, Vd={Vd}",
        "shape": bound["shape"],
    }


def cg_readings(dev, op, ks, rtol, k, blocks, regs, solve_ms):
    """(cg_bound, readings) of one fused solve of ``k`` iterations that took
    ``solve_ms`` by CUDA events: per iteration its time, its grid syncs, the
    floor those syncs set on this grid (the same syncs with no work between
    them: a long run less an empty one), the streaming bound (``cg_bound``'s
    bytes of an iteration that keeps nothing on the chip) and the share of
    it reached; beside them one solve on the host clock, synchronised, which
    checks the CUDA-event time (PERF.md §7)."""
    import ctypes

    from akmc_tpu_torch.ops import cuda_build
    from akmc_tpu_torch.solvers import dia_cg

    lib = cuda_build.load("dia_cg")
    floor = lib.dia_cg_sync_floor_launch
    floor.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    floor.restype = ctypes.c_int
    syncs = lib.dia_cg_syncs_per_iteration()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def syncs_only(iterations):
        if floor(blocks, iterations, stream) != 0:
            fail("the grid-sync kernel did not launch")

    sync_ms = (cuda_time_ms(lambda: syncs_only(k), reps=20, warmup=2)
               - cuda_time_ms(lambda: syncs_only(0), reps=20, warmup=2)) / (syncs * k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dia_cg.dia_cg_solve(op, *ks, rtol, 10000)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    nnz = int((op.diags != 0).sum())
    cv = ks.cvac.to(torch.float64)
    nnz_cv = int(op.matvec(cv, cv)[1].sum())      # edges into a conductive vacancy
    bound = cg_bound(op.D, op.n, nnz, nnz_cv, k)
    per_iteration = solve_ms / k
    return bound, {
        "iterations": k, "ms_per_iteration": per_iteration, "time_source": "CUDA events",
        "wall_ms_one_solve": wall_ms,
        "grid_blocks": blocks, "rows_in_registers": regs,
        "grid_syncs_per_iteration": syncs, "grid_sync_ms": sync_ms,
        "sync_floor_ms_per_iteration": syncs * sync_ms,
        "iteration_bytes_bound_ms": bound["iteration_bytes_bound_ms"],
        "streaming_bound_ms": k * bound["iteration_bytes_bound_ms"],
        "share_of_streaming_bound": bound["iteration_bytes_bound_ms"] / per_iteration,
    }


@contextlib.contextmanager
def count_syncs(dev):
    """A list that receives one warning per host synchronisation made inside
    the block (CUDA only; on a CPU device it stays empty)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if dev.type == "cuda":
            torch.cuda.set_sync_debug_mode("warn")
        try:
            yield caught
        finally:
            if dev.type == "cuda":
                torch.cuda.set_sync_debug_mode(0)


def n_syncs(caught) -> int:
    return sum("synchroniz" in str(w.message) for w in caught)


def sync_sites(caught, top=12) -> dict:
    """Where the synchronisations were made: the most frequent source lines."""
    import collections

    sites = collections.Counter(f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
                                if "synchroniz" in str(w.message))
    return dict(sites.most_common(top))


def drive(deck, workdir, **options):
    """One run of ``runtime.driver.run`` on the card with every launch counter
    set to 0 just before it and read just after: (summary, metrics rows,
    counts). ``counts`` holds the launches of each kernel, the iterations the
    fused CG counted on the device, the host synchronisations and the wall
    time."""
    from akmc_tpu_torch.ops import dia_matvec as mv
    from akmc_tpu_torch.runtime import driver
    from akmc_tpu_torch.solvers import dia_cg

    shutil.rmtree(workdir, ignore_errors=True)
    mv.dia_combined_matvec.launches = 0
    dia_cg.dia_cg_solve.launches = 0
    dia_cg.reset_iterations_total("cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with count_syncs(torch.device("cuda")) as syncs:
        summary = driver.run(deck, workdir=workdir, log=False, **options)
    torch.cuda.synchronize()
    counts = {
        "wall_s": time.perf_counter() - t0,
        "dia_launches": mv.dia_combined_matvec.launches,
        "dia_cg_launches": dia_cg.dia_cg_solve.launches,
        "cg_iterations_counted_on_device": dia_cg.iterations_total("cuda"),
        "host_syncs": n_syncs(syncs),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    for r in rows:
        if not all(math.isfinite(r[k]) for k in ("kmc_time", "event_time", "superstep_s")):
            fail(f"non-finite superstep: {r}")
    return summary, rows, counts


def check_launches(path: str, summary: dict, rows: list, counts: dict) -> None:
    """Each K solve of the driver's model (``k_solves``, those a grown cap
    repeated included) launched the fused CG once and the matvec once (the
    conductive-vacancy degrees), and the iterations the fused kernel counted
    on the device are the model's (``k_iterations``); without a grown cap the
    solves are the supersteps and their iterations those of metrics.jsonl."""
    k_solves, k_iterations = summary["k_solves"], summary["k_iterations"]
    launches = (counts["dia_launches"], counts["dia_cg_launches"])
    if launches != (k_solves, k_solves):
        fail(f"the {path} path launched the DIA kernels (matvec, CG) {launches} times for "
             f"{k_solves} K solves")
    if counts["cg_iterations_counted_on_device"] != k_iterations:
        fail(f"the {path} path's fused solves counted {counts['cg_iterations_counted_on_device']} "
             f"iterations on the device, the model's K solves {k_iterations}")
    cg = sum(r["cg_iterations"] for r in rows)
    if k_solves == len(rows) and k_iterations != cg:
        fail(f"the {path} path's K solves ran {k_iterations} iterations, metrics.jsonl {cg}")


def run_sweep():
    """The main path through ``runtime.driver.run`` on the card: (sweep line, what is
    wrong with it or None)."""
    from akmc_tpu_torch.runtime import golden

    summary, rows, counts = drive(DECK, WORKDIR, synthesize_crossbar=N_YZ, dia_pallas=True)
    wall_s, n_syncs = counts["wall_s"], counts["host_syncs"]
    launches, cg_launches = counts["dia_launches"], counts["dia_cg_launches"]
    cg_counted = counts["cg_iterations_counted_on_device"]
    cg = sum(r["cg_iterations"] for r in rows)
    # one K solve per superstep (the q/v caps never grow on this sweep; a
    # growth would redo the solve): one launch of the fused CG per solve, one
    # of the matvec for the solve's conductive-vacancy degrees, and the
    # iterations the kernel counted on the device are those in metrics.jsonl
    if cg_launches != len(rows):
        fail(f"dia_cg_solve launches {cg_launches} != K solves {len(rows)}")
    if launches != len(rows):
        fail(f"dia_combined_matvec launches {launches} != K solves {len(rows)}")
    if cg_counted != cg:
        fail(f"the fused solves counted {cg_counted} iterations, metrics.jsonl {cg}")
    got = golden.summarize(WORKDIR)
    with open(GOLDEN) as f:
        gold = json.load(f)
    dist = golden.distance(gold, got)
    bad = golden.compare(gold, got, GOLDEN_KMC_RTOL)
    pot_ok = _final_potentials_finite(WORKDIR)
    with open(os.path.join(WORKDIR, "output1_0.txt")) as f:
        head = f.readline()
    sweep = {
        "deck": "decks/iv_sweep_5nm.txt", "n_yz": N_YZ,
        "slots": int(head.split(":")[1].split()[0]) if head.startswith("Synthesized") else None,
        "supersteps": len(rows), "events": sum(r["n_events"] for r in rows),
        "cg_iterations": cg, "cg_iterations_golden": sum(g["cg_iterations"] for g in gold["supersteps"]),
        "cg_iterations_differ_from_golden": dist["cg_iterations_differ"],
        "dia_launches": launches, "dia_cg_launches": cg_launches,
        "cg_iterations_counted_on_device": cg_counted,
        "wall_s": wall_s, "driver_total_s": summary["total_time_s"],
        # the sweep loop's time: supersteps, xyz snapshots, and the rest (log,
        # metrics file, folders)
        "driver_supersteps_s": summary["supersteps_s"],
        "driver_snapshot_s": summary["snapshot_s"], "held_bytes": summary["held_bytes"],
        "driver_other_s": summary["total_time_s"] - summary["supersteps_s"] - summary["snapshot_s"],
        "superstep_s": [r["superstep_s"] for r in rows],
        "cg_per_superstep": [r["cg_iterations"] for r in rows],
        "kmc_time": [r["kmc_time"] for r in rows],
        "host_syncs": n_syncs, "host_syncs_per_superstep": n_syncs / len(rows),
        "kmc_time_max_rel_vs_golden": dist["kmc_time_max_rel"],
        "golden_kmc_rtol": GOLDEN_KMC_RTOL,
        "peak_mem_gb": counts["peak_mem_gb"],
        "rows": rows,                # the metrics rows, for the batched phase's resume check
    }
    with open(WORKDIR + ".record.json", "w") as f:
        json.dump(got, f)       # for ``python -m akmc_tpu_torch.runtime.golden A B``
    problem = None
    if bad:
        problem = "sweep disagrees with the golden: " + "; ".join(bad[:10])
    elif not pot_ok:
        problem = "non-finite potentials in the final snapshot"
    return sweep, problem


@contextlib.contextmanager
def cg_dot(dot):
    """The banded and the ELL K solve with ``dot`` as their CG's dot product."""
    from akmc_tpu_torch.solvers import banded, cg, poisson

    old = banded.jacobi_cg, poisson.jacobi_cg
    banded.jacobi_cg = poisson.jacobi_cg = functools.partial(cg.jacobi_cg, dot_fn=dot)
    try:
        yield
    finally:
        banded.jacobi_cg, poisson.jacobi_cg = old


def wall_ms(fn):
    """Host time of one call of ``fn`` that ends with the device drained."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def cold_k_solves(deck, dev, pbc: bool) -> dict:
    """The sweep's first state at 1 V through the banded and the ELL
    operator, from a zero start, with both dot products."""
    from akmc_tpu_torch.config import KMCParameters
    from akmc_tpu_torch.lattice import build_lattice
    from akmc_tpu_torch.models.vcm import VCMModel
    from akmc_tpu_torch.ops.charge import update_charge_compact
    from akmc_tpu_torch.rng import ReferenceRNG
    from akmc_tpu_torch.runtime.driver import load_structure
    from akmc_tpu_torch.solvers.banded import band_matvec, solve_potential_boundary_banded
    from akmc_tpu_torch.solvers.cg import f64_vdot
    from akmc_tpu_torch.solvers.poisson import solve_potential_boundary
    from akmc_tpu_torch.state import make_substoichiometric

    p = KMCParameters.from_file(deck).replace(pbc=pbc)
    element, x, y, z = load_structure(p, os.path.dirname(deck))
    element = make_substoichiometric(element, p.initial_vacancy_concentration,
                                     ReferenceRNG(p.rnd_seed))
    lat = build_lattice(element, x, y, z, p)
    # the K operators only: no pair table for these solves
    model = VCMModel(p, lat, device=dev, rate_normalize=True, pair_table_budget=0)
    if model.describe()["k_operator"] != "banded":
        fail(f"pbc={pbc}: the disordered structure did not get the banded operator")
    t, bk, meta = model.tables, model.banded, model.band_meta
    elem = torch.as_tensor(lat.element0, dtype=torch.int32, device=dev)
    charge = update_charge_compact(elem, torch.zeros_like(elem), t.neigh_idx,
                                   t.any_metal_nbr, model.vmax)
    zeros = torch.zeros(lat.N, dtype=torch.float64, device=dev)
    geom = (1.0, p.high_G, p.low_G, p.num_atoms_first_layer)

    def banded():
        return solve_potential_boundary_banded(bk, meta, elem, charge, zeros, *geom, p.nn_dist,
                                               model._lattice_t, pbc, model.vmax)

    def ell():
        return solve_potential_boundary(elem, charge, zeros, t.k_neigh_idx, t.metal_edge, *geom)

    out = {"pbc": pbc, "k_edges": int((lat.k_neigh_idx >= 0).sum()),
           "band_blocks": list(bk.blocks.shape), "half_band": meta.half_band}
    banded(), ell()                              # first use: decode the band, load kernels
    for dot_name, dot in (("torch.dot", torch.dot), ("sum(a*b)", f64_vdot)):
        with cg_dot(dot):
            ms_b, (pot_b, res_b) = wall_ms(banded)
            ms_e, (pot_e, res_e) = wall_ms(ell)
        err = float((pot_b - pot_e).abs().max())
        close = torch.allclose(pot_b, pot_e, rtol=BANDED_ELL_RTOL, atol=BANDED_ELL_ATOL)
        out[dot_name] = {
            "banded_iterations": res_b.iterations, "ell_iterations": res_e.iterations,
            "banded_ms": ms_b, "ell_ms": ms_e,
            "banded_ms_per_iteration": ms_b / res_b.iterations,
            "ell_ms_per_iteration": ms_e / res_e.iterations,
            "max_abs_banded_minus_ell": err, "within_tolerance": bool(close),
        }
        print(f"chip_smoke: cold K solve at 1 V, pbc={int(pbc)}, {dot_name}: banded "
              f"{res_b.iterations} iterations {ms_b:.1f} ms, ELL {res_e.iterations} iterations "
              f"{ms_e:.1f} ms, max |banded - ELL| {err:.3e}")
    out["problem"] = None
    if not out["torch.dot"]["within_tolerance"]:
        out["problem"] = (f"pbc={int(pbc)}: banded and ELL potentials differ by "
                          f"{out['torch.dot']['max_abs_banded_minus_ell']:.3e} "
                          f"(rtol {BANDED_ELL_RTOL}, atol {BANDED_ELL_ATOL})")

    if not pbc:
        # the band matvec alone, on a CG-shaped vector
        xp = torch.where(bk.is_int, torch.randn(lat.N, dtype=torch.float64, device=dev), 0.0)
        nb, T, W = bk.blocks.shape
        n_bytes = nb * T * W * 8 + 2 * lat.N * 8       # decoded blocks + x in + y out
        n_ops = 2 * nb * T * W
        out["band_matvec"] = {
            "ms": cuda_time_ms(lambda: band_matvec(bk, meta, xp), reps=50),
            "device_ms": device_ms(lambda: band_matvec(bk, meta, xp), reps=50),
            "bytes": n_bytes, "ops": n_ops,
            "bytes_bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
            "ops_bound_ms": n_ops / F64_FLOP_PER_S * 1e3,
            "int8_codes_bytes": nb * T * W,
        }
    return out


LISTS_N_YZ = (24, 96)                # synthetic_stack: 31,088 and 497,648 sites


def disordered_lists(dev) -> dict:
    """The on-card list builder (``lattice_device.py``) against the k-d tree
    on ``synthetic_stack`` at n_yz = 24 (the stand-in: the neighbor list, the
    periodic K adjacency and the cutoff list) and at n_yz = 96 (about 0.5 M
    sites: the neighbor list and the periodic K adjacency; its cutoff list
    would hold some 1.7e9 entries), with the deck's cutoffs: equal entry for
    entry, each builder timed (host clock; the card's ends with the table on
    the host)."""
    from akmc_tpu_torch import lattice, lattice_device
    from akmc_tpu_torch.config import KMCParameters
    from akmc_tpu_torch.models.crossbar import synthetic_stack

    p = KMCParameters.from_file(DECK)
    out = {}
    for n_yz in LISTS_N_YZ:
        e, x, y, z, dims, _ = synthetic_stack(n_yz=n_yz)
        pos = np.stack([x, y, z], 1)
        dims = np.asarray(dims, np.float64)
        kinds = {
            "neighbors": (lattice.build_neighbor_list, lattice_device.build_neighbor_list_device,
                          (pos, p.nn_dist, p.max_num_neighbors)),
            "k_adjacency_pbc": (lattice.build_neighbor_list,
                                lattice_device.build_neighbor_list_device,
                                (pos, p.nn_dist, p.max_num_neighbors, dims, True)),
        }
        if n_yz == LISTS_N_YZ[0]:
            kinds["cutoff"] = (lattice.build_cutoff_list, lattice_device.build_cutoff_list_device,
                               (pos, e, p.cutoff_radius))
        case = {"sites": len(x)}
        for kind, (host_fn, card_fn, args) in kinds.items():
            t0 = time.perf_counter()
            want = host_fn(*args)
            host_s = time.perf_counter() - t0
            block = lattice_device.row_block(len(x), dev)
            t0 = time.perf_counter()
            got = card_fn(*args, device=dev, block=block)
            card_s = time.perf_counter() - t0
            if kind == "cutoff":
                (want, wmax), (got, gmax) = want, got
                if wmax != gmax:
                    fail(f"cutoff list widths {gmax} on the card, {wmax} by the k-d tree")
            if got.shape != want.shape or not np.array_equal(got, want):
                bad = (np.nonzero((got != want).any(axis=1))[0][:5].tolist()
                       if got.shape == want.shape else got.shape)
                fail(f"the on-card {kind} list of synthetic_stack(n_yz={n_yz}) differs from the "
                     f"k-d tree's (rows {bad})")
            case[kind] = {"kdtree_host_s": host_s, "card_s": card_s, "width": got.shape[1],
                          "entries": int((got >= 0).sum()), "row_block": block}
        print(f"chip_smoke: on-card lists == k-d tree on synthetic_stack(n_yz={n_yz}), "
              f"{len(x)} sites: " + json.dumps(case))
        out[f"n_yz_{n_yz}"] = case
    return out


def run_disordered(dev):
    """(disordered line, what is wrong with it or None)."""
    from akmc_tpu_torch.runtime import golden, synth_deck
    from akmc_tpu_torch.solvers.cg import f64_vdot

    shutil.rmtree(SYNTH_DIR, ignore_errors=True)
    deck = synth_deck.write_synth_deck(DECK, SYNTH_DIR, N_YZ)
    out_dir = os.path.join(SYNTH_DIR, "out")
    summary, rows, counts = drive(deck, out_dir)
    model = summary["model"]
    if (model["N"], model["k_operator"], model["pairwise"]) != (SYNTH_N, "banded", "table"):
        fail(f"the disordered model is {model}, expected N={SYNTH_N}, banded, table")
    if counts["dia_launches"] or counts["dia_cg_launches"]:
        fail(f"a DIA kernel was launched on the disordered path: {counts}")
    with open(SYNTH_GOLDEN) as f:
        gold = json.load(f)
    got = golden.summarize(out_dir)
    dist = golden.distance(gold, got)
    bad = golden.compare(gold, got, SYNTH_KMC_RTOL)
    same_stop = [(g, h) for g, h in zip(gold["supersteps"], got["supersteps"])
                 if g["cg_iterations"] == h["cg_iterations"]]
    rel_same = [abs(h["kmc_time"] - g["kmc_time"]) / abs(g["kmc_time"]) for g, h in same_stop]
    if max(rel_same, default=0.0) > SYNTH_KMC_RTOL_SAME_STOP:
        bad.append(f"KMC time {max(rel_same):.3e} from the golden at a superstep with the "
                   f"golden's CG count (rtol {SYNTH_KMC_RTOL_SAME_STOP})")
    with open(SYNTH_DIR + ".record.json", "w") as f:
        json.dump(got, f)

    # the same sweep with the other dot product in the K-CG: a reading, no gate
    with cg_dot(f64_vdot):
        _, rows_sum, counts_sum = drive(deck, os.path.join(SYNTH_DIR, "out_sum_dot"))
    dist_sum = golden.distance(gold, golden.summarize(os.path.join(SYNTH_DIR, "out_sum_dot")))

    solves = [cold_k_solves(deck, dev, pbc) for pbc in (False, True)]
    cg = sum(r["cg_iterations"] for r in rows)
    cold = [r for r in rows[1:] if r["cg_iterations"] > 1]
    warm = [r for r in rows[1:] if r["cg_iterations"] == 1]
    line = {
        "deck": "decks/iv_sweep_5nm.txt on synthetic_stack(n_yz=24)", "model": model,
        "supersteps": len(rows), "events": sum(r["n_events"] for r in rows),
        "cg_iterations": cg,
        "cg_iterations_golden": sum(g["cg_iterations"] for g in gold["supersteps"]),
        "cg_per_superstep": [r["cg_iterations"] for r in rows],
        "cg_iterations_differ_from_golden": dist["cg_iterations_differ"],
        "superstep_s": [r["superstep_s"] for r in rows],
        "driver_supersteps_s": summary["supersteps_s"],
        "driver_snapshot_s": summary["snapshot_s"], "driver_total_s": summary["total_time_s"],
        "first_superstep_s": rows[0]["superstep_s"],
        "cold_superstep_s_mean": sum(r["superstep_s"] for r in cold) / max(1, len(cold)),
        "cold_ms_per_cg_iteration": 1e3 * sum(r["superstep_s"] for r in cold)
        / max(1, sum(r["cg_iterations"] for r in cold)),
        "warm_superstep_s_mean": sum(r["superstep_s"] for r in warm) / max(1, len(warm)),
        "host_syncs": counts["host_syncs"],
        "host_syncs_per_superstep": counts["host_syncs"] / len(rows),
        "peak_mem_gb": counts["peak_mem_gb"], "wall_s": counts["wall_s"],
        "kmc_time_max_rel_vs_golden": dist["kmc_time_max_rel"],
        "kmc_time_max_rel_vs_golden_same_cg_count": max(rel_same, default=None),
        "supersteps_with_golden_cg_count": len(same_stop),
        "mismatches_vs_golden": dist["mismatches"],
        "synth_kmc_rtol": SYNTH_KMC_RTOL,
        "synth_kmc_rtol_same_stop": SYNTH_KMC_RTOL_SAME_STOP,
        "sum_dot_sweep": {
            "kmc_time_max_rel_vs_golden": dist_sum["kmc_time_max_rel"],
            "cg_iterations": sum(r["cg_iterations"] for r in rows_sum),
            "cg_iterations_differ_from_golden": dist_sum["cg_iterations_differ"],
            "mismatches_vs_golden": dist_sum["mismatches"],
            "driver_supersteps_s": sum(r["superstep_s"] for r in rows_sum),
        },
        "cold_k_solves": solves,
        "lists": disordered_lists(dev),
    }
    problems = [s["problem"] for s in solves if s["problem"]]
    if bad:
        problems.append("disordered sweep disagrees with the golden: " + "; ".join(bad[:10]))
    if not _final_potentials_finite(out_dir):
        problems.append("non-finite potentials in the disordered sweep's final snapshot")
    return line, "; ".join(problems) or None


def run_tiled(dev):
    """(tiled line, what is wrong with it or None)."""
    from akmc_tpu_torch.models.vcm import VCMModel
    from akmc_tpu_torch.ops.pairwise import pairwise_potential, pairwise_potential_tiled
    from akmc_tpu_torch.solvers import dia_cg

    summary, rows, counts = drive(DECK, TILED_DIR, synthesize_crossbar=TILED_N_YZ,
                                  max_supersteps=3, dia_pallas=True)
    model = summary["model"]
    if (model["N"], model["k_operator"], model["pairwise"]) != (TILED_N, "dia", "tiled"):
        fail(f"the n_yz={TILED_N_YZ} model is {model}, expected N={TILED_N}, dia, tiled")
    if len(rows) != 3:
        fail(f"the tiled run made {len(rows)} supersteps, expected 3")
    check_launches("tiled", summary, rows, counts)
    grid = dia_cg.dia_cg_solve.last_grid
    if not _final_potentials_finite(TILED_DIR):
        fail("non-finite potentials in the tiled run's final snapshot")

    # the two pairwise planes against each other on the first superstep's charges
    _, _, p, lat = crossbar_dia(TILED_N_YZ)
    m = VCMModel(p, lat, device=dev, rate_normalize=True)
    t = m.tables
    if m.describe()["pairwise"] != "tiled":
        fail("the rebuilt n_yz=32 model did not take the tiled path")
    _, charge = crossbar_state(p, lat, dev)
    phys = (p.cutoff_radius, p.sigma, p.k)

    def tiled(plane_f32=False):
        return pairwise_potential_tiled(t.pair_tiling, m._pair_r_tile, t.pos, charge, *phys,
                                        qmax=m.qmax, cand_cap=m.pair_cand_cap,
                                        plane_f32=plane_f32)

    def on_the_fly():
        return pairwise_potential(t.pos, charge, *phys, qmax=m.qmax)

    pot_t, q_ovf, c_ovf = tiled()
    pot_32 = tiled(plane_f32=True)[0]
    pot_f, q_ovf_f = on_the_fly()
    if bool(q_ovf) or bool(c_ovf) or bool(q_ovf_f):
        fail("a cap overflowed on the first superstep's charges")
    scale = float(pot_f.abs().max())
    err64 = float((pot_t - pot_f).abs().max())
    if not (scale > 0 and torch.allclose(pot_t, pot_f, rtol=1e-12, atol=1e-18)):
        fail(f"tiled f64 potential differs from the on-the-fly plane by {err64:.3e} "
             f"(max |pot| {scale:.3e})")
    # sites with a charged pair within f32 roundoff of the cutoff shell may
    # classify a whole pair term differently: compare off the shell
    q_sel = torch.nonzero(charge != 0).flatten()
    cut2 = p.cutoff_radius ** 2
    band = 64 * 1.2e-7 * max(cut2, float(t.pos.abs().max()) ** 2)
    ambiguous = torch.zeros(lat.N, dtype=torch.bool, device=dev)
    for s in range(0, lat.N, 16384):
        d2 = torch.sum((t.pos[s:s + 16384, None, :] - t.pos[q_sel][None, :, :]) ** 2, dim=-1)
        ambiguous[s:s + 16384] = ((d2 - cut2).abs() < band).any(dim=1)
    sel = ~ambiguous
    err32 = float((pot_32[sel] - pot_f[sel]).abs().max())
    if not torch.allclose(pot_32[sel], pot_f[sel], rtol=2e-5, atol=2e-6 * scale):
        fail(f"tiled f32-plane potential differs from the on-the-fly plane by {err32:.3e} "
             f"off the cutoff shell (max |pot| {scale:.3e})")
    torch.cuda.reset_peak_memory_stats()
    times = {
        "tiled_ms": cuda_time_ms(tiled, reps=10, warmup=2),
        "tiled_f32_ms": cuda_time_ms(lambda: tiled(plane_f32=True), reps=10, warmup=2),
        "on_the_fly_ms": cuda_time_ms(on_the_fly, reps=10, warmup=2),
    }
    T, S = t.pair_tiling.tile_sites.shape
    C = min(m.pair_cand_cap, m.qmax)
    line = {
        "deck": "decks/iv_sweep_5nm.txt", "n_yz": TILED_N_YZ, "model": model,
        "tiles": T, "S": S, "candidate_cap": C, "qmax": m.qmax,
        "charged_sites": int(q_sel.numel()),
        "tiled_plane_elements": T * S * C, "on_the_fly_plane_elements": lat.N * m.qmax,
        **times,
        "max_abs_tiled_minus_on_the_fly": err64,
        "max_abs_tiled_f32_minus_on_the_fly": err32, "max_abs_potential": scale,
        "shell_ambiguous_sites": int(ambiguous.sum()),
        "supersteps": len(rows), "events": sum(r["n_events"] for r in rows),
        "cg_per_superstep": [r["cg_iterations"] for r in rows],
        "superstep_s": [r["superstep_s"] for r in rows],
        "dia_launches": counts["dia_launches"], "dia_cg_launches": counts["dia_cg_launches"],
        "dia_cg_grid": {"blocks": grid[0], "rows_in_registers": grid[1]} if grid else None,
        "host_syncs_per_superstep": counts["host_syncs"] / len(rows),
        "peak_mem_gb": counts["peak_mem_gb"],
        "pairwise_check_peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "wall_s": counts["wall_s"],
    }
    return line, None


# ---------------------------------------------------------------------------
# phase 6: the production event path
# ---------------------------------------------------------------------------
def species_sums(element) -> tuple:
    """The three sums every event class conserves: V - Od, O + V, d + Od."""
    from akmc_tpu_torch.lattice import ELEM

    c = {e: int((element == int(e)).sum()) for e in
         (ELEM.VACANCY, ELEM.OXYGEN_DEFECT, ELEM.O, ELEM.DEFECT)}
    return (c[ELEM.VACANCY] - c[ELEM.OXYGEN_DEFECT], c[ELEM.O] + c[ELEM.VACANCY],
            c[ELEM.DEFECT] + c[ELEM.OXYGEN_DEFECT])


def replay_uniforms(seed, n, B, clock_f32):
    """Seeded numpy uniforms in the order the batched loop asks for them:
    u_clk (n,) in the clock's type, then u_slot (B,) f64, batch after batch."""
    rng = np.random.default_rng(seed)
    while True:
        yield rng.random(n, dtype=np.float32) if clock_f32 else rng.random(n)
        yield rng.random(B)


def replay_case(dev, state, fr, t, freq, seed, B, clock_f32, mass_eps, name) -> dict:
    """``run_event_loop_batched`` on the card and on the CPU from one frozen
    fields state ``fr`` and the same seeded numpy uniforms: elements, charges,
    event, batch and cut counts and the rate table's zero pattern equal,
    ``event_time`` within rtol 1e-12 (f32 clocks: 1e-6)."""
    from akmc_tpu_torch.ops.events import ReplayDraws, run_event_loop_batched

    n = fr.P.shape[0]
    res, wall = {}, {}
    for where in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        res[where.type] = run_event_loop_batched(
            state.element.to(where), fr.charge.to(where), fr.P.to(where, copy=True),
            fr.etype.to(where), t.act_neigh.to(where),
            ReplayDraws(replay_uniforms(seed, n, B, clock_f32)), freq,
            batch=B, act_idx=t.act_idx.to(where), abs2act=t.abs2act.to(where),
            ln_S=fr.ln_S.to(where), mass_eps=mass_eps, clock_f32=clock_f32)
        wall[where.type] = time.perf_counter() - t0
    g, c = res[dev.type], res["cpu"]
    if g.element.device.type != dev.type or g.P.device.type != dev.type:
        fail(f"the replay for {dev} came back on {g.element.device}")
    counts = [(r.n_events, r.n_batches, r.n_cut_conflict, r.n_cut_mass, r.done)
              for r in (g, c)]
    if counts[0] != counts[1]:
        fail(f"{name}: card (events, batches, conflict cuts, mass cuts, done) "
             f"{counts[0]} != CPU {counts[1]}")
    if not (torch.equal(g.element.cpu(), c.element) and torch.equal(g.charge.cpu(), c.charge)):
        fail(f"{name}: elements or charges differ between the card and the CPU")
    if not torch.equal(g.P.cpu() == 0.0, c.P == 0.0):
        fail(f"{name}: the rate table's zero pattern differs")
    rtol = 1e-6 if clock_f32 else 1e-12
    rel = abs(g.event_time_h - c.event_time_h) / abs(c.event_time_h)
    if not (g.done and g.n_events >= 1 and math.isfinite(g.event_time_h) and rel <= rtol):
        fail(f"{name}: event_time {g.event_time_h!r} on the card, {c.event_time_h!r} on "
             f"the CPU (rtol {rtol}), events {g.n_events}, done {g.done}")
    if species_sums(g.element) != species_sums(state.element):
        fail(f"{name}: species sums not conserved")
    print(f"chip_smoke: batched loop, card == CPU on {name}: {g.n_events} events in "
          f"{g.n_batches} batches")
    return {"B": B, "clock_f32": clock_f32, "mass_eps": mass_eps, "rows": n,
            "events": g.n_events, "batches": g.n_batches, "cut_conflict": g.n_cut_conflict,
            "cut_mass": g.n_cut_mass, "event_time": g.event_time_h,
            "event_time_rel_card_vs_cpu": rel, "wall_s": wall}


def batched_replay(dev) -> dict:
    """The batched loop on the card against the same loop on the CPU, from
    one frozen fields state and the same uniforms."""
    from akmc_tpu_torch.models.vcm import VCMModel
    from akmc_tpu_torch.state import make_device_state

    _, _, p, lat = crossbar_dia(N_YZ)
    model = VCMModel(p, lat, device=dev, rate_normalize=True)
    state = make_device_state(lat, p.background_temp, dev)
    out = []
    for Vd in (8.0, CROSSBAR_VD):
        fr = model.fields(state, Vd)
        for B, clock_f32 in ((64, False), (16, True)):
            case = replay_case(dev, state, fr, model.tables, p.freq, int(Vd) * 100 + B, B,
                               clock_f32, 1e-3, f"replay at {Vd} V, B={B}, clock_f32={clock_f32}")
            out.append({"Vd": Vd, **case})
    return {"cases": out}


def ks_statistic(a, b) -> float:
    """Two-sample Kolmogorov-Smirnov D: the largest gap between the two
    empirical distribution functions."""
    a, b = np.sort(a), np.sort(b)
    both = np.concatenate([a, b])
    return float(np.max(np.abs(np.searchsorted(a, both, side="right") / len(a)
                               - np.searchsorted(b, both, side="right") / len(b))))


def batched_law(dev) -> dict:
    """Waiting time and event count of the batched loop against the serial
    native loop, N_REP replicates each from one frozen table, on the card
    with the device generator."""
    from akmc_tpu_torch.models.crossbar import toy_device
    from akmc_tpu_torch.models.vcm import VCMModel
    from akmc_tpu_torch.ops.device_loop import LoopGraphs
    from akmc_tpu_torch.ops.events import (
        GeneratorDraws,
        run_event_loop_batched,
        run_event_loop_native,
    )
    from akmc_tpu_torch.state import make_device_state

    p, lat = toy_device()
    model = VCMModel(p, lat, device=dev)
    t = model.tables
    state = make_device_state(lat, p.background_temp, dev)
    fr = model.fields(state, 2.0)
    common = dict(act_idx=t.act_idx, abs2act=t.abs2act, ln_S=fr.ln_S)

    def sample(kind, seed):
        draws = GeneratorDraws.seeded(seed, dev)
        times, counts = np.empty(N_REP), np.empty(N_REP)
        graphs = LoopGraphs()                 # one capture for all replicates
        t0 = time.perf_counter()
        for i in range(N_REP):
            args = (state.element, fr.charge, fr.P.clone(), fr.etype, t.act_neigh, draws, p.freq)
            if kind == "serial":
                r = run_event_loop_native(*args, zero_rows=t.act_zero_rows, graphs=graphs,
                                          **common)
            else:
                r = run_event_loop_batched(*args, batch=16, mass_eps=1e-3, graphs=graphs,
                                           **common)
            times[i], counts[i] = r.event_time_h, r.n_events
        if not np.isfinite(times).all():
            fail(f"law: the {kind} loop ran the rate table empty")
        return times, counts, time.perf_counter() - t0

    t_ser, c_ser, s_ser = sample("serial", 1)
    t_bat, c_bat, s_bat = sample("batched", 2)
    d_time, d_count = ks_statistic(t_ser, t_bat), ks_statistic(c_ser, c_bat)
    line = {"replicates": N_REP, "rows": int(fr.P.shape[0]), "ks_critical": KS_CRIT,
            "ks_waiting_time": d_time, "ks_event_count": d_count,
            "mean_events_serial": float(c_ser.mean()), "mean_events_batched": float(c_bat.mean()),
            "serial_s": s_ser, "batched_s": s_bat,
            "serial_ms_per_event": 1e3 * s_ser / float(c_ser.sum())}
    print(f"chip_smoke: law: KS waiting time {d_time:.4f}, event count {d_count:.4f} "
          f"(critical {KS_CRIT:.4f}); mean events {c_ser.mean():.2f} serial, "
          f"{c_bat.mean():.2f} batched")
    if not (d_time < KS_CRIT and d_count < KS_CRIT):
        fail(f"law: KS D {d_time:.4f} (waiting time), {d_count:.4f} (event count) "
             f">= {KS_CRIT:.4f}")
    return line


def crossbar_kernels(dev, model, state, n_yz: int) -> dict:
    """Both CUDA kernels on the crossbar's own operator and K system, as its
    first superstep meets them (cold start at CROSSBAR_VD, the charges of
    that superstep's charge update), each held bit-equal to its plain twin
    and timed beside it, the matvec also beside the one-call sparse product:
    name -> the readings of the ``kernels`` line at this shape. The fused CG
    must have taken its streaming kernel (rows not in registers)."""
    from akmc_tpu_torch.ops import dia_matvec as mv
    from akmc_tpu_torch.ops.charge import update_charge_compact
    from akmc_tpu_torch.solvers import dia_cg
    from akmc_tpu_torch.solvers.dia import k_system

    p, t = model.params, model.tables
    dia, meta = model.dia, model.dia_meta
    op = dia.operator(meta)
    n, D = op.n, op.D
    where = f"n_yz={n_yz} crossbar"
    charge = update_charge_compact(state.element, state.charge, t.neigh_idx, t.any_metal_nbr,
                                   model.vmax)
    ks = k_system(dia, meta, state.element, charge, state.potential_boundary, CROSSBAR_VD,
                  p.high_G, p.low_G, p.num_atoms_first_layer)
    rtol = 1e-14 * (n - 2 * p.num_atoms_first_layer)
    got, k, blocks, cg_plain_ms = compare_cg(f"{where}, cold, Vd={CROSSBAR_VD}", op, ks, rtol,
                                             10000, False)

    # the matvec on the two kinds of input the solve gives it: the vacancy
    # indicator (k_system's call) and a CG-shaped vector (the solution)
    offs = op.offsets.tolist()
    cv = ks.cvac.to(torch.float64)
    xv = torch.where(ks.cvac, got.x, 0.0)
    max_abs = 0.0
    for name, a, b in (("vacancy indicator", cv, cv), ("K solution", got.x, xv)):
        y, v = op.matvec(a, b)
        y0, v0 = mv.dia_combined_matvec_plain(op.diags, offs, op.val_low, op.val_high, a, b)
        torch.cuda.synchronize()
        if not (torch.equal(y, y0) and torch.equal(v, v0)):
            fail(f"DIA kernel is not bit-equal to its twin on {where}, {name}")
        max_abs = max(max_abs, float((y - y0).abs().max()), float((v - v0).abs().max()))
    print(f"chip_smoke: dia_combined_matvec == twin on {where} (D={D}, N={n})")

    calls = {"kernel": lambda: op.matvec(got.x, xv),
             "plain": lambda: mv.dia_combined_matvec_plain(op.diags, offs, op.val_low,
                                                           op.val_high, got.x, xv)}
    lib = library_product(op.diags, op.offsets, op.val_low, op.val_high, dev)
    xcat = torch.cat([got.x, xv])
    y, v = op.matvec(got.x, xv)
    ref = torch.cat([y, v])
    lib_err = float(((lib @ xcat) - ref).abs().max() / ref.abs().max())
    if lib_err > MATVEC_RTOL:
        fail(f"the library yardstick computes another function on {where} "
             f"(rel err {lib_err:.3e})")
    calls["library"] = lambda: lib @ xcat
    mv_ms, mv_call_ms = {}, {}
    for name, fn in calls.items():
        reps = 20 if name == "plain" else 200
        mv_call_ms[name] = cuda_time_ms(fn, reps=reps)
        dev_ms = device_ms(fn, reps=reps)
        mv_ms[name] = dev_ms if dev_ms is not None else mv_call_ms[name]

    def fused():
        return dia_cg.dia_cg_solve(op, *ks, rtol, 10000)

    cg_ms = cuda_time_ms(fused, reps=10, warmup=2)
    cb, readings = cg_readings(dev, op, ks, rtol, k, blocks, False, cg_ms)
    nnz = int((op.diags != 0).sum())
    mb = matvec_bound(D, n, nnz)
    return {
        "dia_combined_matvec": {
            "n_yz": n_yz, "bitwise_equal_to_twin": True, "max_abs_err": max_abs,
            "ms": mv_ms["kernel"], "plain_ms": mv_ms["plain"], "bound_ms": mb["bound_ms"],
            "bound_by": mb["bound_by"], "library_ms": mv_ms["library"],
            "call_ms": mv_call_ms, "shape": mb["shape"],
        },
        "dia_cg_solve": {
            "n_yz": n_yz, "bitwise_equal_to_twin": True, "max_abs_err": 0.0,
            "ms": cg_ms, "plain_ms": cg_plain_ms, "bound_ms": cb["bound_ms"],
            "bound_by": cb["bound_by"], "library_ms": None, **readings, "shape": cb["shape"],
        },
    }


# Streaming-case schedules of csrc/dia_cg.cu that ``--only schedules`` times
# against each other on the crossbars' cold K systems: name -> the values of
# the file's constexpr switches in that build, over CG_SCHEDULE_BASE (the
# values the file ships with).
CG_SCHEDULE_BASE = {"kRows": "1", "kContiguousRuns": "false", "kPrefetch": "false",
                    "kGatherStream": "4", "kStreamBlocksPerSM": "4", "kLoadBatch": "8"}
CG_SCHEDULES = {
    "one row (as built)": {},
    "one row, contiguous runs": {"kContiguousRuns": "true"},
    "one row, cp.async masks": {"kPrefetch": "true"},
    "one row, eight gathers": {"kGatherStream": "8"},
    "one row, three blocks per SM": {"kStreamBlocksPerSM": "3"},
    "one row, five blocks per SM": {"kStreamBlocksPerSM": "5"},
    "one row, six blocks per SM": {"kStreamBlocksPerSM": "6"},
    "one row, 16 chunk sums in flight": {"kLoadBatch": "16"},
    "one row, 32 chunk sums in flight": {"kLoadBatch": "32"},
    "two rows": {"kRows": "2"},
    "two rows, contiguous runs": {"kRows": "2", "kContiguousRuns": "true"},
    "two rows, cp.async masks": {"kRows": "2", "kPrefetch": "true"},
}
SCHEDULE_N_YZ = (64, 104, 215)


def schedule_build(name: str, values: dict):
    """Start ``nvcc`` on a copy of csrc/dia_cg.cu with ``values`` in place of
    its constexpr ones: (library path, process)."""
    import re

    from akmc_tpu_torch.ops import cuda_build

    src = (cuda_build.CSRC / "dia_cg.cu").read_text()
    for key, value in values.items():
        src, found = re.subn(rf"(constexpr \w+ {key} = )[^;]+;", rf"\g<1>{value};", src)
        if found != 1:
            fail(f"csrc/dia_cg.cu has no constexpr {key}")
    out = cuda_build.BUILD_DIR / "schedules"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / (re.sub(r"\W+", "-", name) + ".cu")
    cu.write_text(src)
    so = cu.with_suffix(".so")
    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so), str(cu)]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def run_schedules(dev):
    """(schedules line, None): each build of CG_SCHEDULES held bit-equal to the
    twin and timed by CUDA events on the cold K system (15 V) of each crossbar
    of SCHEDULE_N_YZ, in the order of the table and then backwards; per
    shape its ms per iteration and share of the streaming bound."""
    import ctypes
    import gc

    from akmc_tpu_torch.ops import cuda_build
    from akmc_tpu_torch.ops.charge import update_charge_compact
    from akmc_tpu_torch.solvers import dia_cg
    from akmc_tpu_torch.solvers.dia import k_system
    from akmc_tpu_torch.state import make_device_state

    started = {name: schedule_build(name, {**CG_SCHEDULE_BASE, **values})
               for name, values in CG_SCHEDULES.items()}
    libs, ptxas = {}, {}
    for name, (so, proc) in started.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"nvcc failed for the schedule {name!r}:\n{text}")
        ptxas[name] = [ln.strip() for ln in text.splitlines() if "registers" in ln or "spill" in ln]
        libs[name] = ctypes.CDLL(str(so))
        print(f"chip_smoke: schedule {name!r}: {' | '.join(ptxas[name])}")
    own = cuda_build.load("dia_cg")
    shapes = {}
    try:
        for n_yz in SCHEDULE_N_YZ:
            p, lat, model, _, _ = crossbar_model(dev, n_yz)
            state = make_device_state(lat, p.background_temp, dev)
            t = model.tables
            op = model.dia.operator(model.dia_meta)
            charge = update_charge_compact(state.element, state.charge, t.neigh_idx,
                                           t.any_metal_nbr, model.vmax)
            ks = k_system(model.dia, model.dia_meta, state.element, charge,
                          state.potential_boundary, CROSSBAR_VD, p.high_G, p.low_G,
                          p.num_atoms_first_layer)
            del model, state, lat, charge
            rtol = 1e-14 * (op.n - 2 * p.num_atoms_first_layer)
            ref = dia_cg.dia_cg_solve_plain(op, *ks, rtol, 10000)
            bound = cg_bound(op.D, op.n, 0, 0, ref.iterations)["iteration_bytes_bound_ms"]
            ms = {name: [] for name in libs}
            for order in (list(libs), list(libs)[::-1]):
                for name in order:
                    cuda_build._loaded["dia_cg"] = libs[name]
                    got = dia_cg.dia_cg_solve(op, *ks, rtol, 10000)
                    if not (int(got.iterations) == ref.iterations and torch.equal(got.x, ref.x)
                            and torch.equal(got.r, ref.r)
                            and torch.equal(got.residual_sq, ref.residual_sq)):
                        fail(f"the schedule {name!r} is not bit-equal to the twin at n_yz={n_yz}")
                    ms[name].append(cuda_time_ms(
                        lambda: dia_cg.dia_cg_solve(op, *ks, rtol, 10000), reps=10, warmup=2))
            k = ref.iterations
            shapes[f"n_yz={n_yz}"] = {
                "N": op.n, "D": op.D, "iterations": k, "blocks": dia_cg.dia_cg_solve.last_grid[0],
                "iteration_bytes_bound_ms": bound,
                "ms_per_iteration": {name: [v / k for v in ms[name]] for name in libs},
                "share_of_streaming_bound": {name: bound * k * len(v) / sum(v)
                                             for name, v in ms.items()},
            }
            print(f"chip_smoke: schedules at n_yz={n_yz}: " + json.dumps(shapes[f"n_yz={n_yz}"]))
            del op, ks, ref
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        cuda_build._loaded["dia_cg"] = own
    return {"base": CG_SCHEDULE_BASE, "schedules": CG_SCHEDULES, "ptxas": ptxas,
            "shapes": shapes}, None


def crossbar_model(dev, n_yz: int, **model_kw):
    """``build_grid_crossbar(n_yz, 10/22/8 slices, defect 0.1, vacancies
    0.05, seed 0)`` and its model on ``dev`` with shifted-exponent rates
    (and ``model_kw``): (p, lat, model, describe(), build), ``build`` the
    host seconds of the structure with its lists (``build_s``) and of the
    model with its tables, DIA operator and pair tiling on the card
    (``model_s``). The card's peak memory is reset just before the model."""
    from akmc_tpu_torch.models import crossbar, vcm

    t0 = time.perf_counter()
    p, lat = crossbar.build_grid_crossbar(
        n_yz=n_yz, contact_slices=10, oxide_slices=22, ti_slices=8,
        defect_fraction=0.1, vacancy_concentration=0.05, seed=0)
    build_s = time.perf_counter() - t0
    print(f"chip_smoke: crossbar n_yz={n_yz}: {lat.N} slots built in {build_s:.1f} s")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = vcm.VCMModel(p, lat, device=dev, rate_normalize=True, **model_kw)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    model_s = time.perf_counter() - t0
    desc = model.describe()
    print(f"chip_smoke: crossbar model in {model_s:.1f} s: {desc}")
    if lat.N != n_yz * n_yz * 50 * 2:
        fail(f"the n_yz={n_yz} crossbar has {lat.N} slots, expected {n_yz * n_yz * 100}")
    if n_yz >= CROSSBAR_N_YZ[0] and (desc["k_operator"], desc["pairwise"]) != ("dia", "tiled"):
        fail(f"the crossbar model is {desc}, expected the DIA operator and tiled pairwise")
    build = {"build_s": build_s, "model_s": model_s}
    return p, lat, model, desc, build


class CrossbarSteps:
    """Supersteps of one crossbar model at CROSSBAR_VD, from ``state`` on,
    each checked as it ends: an event fired, the species sums kept,
    ``kmc_time`` finite and not falling; a batched one ends done and (on the
    card) reads the device at most once per batch from its loop. ``steps``
    holds a row per superstep. Serial supersteps draw from ``stream``,
    batched ones from ``draws``."""

    def __init__(self, dev, model, state, stream, draws, where="crossbar"):
        self.dev, self.model, self.state = dev, model, state
        self.stream, self.draws, self.where = stream, draws, where
        self.sums0 = species_sums(state.element)
        self.steps, self.kmc_times = [], []
        self.pb_prev2 = None

    def step(self, kind, **kw):
        from akmc_tpu_torch.ops import events as ev

        dev, model, i = self.dev, self.model, len(self.steps)
        name = f"{self.where} superstep {i} ({kind})"
        pb_before = self.state.potential_boundary
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ev.reset_loop_counts()
        t0 = time.perf_counter()
        with count_syncs(dev) as caught:
            if kind == "serial":
                self.state, stats = model.superstep(self.state, CROSSBAR_VD, self.stream)
            elif kind == "timed":
                self.state, stats = model.superstep_timed(self.state, CROSSBAR_VD, self.stream)
            else:
                self.state, stats = model.superstep_native_batched(
                    self.state, CROSSBAR_VD, self.draws, batch=64, pb_prev2=self.pb_prev2, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        self.pb_prev2 = pb_before
        syncs = n_syncs(caught)
        # the loop's host reads are those made from LOOP_FILES; the rest
        # are the fields' own (cap flags, compactions, the K solve's iteration
        # count) and the rand chunks' copies, and the fields end at the
        # model's ``fields_s``
        in_loop = n_syncs([w for w in caught if os.path.basename(w.filename) in LOOP_FILES])
        loop = ev.LOOP_COUNTS["serial" if kind in ("serial", "timed") else "batched"]
        row = {"kind": kind, "wall_s": wall, "events": stats["n_events"],
               "event_time": stats["event_time"], "cg_iterations": stats["cg_iterations"],
               "host_syncs": syncs, "host_syncs_in_loop": in_loop,
               "loop_replays": loop["replays"], "loop_steps": loop["steps"],
               "loop_dead_steps": loop["steps"] - loop["live_steps"]}
        if kind not in ("serial", "timed"):
            nb = stats["n_batches"]
            k = ev.BATCHED_K if dev.type == "cuda" else 1
            row.update(batches=nb, events_per_batch=stats["n_events"] / nb,
                       cut_conflict=stats["n_cut_conflict"], cut_mass=stats["n_cut_mass"],
                       host_syncs_in_fields=syncs - in_loop,
                       host_syncs_in_loop_per_batch=in_loop / nb, fields_s=model.fields_s,
                       loop_ms_per_batch=1e3 * (wall - model.fields_s) / nb,
                       loop_k=k, done=stats["done"], **kw)
            if not stats["done"]:
                fail(f"{name} did not end done: {stats['n_events']} events in {nb} batches")
            # no card, no count: the check is the card's. The device loop
            # reads the host once per replay of k batches
            if dev.type == "cuda" and in_loop > math.ceil(nb / k) + 1:
                fail(f"{name}: the batched loop read the device {in_loop} times in {nb} "
                     f"batches (k = {k}), at {sync_sites(caught)}")
        else:
            row["host_syncs_per_event"] = syncs / max(1, stats["n_events"])
            row["loop_k"] = ev.SERIAL_K if dev.type == "cuda" else 1
            if i == 0:
                row["host_sync_sites"] = sync_sites(caught)
            if dev.type == "cuda" and in_loop > loop["replays"]:
                fail(f"{name}: the serial loop read the device {in_loop} times in "
                     f"{loop['replays']} replays, at {sync_sites(caught)}")
        if kind == "timed":
            row.update({k: stats[k] for k in
                        ("t_charge", "t_boundary", "t_pairwise", "t_rates", "t_events")})
        if stats["n_events"] < 1:
            fail(f"{name} fired no event")
        self.kmc_times.append(float(self.state.kmc_time))
        # every superstep adds a positive waiting time; in f64 a gap of 1e-13 s
        # on a clock at 1e2 s may leave the sum where it was
        kt = self.kmc_times
        if not (math.isfinite(kt[-1]) and stats["event_time"] > 0.0
                and (len(kt) < 2 or kt[-1] >= kt[-2])):
            fail(f"{self.where} kmc_time not finite and increasing: {kt}, "
                 f"last waiting time {stats['event_time']}")
        if species_sums(self.state.element) != self.sums0:
            fail(f"{name}: species sums not conserved")
        self.steps.append(row)
        print(f"chip_smoke: {self.where} superstep {i} " + json.dumps(row))


# ---------------------------------------------------------------------------
# the event loops on the card: each device loop (k steps per CUDA-graph
# replay) against its plain host loop, from one frozen fields state
# ---------------------------------------------------------------------------
LOOP_SERIAL_DRAWS = 4096          # the serial loops are held on a chunk of this many draws
LOOP_FILES = ("events.py", "device_loop.py")   # where the event loops read the host
LOOP_KS = {"serial": (32, 64, 128), "batched": (16, 32, 64)}   # k read at the flagship
SERIAL_FIELDS = ("element", "charge", "P", "event_time", "n_events", "draws_used", "done",
                 "event_time_h")
BATCHED_FIELDS = ("element", "charge", "P", "event_time", "n_events", "n_batches", "done",
                  "n_cut_conflict", "n_cut_mass", "event_time_h")


def synced_s(fn):
    """(fn(), host seconds to its end on the card, device ms between two
    CUDA events around it)."""
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, a.elapsed_time(b)


def same_loop(name, a, b, fields):
    """Fails unless the two loop results are equal to the bit in ``fields``."""
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if not (torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y):
            fail(f"{name}: the device loop differs from the plain loop in {f}: "
                 f"{getattr(a, 'n_events', None)} events against {getattr(b, 'n_events', None)}")


def loop_turns(dev, model, state, fr, where, mass_eps, ks=False) -> dict:
    """The three event loops on the frozen fields ``fr``, each run as its
    plain host loop and as its device loop (the model's ``LoopGraphs``), in
    turns plain, device, device, plain from the same draws, and every run
    held bit-equal to the first plain one: the serial loop on
    LOOP_SERIAL_DRAWS draws of the mt19937 stream (with the model's
    selection), the native loop on as many events of the device generator,
    the batched loop (B = 64) to its end. Per loop: capture seconds, host
    seconds and device ms of each run, ms per event or batch, replays, dead
    steps and host reads of a device run, and with ``ks`` the device loop at
    each k of LOOP_KS (a capture each) against the same plain run. Then the
    copy of the inputs into the batched program and of its table out."""
    from akmc_tpu_torch.ops import events as ev
    from akmc_tpu_torch.ops.device_loop import LoopGraphs
    from akmc_tpu_torch.rng import ReferenceRNG

    p, t = model.params, model.tables
    rand = torch.as_tensor(ReferenceRNG(p.rnd_seed_kmc + 1).uniform(LOOP_SERIAL_DRAWS),
                           device=dev)
    loops = {
        "serial": (ev.run_event_loop_plain, ev.run_event_loop, SERIAL_FIELDS,
                   lambda: (rand, p.freq, t.act_idx, t.abs2act, t.act_zero_rows),
                   dict(ln_S=fr.ln_S, incremental_select=model.event_select_incremental)),
        "native": (ev.run_event_loop_native_plain, ev.run_event_loop_native, SERIAL_FIELDS,
                   lambda: (ev.GeneratorDraws.seeded(11, dev), p.freq),
                   dict(max_events=LOOP_SERIAL_DRAWS // 2, act_idx=t.act_idx,
                        abs2act=t.abs2act, ln_S=fr.ln_S, zero_rows=t.act_zero_rows)),
        "batched": (ev.run_event_loop_batched_plain, ev.run_event_loop_batched, BATCHED_FIELDS,
                    lambda: (ev.GeneratorDraws.seeded(12, dev), p.freq),
                    dict(batch=64, act_idx=t.act_idx, abs2act=t.abs2act, ln_S=fr.ln_S,
                         mass_eps=mass_eps)),
    }
    graphs = LoopGraphs()
    out = {}
    for name, (plain, device, fields, tail, kw) in loops.items():
        def run(loop, **more):
            P = fr.P.clone()
            return synced_s(lambda: loop(state.element, fr.charge, P, fr.etype, t.act_neigh,
                                         *tail(), **kw, **more))

        ref, plain_s, plain_ms = run(plain)
        # the first device call builds and captures the program
        first, first_s, _ = run(device, graphs=graphs)
        same_loop(f"{where} {name} loop", first, ref, fields)
        runs = {"plain_s": [plain_s], "device_s": [], "plain_device_ms": [plain_ms],
                "device_device_ms": []}
        for turn in ("device", "device", "plain"):
            ev.reset_loop_counts()
            with count_syncs(dev) as caught:
                res, wall, dms = run(plain if turn == "plain" else device,
                                     **({} if turn == "plain" else {"graphs": graphs}))
            same_loop(f"{where} {name} loop ({turn})", res, ref, fields)
            runs[f"{turn}_s"].append(wall)
            runs[f"{turn}_device_ms"].append(dms)
            if turn == "device":
                c = dict(ev.LOOP_COUNTS[name])
                reads = n_syncs([w for w in caught
                                 if os.path.basename(w.filename) in LOOP_FILES])
                if dev.type == "cuda" and reads != c["replays"]:
                    fail(f"{where} {name} loop: {reads} host reads in {c['replays']} replays")
        steps = ref.n_batches if name == "batched" else ref.n_events
        prog = [pg for key, pg in graphs.programs.items() if key[0] == name][0]
        line = {"k": prog.k, "events": ref.n_events, "done": ref.done,
                "batches" if name == "batched" else "draws_used":
                    ref.n_batches if name == "batched" else ref.draws_used,
                "capture_s": prog.loop.capture_s, "first_device_call_s": first_s, **runs,
                "replays": c["replays"], "dead_steps": c["steps"] - c["live_steps"],
                "host_reads": reads, "bitwise_equal": True,
                "plain_ms_per_step": 1e3 * min(runs["plain_s"]) / max(steps, 1),
                "device_ms_per_step": 1e3 * min(runs["device_s"]) / max(steps, 1)}
        if ks:
            line["k_readings"] = {}
            for k in LOOP_KS["batched" if name == "batched" else "serial"]:
                run(device, graphs=graphs, k=k)
                res, wall, dms = run(device, graphs=graphs, k=k)
                same_loop(f"{where} {name} loop, k = {k}", res, ref, fields)
                line["k_readings"][k] = {"device_s": wall, "device_ms": dms,
                                         "ms_per_step": 1e3 * wall / max(steps, 1)}
        out[name] = line
        print(f"chip_smoke: {where} {name} loop, device == plain: " + json.dumps(line))
    # the batched program's inputs copied in, and its table copied out
    prog = [pg for key, pg in graphs.programs.items() if key[0] == "batched"][0]
    P = fr.P.clone()
    out["batched"]["copy_in_ms"] = cuda_time_ms(
        lambda: prog.load(state.element, fr.charge, fr.P, fr.etype, fr.ln_S, mass_eps, 1),
        reps=5, warmup=1)
    out["batched"]["copy_out_ms"] = cuda_time_ms(lambda: P.copy_(prog.P), reps=5, warmup=1)
    out["rate_table"] = {"rows": int(fr.P.shape[0]), "slots_per_row": int(fr.P.shape[1]),
                         "bytes": fr.P.numel() * fr.P.element_size()}
    out["capture_s_all"] = graphs.capture_s()
    return out


@contextlib.contextmanager
def plain_event_loops():
    """The model's supersteps run their plain host loops while the block
    lasts (a measurement's baseline: nothing in the package selects them)."""
    from akmc_tpu_torch.models import vcm
    from akmc_tpu_torch.ops import events as ev

    saved = vcm.run_event_loop, vcm.run_event_loop_batched
    vcm.run_event_loop = lambda *a, graphs=None, **kw: ev.run_event_loop_plain(*a, **kw)
    vcm.run_event_loop_batched = (
        lambda *a, graphs=None, **kw: ev.run_event_loop_batched_plain(*a, **kw))
    try:
        yield
    finally:
        vcm.run_event_loop, vcm.run_event_loop_batched = saved


def busy_share(prof) -> dict:
    """Device activity (kernels, copies, sets) in a profiled window: the
    union of its intervals against the span of every recorded event."""
    try:
        evs = [(e.device_type(), e.start_ns(), e.start_ns() + e.duration_ns())
               for e in prof.profiler.kineto_results.events()]
        cuda = torch.autograd.DeviceType.CUDA
    except AttributeError:
        evs = [(e.device_type, 1000 * e.time_range.start, 1000 * e.time_range.end)
               for e in prof.events()]
        cuda = torch.autograd.DeviceType.CUDA
    dev_iv = sorted((a, b) for d, a, b in evs if d == cuda and b > a)
    if not dev_iv:
        return {"device_events": 0, "idle_share": None}
    busy, cur_a, cur_b = 0, dev_iv[0][0], dev_iv[0][1]
    for a, b in dev_iv[1:]:
        if a > cur_b:
            busy += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    busy += cur_b - cur_a
    span = max(b for _, _, b in evs) - min(a for _, a, _ in evs)
    return {"device_events": len(dev_iv), "span_ms": span / 1e6, "busy_ms": busy / 1e6,
            "idle_share": 1.0 - busy / span}


def superstep_turns(dev, model, state, where, mass_eps) -> dict:
    """One batched superstep (B = 64, f64 clocks) from ``state`` with the
    plain loop and with the device loop, each from a generator of one seed:
    in turns plain, device, device, plain on the host clock (every result
    equal to the first: events, batches, waiting time, elements), then one of
    each under ``torch.profiler`` for the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    from akmc_tpu_torch.ops import events as ev

    def step():
        return model.superstep_native_batched(state, CROSSBAR_VD,
                                              ev.GeneratorDraws.seeded(21, dev), batch=64,
                                              mass_eps=mass_eps)

    out, ref = {"plain_s": [], "device_s": [], "fields_s": []}, None
    for turn in ("plain", "device", "device", "plain"):
        with plain_event_loops() if turn == "plain" else contextlib.nullcontext():
            (new, stats), wall, _ = synced_s(step)
        got = (stats["n_events"], stats["n_batches"], stats["event_time"])
        if ref is None:
            ref = (got, new.element)
        elif got != ref[0] or not torch.equal(new.element, ref[1]):
            fail(f"{where}: the {turn} loop's batched superstep {got} differs from {ref[0]}")
        out[f"{turn}_s"].append(wall)
        out["fields_s"].append(model.fields_s)
    out.update(events=ref[0][0], batches=ref[0][1])
    for turn in ("plain", "device"):
        with plain_event_loops() if turn == "plain" else contextlib.nullcontext():
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                step()
                torch.cuda.synchronize()
        out[f"profiled_{turn}"] = busy_share(prof)
    print(f"chip_smoke: {where} batched superstep, plain and device loop: " + json.dumps(out))
    return out


def reset_launches(dev, model):
    """Every launch counter to 0 and the model's solve counts as they stand:
    (k_solves, k_iterations) to count a path's own from."""
    from akmc_tpu_torch.ops import dia_matvec as mv
    from akmc_tpu_torch.solvers import dia_cg

    mv.dia_combined_matvec.launches = 0
    dia_cg.dia_cg_solve.launches = 0
    dia_cg.reset_iterations_total(dev.type)
    return model.k_solves, model.k_iterations


def crossbar_launches(dev, model, steps, since, where="crossbar") -> dict:
    """The kernels' launches since ``reset_launches`` (which returned
    ``since``) against the model's count of K solves: one fused CG and one
    matvec (the conductive-vacancy degrees) per solve, those repeated for a
    grown cap too, and the iterations the fused kernel counted on the device
    equal to the model's."""
    from akmc_tpu_torch.ops import dia_matvec as mv
    from akmc_tpu_torch.solvers import dia_cg

    launches = (mv.dia_combined_matvec.launches, dia_cg.dia_cg_solve.launches)
    k_solves = model.k_solves - since[0]
    if k_solves < len(steps):
        fail(f"{k_solves} K solves in {len(steps)} supersteps on the {where}")
    if dev.type == "cuda" and launches != (k_solves, k_solves):
        fail(f"the {where} path launched the DIA kernels {launches} times for {k_solves} K solves")
    cg = model.k_iterations - since[1]
    if dev.type == "cuda" and dia_cg.iterations_total(dev.type) != cg:
        fail(f"the fused solves counted {dia_cg.iterations_total(dev.type)} iterations on the "
             f"device, the model's K solves {cg}")
    if k_solves == len(steps) and cg != sum(r["cg_iterations"] for r in steps):
        fail(f"the K solves ran {cg} iterations, the supersteps report "
             f"{sum(r['cg_iterations'] for r in steps)}")
    grid = dia_cg.dia_cg_solve.last_grid
    return {"dia_launches": launches[0], "dia_cg_launches": launches[1], "k_solves": k_solves,
            "cg_iterations_counted_on_device": dia_cg.iterations_total(dev.type),
            "dia_cg_grid": {"blocks": grid[0], "rows_in_registers": grid[1]} if grid else None}


def batched_summary(rows) -> dict:
    ev, nb = sum(r["events"] for r in rows), sum(r["batches"] for r in rows)
    wall = sum(r["wall_s"] for r in rows)
    loop = wall - sum(r["fields_s"] for r in rows)
    return {"supersteps": len(rows), "events": ev, "batches": nb, "events_per_batch": ev / nb,
            "wall_s_mean": wall / len(rows), "fields_s_mean": (wall - loop) / len(rows),
            "loop_ms_per_batch": 1e3 * loop / nb, "loop_ms_per_event": 1e3 * loop / ev,
            "superstep_ms_per_event": 1e3 * wall / ev,
            "cg_iterations": [r["cg_iterations"] for r in rows]}


def incremental_against_fresh(dev, model, state) -> dict:
    """One serial superstep from ``state`` with the incremental event
    selection and one with the fresh one, each on its own stream from the
    deck's seed: events, the waiting time, CG iterations, the draws used and
    the new state must be equal to the bit."""
    from akmc_tpu_torch.rng import BufferedStream, ReferenceRNG

    runs = {}
    for inc in (False, True):
        model.event_select_incremental = inc
        stream = BufferedStream(ReferenceRNG(model.params.rnd_seed_kmc))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, stats = model.superstep(state, CROSSBAR_VD, stream)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        runs[inc] = (new, stats, time.perf_counter() - t0, stream.peek(4))
    model.event_select_incremental = False
    (a, sa, wa, da), (b, sb, wb, db) = runs[False], runs[True]
    differ = [f.name for f in dataclasses.fields(a)
              if not torch.equal(getattr(a, f.name), getattr(b, f.name))]
    if sa != sb or differ or not np.array_equal(da, db):
        fail(f"incremental selection differs from the fresh one: stats {sb} against {sa}, "
             f"state fields {differ}, next draws equal {np.array_equal(da, db)}")
    print(f"chip_smoke: incremental == fresh selection, one serial superstep: "
          f"{sa['n_events']} events, {wb:.2f} s against {wa:.2f} s")
    return {"bitwise_equal": True, "events": sa["n_events"], "event_time": sa["event_time"],
            "kmc_time": float(b.kmc_time), "fresh_s": wa, "incremental_s": wb,
            "ms_per_event_fresh": 1e3 * wa / sa["n_events"],
            "ms_per_event_incremental": 1e3 * wb / sb["n_events"]}


def batched_crossbar(dev, n_yz: int, depth: int, incremental: bool = False) -> dict:
    """Supersteps of the production path on the full-width crossbar:
    one serial, ``depth`` of each batched kind, one module-timed; with
    ``incremental``, then the three event loops against their plain loops on
    the last state's fields (``loop_turns``), a batched superstep with each
    (``superstep_turns``), and one serial superstep from the initial state
    with the incremental selection and one without
    (``incremental_against_fresh``)."""
    from akmc_tpu_torch.ops.events import GeneratorDraws
    from akmc_tpu_torch.rng import BufferedStream, ReferenceRNG
    from akmc_tpu_torch.state import make_device_state

    p, lat, model, desc, build = crossbar_model(dev, n_yz)
    state = make_device_state(lat, p.background_temp, dev)
    # the kernels against their twins at this path's shapes, before the counts
    # are set to 0: these launches are not the path's
    at_shape = crossbar_kernels(dev, model, state, n_yz) if dev.type == "cuda" else None
    since = reset_launches(dev, model)
    run = CrossbarSteps(dev, model, state, BufferedStream(ReferenceRNG(p.rnd_seed_kmc)),
                        GeneratorDraws.seeded(7, dev))
    run.step("serial")
    for _ in range(depth):
        run.step("batched", mass_eps=1e-3)
    model.pair_f32 = True
    for _ in range(depth):
        run.step("batched production", mass_eps=0.1, clock_f32=True, k_extrap=1.0)
    model.pair_f32 = False
    run.step("timed")
    launches = crossbar_launches(dev, model, run.steps, since)
    steps = run.steps
    out = {
        "n_yz": n_yz, "slots": lat.N, "Vd": CROSSBAR_VD, "model": desc, **build,
        "serial": {k: steps[0][k] for k in ("wall_s", "events", "cg_iterations", "host_syncs")}
        | {"ms_per_event": 1e3 * steps[0]["wall_s"] / steps[0]["events"]},
        "batched_mass_eps_1e-3": batched_summary([r for r in steps if r["kind"] == "batched"]),
        "batched_f32_plane_f32_clocks_mass_eps_0.1_k_extrap_1": batched_summary(
            [r for r in steps if r["kind"] == "batched production"]),
        "module_timed": steps[-1],
        "steps": steps, "kmc_time": run.kmc_times, **launches,
        "kernels_at_this_shape": at_shape,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else None,
    }
    if incremental:
        if dev.type == "cuda":
            fr = model.fields(run.state, CROSSBAR_VD)
            out["loops"] = loop_turns(dev, model, run.state, fr, f"n_yz={n_yz}", 1e-3)
            out["superstep_turns"] = superstep_turns(dev, model, run.state, f"n_yz={n_yz}",
                                                     1e-3)
        out["incremental_selection"] = incremental_against_fresh(dev, model, state)
    return out


def batched_driver(dev, serial_rows) -> dict:
    """Checkpoint and resume through the driver on the n_yz=24 sweep, with the
    serial loop (held against ``serial_rows``, the uninterrupted sweep's
    metrics, and its final snapshot) and with ``batched_events=64``. A
    checkpoint counts supersteps per bias point and this sweep makes one to
    three of them per point, so it is saved after every superstep."""
    from akmc_tpu_torch.lattice import read_xyz
    from akmc_tpu_torch.runtime import driver
    from akmc_tpu_torch.runtime.golden import _final_snapshot

    def rows_of(workdir):
        with open(os.path.join(workdir, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f if line.strip()]
        for r in rows:
            r.pop("superstep_s")
        return rows

    def run(workdir, **kw):
        return driver.run(DECK, workdir=workdir, log=False, synthesize_crossbar=N_YZ,
                          device=dev, **kw)

    shutil.rmtree(BATCHED_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    if serial_rows is None:
        run(WORKDIR)
        serial_rows = rows_of(WORKDIR)
    else:
        serial_rows = [{k: v for k, v in r.items() if k != "superstep_s"} for r in serial_rows]
    stop = len(serial_rows) // 2
    out = {"stopped_after": stop}
    for name, kw in (("serial", {}), ("batched", dict(batched_events=64))):
        workdir = os.path.join(BATCHED_DIR, name)
        if kw:
            whole = os.path.join(BATCHED_DIR, name + "_uninterrupted")
            run(whole, **kw)
        run(workdir, max_supersteps=stop, checkpoint_every=1, **kw)
        run(workdir, resume_from=os.path.join(workdir, "checkpoint.npz"), **kw)
        rows = rows_of(workdir)
        if not kw:
            if rows != serial_rows:
                diff = next((i for i, (a, b) in enumerate(zip(rows, serial_rows)) if a != b),
                            min(len(rows), len(serial_rows)))
                fail(f"the resumed serial sweep's metrics differ from the uninterrupted "
                     f"sweep's at row {diff} ({len(rows)} rows against {len(serial_rows)})")
            a, b = _final_snapshot(workdir), _final_snapshot(WORKDIR)
            with open(a, "rb") as fa, open(b, "rb") as fb:
                if os.path.relpath(a, workdir) != os.path.relpath(b, WORKDIR) or fa.read() != fb.read():
                    fail(f"the resumed serial sweep's final snapshot {a} differs from {b}")
        else:
            for wd in (whole, workdir):
                rws = rows_of(wd)
                first = os.path.join(wd, f"Results_{rws[0]['bias']:.6f}", "snapshot_init.xyz")
                if wd == workdir:      # rewritten by the resumed run: take the other run's
                    first = first.replace(workdir, whole)
                if species_sums(read_xyz(first)[0]) != species_sums(read_xyz(_final_snapshot(wd))[0]):
                    fail(f"the batched sweep in {wd} does not conserve species")
                if not all(r["n_events"] >= 1 and r["done"] and math.isfinite(r["kmc_time"])
                           for r in rws):
                    fail(f"a batched superstep in {wd} fired no event or did not end done")
            if [(r["bias"], r["step"]) for r in rows][:stop] != [
                    (r["bias"], r["step"]) for r in rows_of(whole)][:stop]:
                fail("the interrupted batched sweep's first rows differ from the uninterrupted one's")
        out[name] = {"supersteps": len(rows), "events": sum(r["n_events"] for r in rows)}
        if kw:
            out[name]["batches"] = sum(r["n_batches"] for r in rows)
            out[name]["uninterrupted_events"] = sum(r["n_events"] for r in rows_of(whole))
    out["wall_s"] = time.perf_counter() - t0
    print(f"chip_smoke: driver checkpoint and resume: {json.dumps(out)}")
    return out


def run_batched(dev, widths, serial_rows):
    """(batched line, None): each part fails the run on its own."""
    line = {"replay": batched_replay(dev), "law": batched_law(dev),
            "crossbar": batched_crossbar(dev, widths[0], depth=6, incremental=True)}
    for n_yz in widths[1:]:
        line[f"crossbar_n_yz_{n_yz}"] = batched_crossbar(dev, n_yz, depth=3)
    line["driver"] = batched_driver(dev, serial_rows)
    return line, None


# ---------------------------------------------------------------------------
# phase 7: full physics
# ---------------------------------------------------------------------------
def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b else (0.0 if a == b else math.inf)


@contextlib.contextmanager
def full_physics_probe():
    """Per-superstep readings of the driver's model, taken from outside it:
    after each ``superstep_full`` its ``power_timing`` (the W-block build and
    the power solve, in host seconds ending in a device read; the energy-loop
    bounds; the power CG's iterations) and ``fields_s``; after each
    ``update_cb_edge`` its CG iterations and host time."""
    from akmc_tpu_torch.models.vcm import VCMModel

    steps, cb = [], []
    full, cb_edge = VCMModel.superstep_full, VCMModel.update_cb_edge

    def probed_full(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = full(self, *args, **kwargs)        # ends with a read of its stats
        wall = time.perf_counter() - t0
        timing = dict(self.power_timing)
        marks = timing.pop("device_marks")
        if marks:
            marks[-1].synchronize()
            timing["wkb_build_device_ms"] = marks[0].elapsed_time(marks[1])
            timing["power_solve_device_ms"] = marks[1].elapsed_time(marks[2])
        steps.append({**timing, "fields_s": self.fields_s, "superstep_s": wall})
        return out

    def probed_cb(self, state, Vd):
        t0 = time.perf_counter()
        out = cb_edge(self, state, Vd)
        cb.append({"Vd": Vd, "iterations": self.cb_iterations,
                   "ms": 1e3 * (time.perf_counter() - t0)})
        return out

    VCMModel.superstep_full, VCMModel.update_cb_edge = probed_full, probed_cb
    try:
        yield steps, cb
    finally:
        VCMModel.superstep_full, VCMModel.update_cb_edge = full, cb_edge


def _summarize_steps(steps: list) -> dict:
    """The probe's per-superstep readings, as lists and their sums."""
    def col(k):
        return [r[k] for r in steps]

    wkb, solve = col("wkb_build_s"), col("power_solve_s")
    its = col("iterations")
    device = {}
    if steps and "wkb_build_device_ms" in steps[0]:
        device = {"wkb_build_device_ms": col("wkb_build_device_ms"),
                  "power_solve_device_ms": col("power_solve_device_ms")}
    return {
        **device,
        "wkb_build_ms": [1e3 * v for v in wkb], "ct_loop_bounds": col("ct_loop_bounds"),
        "power_solve_ms": [1e3 * v for v in solve], "power_cg_iterations": its,
        "power_ms_per_iteration": [1e3 * v / k for v, k in zip(solve, its)],
        "fields_ms": [1e3 * v for v in col("fields_s")],
        "superstep_ms": [1e3 * v for v in col("superstep_s")],
        "wkb_build_s_total": sum(wkb), "power_solve_s_total": sum(solve),
    }


def full_model(deck: str, dev, synth_dir=None, pair_table_budget=0.0, **model_kw):
    """The port's model and first state for ``deck`` on the N_YZ crossbar, or
    with ``synth_dir`` on the disordered stand-in's files there, built as the
    driver builds them; no static pair table unless ``pair_table_budget``
    says so (power solves alone need none). ``model_kw`` goes to the model."""
    from akmc_tpu_torch.config import KMCParameters
    from akmc_tpu_torch.lattice import build_lattice
    from akmc_tpu_torch.models.crossbar import mask_null_slots, synthesize_deck_structure
    from akmc_tpu_torch.models.vcm import VCMModel
    from akmc_tpu_torch.rng import ReferenceRNG
    from akmc_tpu_torch.runtime.driver import load_structure
    from akmc_tpu_torch.state import make_device_state, make_substoichiometric

    p = KMCParameters.from_file(deck)
    if synth_dir:
        element, x, y, z = load_structure(p, synth_dir)
    else:
        p, element, x, y, z = synthesize_deck_structure(p, N_YZ)
    element = make_substoichiometric(element, p.initial_vacancy_concentration,
                                     ReferenceRNG(p.rnd_seed))
    lat = build_lattice(element, x, y, z, p)
    if not synth_dir:
        mask_null_slots(lat)
    model = VCMModel(p, lat, device=dev, rate_normalize=True,
                     pair_table_budget=pair_table_budget, **model_kw)
    return model, make_device_state(lat, p.background_temp, dev)


def tolerance_solves(model, state, ref: dict, where: str, current_rtol=None,
                     power_rtol=None) -> dict:
    """One power solve at ref["Vd"] per tolerance multiplier of ``ref``, each
    held to akmc_tpu's (``solves``): I_macro and P_tot within ``current_rtol``
    and ``power_rtol`` (one bound per multiplier), or where those are None
    within akmc_tpu's own band-against-gather spread at that multiplier
    (``solves_gather``), which the line reports beside them."""
    state = model.update_cb_edge(state, ref["Vd"])
    torch.cuda.synchronize()
    out, bad = [], []
    for n, (g, gg) in enumerate(zip(ref["solves"], ref["solves_gather"])):
        scale = g["rtol_scale"]
        t0 = time.perf_counter()
        s, I_macro, _, iters = model.update_power(state, ref["Vd"], rtol_scale=scale)
        P_tot = float(s.power.sum())
        ms = 1e3 * (time.perf_counter() - t0)
        marks = model.power_timing["device_marks"]
        device = {}
        if marks:
            device = {"wkb_build_device_ms": marks[0].elapsed_time(marks[1]),
                      "power_solve_device_ms": marks[1].elapsed_time(marks[2])}
        row = {"rtol_scale": scale, "I_macro": I_macro, "I_macro_akmc_tpu": g["I_macro"],
               "P_tot": P_tot, "P_tot_akmc_tpu": g["P_tot"],
               "power_cg_iterations": iters, "power_cg_iterations_akmc_tpu":
               g["power_cg_iterations"], "ms": ms, **device,
               **{k: v for k, v in model.power_timing.items() if k != "device_marks"},
               "I_macro_rel": _rel(I_macro, g["I_macro"]), "P_tot_rel": _rel(P_tot, g["P_tot"]),
               "I_macro_spread": _rel(gg["I_macro"], g["I_macro"]),
               "P_tot_spread": _rel(gg["P_tot"], g["P_tot"])}
        for key, bound in (("I_macro", current_rtol), ("P_tot", power_rtol)):
            row[key + "_bound"] = row[key + "_spread"] if bound is None else bound[n]
        out.append(row)
        print(f"chip_smoke: {where}: power solve at {ref['Vd']} V, rtol_scale {scale}: "
              f"I_macro {I_macro:.6e} (akmc_tpu {g['I_macro']:.6e}), P_tot {P_tot:.6e} "
              f"({g['P_tot']:.6e}), {iters} iterations ({g['power_cg_iterations']}), {ms:.1f} ms")
        for key in ("I_macro", "P_tot"):
            if not (math.isfinite(row[key]) and row[f"{key}_rel"] <= row[f"{key}_bound"]):
                bad.append(f"{where}, rtol_scale {scale}: {key} {row[key]!r} is "
                           f"{row[key + '_rel']:.3e} relative to akmc_tpu's {g[key]!r}, beyond "
                           f"{row[key + '_bound']:.3e}")
    cb_finite = bool(torch.isfinite(state.cb_edge).all())
    return {"solves": out, "cb_edge_finite": cb_finite, "cb_iterations": model.cb_iterations,
            "problems": bad}


def max_abs_current(ref: dict, got: dict) -> float:
    """The largest |I_macro| difference [A] between two records' supersteps."""
    return max(abs(h["I_macro"] - g["I_macro"])
               for g, h in zip(ref["supersteps"], got["supersteps"]))


def heat_close(got: float, want: float, T0: float) -> bool:
    """A temperature within FULL_POWER_RTOL of akmc_tpu's rise over ``T0``
    plus HEAT_T_ULPS units in the last place of the temperature."""
    return abs(got - want) <= FULL_POWER_RTOL * abs(want - T0) + HEAT_T_ULPS * math.ulp(want)


def heating_part(dev, kind: str, ref: dict) -> dict:
    """Four supersteps of the heating deck copy, stepped as the driver steps a
    full-physics sweep, held to akmc_tpu's: events and final elements exact,
    KMC times within GOLDEN_KMC_RTOL, T_bg and every site temperature within
    ``heat_close``."""
    from akmc_tpu_torch.config import KMCParameters
    from akmc_tpu_torch.rng import BufferedStream, ReferenceRNG
    from akmc_tpu_torch.runtime.synth_deck import write_heating_deck

    deck = write_heating_deck(DECK, os.path.join(FULL_DIR + "_heating", kind), kind)
    p = KMCParameters.from_file(deck)
    model, state = full_model(deck, dev, pair_table_budget=8e9)   # the driver's budget
    stream = BufferedStream(ReferenceRNG(p.rnd_seed_kmc))
    rows, m_warm, last_I = [], None, None
    T0 = p.background_temp
    for Vd, t_bias in zip(p.V_switch, p.t_switch):
        state = model.update_cb_edge(state, Vd)
        kmc_time = 0.0
        state = state.replace(kmc_time=state.kmc_time * 0.0)
        while kmc_time < t_bias and len(rows) < len(ref["supersteps"]):
            rscale = 1e-2 if last_I is not None and abs(last_I) < 1e-9 else 1.0
            state, stats, m_warm = model.superstep_full(state, Vd, stream, m_prev=m_warm,
                                                        rtol_scale=rscale)
            last_I = stats["I_macro"]
            kmc_time += stats["event_time"]
            rows.append({"bias": Vd, "kmc_time": kmc_time, **stats})
        if len(rows) >= len(ref["supersteps"]):
            break
    bad = []
    for i, (g, h) in enumerate(zip(ref["supersteps"], rows)):
        if (g["bias"], g["n_events"]) != (h["bias"], h["n_events"]):
            bad.append(f"heating {kind}, superstep {i}: (bias, events) differ")
        if _rel(h["kmc_time"], g["kmc_time"]) > GOLDEN_KMC_RTOL:
            bad.append(f"heating {kind}, superstep {i}: kmc_time {h['kmc_time']!r} != "
                       f"{g['kmc_time']!r}")
        if not heat_close(h["T_bg"], g["T_bg"], T0):
            bad.append(f"heating {kind}, superstep {i}: T_bg {h['T_bg']!r} != {g['T_bg']!r}")
    elements = "".join(str(int(e)) for e in state.element.cpu().numpy())
    if len(rows) != len(ref["supersteps"]) or elements != ref["final_elements"]:
        bad.append(f"heating {kind}: superstep count or final elements differ")
    temp = state.temperature.cpu().numpy()
    moved = np.nonzero(temp != T0)[0]
    want = np.full_like(temp, T0)         # the golden keeps the entries that moved
    for i, v in ref["temperature_moved"]:
        want[i] = v
    far = [i for i in range(len(temp)) if not heat_close(float(temp[i]), float(want[i]), T0)]
    if far:
        bad.append(f"heating {kind}: {len(far)} site temperatures differ from those of akmc_tpu, "
                   f"first {far[0]}: {temp[far[0]]!r} != {want[far[0]]!r}")
    return {"supersteps": len(rows), "T_bg": [r["T_bg"] for r in rows],
            "T_bg_akmc_tpu": [g["T_bg"] for g in ref["supersteps"]],
            "T_bg_max_abs_dev_vs_akmc_tpu": max(abs(h["T_bg"] - g["T_bg"])
                                                for g, h in zip(ref["supersteps"], rows)),
            "temperature_moved": len(moved),
            "temperature_moved_akmc_tpu": len(ref["temperature_moved"]),
            "temperature_max_abs_dev": float(np.abs(temp - T0).max()),
            "power_cg_iterations": [r["power_cg_iterations"] for r in rows],
            "power_cg_iterations_akmc_tpu": [g["power_cg_iterations"] for g in ref["supersteps"]],
            "problems": bad}


def run_full(dev):
    """(full line, what is wrong with it or None)."""
    from akmc_tpu_torch.runtime import golden, synth_deck

    with open(FULL_GOLDEN) as f:
        gold = json.load(f)
    spread = gold["spread"]["band_vs_gather"]
    parts = gold["parts"]
    problems = []

    # the whole sweep through the driver, held to the golden
    with full_physics_probe() as (steps, cb):
        summary, rows, counts = drive(DECK, FULL_DIR, synthesize_crossbar=N_YZ,
                                      committed_parity=False, dia_pallas=True)
    check_launches("full", summary, rows, counts)
    got = golden.summarize(FULL_DIR)
    dist = golden.distance(gold, got)
    bad = golden.compare(gold, got, GOLDEN_KMC_RTOL, power_rtol=FULL_POWER_RTOL)
    I_abs = max_abs_current(gold, got)
    if I_abs > FULL_CURRENT_ATOL:
        bad.append(f"I_macro {I_abs:.3e} A from the golden, beyond {FULL_CURRENT_ATOL:.1e} A")
    if bad:
        problems.append("full-physics sweep disagrees with the golden: " + "; ".join(bad[:10]))
    with open(os.path.join(FULL_DIR, "output1_0.txt")) as f:
        n_current = sum(line.startswith("Current [uA]: ") for line in f)
    if n_current != len(rows):
        problems.append(f"{n_current} 'Current [uA]' lines for {len(rows)} supersteps")
    line = {
        "deck": "decks/iv_sweep_5nm.txt --synthesize-crossbar 24 --full-physics",
        "supersteps": len(rows), "events": sum(r["n_events"] for r in rows),
        "model": summary["model"], "k_solves": summary["k_solves"],
        "dia_launches": counts["dia_launches"], "dia_cg_launches": counts["dia_cg_launches"],
        "cg_iterations_counted_on_device": counts["cg_iterations_counted_on_device"],
        "kmc_time_max_rel_vs_golden": dist["kmc_time_max_rel"],
        "I_macro_max_rel_vs_golden": dist["I_macro_max_rel"],
        "P_tot_max_rel_vs_golden": dist["P_tot_max_rel"],
        "I_macro_max_abs_vs_golden": I_abs,
        "bounds": {"kmc_rtol": GOLDEN_KMC_RTOL, "P_tot_rtol": FULL_POWER_RTOL,
                   "I_macro_atol": FULL_CURRENT_ATOL},
        "akmc_tpu_band_vs_gather_I_macro_abs": max_abs_current(gold, parts["gather"]),
        "akmc_tpu_band_vs_gather": spread,
        "power_cg_iterations_vs_golden": dist["power_cg_iterations"],
        "I_macro": [r["I_macro"] for r in rows], "P_tot": [r["P_tot"] for r in rows],
        "power_rtol_scale": [r["power_rtol_scale"] for r in rows],
        "cb_edge_solves": cb, **_summarize_steps(steps),
        "superstep_s": [r["superstep_s"] for r in rows],
        "driver_total_s": summary["total_time_s"], "driver_supersteps_s": summary["supersteps_s"],
        "driver_snapshot_s": summary["snapshot_s"],
        "host_syncs": counts["host_syncs"], "host_syncs_per_superstep":
        counts["host_syncs"] / len(rows), "peak_mem_gb": counts["peak_mem_gb"],
        "wall_s": counts["wall_s"],
    }
    print(f"chip_smoke: full sweep: {len(rows)} supersteps, P_tot {dist['P_tot_max_rel']:.3e} "
          f"and I_macro {dist['I_macro_max_rel']:.3e} from the golden (relative)")

    # --wkb-f32: three supersteps, held to akmc_tpu's f32 run within its f32-vs-f64 spread
    f32_ref, f32_spread = parts["wkb_f32"], gold["spread"]["wkb_f32_vs_f64"]
    _, rows32, counts32 = drive(DECK, FULL_DIR + "_wkb_f32", synthesize_crossbar=N_YZ,
                                committed_parity=False, dia_pallas=True, wkb_f32=True,
                                max_supersteps=len(f32_ref["supersteps"]))
    got32 = golden.summarize(FULL_DIR + "_wkb_f32")
    # the golden keeps no final elements of this run: the events are held to the f64 run's
    f32_ref = {**f32_ref, "final_elements": got32["final_elements"]}
    bad32 = golden.compare(f32_ref, got32, GOLDEN_KMC_RTOL,
                           power_rtol=f32_spread["P_tot_max_rel"])
    I_abs32 = max_abs_current(f32_ref, got32)
    if I_abs32 > FULL_CURRENT_ATOL:
        bad32.append(f"I_macro {I_abs32:.3e} A off akmc_tpu's, beyond {FULL_CURRENT_ATOL:.1e} A")
    if [(r["bias"], r["n_events"]) for r in rows32] != [
            (r["bias"], r["n_events"]) for r in rows[: len(rows32)]]:
        bad32.append("the f32 run's events differ from the f64 run's")
    if bad32:
        problems.append("--wkb-f32: " + "; ".join(bad32[:5]))
    d32 = golden.distance(f32_ref, got32)
    line["wkb_f32"] = {"supersteps": len(rows32), "I_macro_max_rel": d32["I_macro_max_rel"],
                       "P_tot_max_rel": d32["P_tot_max_rel"],
                       "I_macro_max_abs": I_abs32,
                       "bounds": {"P_tot_rtol": f32_spread["P_tot_max_rel"],
                                  "I_macro_atol": FULL_CURRENT_ATOL},
                       "akmc_tpu_f32_vs_f64": f32_spread,
                       "dia_launches": counts32["dia_launches"]}

    # one power solve at three tolerances, on the crossbar and on the disordered stand-in
    model, state = full_model(DECK, dev)
    line["tolerances_crossbar"] = tolerance_solves(model, state, parts["rtol"], "crossbar",
                                                   power_rtol=CROSSBAR_SOLVE_POWER_RTOL)
    synth_dir = FULL_DIR + "_synth"
    shutil.rmtree(synth_dir, ignore_errors=True)
    synth = synth_deck.write_synth_deck(DECK, synth_dir, N_YZ)
    model, state = full_model(synth, dev, synth_dir=synth_dir)
    line["tolerances_disordered"] = tolerance_solves(
        model, state, parts["synth_rtol"], "disordered stand-in",
        current_rtol=(STANDIN_SOLVE_CURRENT_RTOL,) * 3, power_rtol=(STANDIN_SOLVE_POWER_RTOL,) * 3)
    del model, state
    for key in ("tolerances_crossbar", "tolerances_disordered"):
        problems += line[key].pop("problems")

    # three supersteps of the stand-in through the driver, tunneling live
    ref = parts["synth_sweep"]
    with full_physics_probe() as (steps_s, cb_s):
        _, rows_s, counts_s = drive(synth, synth_dir + "_out", committed_parity=False,
                                    max_supersteps=len(ref["supersteps"]))
    got_s = golden.summarize(synth_dir + "_out")
    spread_s = gold["spread"]["synth_sweep_band_vs_gather"]
    bad_s = golden.compare(ref, got_s, SYNTH_KMC_RTOL, current_rtol=spread_s["I_macro_max_rel"],
                           power_rtol=STANDIN_STEP_POWER_RTOL)
    if counts_s["dia_launches"] or counts_s["dia_cg_launches"]:
        bad_s.append(f"a DIA kernel was launched on the disordered path: {counts_s}")
    if bad_s:
        problems.append("disordered full-physics supersteps: " + "; ".join(bad_s[:5]))
    d_s = golden.distance(ref, got_s)
    line["disordered_supersteps"] = {
        "supersteps": len(rows_s), "I_macro": [r["I_macro"] for r in rows_s],
        "I_macro_max_rel": d_s["I_macro_max_rel"], "P_tot_max_rel": d_s["P_tot_max_rel"],
        "kmc_time_max_rel": d_s["kmc_time_max_rel"],
        "power_cg_iterations_vs_golden": d_s["power_cg_iterations"],
        "bounds": {"I_macro_rtol": spread_s["I_macro_max_rel"],
                   "P_tot_rtol": STANDIN_STEP_POWER_RTOL},
        "akmc_tpu_band_vs_gather": spread_s,
        "cb_edge_solves": cb_s, **_summarize_steps(steps_s),
        "host_syncs_per_superstep": counts_s["host_syncs"] / len(rows_s),
        "peak_mem_gb": counts_s["peak_mem_gb"],
    }

    # the two heat models, four supersteps each
    for kind in ("global", "local"):
        h = heating_part(dev, kind, parts["heating_" + kind])
        problems += h.pop("problems")
        line["heating_" + kind] = h
    return line, "; ".join(problems) or None


# ---------------------------------------------------------------------------
# phase 8: the rest of the driver
# ---------------------------------------------------------------------------
def _rows_but_time(workdir: str) -> list:
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    for r in rows:
        r.pop("superstep_s")
    return rows


def _log_but_time(workdir: str) -> list:
    """output1_0.txt without its timing values and without the warmup line."""
    import re

    with open(os.path.join(workdir, "output1_0.txt")) as f:
        lines = f.read().splitlines()
    return [re.sub(r"[-+.0-9e]+$", "", ln) if ln.startswith("Z - calculation time") else ln
            for ln in lines if not ln.startswith("AOT warmup:")]


def _first_difference(a: list, b: list) -> str:
    i = next((i for i, (u, v) in enumerate(zip(a, b)) if u != v), min(len(a), len(b)))
    return f"row {i} of {len(a)} against {len(b)}"


def _launches_of(counts: dict, summary: dict) -> dict:
    return {"dia_launches": counts["dia_launches"], "dia_cg_launches": counts["dia_cg_launches"],
            "k_solves": summary["k_solves"]}


@contextlib.contextmanager
def lists_never_built():
    """Building the port's neighbor lists raises inside the block: a run in
    it must read its lists from the cache."""
    from akmc_tpu_torch import lattice

    def refuse(*args, **kwargs):
        raise AssertionError("the neighbor lists were built, not read from the cache")

    built = lattice.build_neighbor_list
    lattice.build_neighbor_list = refuse
    try:
        yield
    finally:
        lattice.build_neighbor_list = built


def run_driver(dev, sweep_rows):
    """(driver line, what is wrong with it or None): the deck modes and the
    options the port gained last, each through ``runtime.driver.run`` on the
    card (see the module docstring, phase 8)."""
    from akmc_tpu_torch.rng import BufferedStream, ReferenceRNG
    from akmc_tpu_torch.runtime import golden, profiling, synth_deck

    shutil.rmtree(DRIVER_DIR, ignore_errors=True)
    with open(MODES_GOLDEN) as f:
        gold = json.load(f)
    problems, line, launches = [], {}, {}
    with open(DECK) as f:
        template = f.read()

    # fields only: the whole sweep, two passes per bias point
    deck = synth_deck.write_mode_deck(DECK, DRIVER_DIR, "fields_only")
    wd = os.path.join(DRIVER_DIR, "fields_only")
    summary, rows, counts = drive(deck, wd, synthesize_crossbar=N_YZ, dia_pallas=True)
    check_launches("fields-only", summary, rows, counts)
    launches["fields_only"] = _launches_of(counts, summary)
    ref, spread = gold["fields_only"], gold["spread"]
    got = golden.summarize(wd)
    bad = golden.compare(ref, got, 0.0)       # KMC times are 0 and t_switch: exact
    cg_diff = max(abs(g["cg_iterations"] - h["cg_iterations"])
                  for g, h in zip(ref["supersteps"], got["supersteps"]))
    if cg_diff > spread["cg_iterations_max_abs"]:
        bad.append(f"a pass's CG count is {cg_diff} from the golden's, akmc_tpu's own spread "
                   f"{spread['cg_iterations_max_abs']}")
    pot = golden.potential_distance(ref["potentials"], golden.potentials(wd))
    for key, bound in (("abs_sum_max_rel", FIELDS_POT_SUM_RTOL),
                       ("final_max_abs", spread["final_max_abs"])):
        if not pot[key] <= bound:
            bad.append(f"potentials: {key} {pot[key]:.3e} beyond {bound:.3e}")
    if bad:
        problems.append("fields-only sweep: " + "; ".join(bad[:5]))
    line["fields_only"] = {
        "passes": len(rows), "k_solves": summary["k_solves"],
        "cg_per_pass": [r["cg_iterations"] for r in rows],
        "cg_max_abs_vs_golden": cg_diff, "potentials_vs_golden": pot,
        "bounds": {"cg_iterations_max_abs": spread["cg_iterations_max_abs"],
                   "abs_sum_max_rel": FIELDS_POT_SUM_RTOL, "final_max_abs": spread["final_max_abs"]},
        "akmc_tpu_pallas_vs_xla": {k: spread[k] for k in
                                   ("cg_iterations_max_abs", "abs_sum_max_rel", "final_max_abs")},
        "superstep_s": [r["superstep_s"] for r in rows],
        "driver_total_s": summary["total_time_s"], "driver_snapshot_s": summary["snapshot_s"],
        "host_syncs_per_pass": counts["host_syncs"] / len(rows), **launches["fields_only"],
    }

    # events only, on the stale (zero) potential: no K solve, no kernel
    deck = synth_deck.write_mode_deck(DECK, DRIVER_DIR, "events_only")
    wd = os.path.join(DRIVER_DIR, "events_only")
    summary, rows, counts = drive(deck, wd, synthesize_crossbar=N_YZ, max_supersteps=N_SWEEP)
    launches["events_only"] = _launches_of(counts, summary)
    if any(launches["events_only"].values()):
        problems.append(f"the events-only sweep solved or launched: {launches['events_only']}")
    ref = gold["events_only"]
    got = golden.summarize(wd)
    bad = golden.compare(ref, got, EVENTS_KMC_RTOL)
    if bad:
        problems.append("events-only sweep: " + "; ".join(bad[:5]))
    line["events_only"] = {
        "supersteps": len(rows), "events": sum(r["n_events"] for r in rows),
        "kmc_time_max_rel_vs_golden": golden.distance(ref, got)["kmc_time_max_rel"],
        "kmc_rtol": EVENTS_KMC_RTOL, "superstep_s": [r["superstep_s"] for r in rows],
        "host_syncs_per_superstep": counts["host_syncs"] / len(rows), **launches["events_only"],
    }

    # --steps-per-dispatch on the sweep: a bias point runs whole batches, so
    # it passes t_switch by up to k - 1 supersteps; up to the first bias
    # point's last single-step superstep the rows are the sweep phase's
    if sweep_rows is None:
        drive(DECK, WORKDIR, synthesize_crossbar=N_YZ, dia_pallas=True)
        sweep_rows = _rows_but_time(WORKDIR)
    else:
        sweep_rows = [{k: v for k, v in r.items() if k != "superstep_s"} for r in sweep_rows]
    wd = os.path.join(DRIVER_DIR, "sweep_spd")
    summary, rows, counts = drive(DECK, wd, synthesize_crossbar=N_YZ, dia_pallas=True,
                                  steps_per_dispatch=SPD)
    check_launches("--steps-per-dispatch sweep", summary, rows, counts)
    launches["sweep_steps_per_dispatch"] = _launches_of(counts, summary)
    rows = _rows_but_time(wd)
    first = sweep_rows[: next((i for i, r in enumerate(sweep_rows)
                               if r["bias"] != sweep_rows[0]["bias"]), len(sweep_rows))]
    steps_per_point = []
    for r in rows:
        if r["step"] == 1:
            steps_per_point.append(0)
        steps_per_point[-1] += 1
    if rows[: len(first)] != first:
        problems.append("the --steps-per-dispatch sweep's first rows differ from the sweep's: "
                        + _first_difference(rows, first))
    if any(n % SPD for n in steps_per_point) or len(steps_per_point) != 15:
        problems.append(f"the --steps-per-dispatch sweep ran {steps_per_point} supersteps "
                        f"per bias point, not whole batches of {SPD} at 15 points")
    line["sweep_steps_per_dispatch"] = {
        "k": SPD, "supersteps": len(rows), "supersteps_per_bias_point": steps_per_point,
        "rows_equal_to_sweep": len(first), **launches["sweep_steps_per_dispatch"],
    }

    # --steps-per-dispatch against single steps where neither overshoots: the
    # sweep's deck with t_switch long enough that max_supersteps ends the run
    long_deck = synth_deck.write_deck_copy(
        template, {"t_switch": " ".join(["1e3"] * 15)}, os.path.join(DRIVER_DIR, "deck_long.txt"))
    pair = {}
    for name, extra, depth in (("serial", {}, N_SWEEP),
                               ("full", dict(committed_parity=False, power_rtol_scale="1.0"), SPD)):
        runs = []
        for k in (1, SPD):
            wd = os.path.join(DRIVER_DIR, f"long_{name}_k{k}")
            summary, rows_k, counts = drive(long_deck, wd, synthesize_crossbar=N_YZ,
                                            dia_pallas=True, max_supersteps=depth,
                                            steps_per_dispatch=k, **extra)
            check_launches(f"--steps-per-dispatch {k} ({name})", summary, rows_k, counts)
            runs.append((_rows_but_time(wd), summary, counts, rows_k))
        (rows1, _, _, raw1), (rowsk, summary_k, counts_k, rawk) = runs
        if rowsk != rows1 or len(rowsk) != depth:
            problems.append(f"--steps-per-dispatch {SPD} ({name}) differs from single supersteps: "
                            + _first_difference(rowsk, rows1))
        launches[f"{name}_steps_per_dispatch"] = _launches_of(counts_k, summary_k)
        pair[name] = {"supersteps": len(rowsk), "events": sum(r["n_events"] for r in rowsk),
                      "cg_iterations": sum(r["cg_iterations"] for r in rowsk),
                      "sum_superstep_s_single": sum(r["superstep_s"] for r in raw1),
                      "sum_superstep_s_batched": sum(r["superstep_s"] for r in rawk),
                      **launches[f"{name}_steps_per_dispatch"]}
    line["steps_per_dispatch_vs_single"] = pair

    # --warmup on three full-physics supersteps: the same output, and the
    # first superstep's wall time with and without it (a reading)
    warm = {}
    for flag in (True, False):
        wd = os.path.join(DRIVER_DIR, f"full_warmup_{flag}")
        summary, rows_w, counts = drive(DECK, wd, synthesize_crossbar=N_YZ, dia_pallas=True,
                                        committed_parity=False, max_supersteps=3, warmup=flag)
        check_launches(f"--warmup {flag}", summary, rows_w, counts)
        with open(os.path.join(wd, "output1_0.txt")) as f:
            aot = [ln for ln in f.read().splitlines() if ln.startswith("AOT warmup:")]
        warm[flag] = {"first_superstep_s": rows_w[0]["superstep_s"],
                      "superstep_s": [r["superstep_s"] for r in rows_w],
                      "aot_line": aot[0] if aot else None, **_launches_of(counts, summary)}
    if _log_but_time(os.path.join(DRIVER_DIR, "full_warmup_True")) != _log_but_time(
            os.path.join(DRIVER_DIR, "full_warmup_False")) or _rows_but_time(
            os.path.join(DRIVER_DIR, "full_warmup_True")) != _rows_but_time(
            os.path.join(DRIVER_DIR, "full_warmup_False")):
        problems.append("--warmup changed the full-physics output")
    if not warm[True]["aot_line"] or warm[False]["aot_line"]:
        problems.append(f"the 'AOT warmup:' line is wrong: {warm[True]['aot_line']!r}, "
                        f"{warm[False]['aot_line']!r}")
    launches["warmup"] = {k: warm[True][k] for k in ("dia_launches", "dia_cg_launches", "k_solves")}
    line["warmup"] = {"with": warm[True], "without": warm[False]}

    # the disordered stand-in: --cache-dir twice, the second run reading the file
    synth_dir = os.path.join(DRIVER_DIR, "synth")
    synth = synth_deck.write_synth_deck(DECK, synth_dir, N_YZ)
    cache = os.path.join(DRIVER_DIR, "cache")
    cached = []
    for i in range(2):
        wd = os.path.join(DRIVER_DIR, f"cache_run{i}")
        with lists_never_built() if i else contextlib.nullcontext():
            summary, rows_c, counts = drive(synth, wd, cache_dir=cache, max_supersteps=3)
        files = sorted(os.listdir(cache))
        cached.append({"lattice_s": summary["lattice_s"], "files": files,
                       "rows": _rows_but_time(wd),
                       "snapshot": open(golden._final_snapshot(wd), "rb").read()})
    if cached[0]["files"] != cached[1]["files"] or len(cached[0]["files"]) != 1:
        problems.append(f"the cache holds {cached[1]['files']} after two runs")
    if cached[0]["rows"] != cached[1]["rows"] or cached[0]["snapshot"] != cached[1]["snapshot"]:
        problems.append("the run that read the list cache differs from the one that wrote it")
    line["cache_dir"] = {"lattice_s_built": cached[0]["lattice_s"],
                         "lattice_s_read": cached[1]["lattice_s"], "file": cached[0]["files"],
                         "supersteps": len(cached[0]["rows"])}

    # the stand-in: superstep_multi with the carried residual and without,
    # from one state, 3 x 4 supersteps
    model, state0 = full_model(synth, dev, synth_dir=synth_dir, pair_table_budget=8e9)
    multi = {}
    for flag in (False, True):
        model.k_carry_residual = flag
        state, stream = state0, BufferedStream(ReferenceRNG(model.params.rnd_seed_kmc))
        evs, cgs, wall = [], [], []
        for _ in range(3):
            t0 = time.perf_counter()
            state, stats = model.superstep_multi(state, 2.0, stream, k=SPD)
            wall.append(time.perf_counter() - t0)
            evs += [s["n_events"] for s in stats]
            cgs += [s["cg_iterations"] for s in stats]
        multi[flag] = (evs, cgs, state, wall)
    (e0, c0, s0, w0), (e1, c1, s1, w1) = multi[False], multi[True]
    if (e0, c0) != (e1, c1) or not torch.equal(s0.element, s1.element) or float(
            s0.kmc_time) != float(s1.kmc_time):
        problems.append(f"the carried residual changed the stand-in's trajectory: events "
                        f"{e0} / {e1}, CG {c0} / {c1}")
    line["carried_residual"] = {
        "model": model.describe(), "events": e1, "cg_iterations": c1,
        "kmc_time": float(s1.kmc_time), "batch_s_fresh": w0, "batch_s_carried": w1,
        "potential_boundary_max_abs_diff": float((s0.potential_boundary - s1.potential_boundary)
                                                 .abs().max()),
    }

    # profiling.trace around one superstep
    trace_dir = os.path.join(DRIVER_DIR, "trace")
    with profiling.trace(trace_dir):       # a warm superstep: one CG iteration
        profiling.pull_sync(model.superstep(s1, 2.0, BufferedStream(
            ReferenceRNG(model.params.rnd_seed_kmc))))
    traces = [os.path.join(trace_dir, n) for n in os.listdir(trace_dir)]
    sizes = [os.path.getsize(t) for t in traces]
    if len(traces) != 1 or not sizes[0]:
        problems.append(f"profiling.trace wrote {list(zip(traces, sizes))}")
    line["trace"] = {"files": len(traces), "bytes": sizes}
    line["device_memory_stats"] = profiling.device_memory_stats()
    line["launches"] = launches
    del model, state0, s0, s1
    return line, "; ".join(problems) or None


def _final_potentials_finite(workdir: str) -> bool:
    from akmc_tpu_torch.runtime.golden import _final_snapshot

    with open(_final_snapshot(workdir)) as f:
        vals = [float(ln.split()[4]) for ln in f.read().splitlines()[2:] if ln.strip()]
    return bool(vals) and all(math.isfinite(v) for v in vals)


# ----------------------------------------------------------------------
# sharded: scale-out over torch.distributed, the ranks sharing this card over
# gloo (NCCL refuses two ranks on one card)
# ----------------------------------------------------------------------
SHARDED_DIR = os.path.join(HERE, "build", "chip_smoke", "sharded")
SHARDED_BATCHED_N_YZ = 64            # 409,600 slots
SHARDED_BATCHED_STEPS = 3
SHARDED_FULL_STEPS = 4
SHARDED_SYNTH_STEPS = 3
SHARDED_CONCERN_STEPS = 3
HARNESS_K_N = 100_000
HARNESS_T_N, HARNESS_T_SUB = 102_722, 14_854   # the reference's instance (cg_harness.py)
HARNESS_RTOL = 1e-8
HARNESS_ITER_SLACK = 2
# the T-class solve's stop coefficient: at akmc_tpu's default 1e-14 the stop
# rule (relative to ||b||) leaves a solution error near 1e-6 on the
# reference's instance (one rank and four alike), which the dense subblock's
# conditioning sets; the check solves the same system to 1e-17 as well
HARNESS_T_RTOL_COEFF = 1e-17
# a rank's share of a sharded table may exceed total / ranks by its rounding
# to whole rows, chunks or blocks
SHARE_SLACK = 1.1
# tests/test_sharding.py's tolerances (akmc_tpu's sharded against one device)
SHARDED_T_BG_RTOL = 1e-12
SHARDED_KMC_RTOL = 1e-9
# Sharded against one rank where the ranks add in another order: full physics
# (W_ct's column sums and W_ct^T v_c added over ranks in rank order) and the
# disordered stand-in (torch.bmm over a rank's band blocks). An H100 80GB HBM3
# at 700 W read the same in every run: full physics I_macro 3.90e-16 A apart
# (3.3e-3 relative: each current there is a power-CG stopping point below
# 5e-12 A, so tests/test_sharding.py's rtol 1e-5 cannot hold), P_tot 2.87e-7
# (past its 1e-8), power-CG counts and KMC times equal; the stand-in's KMC
# times 1.98e-7 with equal CG counts. Each bound is its reading with room.
SHARDED_I_MACRO_ATOL = 1e-15
SHARDED_P_TOT_RTOL = 1e-6
SHARDED_SYNTH_KMC_RTOL = 1e-6


def window_library(slab, offsets, val_low, val_high, row0, n, dev):
    """The row window's function as one PyTorch sparse product: the CSR rows
    [row0, row0 + R) of [[W, 0], [0, adjacency]] against [x; xv]."""
    D, rows = slab.shape
    c = slab.cpu().numpy()
    d_idx, r = np.nonzero(c)
    cols = r + row0 + offsets.cpu().numpy()[d_idx]
    keep = (cols >= 0) & (cols < n)
    d_idx, r, cols = d_idx[keep], r[keep], cols[keep]
    w = np.where(c[d_idx, r] == 2, val_high, val_low)
    all_rows = np.concatenate([r, r + rows])
    all_cols = np.concatenate([cols, cols + n])
    vals = np.concatenate([w, np.ones_like(w)])
    order = np.lexsort((all_cols, all_rows))
    crow = np.zeros(2 * rows + 1, np.int64)
    np.cumsum(np.bincount(all_rows, minlength=2 * rows), out=crow[1:])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            torch.from_numpy(crow), torch.from_numpy(all_cols[order]),
            torch.from_numpy(vals[order]), size=(2 * rows, 2 * n), dtype=torch.float64,
        ).to(dev)


def window_bound(slab, offsets, row0, n) -> dict:
    """The least time of one row-window matvec: the window's codes, the reach
    of x and xv its rows read, the two outputs; 2 flops per nonzero code and
    3 per row."""
    D, rows = slab.shape
    offs = offsets.tolist()
    reach = min(n, row0 + rows + max(offs)) - max(0, row0 + min(offs))
    nnz = int((slab != 0).sum())
    n_bytes = D * rows + D * 8 + 2 * reach * 8 + 2 * rows * 8
    n_ops = 2 * nnz + 3 * rows
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / F64_FLOP_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "shape": {"D": D, "rows": rows, "row0": row0, "N": n, "nnz": nnz,
                      "bytes": n_bytes, "ops": n_ops}}


def check_row_window(dev, operators) -> dict:
    """The row-window matvec against its twin (the full-N twin's rows, and the
    twin on the slab) at the first, a middle and the last rank's window of
    each split, bit for bit; then timed on the middle window of the last
    split of the first operator beside the twin and a sparse product."""
    from akmc_tpu_torch.ops import dia_matvec as mv
    from akmc_tpu_torch.parallel.mesh import Mesh
    from akmc_tpu_torch.solvers.dia_cg import CHUNK

    rng = np.random.default_rng(8)
    checked, timing = [], None
    for label, diags, offsets, lo, hi, splits in operators:
        D, n = diags.shape
        offs = offsets.tolist()
        x = torch.tensor(rng.standard_normal(n) * np.exp(rng.standard_normal(n)), device=dev)
        xv = torch.where(torch.tensor(rng.random(n) < 0.05, device=dev), x, 0.0)
        yf, vf = mv.dia_combined_matvec_plain(diags, offs, lo, hi, x, xv)
        for size in splits:
            ranges = Mesh(0, size, dev, "gloo").split(n, CHUNK)
            for r in sorted({0, size // 2, size - 1}):
                r0, r1 = ranges[r]
                slab = diags[:, r0:r1].clone()          # an array of its own, as a rank holds it
                op = mv.DiaOperator(slab, offsets, lo, hi, row0=r0, n=n)
                y, v = op.matvec(x, xv)
                y0, v0 = mv.dia_combined_matvec_plain(slab, offs, lo, hi, x, xv, row0=r0)
                torch.cuda.synchronize()
                err = max(float((y - y0).abs().max()), float((v - v0).abs().max()))
                if not (torch.equal(y, y0) and torch.equal(v, v0)
                        and torch.equal(y, yf[r0:r1]) and torch.equal(v, vf[r0:r1])):
                    fail(f"row-window kernel is not bit-equal to its twin on {label}, "
                         f"{size} ranks, rank {r} [{r0}, {r1}) (max abs {err:.3e})")
                checked.append({"operator": label, "ranks": size, "rank": r,
                                "rows": [r0, r1], "max_abs_err": err})
                if timing is None and size == splits[-1] and r == size // 2:
                    timing = (label, slab, offsets, lo, hi, r0, n, x, xv, op)
        print(f"chip_smoke: row-window matvec == twin on {label} (D={D}, N={n}), "
              f"splits {splits}")
    label, slab, offsets, lo, hi, r0, n, x, xv, op = timing
    offs = offsets.tolist()
    lib = window_library(slab, offsets, lo, hi, r0, n, dev)
    xcat = torch.cat([x, xv])
    yl = lib @ xcat
    y, v = op.matvec(x, xv)
    lib_err = float((yl - torch.cat([y, v])).abs().max() / torch.cat([y, v]).abs().max())
    if lib_err > MATVEC_RTOL:
        fail(f"the window's library yardstick computes another function ({lib_err:.3e})")
    out = torch.empty((2, slab.shape[1]), dtype=torch.float64, device=dev)
    calls = {
        "kernel": lambda: op.matvec(x, xv, out=out),
        "plain": lambda: mv.dia_combined_matvec_plain(slab, offs, lo, hi, x, xv, row0=r0),
        "library": lambda: lib @ xcat,
    }
    call_ms = {k: cuda_time_ms(f, reps=50 if k == "plain" else 1000) for k, f in calls.items()}
    dev_ms = {k: device_ms(f) for k, f in calls.items()}
    times = {k: dev_ms[k] if dev_ms[k] is not None else call_ms[k] for k in calls}
    bound = window_bound(slab, offsets, r0, n)
    return {
        "checked": checked, "bitwise_equal_to_twin": True,
        "max_abs_err": max(c["max_abs_err"] for c in checked),
        "timed_on": label, "ms": times["kernel"], "plain_ms": times["plain"],
        "library_ms": times["library"], "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"], "shape": bound["shape"], "call_ms": call_ms,
        "time_source": "profiler device time" if dev_ms["kernel"] is not None else "CUDA events",
        "library": "torch.sparse_csr_tensor @ vector on the window's rows",
    }


def _reset_counts():
    from akmc_tpu_torch.ops import dia_matvec as mv
    from akmc_tpu_torch.solvers import dia_cg

    mv.dia_combined_matvec.launches = 0
    dia_cg.dia_cg_solve.launches = 0
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()


def _rank_counts(summary=None) -> dict:
    from akmc_tpu_torch.ops import dia_matvec as mv
    from akmc_tpu_torch.solvers import dia_cg

    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
    out = {"row_window_launches": mv.dia_combined_matvec.launches,
           "dia_cg_launches": dia_cg.dia_cg_solve.launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None}
    if summary is not None:
        out.update({k: summary[k] for k in ("k_solves", "k_iterations", "replica_checks",
                                            "held_bytes")})
    return out


def _sharded_drive(mesh, workdir, deck=DECK, **options):
    """The driver on this rank of ``mesh``, the counts set to 0 just before and
    read just after; rank 0 adds the run's record (``runtime/golden.py``)."""
    from akmc_tpu_torch.runtime import driver, golden

    if mesh.rank == 0:
        shutil.rmtree(workdir, ignore_errors=True)
    mesh.barrier()
    _reset_counts()
    t0 = time.perf_counter()
    summary = driver.run_on_mesh(mesh, deck, workdir=workdir, log=False, **options)
    counts = _rank_counts(summary)
    out = {"wall_s": time.perf_counter() - t0, **counts}
    if mesh.rank == 0:
        out["record"] = golden.summarize(workdir)
        with open(os.path.join(workdir, "metrics.jsonl")) as f:
            out["rows"] = [json.loads(ln) for ln in f if ln.strip()]
        with open(os.path.join(workdir, "output1_0.txt")) as f:
            out["mesh_lines"] = [ln.strip() for ln in f if ln.startswith(
                ("Mesh padding:", "Device mesh:", "Concern groups:"))]
    return out


def _sharded_batched(mesh):
    """Item 3: the production event path at 409,600 slots on this rank."""
    from akmc_tpu_torch.models.crossbar import build_grid_crossbar
    from akmc_tpu_torch.models.vcm import VCMModel
    from akmc_tpu_torch.ops.events import GeneratorDraws
    from akmc_tpu_torch.parallel.mesh import check_replicas, replicate_state, shard_model
    from akmc_tpu_torch.state import make_device_state

    p, lat = build_grid_crossbar(n_yz=SHARDED_BATCHED_N_YZ, contact_slices=10, oxide_slices=22,
                                 ti_slices=8, defect_fraction=0.1, vacancy_concentration=0.05,
                                 seed=0)
    dev = mesh.device if mesh is not None else (
        torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available()
        else torch.device("cpu"))
    _reset_counts()
    model = VCMModel(p, lat, device=dev, rate_normalize=True)
    state = make_device_state(lat, p.background_temp, dev)
    if mesh is not None:
        shard_model(model, mesh)
        state = replicate_state(state, mesh)
    draws = GeneratorDraws.seeded(7, dev)
    stats, pb_prev2 = [], None
    t0 = time.perf_counter()
    for _ in range(SHARDED_BATCHED_STEPS):
        pb = state.potential_boundary
        state, st = model.superstep_native_batched(state, CROSSBAR_VD, draws, batch=64,
                                                   mass_eps=1e-3, pb_prev2=pb_prev2)
        pb_prev2 = pb
        check_replicas(state, mesh)
        stats.append({k: st[k] for k in ("n_events", "n_batches", "cg_iterations",
                                         "n_cut_conflict", "n_cut_mass")})
    counts = _rank_counts()
    out = {"wall_s": time.perf_counter() - t0, "stats": stats, "describe": model.describe(),
           "kmc_time": float(state.kmc_time), **counts,
           "k_solves": model.k_solves, "k_iterations": model.k_iterations,
           "held_bytes": model.held_bytes()}
    if mesh is None or mesh.rank == 0:
        out["element"] = state.element.cpu().numpy()
        out["charge"] = state.charge.cpu().numpy()
    return out


def _concern_fields(mesh, ratio):
    """Item 5's fields: ``ConcernGroups.fields`` on the sweep's first state at
    the deck's first bias, and (rank 0) the sequential ``_fields`` of a second,
    unsharded model on the same state."""
    from akmc_tpu_torch.parallel.mesh import ConcernGroups

    model, state = full_model(DECK, mesh.device, pair_table_budget=8e9)
    Vd = float(model.params.V_switch[0])
    groups = ConcernGroups(model, mesh, ratio=ratio)
    charge, pot_b, pot_sum, cg, *_ = groups.fields(
        state.element, state.charge, state.potential_boundary, state.T_bg, Vd)
    out = {"groups": [groups.mesh_k.ranks, groups.mesh_pair.ranks]}
    if mesh.rank == 0:
        ref, _ = full_model(DECK, mesh.device, pair_table_budget=8e9)
        fr = ref._fields_grown(state, Vd)
        out.update(
            charge_equal=bool(torch.equal(charge, fr.charge)),
            pot_b_equal=bool(torch.equal(pot_b, fr.potential_boundary)),
            pot_sum_equal=bool(torch.equal(pot_sum, fr.potential_sum)),
            cg=(cg, fr.cg_iterations),
            pot_sum_max_abs_diff=float((pot_sum - fr.potential_sum).abs().max()),
        )
        del ref
    del model
    return out


def _harness(mesh, klass):
    from akmc_tpu_torch.solvers import cg_harness

    if klass == "K":
        return cg_harness._solve(mesh, None, HARNESS_K_N, 1e8, 1e-14)
    return cg_harness._solve(mesh, None, HARNESS_T_N, 1e8, HARNESS_T_RTOL_COEFF,
                             n_sub=HARNESS_T_SUB, more_rtol=(1e-14,))


def sharded_rank(mesh, parts):
    """What each rank of the sharded phase runs, part by part: {part: this
    rank's readings}. Every rank runs the same parts in the same order."""
    import_port()
    out = {}
    for name, kw in parts:
        t0 = time.perf_counter()
        if name.startswith("sweep") or name.startswith("concern_run") or name in (
                "full", "synth"):
            out[name] = _sharded_drive(mesh, **kw)
        elif name == "batched":
            out[name] = _sharded_batched(mesh)
        elif name.startswith("concern_fields"):
            out[name] = _concern_fields(mesh, **kw)
        elif name.startswith("harness"):
            out[name] = _harness(mesh, **kw)
        else:
            raise ValueError(name)
        out[name]["part_s"] = time.perf_counter() - t0
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return out


def _strip_rows(rows):
    """Metrics rows without their host times."""
    return [{k: v for k, v in r.items() if k != "superstep_s"} for r in rows]


def _share_ok(per_rank: list, total: int, ranks: int) -> bool:
    return max(per_rank) <= SHARE_SLACK * total / ranks + 4096


def run_sharded(dev, sweep_rows, sweep_held, device=None, backend="gloo"):
    """(sharded line, what is wrong with it or None). By default the ranks
    share this card over gloo and every part runs. With ``device="cuda"`` and
    ``backend="nccl"`` (``--only nccl``: a card per rank, on a machine with
    several cards) only the sweep and the batched path run, on 2 and on 4
    ranks as far as there are cards, under the same checks; its times are the
    port's only readings on several cards. ``sweep_rows`` and ``sweep_held``
    are the sweep phase's metrics rows and held bytes, or None."""
    from akmc_tpu_torch.lattice import ELEM, metal_mask
    from akmc_tpu_torch.models.crossbar import build_grid_crossbar, grid_dia_k
    from akmc_tpu_torch.parallel.launch import spawn
    from akmc_tpu_torch.runtime import golden, synth_deck
    from akmc_tpu_torch.solvers import cg_harness

    nccl = backend == "nccl"
    cards = torch.cuda.device_count()
    if nccl and cards < 2:
        fail("the nccl phase needs at least two cards")
    problems, line = [], {"backend": backend, "cards": cards if nccl else 1}
    os.makedirs(SHARDED_DIR, exist_ok=True)

    dia24, meta24, _, _ = crossbar_dia(N_YZ)
    if not nccl:
        # 1. the row-window kernel against its twin
        pb, latb = build_grid_crossbar(n_yz=SHARDED_BATCHED_N_YZ, contact_slices=10,
                                       oxide_slices=22, ti_slices=8, defect_fraction=0.1,
                                       vacancy_concentration=0.05, seed=0)
        n_yz_g, nx_g, a_g = latb.grid
        diab, metab = grid_dia_k(n_yz_g, nx_g, a_g, pb.nn_dist,
                                 metal_mask(latb.element0, pb.metals),
                                 pb.num_atoms_first_layer, pb.high_G, pb.low_G,
                                 np.stack([latb.x, latb.y, latb.z], 1),
                                 null_mask=latb.element0 == int(ELEM.NULL_ELEMENT))
        del latb
        line["row_window"] = check_row_window(dev, [
            ("n_yz=24 crossbar", dia24.diags.to(dev), dia24.offsets.to(dev), meta24.val_low,
             meta24.val_high, (2, 4)),
            ("n_yz=64 crossbar", diab.diags.to(dev), diab.offsets.to(dev), metab.val_low,
             metab.val_high, (4,)),
        ])
        del diab

    # one-rank references
    refs = {}
    t0 = time.perf_counter()
    if sweep_rows is None:
        shutil.rmtree(WORKDIR, ignore_errors=True)
        s_one, sweep_rows, _ = drive(DECK, os.path.join(SHARDED_DIR, "one_sweep"),
                                     synthesize_crossbar=N_YZ)
        sweep_held = s_one["held_bytes"]
    refs["sweep"] = golden.summarize(
        WORKDIR if os.path.isdir(WORKDIR) else os.path.join(SHARDED_DIR, "one_sweep"))
    refs["sweep_rows"] = sweep_rows
    refs["batched"] = _sharded_batched(None)
    if not nccl:
        synth = synth_deck.write_synth_deck(DECK, os.path.join(SHARDED_DIR, "synth"), N_YZ)
        s_full, refs["full_rows"], _ = drive(DECK, os.path.join(SHARDED_DIR, "one_full"),
                                             synthesize_crossbar=N_YZ, committed_parity=False,
                                             max_supersteps=SHARDED_FULL_STEPS)
        refs["full_held"] = s_full["held_bytes"]
        _, refs["synth_rows"], _ = drive(synth, os.path.join(SHARDED_DIR, "one_synth"),
                                         max_supersteps=SHARDED_SYNTH_STEPS)
        refs["synth"] = golden.summarize(os.path.join(SHARDED_DIR, "one_synth"))
        refs["full"] = golden.summarize(os.path.join(SHARDED_DIR, "one_full"))
        refs["harness_K"] = cg_harness._solve(None, dev, HARNESS_K_N, 1e8, 1e-14)
        refs["harness_T"] = cg_harness._solve(None, dev, HARNESS_T_N, 1e8, HARNESS_T_RTOL_COEFF,
                                              n_sub=HARNESS_T_SUB, more_rtol=(1e-14,))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    line["references_s"] = time.perf_counter() - t0

    def sweep_part(size):
        return (f"sweep_{size}", {"workdir": os.path.join(SHARDED_DIR, f"sweep_{size}"),
                                  "synthesize_crossbar": N_YZ})

    def concern_part(ratio):
        tag = f"{ratio[0]}to{ratio[1]}"
        return [(f"concern_run_{tag}", {"workdir": os.path.join(SHARDED_DIR, f"concern_{tag}"),
                                         "synthesize_crossbar": N_YZ,
                                         "max_supersteps": SHARDED_CONCERN_STEPS,
                                         "concern_split": ratio}),
                (f"concern_fields_{tag}", {"ratio": ratio})]

    if nccl:
        plans = {size: [sweep_part(size), ("batched", {})] for size in (2, 4) if size <= cards}
    else:
        plans = {
            2: [sweep_part(2), *concern_part((1, 1))],
            4: [sweep_part(4),
                ("batched", {}),
                ("full", {"workdir": os.path.join(SHARDED_DIR, "full_4"),
                          "synthesize_crossbar": N_YZ, "committed_parity": False,
                          "max_supersteps": SHARDED_FULL_STEPS}),
                ("synth", {"workdir": os.path.join(SHARDED_DIR, "synth_4"), "deck": synth,
                           "max_supersteps": SHARDED_SYNTH_STEPS}),
                *concern_part((1, 3)),
                ("harness_K", {"klass": "K"}), ("harness_T", {"klass": "T"})],
        }
    results = {}
    for size, parts in plans.items():
        t0 = time.perf_counter()
        results[size] = spawn(sharded_rank, size, device or str(dev), backend, parts,
                              timeout=900)
        line[f"spawn_{size}_s"] = time.perf_counter() - t0

    strip = _strip_rows
    with open(GOLDEN) as f:
        gold = json.load(f)
    for size, per_rank in results.items():
        r0 = per_rank[0]
        # 2. the sweep
        sw = r0[f"sweep_{size}"]
        if strip(sw["rows"]) != strip(refs["sweep_rows"]):
            problems.append(f"the {size}-rank sweep's metrics differ from the one-rank sweep's")
        bad = golden.compare(gold, sw["record"], GOLDEN_KMC_RTOL)
        if bad:
            problems.append(f"the {size}-rank sweep disagrees with the golden: {bad[:3]}")
        if sw["record"]["final_elements"] != refs["sweep"]["final_elements"]:
            problems.append(f"the {size}-rank sweep's final elements differ from one rank's")
        for rk, got in enumerate(per_rank):
            s = got[f"sweep_{size}"]
            if s["row_window_launches"] != s["k_iterations"] + s["k_solves"]:
                problems.append(f"rank {rk} of {size} launched the row window "
                                f"{s['row_window_launches']} times for {s['k_solves']} K solves "
                                f"of {s['k_iterations']} iterations")
            if s["row_window_launches"] == 0 or s["dia_cg_launches"]:
                problems.append(f"rank {rk} of {size}: row window {s['row_window_launches']}, "
                                f"fused CG {s['dia_cg_launches']} launches")
            if s["replica_checks"] != len(sw["rows"]):
                problems.append(f"rank {rk} of {size} checked its state after "
                                f"{s['replica_checks']} of {len(sw['rows'])} supersteps")
        held = [got[f"sweep_{size}"]["held_bytes"] for got in per_rank]
        for name, total in (("pair_table", sweep_held["pair_table"]),
                            ("dia_codes", dia24.diags.numel())):
            per = [h[name] for h in held]
            if not _share_ok(per, total, size):
                problems.append(f"{size} ranks hold {per} bytes of {name} of {total}")
        steps_s = sum(r["superstep_s"] for r in sw["rows"])
        cg_its = sum(r["cg_iterations"] for r in sw["rows"])
        line[f"sweep_{size}"] = {
            "supersteps": len(sw["rows"]), "wall_s": sw["wall_s"],
            "superstep_s": [r["superstep_s"] for r in sw["rows"]],
            "one_rank_superstep_s": [r["superstep_s"] for r in refs["sweep_rows"]],
            "supersteps_s": steps_s,
            "one_rank_supersteps_s": sum(r["superstep_s"] for r in refs["sweep_rows"]),
            "cg_iterations": cg_its, "ms_per_cg_iteration": 1e3 * steps_s / max(1, cg_its),
            "kmc_time_max_rel_vs_golden": golden.distance(gold, sw["record"])["kmc_time_max_rel"],
            "row_window_launches": [g[f"sweep_{size}"]["row_window_launches"] for g in per_rank],
            "k_solves": [g[f"sweep_{size}"]["k_solves"] for g in per_rank],
            "k_iterations": [g[f"sweep_{size}"]["k_iterations"] for g in per_rank],
            "replica_checks": [g[f"sweep_{size}"]["replica_checks"] for g in per_rank],
            "held_bytes": held, "peak_mem_gb": [g[f"sweep_{size}"]["peak_mem_gb"]
                                                for g in per_rank],
            "mesh_lines": sw["mesh_lines"],
        }
        # 3. the production event path at 409,600 slots
        if "batched" in r0:
            bt, one = r0["batched"], refs["batched"]
            if not (np.array_equal(bt["element"], one["element"])
                    and np.array_equal(bt["charge"], one["charge"])
                    and bt["stats"] == one["stats"]):
                problems.append(f"the {size}-rank batched path differs from one rank's: "
                                f"{bt['stats']} / {one['stats']}")
            for rk, got in enumerate(per_rank):
                b = got["batched"]
                if b["row_window_launches"] != b["k_iterations"] + b["k_solves"]:
                    problems.append(f"rank {rk} of {size}: batched row-window launches "
                                    f"{b['row_window_launches']} != {b['k_iterations']} + "
                                    f"{b['k_solves']}")
            line[f"batched_{size}"] = {
                "stats": bt["stats"], "wall_s": bt["wall_s"], "one_rank_wall_s": one["wall_s"],
                "kmc_time": bt["kmc_time"], "describe": bt["describe"],
                "peak_mem_gb": [g["batched"]["peak_mem_gb"] for g in per_rank],
                "one_rank_peak_mem_gb": one["peak_mem_gb"],
                "held_bytes": [g["batched"]["held_bytes"] for g in per_rank],
                "one_rank_held_bytes": one["held_bytes"],
            }
        # 5. concern groups
        for ratio in () if nccl else ((1, 1),) if size == 2 else ((1, 3),):
            tag = f"{ratio[0]}to{ratio[1]}"
            run_ = r0[f"concern_run_{tag}"]
            want = strip(refs["sweep_rows"][:SHARDED_CONCERN_STEPS])
            if strip(run_["rows"]) != want:
                problems.append(f"concern groups {tag}: supersteps differ from the sequential")
            fl = r0[f"concern_fields_{tag}"]
            if not (fl["charge_equal"] and fl["pot_b_equal"] and fl["pot_sum_equal"]
                    and fl["cg"][0] == fl["cg"][1]):
                problems.append(f"concern groups {tag}: fields differ from _fields: {fl}")
            line[f"concern_{tag}"] = {
                "groups": fl["groups"], "supersteps": len(run_["rows"]),
                "superstep_s": [r["superstep_s"] for r in run_["rows"]],
                "fields_bit_equal": fl["charge_equal"] and fl["pot_b_equal"]
                and fl["pot_sum_equal"], "mesh_lines": run_["mesh_lines"],
                "k_solves_per_rank": [g[f"concern_run_{tag}"]["k_solves"] for g in per_rank],
            }
    if nccl:
        return line, "; ".join(problems) or None

    per_rank = results[4]
    r0 = per_rank[0]
    # 4. full physics: against one rank, events, elements and power-CG counts
    # exact, KMC times, P_tot, I_macro and T_bg within the sharded bounds; and
    # against the golden's first supersteps within the full phase's bounds
    fu = r0["full"]
    pairs = list(zip(refs["full_rows"], fu["rows"]))
    bad = golden.compare(refs["full"], fu["record"], SHARDED_KMC_RTOL,
                         power_rtol=SHARDED_P_TOT_RTOL)
    bad += [f"superstep {i}: I_macro {b['I_macro']!r} against one rank's {a['I_macro']!r}"
            for i, (a, b) in enumerate(pairs)
            if not abs(a["I_macro"] - b["I_macro"]) <= SHARDED_I_MACRO_ATOL]
    bad += [f"superstep {i}: T_bg {b['T_bg']!r} against one rank's {a['T_bg']!r}"
            for i, (a, b) in enumerate(pairs)
            if not _rel(b["T_bg"], a["T_bg"]) <= SHARDED_T_BG_RTOL]
    bad += [f"superstep {i}: {b['power_cg_iterations']} power-CG iterations, one rank "
            f"{a['power_cg_iterations']}" for i, (a, b) in enumerate(pairs)
            if a["power_cg_iterations"] != b["power_cg_iterations"]]
    with open(FULL_GOLDEN) as f:
        fgold = json.load(f)
    fgold = {"supersteps": fgold["supersteps"][:len(fu["rows"])],
             "final_elements": refs["full"]["final_elements"]}
    bad_g = golden.compare(fgold, fu["record"], GOLDEN_KMC_RTOL, power_rtol=FULL_POWER_RTOL)
    I_gold = max_abs_current(fgold, fu["record"])
    if I_gold > FULL_CURRENT_ATOL:
        bad_g.append(f"I_macro {I_gold:.3e} A from the golden, beyond {FULL_CURRENT_ATOL:.1e} A")
    if bad or bad_g:
        problems.append(f"4-rank full physics: against one rank {bad[:3]}, against the golden "
                        f"{bad_g[:3]}")
    w_per = [sum(g["full"]["held_bytes"].get(k, 0) for k in ("W_tt", "W_ct", "W_cc"))
             for g in per_rank]
    line["full_4"] = {
        "supersteps": len(fu["rows"]), "superstep_s": [r["superstep_s"] for r in fu["rows"]],
        "one_rank_superstep_s": [r["superstep_s"] for r in refs["full_rows"]],
        "I_macro": [r["I_macro"] for r in fu["rows"]],
        "one_rank_I_macro": [r["I_macro"] for r in refs["full_rows"]],
        "kmc_time_max_rel": max(_rel(b["kmc_time"], a["kmc_time"]) for a, b in pairs),
        "W_bytes_per_rank": w_per,
        "I_macro_max_abs_diff": max(abs(a["I_macro"] - b["I_macro"]) for a, b in pairs),
        "I_macro_max_rel_diff": max(_rel(b["I_macro"], a["I_macro"]) for a, b in pairs),
        "P_tot_max_rel_diff": max(_rel(b["P_tot"], a["P_tot"]) for a, b in pairs),
        "I_macro_max_abs_vs_golden": I_gold,
        "rows_bit_equal": _strip_rows(fu["rows"]) == _strip_rows(refs["full_rows"]),
        "power_cg_iterations": [r["power_cg_iterations"] for r in fu["rows"]],
        "one_rank_power_cg_iterations": [r["power_cg_iterations"] for r in refs["full_rows"]],
        "bounds": {"I_macro_atol": SHARDED_I_MACRO_ATOL, "P_tot_rtol": SHARDED_P_TOT_RTOL,
                   "kmc_rtol": SHARDED_KMC_RTOL, "T_bg_rtol": SHARDED_T_BG_RTOL},
    }
    # the disordered stand-in: against one rank, events, elements and CG counts
    # exact and KMC times within SHARDED_SYNTH_KMC_RTOL; against its golden
    # within the disordered phase's bounds
    sy = r0["synth"]
    bad = golden.compare(refs["synth"], sy["record"], SHARDED_SYNTH_KMC_RTOL)
    bad += [f"superstep {i}: {b['cg_iterations']} CG iterations, one rank {a['cg_iterations']}"
            for i, (a, b) in enumerate(zip(refs["synth_rows"], sy["rows"]))
            if a["cg_iterations"] != b["cg_iterations"]]
    with open(SYNTH_GOLDEN) as f:
        sgold = json.load(f)["supersteps"][:len(sy["rows"])]
    for i, (g, h) in enumerate(zip(sgold, sy["rows"])):
        rtol = SYNTH_KMC_RTOL_SAME_STOP if g["cg_iterations"] == h["cg_iterations"] else (
            SYNTH_KMC_RTOL)
        if g["n_events"] != h["n_events"] or _rel(h["kmc_time"], g["kmc_time"]) > rtol:
            bad.append(f"superstep {i}: (events, kmc_time) ({h['n_events']}, {h['kmc_time']}) "
                       f"against the golden's ({g['n_events']}, {g['kmc_time']}), rtol {rtol}")
    if bad:
        problems.append(f"4-rank disordered stand-in: {bad[:3]}")
    line["synth_4"] = {
        "supersteps": len(sy["rows"]), "superstep_s": [r["superstep_s"] for r in sy["rows"]],
        "cg_iterations": [r["cg_iterations"] for r in sy["rows"]],
        "one_rank_cg_iterations": [r["cg_iterations"] for r in refs["synth_rows"]],
        "golden_cg_iterations": [g["cg_iterations"] for g in sgold],
        "rows_bit_equal": _strip_rows(sy["rows"]) == _strip_rows(refs["synth_rows"]),
        "kmc_time_max_rel": golden.distance(refs["synth"], sy["record"])["kmc_time_max_rel"],
        "kmc_rtol": SHARDED_SYNTH_KMC_RTOL,
        "band_bytes_per_rank": [g["synth"]["held_bytes"].get("band_blocks") for g in per_rank],
        "pair_table_bytes_per_rank": [g["synth"]["held_bytes"].get("pair_table")
                                      for g in per_rank],
    }
    for name, per in (("W blocks", w_per),
                      ("band blocks", line["synth_4"]["band_bytes_per_rank"])):
        if None in per or not _share_ok(per, sum(per), 4):
            problems.append(f"4 ranks hold {per} bytes of the {name}")
    one_w = sum(refs["full_held"].get(k, 0) for k in ("W_tt", "W_ct", "W_cc"))
    line["full_4"]["one_rank_W_bytes"] = one_w
    if not max(w_per) <= SHARE_SLACK * one_w / 4 + 4096:
        problems.append(f"a rank holds {max(w_per)} W bytes, one rank {one_w}")
    # 6. the CG harness
    for klass in ("K", "T"):
        got, one = r0[f"harness_{klass}"], refs[f"harness_{klass}"]
        if not (got["rel_l2_error"] < HARNESS_RTOL and one["rel_l2_error"] < HARNESS_RTOL
                and abs(got["iterations"] - one["iterations"]) <= HARNESS_ITER_SLACK):
            problems.append(f"cg_harness {klass}-class: 4 ranks {got}, one rank {one}")
        line[f"harness_{klass}"] = {"one_rank": one, "ranks_4": got}
    return line, "; ".join(problems) or None


# ---------------------------------------------------------------------------
# phase 10: the flagship crossbar
# ---------------------------------------------------------------------------
FLAGSHIP_N_YZ = 215                  # 215^2 x 50 slices x 2 sublattices = 4,622,500 slots
FLAGSHIP_STEPS = 3
FLAGSHIP_MASS_EPS = 0.1
# The batched supersteps race f64 clocks, not the recorded run's f32 ones. The
# loop ends a superstep on a gap of exp(ln_S) / freq in the clocks' scaled
# units, and on the fields that the serial superstep leaves here ln_S puts
# that gap beyond f32's largest value: no f32 clock can end the superstep.
# akmc_tpu's loop does the same arithmetic (tests/test_torch_rate_scale.py
# holds the two step for step there); whether akmc_tpu reaches such fields at
# this size is not known, since it has not run here. The phase reads the f32
# loop on those fields, cut at FLAGSHIP_F32_PROBE_BATCHES batches
# (``clock_f32_probe``), and checks the rate scale (``rate_scale``).
FLAGSHIP_CLOCK_F32 = False
FLAGSHIP_F32_PROBE_BATCHES = 1500
# the rate scale check: the pair potentials of both sites of the largest
# FLAGSHIP_TOP_RATES rates, the tiled f32 plane's against a plain f64 sum over
# every charged site, within FLAGSHIP_PAIR_ATOL volts (2e-3 eV, 0.08 kT on an
# event's barrier)
FLAGSHIP_TOP_RATES = 64
FLAGSHIP_PAIR_ATOL = 1e-3


def plain_pair_potential(pos, charge, sites, cutoff, sigma, k):
    """The pair potential at ``sites`` summed in f64 over every charged site
    within ``cutoff``, one site at a time: the formula of
    ``ops/pairwise.py`` with no tiling, candidate list or f32 plane."""
    from akmc_tpu_torch.ops.pairwise import Q_E

    q_idx = torch.nonzero(charge != 0).squeeze(1)
    q_pos, q_val = pos[q_idx], charge[q_idx].to(torch.float64)
    inv_sig = 1.0 / (sigma * math.sqrt(2.0))
    out = []
    for i in sites.tolist():
        d2 = torch.sum((pos[i] - q_pos) ** 2, dim=1)
        ok = (d2 < cutoff * cutoff) & (q_idx != i)
        d = 1e-10 * torch.sqrt(d2[ok])
        out.append(torch.sum(q_val[ok] * torch.special.erfc(d * inv_sig) * (k * Q_E) / d))
    return torch.stack(out)


def rate_scale(dev, model, state, fr, cold_ln_S) -> dict:
    """What sets the fields' ln_S: the largest rate's event (its sites,
    elements, charges, potentials and barrier), the pair potentials at the
    sites of the FLAGSHIP_TOP_RATES largest rates against
    ``plain_pair_potential``, and ln_S of the same state with the f64 pair
    plane. Fails when the plain sums part from the plane's by more than
    FLAGSHIP_PAIR_ATOL."""
    from akmc_tpu_torch.config import KB_EV

    p, t = model.params, model.tables
    nn = fr.P.shape[1]
    _, flat = torch.topk(fr.P.reshape(-1), FLAGSHIP_TOP_RATES)
    rows, slots = flat // nn, flat % nn
    si, sj = t.act_idx[rows], t.act_neigh[rows, slots]
    sites = torch.unique(torch.cat([si, sj]))
    pair = fr.potential_sum - fr.potential_boundary
    plain = plain_pair_potential(t.pos, fr.charge, sites, p.cutoff_radius, p.sigma, p.k)
    diff = float((plain - pair[sites]).abs().max())
    model.pair_f32 = False
    ln_S_f64 = float(model.fields(state, CROSSBAR_VD).ln_S)
    model.pair_f32 = True
    i, j = int(si[0]), int(sj[0])
    ln_S = float(fr.ln_S)
    kT = KB_EV * float(state.T_bg)
    top = {"site_i": i, "site_j": j, "etype": int(fr.etype[rows[0], slots[0]]),
           "element": [int(state.element[i]), int(state.element[j])],
           "charge": [int(fr.charge[i]), int(fr.charge[j])],
           "x": [float(t.pos[i, 0]), float(t.pos[j, 0])],
           "potential_sum": [float(fr.potential_sum[i]), float(fr.potential_sum[j])],
           "barrier_eV": (math.log(p.freq) - ln_S) * kT}
    out = {"cold_ln_S": cold_ln_S, "ln_S": ln_S, "ln_S_f64_plane": ln_S_f64,
           "ln_S_f32_limit": math.log(p.freq) + math.log(torch.finfo(torch.float32).max),
           "largest_rate": top, "sites_checked": int(sites.numel()),
           "pair_potential_max_abs_diff_V": diff, "pair_atol_V": FLAGSHIP_PAIR_ATOL}
    print("chip_smoke: flagship rate scale " + json.dumps(out))
    if not diff <= FLAGSHIP_PAIR_ATOL:
        fail(f"flagship: the pair potentials at the largest rates' sites part from a plain f64 "
             f"sum by {diff} V")
    return out


def run_flagship(dev):
    """(flagship line, None): the 40 nm crossbar of ``tools/bench_crossbar.py
    215`` in the configuration of its recorded run (shifted-exponent rates,
    f32 pair plane, incremental selection; batched B = 64, ``mass_eps`` 0.1)
    at 15 V, with f64 clocks (FLAGSHIP_CLOCK_F32). Each part fails the run on
    its own."""
    from akmc_tpu_torch.lattice import ELEM
    from akmc_tpu_torch.ops.events import GeneratorDraws, run_event_loop_batched
    from akmc_tpu_torch.rng import BufferedStream, ReferenceRNG
    from akmc_tpu_torch.state import make_device_state

    p, lat, model, desc, build = crossbar_model(
        dev, FLAGSHIP_N_YZ, pair_f32=True, event_select_incremental=True)
    if lat.N != FLAGSHIP_N_YZ ** 2 * 100 or (desc["k_operator"], desc["pairwise"]) != (
            "dia", "tiled"):
        fail(f"the flagship crossbar is {lat.N} slots, {desc}")
    state = make_device_state(lat, p.background_temp, dev)
    # the kernels were built and loaded when the script started: the warmup
    # finds both built and loads nothing
    t0 = time.perf_counter()
    warm = {**model.warmup(state, CROSSBAR_VD), **model.warmup(state, CROSSBAR_VD, batched=64)}
    warmup_s = time.perf_counter() - t0
    at_shape = crossbar_kernels(dev, model, state, FLAGSHIP_N_YZ)

    since = reset_launches(dev, model)
    run = CrossbarSteps(dev, model, state, BufferedStream(ReferenceRNG(p.rnd_seed_kmc)),
                        GeneratorDraws.seeded(7, dev), where="flagship")
    run.step("serial")
    after_serial = run.state
    for _ in range(FLAGSHIP_STEPS):
        run.step("batched", mass_eps=FLAGSHIP_MASS_EPS, clock_f32=FLAGSHIP_CLOCK_F32)
    launches = crossbar_launches(dev, model, run.steps, since, where="flagship")
    peak = torch.cuda.max_memory_allocated() / 1e9

    # the three loops against their plain loops, then a batched superstep
    # with each, on the last state; one batched loop replayed on the CPU,
    # from the same fields and the same uniforms
    fr = model.fields(run.state, CROSSBAR_VD)
    loops = loop_turns(dev, model, run.state, fr, "flagship", FLAGSHIP_MASS_EPS, ks=True)
    turns = superstep_turns(dev, model, run.state, "flagship", FLAGSHIP_MASS_EPS)
    peak_loops = torch.cuda.max_memory_allocated() / 1e9
    replay = replay_case(dev, run.state, fr, model.tables, p.freq, 215, 64, FLAGSHIP_CLOCK_F32,
                         FLAGSHIP_MASS_EPS, "the flagship's fields, B=64")
    t = model.tables
    cold_ln_S = float(model.fields(state, CROSSBAR_VD).ln_S)
    fr = model.fields(after_serial, CROSSBAR_VD)
    scale = rate_scale(dev, model, after_serial, fr, cold_ln_S)
    t0 = time.perf_counter()
    f32 = run_event_loop_batched(
        after_serial.element, fr.charge, fr.P, fr.etype, t.act_neigh,
        GeneratorDraws.seeded(8, dev), p.freq, batch=64, max_batches=FLAGSHIP_F32_PROBE_BATCHES,
        act_idx=t.act_idx, abs2act=t.abs2act, ln_S=fr.ln_S, mass_eps=FLAGSHIP_MASS_EPS,
        clock_f32=True)
    probe = {"ln_S": float(fr.ln_S), "terminating_gap_scaled": math.exp(float(fr.ln_S)) / p.freq,
             "f32_max": torch.finfo(torch.float32).max, "max_batches": FLAGSHIP_F32_PROBE_BATCHES,
             "events": f32.n_events, "batches": f32.n_batches, "done": f32.done,
             "wall_s": time.perf_counter() - t0}
    print("chip_smoke: flagship, f32 clocks on the first batched superstep's fields: "
          + json.dumps(probe))
    steps = run.steps
    batched = [r for r in steps if r["kind"] == "batched"]
    line = {
        "command": "tools/bench_crossbar.py 215 (BENCH_crossbar_r05.json's options)",
        "slots": lat.N, "sites": int((lat.element0 != int(ELEM.NULL_ELEMENT)).sum()),
        "Vd": CROSSBAR_VD,
        "model": desc, **build, "warmup_s": warmup_s, "warmup": warm,
        "serial_incremental": {k: steps[0][k] for k in (
            "wall_s", "events", "cg_iterations", "host_syncs", "host_syncs_per_event")}
        | {"ms_per_event": 1e3 * steps[0]["wall_s"] / steps[0]["events"]},
        "batched": batched_summary(batched), "steps": steps, "kmc_time": run.kmc_times,
        **launches, "peak_mem_gb": peak, "replay": replay, "clock_f32_probe": probe,
        "rate_scale": scale, "kernels_at_this_shape": at_shape, "loops": loops,
        "superstep_turns": turns, "peak_mem_gb_with_loop_turns": peak_loops,
        "loop_graphs_capture_s": model.loop_graphs.capture_s(),
    }
    print("chip_smoke: flagship " + json.dumps({k: line[k] for k in (
        "slots", "build_s", "model_s", "warmup_s", "peak_mem_gb")}))
    return line, None


def crossbar_lines(lines):
    """(name, line) of each run that held the kernels at its own shapes:
    the batched phase's crossbars and the flagship."""
    out = [(name, line) for name, line in lines.get("batched", {}).items()
           if name.startswith("crossbar")]
    return out + ([("flagship", lines["flagship"])] if "flagship" in lines else [])


PHASES = ("kernels", "sweep", "disordered", "tiled", "batched", "full", "driver", "sharded",
          "flagship")
OPT_IN = ("nccl", "schedules")   # run only when --only names them


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated phases to run (default: all)")
    ap.add_argument("--crossbar-n-yz", default=",".join(map(str, CROSSBAR_N_YZ)),
                    help="widths of the batched phase's crossbar runs (default 64,104: 409,600 "
                         "and 1,081,600 slots), the first at full depth")
    args = ap.parse_args(argv)
    phases = args.only.split(",")
    if set(phases) - set(PHASES) - set(OPT_IN):
        fail(f"--only takes phases of {PHASES + OPT_IN}")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs the card")
    import_port()
    from akmc_tpu_torch.ops import cuda_build

    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    cuda_build.build(KERNELS)
    for name in KERNELS:
        cuda_build.load(name)
        for line in cuda_build.log_path(name).read_text().splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"chip_smoke: {name}: {line.strip()}")
    print(f"chip_smoke: built and loaded {', '.join(KERNELS)} in {time.perf_counter() - t0:.1f} s")

    kernels, lines, problems = [], {}, []
    if "kernels" in phases:
        dia, meta, p, lat = crossbar_dia(N_YZ)
        kernels = [check_dia_kernel(dev, dia, meta), check_dia_cg(dev, dia, meta, p, lat)]
    sweep_rows, sweep_held = [], {}

    def sweep():
        line, problem = run_sweep()
        sweep_rows.extend(line.pop("rows"))
        sweep_held.update(line["held_bytes"])
        return line, problem

    for name, run in (("sweep", sweep), ("disordered", lambda: run_disordered(dev)),
                      ("tiled", lambda: run_tiled(dev)),
                      ("batched", lambda: run_batched(
                          dev, [int(n) for n in args.crossbar_n_yz.split(",")],
                          sweep_rows or None)),
                      ("full", lambda: run_full(dev)),
                      ("driver", lambda: run_driver(dev, sweep_rows or None)),
                      ("sharded", lambda: run_sharded(dev, sweep_rows or None, sweep_held)),
                      ("nccl", lambda: run_sharded(dev, sweep_rows or None, sweep_held,
                                                   device="cuda", backend="nccl")),
                      ("flagship", lambda: run_flagship(dev)),
                      ("schedules", lambda: run_schedules(dev))):
        if name in phases:
            t0 = time.perf_counter()
            lines[name], problem = run()
            lines[name]["phase_s"] = time.perf_counter() - t0
            if problem:
                problems.append(problem)
    # launches on each path that runs the kernels, counted over that path alone
    for kern, key in zip(kernels, ("dia_launches", "dia_cg_launches")):
        # top-level keys: the n_yz=24 sweep's shapes and launches
        if "sweep" in lines:
            kern["launches"] = lines["sweep"][key]
            kern["launches_per_superstep"] = kern["launches"] / lines["sweep"]["supersteps"]
        if "tiled" in lines:
            kern["launches_tiled_path"] = lines["tiled"][key]
        if "full" in lines:
            kern["launches_full_path"] = lines["full"][key]
        if "driver" in lines:
            kern["launches_driver_path"] = {
                path: n[key] for path, n in lines["driver"]["launches"].items()}
        if "disordered" in lines:
            kern["launches_disordered_path"] = 0      # asserted: no DIA form there
        if "sharded" in lines:
            # the sharded K-CG runs the row window on every rank and the fused
            # CG on none (asserted): launches per rank of each sharded sweep
            sh = lines["sharded"]
            kern["launches_sharded_path"] = {
                f"sweep_{n}_ranks": (sh[f"sweep_{n}"]["row_window_launches"]
                                     if key == "dia_launches" else [0] * n) for n in (2, 4)}
            if key == "dia_launches":
                kern["row_window"] = sh["row_window"]
        # the crossbar paths and the flagship: the same keys once more, read
        # at their shapes (the fused CG's streaming kernel there) and counted
        # over their supersteps
        for name, line in crossbar_lines(lines):
            kern[name + "_path"] = {"launches": line[key],
                                    **line["kernels_at_this_shape"][kern["name"]]}
    if kernels:                      # now in the kernels line
        for _, line in crossbar_lines(lines):
            del line["kernels_at_this_shape"]
    # the device loops against their plain loops: one line for both widths
    loops = {name: line.pop("loops") for name, line in crossbar_lines(lines) if "loops" in line}
    if loops:
        lines["loops"] = loops

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    print(json.dumps({"kernels": kernels}))
    for name, line in lines.items():
        print(f"{name} " + json.dumps(line))
    if problems:
        fail("; ".join(problems))
    print(smi[0] if smi else "nvidia-smi: no output")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
