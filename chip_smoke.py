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
           ``pairwise_potential_tiled`` (``csrc/pair_tiled.cu``): the n_yz=24
           crossbar tiled as the model tiles a structure whose pair table does
           not fit, on its first superstep's charges: potential and both flags
           bit-equal to ``pairwise_potential_tiled_plain`` in the f32 and the
           f64 plane, then the launch alone and the whole call timed beside
           the twin, beside the bound of the f32 plane's work (the pairs
           inside the cutoff at PAIR_ISSUE issue slots and PAIR_MUFU MUFU
           operations each: ``pair_tiled_bound``) and beside the issue time
           of the kernel's own SASS (a diagnostic). The other phases add the
           kernel's launches on each path, counted over that path alone (one
           a K solve where the model took the tiled path, none elsewhere),
           and its readings at their shapes.

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
           Each of those solves runs its CG (``solvers/cg.py``) as the device
           loop (k iterations per CUDA-graph replay, one host read each) and
           as the host loop in turns (``cg_turns``): bit-equal in x, r,
           residual and iteration count, with ms per iteration, replays,
           dead iterations, host reads per solve and capture seconds, and k
           = 8, 16, 32 on the open torch.dot solves; then one cold banded
           solve the same way at n_yz = LARGE_BANDED_N_YZ (124,412 sites;
           n_yz = 96's 497,648 sites take no banded operator), and the sweep
           once more with the host loops, equal row for row but for time.
           The driver builds this structure file's lists on the card
           (``lattice_device.py``); beside the sweep, that builder against
           the k-d tree on ``synthetic_stack`` at n_yz = 24 (neighbor list,
           periodic K adjacency, cutoff list) and at n_yz = 48 (124,412
           sites: the first two), equal entry for entry, both timed.
4b. superstep_graph  the serial superstep as one CUDA graph
           (``models/step_program.py``: the K-CG and the event loop
           conditional while nodes, one host read a superstep) against the
           per-loop path (``VCMModel(step_program=False)``), in turns (loops,
           program, program, loops), two supersteps at each of the deck's
           first SG_BIASES biases on the sweep's crossbar (DIA, 58,752 slots, pair table) and
           on the disordered structure (banded and ELL, 31,088 sites): every
           superstep bit-equal (state, stats, the stream), one host read a
           superstep without a redo or a continuation, the DIA kernels
           launched from inside the graph once per K solve, their iterations
           counted on the device. Read: ms and host reads a superstep (warm
           and cold), capture s, while passes, redos, continuations, the
           while nodes at k = 1, 4, 16 (SG_NODE_KS), and on the crossbar
           ``superstep_multi`` of 4 against one at a time (the same
           supersteps; one read per dispatch). Its line also gives the CUDA
           runtime and driver versions.
5. tiled   the pairwise paths at a size that needs them: three supersteps of
           the deck on a synthesized crossbar at n_yz=32 (104,448 slots, pair
           table past its 8e9-byte budget). The model must have taken the tiled
           path and the DIA operator, both kernels must have been launched,
           every superstep finite, and the tiled pairwise kernel
           (``csrc/pair_tiled.cu``) launched once per K solve. On the first
           superstep's charges the kernel is held bit-equal to its plain twin
           (potential and both flags, f64 and f32 planes), the tiled potential
           against the on-the-fly plane (f64: rtol 1e-12; f32 plane: rtol 2e-5
           off the cutoff shell), and kernel, twin and on-the-fly plane are
           timed, the kernel beside its bound.

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
           pairwise asserted. First the kernels once more against their
           twins, on this crossbar's own operator and first K system (cold
           start, the fused CG's streaming kernel: rows not in registers) and
           its tiling on that superstep's charges: bit-equal, equal iteration
           count, timed, with the bounds from this shape (the matvec beside
           the sparse product assembled on the card, the fused CG per
           iteration beside its sync floor and streaming bound, the pairwise
           kernel as in the kernels phase); the ``kernels`` line carries these
           readings per kernel under ``crossbar_path``. One serial superstep (cold CG), one
           ``superstep_native_batched`` (B = 64, ``mass_eps`` 1e-3), one more
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
           state's fields (``loop_turns``): the serial loop (on 2,048 draws of
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
           slots) with one superstep of each batched kind, under the same
           checks. ``--crossbar-n-yz N[,N]`` picks other widths (the first at
           full depth).

7. full    the full physics (``--full-physics``: CB edge, WKB tunnel blocks,
           power CG, heat models). Each superstep is one program
           (``models/step_program.py::FullProgram``: one CUDA graph, its loops
           while nodes, one host read). The whole n_yz=24 sweep through the driver,
           held to ``akmc_tpu_torch/golden/iv_sweep_5nm_n24_full.json``
           (``tools/full_physics_golden.py``): events, superstep count and final
           elements exactly, KMC times within GOLDEN_KMC_RTOL, each superstep's
           P_tot within FULL_POWER_RTOL and I_macro within FULL_CURRENT_ATOL,
           one 'Current [uA]' line per superstep, DIA launches equal to the
           model's K solves, power-CG counts equal to the golden's at every
           superstep; the sweep once more on the per-loop path
           (``step_program=False``) and once with the CGs' host loops, each
           equal row for row but for time (host reads and superstep times). Then three supersteps with ``--wkb-f32`` (the f64
           run's events; P_tot within akmc_tpu's f32-against-f64 spread,
           I_macro within FULL_CURRENT_ATOL); one power solve at 8 V and
           rtol_scale 1, 1e-2, 1e-4 on the sweep's first state and on the
           disordered stand-in's (whose CB edge is finite, so that its W blocks
           tunnel); on the stand-in at 8 V the CB-edge CG, the power CG with the
           band (k = 8, 16, 32) and with the gather operator and the steady
           heat CG, each device loop against its host loop as in the
           disordered phase; three full-physics supersteps of the stand-in through the
           driver, through the program and on the per-loop path, equal row for
           row, an energy loop past one step; four supersteps each with ``solve_heating_global = 1`` and
           ``solve_heating_local = 1`` (deck copies from
           ``runtime/synth_deck.py::write_heating_deck``): events and elements
           exact, T_bg and each site's temperature within ``heat_close``. The
           bounds are akmc_tpu's own band-against-gather spread or, where the
           card read more, the reading rounded up (their constants say which).
           Per superstep: the CB-edge solves, the WKB build in ms and its
           energy-loop bounds, the power solve in ms and per iteration, host
           reads, peak memory. Then the program against the per-loop path in
           turns (loops, program, program, loops), every superstep bit-equal
           (state, stats, the warm start, the stream): FP_SUPERSTEPS on the
           sweep's crossbar and FP_STANDIN_SUPERSTEPS on the stand-in, ms a
           superstep, host reads,
           capture s, while passes, the card's idle share by CUDA events around
           the replays, the contact-trap kernel (``csrc/wkb_ct.cu``) launched
           once a power build on every turn (a program run or a per-loop
           superstep); the stand-in with the global and with the local heat
           model (delta_t between two supersteps' event times: one steady, one
           transient); FP_SPD supersteps a dispatch against one at a time (one
           read a dispatch), and a batch discarded on a vmax below the
           vacancies; one superstep of the stand-in at 124,412 sites (W-block
           bytes, energy bounds, peak memory; it takes the tiled pairwise
           path: that kernel and the contact-trap kernel launched once a K
           solve through the program and through the loops, each held
           against its twin at this shape). On the driver's sweep the
           contact-trap kernel launched once a superstep's power build (one
           a K solve); on the deck programs of the driver phase, never.

7b. wkb_kernel the contact-trap block's kernel (``csrc/wkb_ct.cu``) against
           its plain twin on the card at ``tsys102k.iv_set``'s shape
           (portbench's configuration and builder, 12,800 contact rows x
           3,328 trap slots) and at the disordered stand-in's, each at 8 V
           on its solved CB edge: W_ct and the chunks' bounds bit-equal, one
           launch; the launch alone by CUDA events over a graph of launches,
           the twin's build once, the terms and the lane efficiency from
           the kernel's counters, the work from the inputs (pairs, terms,
           terms with a pow) and its issue bound at the SASS counts
           WKB_TERM_INSTR / WKB_POW_INSTR; the kernel's opcodes and loops
           from ``cuobjdump -sass`` (the listing in chiprun_out/wkb_ct.sass).
           Those counts were read from one build (WKB_SASS_READ): a build
           whose instructions or loops differ fails the phase. The kernels
           line's ``wkb_contact_trap_kernel`` entry gathers every path's
           launches and readings.

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
           device equal to the model's. The fields-only and events-only
           sweeps once more on the per-loop path (``step_program=False``),
           equal row for row but for time. The deck modes and the CB edge as
           one program a call (``models/step_program.py``: ``FieldsProgram``,
           ``EventsOnlyProgram``, ``CbEdgeProgram``) against the per-loop
           path in turns (loops, program, program, loops), every call
           bit-equal: fields only at the deck's 15 biases, events only for 24
           supersteps and the CB edge at the 15 biases on the sweep's
           crossbar, the CB edge on the disordered stand-in; ms and host
           reads a call, capture s, and the DIA kernels launched from inside
           ``FieldsProgram``'s graph once per K solve; one fields-only call of
           the stand-in (banded, 31,088 sites) and of the n_yz = 64 crossbar
           (409,600 slots) each way, bit-equal. Then every program kind after
           its redo paths on the crossbar (a vmax below the vacancies: a
           discarded batch, a redo at the grown cap, continuations), every
           call bit-equal to the per-loop path.

           Fault A's checks (``lifetime_checks``) run wherever programs are
           built (superstep_graph, production_graph, full, driver): every
           capture records the spans its graph binds from outside its private
           pools (``device_loop.tracing_bindings``), each must lie inside a
           live block of ``torch.cuda.memory_snapshot()``, and each program
           replayed after every free block of the caching allocator was
           filled with NaN bytes (``device_loop.poison_free_blocks``) must
           equal its replay before, to the bit.

9. sharded  scale-out over torch.distributed, with 2 and 4 ranks sharing this
           card over gloo (NCCL refuses two ranks on one card; the gloo
           collectives are staged through host buffers): correctness and
           launches, not speed. The row-window matvec against its twin (its
           own slab, x and xv whole) at the first, a middle and the last
           rank's 256-row-chunk window of N = 58,752 split 2 and 4 ways and of
           409,600 split 4 ways, bit-equal, then timed beside the twin and a
           sparse product on the window's rows. Through the driver's per-rank
           function (``runtime/driver.py::run_on_mesh``): the sweep's first
           SHARDED_SWEEP_STEPS supersteps on 2 and 4 ranks, every metrics row
           and the final elements equal to one rank's, the golden's first
           supersteps within GOLDEN_KMC_RTOL,
           each rank's row-window launches equal to its K-CG iterations plus
           one per solve, every rank's state equal to rank 0's after every
           superstep, per-rank bytes of the pair table and the DIA codes about
           1/ranks; concern groups 1:1 and 1:3 (fields and
           SHARDED_CONCERN_STEPS supersteps equal to one rank's to the bit);
           on 4 ranks, SHARDED_BATCHED_STEPS batched supersteps at 409,600
           slots (integer state and counts equal to one rank's, peak memory
           per rank, each rank's tiled pairwise kernel launched once a K
           solve and bit-equal to its twin on the rank's share of the tiles), SHARDED_FULL_STEPS full-physics supersteps
           (against one rank: events, elements and power-CG counts exact, KMC
           times within SHARDED_KMC_RTOL, P_tot within SHARDED_P_TOT_RTOL,
           I_macro within SHARDED_I_MACRO_ATOL, T_bg within 1e-12; against
           the golden's first supersteps: the full phase's bounds; W
           bytes per rank about a quarter of one rank's; each rank's
           contact-trap kernel launched once a K solve over its own contact
           rows, and bit-equal to its twin on its window of the disordered
           stand-in's contact rows at 8 V), SHARDED_SYNTH_STEPS
           supersteps of the disordered stand-in (against one rank: events, elements and CG
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
           are built and loaded when the script starts), the kernels against
           their twins on its operator, first K system and tiling
           (``crossbar_kernels``: bit-equal ``x``, ``r``, residual and
           iteration count, the pairwise potential and flags), then one cold serial superstep with the incremental
           selection and FLAGSHIP_STEPS ``superstep_native_batched`` (B = 64,
           ``mass_eps`` 0.1; f64 clocks, as FLAGSHIP_CLOCK_F32 says why)
           under the crossbar checks (an event each, ended done, launches
           equal to the K solves, one host read per replay of the loops); on
           the last state's fields ``loop_turns`` and ``superstep_turns`` as
           at n_yz=64, with the device loops also at k = 16 and 64 batches
           and 32 and 128 events (LOOP_KS); and one batched loop on those
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
``disordered``, ``superstep_graph``, ``tiled``, ``batched``, ``full``, ``wkb_kernel``,
``driver``, ``sharded`` and ``flagship``, a ``loops`` line (``loop_turns`` at n_yz=64 and at the
flagship), a ``cg_loops`` line (each CG's device loop against its host loop,
from the disordered and full phases), the card's name and power limit from
nvidia-smi, and last
``{"ok": true, "device": {...}}``. ``--only PHASE[,PHASE]`` (of kernels,
sweep, disordered, superstep_graph, tiled, batched, full, wkb_kernel, driver,
sharded, flagship) runs a
part of it while developing;
``--only nccl`` (never run by default) runs the sharded phase's sweep and
batched path, under the same checks, on 2 and 4 ranks with a card each over
NCCL, on a machine with four cards. ``--only schedules`` (never run by
default) compiles copies of csrc/dia_cg.cu with the streaming case's other
schedules (CG_SCHEDULES), holds each bit-equal to the twin and times each on
the crossbars' cold K systems at n_yz = 64, 104 and 215. ``--only
profiler_fault`` (never run by default) runs ``torch.profiler`` over three
replays of each of PROFILER_CASES in a process of its own (``--profiler-case
NAME``): a bare graph with one while node whose body is one elementwise add,
then each program kind on the n_yz = 24 crossbar; its line says which ended
their process, with the exit code and the last lines of its errors. Needs one
card, no network, and no JAX.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import re
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
KERNELS = ("dia_matvec", "dia_cg", "threefry", "pair_tiled", "wkb_ct")
SASS_DIR = os.path.join(HERE, "chiprun_out")    # cuobjdump -sass listings of the kernels read
PLUMBING = ("graph_while",)      # built with the kernels: the superstep graph's while nodes
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
# the tiled pairwise solve's bound, from the work of the function and not
# from the kernel's code: each pair inside the cutoff in f32, as the
# production plane runs it. d² (3 differences, 3 squares, 2 sums: 8), the
# cutoff and self tests (2), the sum's add (1), one reciprocal square root
# for d and 1/d (MUFU) with d = ang·d²·rsqrt (2), the argument d·inv_sig
# (1), erfc as exp(-x²) times a degree-5 polynomial in t = 1/(1 + p·x)
# (Abramowitz & Stegun 7.1.26, error 1.5e-7: x², the ex2 scale, p·x + 1,
# five Horner steps, the product: 9, and an ex2 and a reciprocal, MUFU), and
# q·erfc·(kq/ang)·rsqrt (3): 26 instructions and 3 MUFU, 29 issue slots a
# pair. H100 SXM: 132 SMs, each issuing 4 x 32 lanes and 16 MUFU results a
# cycle, at 1,980 MHz.
PAIR_ISSUE, PAIR_MUFU = 29, 3
LANE_INSTR_PER_S = 132 * 4 * 32 * 1.98e9
MUFU_PER_S = 132 * 16 * 1.98e9
# beside the bound, what this kernel's own SASS issues (cuobjdump -sass, nvcc
# 12.9): 27 instructions a pair tested, inside the cutoff or not (the ring's
# loads, d², the tests, the add), and 78 more a pair inside the cutoff (the
# IEEE square root and division, the library's erfc, the products)
PAIR_TEST_INSTR, PAIR_TERM_INSTR = 27, 78
BATCHED_DIR = os.path.join(HERE, "build", "chip_smoke", "batched")
# crossbar widths: n_yz^2 x (10 + 22 + 8 + 10 slices) x 2 sublattices = 409,600 and
# 1,081,600 slots; one superstep of each batched kind
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


class PartTimes(dict):
    """Host seconds of a phase's parts: ``mark(name)`` closes the part that
    ran since the last mark (a reading for the time aim)."""

    def __init__(self):
        super().__init__()
        self.t = time.perf_counter()

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self[name] = now - self.t
        self.t = now


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


def device_ms(fn, reps: int = 100):
    """Device time per call: ``reps`` calls captured into one CUDA graph and
    its replays timed by CUDA events (``graph_launch_ms``: no host path
    between the calls). It reads within 6% of ``torch.profiler``'s summed
    kernel time, which took seconds a session (threefry, PR 16). None when
    the calls cannot be captured (the caller then takes the CUDA events of
    calls launched one by one)."""
    try:
        return graph_launch_ms(fn, n=reps)
    except RuntimeError:
        torch.cuda.synchronize()
        return None


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
        "time_source": ("CUDA events over a graph of launches" if dev_ms["kernel"] is not None
                        else "CUDA events"),
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
    the block (CUDA only; on a CPU device it stays empty). While it is open
    the list is also ``SYNC_LOGS[-1]``, so that code inside the block can
    count the reads of a part of it."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if dev.type == "cuda":
            torch.cuda.set_sync_debug_mode("warn")
        SYNC_LOGS.append(caught)
        try:
            yield caught
        finally:
            SYNC_LOGS.pop()
            if dev.type == "cuda":
                torch.cuda.set_sync_debug_mode(0)


SYNC_LOGS: list = []     # the lists of the ``count_syncs`` blocks open, innermost last


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
    from akmc_tpu_torch.ops import pairwise
    from akmc_tpu_torch.runtime import driver
    from akmc_tpu_torch.solvers import current, dia_cg

    shutil.rmtree(workdir, ignore_errors=True)
    mv.dia_combined_matvec.launches = 0
    dia_cg.dia_cg_solve.launches = 0
    pairwise.pairwise_potential_tiled.launches = 0
    current.wkb_contact_trap_kernel.launches = 0
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
        "pair_tiled_launches": pairwise.pairwise_potential_tiled.launches,
        "wkb_ct_launches": current.wkb_contact_trap_kernel.launches,
        "cg_iterations_counted_on_device": dia_cg.iterations_total("cuda"),
        "host_syncs": n_syncs(syncs), "host_sync_sites": sync_sites(syncs),
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
    conductive-vacancy degrees), and the tiled pairwise kernel once where the
    model took the tiled path (none elsewhere); the iterations the fused
    kernel counted on the device are the model's (``k_iterations``); without
    a grown cap the solves are the supersteps and their iterations those of
    metrics.jsonl."""
    k_solves, k_iterations = summary["k_solves"], summary["k_iterations"]
    launches = (counts["dia_launches"], counts["dia_cg_launches"])
    if launches != (k_solves, k_solves):
        fail(f"the {path} path launched the DIA kernels (matvec, CG) {launches} times for "
             f"{k_solves} K solves")
    pair = k_solves if summary["model"]["pairwise"] == "tiled" else 0
    if counts["pair_tiled_launches"] != pair:
        fail(f"the {path} path launched the tiled pairwise kernel "
             f"{counts['pair_tiled_launches']} times for {k_solves} K solves of a "
             f"{summary['model']['pairwise']} pairwise path")
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


# ---------------------------------------------------------------------------
# the CG device loops (solvers/cg.py) against their host loops
# ---------------------------------------------------------------------------
CG_FILES = ("cg.py", "device_loop.py")       # where the CG loops read the host
CG_KS = (8, 16, 32)                          # k read on the banded K solve and the power CG
K_MODULES = ("banded", "poisson")            # the K solves' callers
# One cold banded solve at the largest synthetic_stack the banded operator
# takes within the phase's time: at n_yz = 96 (497,648 sites) the band
# would be about 11 GB of int8 codes, past build_banded_k's
# 4e9-byte cap, and 87 GB decoded (the model falls back to ELL there); n_yz =
# 48 is 124,412 sites, 0.73 GB of codes, 5.8 GB decoded.
LARGE_BANDED_N_YZ = 48


def _cg_wrap(cg, fn, plain, k, dot, log):
    device, host = getattr(cg, fn), getattr(cg, fn + "_plain")

    def run(*args, graphs=None, **kw):
        if dot is not None:
            kw["dot_fn"] = dot
        res = host(*args, **kw) if plain else device(*args, graphs=graphs, k=k, **kw)
        log.append(res)
        return res
    return run


@contextlib.contextmanager
def cg_as(plain=False, k=None, dot=None, modules=("banded", "poisson", "current", "heat")):
    """The single-device CGs of ``modules`` (of ``akmc_tpu_torch.solvers``)
    as their host loops ``*_plain`` or as their device loops at ``k`` (None:
    ``cg.CG_K``), with ``dot`` in place of the caller's dot product when
    given; each CG's result is appended to the yielded list. A measurement's
    baseline: nothing in the package selects a host loop on one device."""
    import importlib

    from akmc_tpu_torch.solvers import cg

    log, saved = [], []
    for name in modules:
        mod = importlib.import_module(f"akmc_tpu_torch.solvers.{name}")
        for fn in ("jacobi_cg", "symscaled_cg"):
            if hasattr(mod, fn):
                saved.append((mod, fn, getattr(mod, fn)))
                setattr(mod, fn, _cg_wrap(cg, fn, plain, k, dot, log))
    try:
        yield log
    finally:
        for mod, fn, orig in saved:
            setattr(mod, fn, orig)


def same_bits(a, b) -> bool:
    """Equal to the bit (NaNs included) for tensors, equal for the rest."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.float64:
            a, b = a.view(torch.int64), b.view(torch.int64)
        return a.shape == b.shape and torch.equal(a, b)
    return a == b


def _flat(out) -> list:
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    if dataclasses.is_dataclass(out):
        return [t for f in dataclasses.fields(out) for t in _flat(getattr(out, f.name))]
    return [out]


def same_cg(label, a, b) -> None:
    """Fails unless two runs (outputs, CG results) are equal to the bit: each
    CG's x, r, residual and iteration count, and every output."""
    (out_a, log_a), (out_b, log_b) = a, b
    if [r.iterations for r in log_a] != [r.iterations for r in log_b]:
        fail(f"{label}: the device loop ran {[r.iterations for r in log_a]} iterations, the "
             f"plain loop {[r.iterations for r in log_b]}")
    for ra, rb in zip(log_a, log_b):
        for f in ("x", "r", "residual_sq"):
            if not same_bits(getattr(ra, f), getattr(rb, f)):
                fail(f"{label}: the device loop's {f} differs from the plain loop's")
    fa, fb = _flat(out_a), _flat(out_b)
    if len(fa) != len(fb) or not all(same_bits(u, v) for u, v in zip(fa, fb)):
        fail(f"{label}: the device loop's output differs from the plain loop's")


def cg_turns(dev, label, solve, graphs, dot=None, modules=("banded", "poisson", "current",
                                                               "heat"), ks=(), turns=3,
             firsts=()):
    """``solve()`` (one caller's CGs on fixed inputs) with the device loops
    (programs in ``graphs``; the first call builds and captures them) and
    with the host loops, in turns plain, device, device, plain (``turns`` 1:
    plain only after the first device call); every run bit-equal to the
    first plain one. Returns (readings, the plain run's outputs): iterations,
    ms of each run (host clock, the device drained), ms per iteration,
    capture seconds, replays, dead iterations, host reads per solve of each
    loop (synchronisations made in ``CG_FILES``) and, with ``ks``, the device
    loop at each k, with ``firsts`` at each length of the first replay
    (``cg.CG_FIRST``; a capture each)."""
    from akmc_tpu_torch.solvers import cg

    def run(plain, k=None):
        cg.reset_cg_counts()
        with count_syncs(dev) as caught, cg_as(plain, k, dot, modules) as log:
            ms, out = wall_ms(solve)
        counts = {key: sum(c[key] for c in cg.CG_COUNTS.values())
                  for key in ("solves", "replays", "steps", "live_steps")}
        reads = n_syncs([w for w in caught if os.path.basename(w.filename) in CG_FILES])
        if not plain and dev.type == "cuda" and reads != counts["replays"]:
            fail(f"{label}: {reads} host reads in {counts['replays']} replays")
        return (out, log), {"ms": ms, "reads": reads, "syncs": n_syncs(caught), **counts}

    cap0 = graphs.capture_s()
    first, first_r = run(False)
    capture_s = graphs.capture_s() - cap0
    ref, plain_r = run(True)
    same_cg(f"{label} (first device call)", first, ref)
    runs = {True: [plain_r], False: []}
    for plain in (False, False, True)[:turns] if turns > 1 else (True,):
        got, r = run(plain)
        same_cg(f"{label} ({'plain' if plain else 'device'})", got, ref)
        runs[plain].append(r)
    device_runs = runs[False] or [first_r]
    iters = [res.iterations for res in ref[1]]
    n_it, n_cg = max(sum(iters), 1), max(len(iters), 1)
    d = min(device_runs, key=lambda r: r["ms"])
    pl = min(runs[True], key=lambda r: r["ms"])
    line = {
        "iterations": iters, "bitwise_equal": True,
        "plain_ms": [r["ms"] for r in runs[True]], "device_ms": [r["ms"] for r in device_runs],
        "first_device_call_ms": first_r["ms"], "capture_s": capture_s,
        "plain_ms_per_iteration": pl["ms"] / n_it, "device_ms_per_iteration": d["ms"] / n_it,
        "replays": d["replays"], "dead_iterations": d["steps"] - d["live_steps"],
        "host_reads_per_solve_plain": pl["reads"] / n_cg,
        "host_reads_per_solve_device": d["reads"] / n_cg,
        "host_syncs_plain": pl["syncs"], "host_syncs_device": d["syncs"],
    }
    for name, values in (("k_readings", ks), ("first_readings", firsts)):
        if not values:
            continue
        line[name] = {}
        for v in values:
            saved = cg.CG_FIRST
            if name == "first_readings":
                cg.CG_FIRST = v
            try:
                k = v if name == "k_readings" else None
                run(False, k)                              # builds and captures
                got, r = run(False, k)
            finally:
                cg.CG_FIRST = saved
            same_cg(f"{label}, {name[:-9]} = {v}", got, ref)
            line[name][v] = {"ms": r["ms"], "ms_per_iteration": r["ms"] / n_it,
                             "replays": r["replays"],
                             "dead_iterations": r["steps"] - r["live_steps"]}
    print(f"chip_smoke: {label}, device loop == plain loop: " + json.dumps(line))
    return line, ref[0]


def wall_ms(fn):
    """Host time of one call of ``fn`` that ends with the device drained."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def _k_system(deck, dev, pbc: bool, **model_kw):
    """The sweep's first state of ``deck``'s structure, its charges and the
    banded model (no pair table): (p, lat, model, element, charge, zeros)."""
    from akmc_tpu_torch.config import KMCParameters
    from akmc_tpu_torch.lattice import build_lattice
    from akmc_tpu_torch.models.vcm import VCMModel
    from akmc_tpu_torch.ops.charge import update_charge_compact
    from akmc_tpu_torch.rng import ReferenceRNG
    from akmc_tpu_torch.runtime.driver import load_structure
    from akmc_tpu_torch.state import make_substoichiometric

    p = KMCParameters.from_file(deck).replace(pbc=pbc)
    element, x, y, z = load_structure(p, os.path.dirname(deck))
    element = make_substoichiometric(element, p.initial_vacancy_concentration,
                                     ReferenceRNG(p.rnd_seed))
    lat = build_lattice(element, x, y, z, p, device=dev)
    # the K operators only: no pair table for these solves
    model = VCMModel(p, lat, device=dev, rate_normalize=True, pair_table_budget=0, **model_kw)
    if model.describe()["k_operator"] != "banded":
        fail(f"pbc={pbc}: the disordered structure of {deck} did not get the banded operator")
    t = model.tables
    elem = torch.as_tensor(lat.element0, dtype=torch.int32, device=dev)
    charge = update_charge_compact(elem, torch.zeros_like(elem), t.neigh_idx,
                                   t.any_metal_nbr, model.vmax)
    return p, lat, model, elem, charge, torch.zeros(lat.N, dtype=torch.float64, device=dev)


def cold_k_solves(deck, dev, pbc: bool) -> dict:
    """The sweep's first state at 1 V through the banded and the ELL
    operator, from a zero start, with both dot products: each CG with its
    device loop and its host loop in turns (``cg_turns``), bit-equal."""
    from akmc_tpu_torch.solvers.banded import band_matvec, solve_potential_boundary_banded
    from akmc_tpu_torch.solvers.cg import f64_vdot
    from akmc_tpu_torch.solvers.poisson import solve_potential_boundary

    p, lat, model, elem, charge, zeros = _k_system(deck, dev, pbc)
    t, bk, meta = model.tables, model.banded, model.band_meta
    geom = (1.0, p.high_G, p.low_G, p.num_atoms_first_layer)
    graphs = model.cg_graphs

    def banded():
        return solve_potential_boundary_banded(bk, meta, elem, charge, zeros, *geom, p.nn_dist,
                                               model._lattice_t, pbc, model.vmax, graphs=graphs)

    def ell():
        return solve_potential_boundary(elem, charge, zeros, t.k_neigh_idx, t.metal_edge, *geom,
                                        graphs=graphs)

    out = {"pbc": pbc, "k_edges": int((lat.k_neigh_idx >= 0).sum()),
           "band_blocks": list(bk.blocks.shape), "half_band": meta.half_band}
    bk.values(meta)                              # first use: decode the band
    for dot_name, dot in (("torch.dot", torch.dot), ("sum(a*b)", f64_vdot)):
        ks = CG_KS if dot is torch.dot and not pbc else ()
        lb, (pot_b, res_b) = cg_turns(dev, f"pbc={int(pbc)} banded K-CG, {dot_name}", banded,
                                      graphs, dot, K_MODULES, ks)
        le, (pot_e, res_e) = cg_turns(dev, f"pbc={int(pbc)} ELL K-CG, {dot_name}", ell,
                                      graphs, dot, K_MODULES, ks)
        err = float((pot_b - pot_e).abs().max())
        close = torch.allclose(pot_b, pot_e, rtol=BANDED_ELL_RTOL, atol=BANDED_ELL_ATOL)
        ms_b, ms_e = min(lb["device_ms"]), min(le["device_ms"])
        out[dot_name] = {
            "banded_iterations": res_b.iterations, "ell_iterations": res_e.iterations,
            "banded_ms": ms_b, "ell_ms": ms_e,
            "banded_ms_per_iteration": ms_b / res_b.iterations,
            "ell_ms_per_iteration": ms_e / res_e.iterations,
            "max_abs_banded_minus_ell": err, "within_tolerance": bool(close),
            "banded_cg": lb, "ell_cg": le,
        }
        print(f"chip_smoke: cold K solve at 1 V, pbc={int(pbc)}, {dot_name}: banded "
              f"{res_b.iterations} iterations {ms_b:.1f} ms (host loop "
              f"{min(lb['plain_ms']):.1f}), ELL {res_e.iterations} iterations {ms_e:.1f} ms "
              f"(host loop {min(le['plain_ms']):.1f}), max |banded - ELL| {err:.3e}")
        if ks:
            # a warm solve from its own solution (a sweep's warm superstep):
            # converged at entry, it runs one dead iteration (the first
            # replay's), or CG_FIRST's other lengths'
            for op_name, fn, pot in (("banded", solve_potential_boundary_banded, pot_b),
                                     ("ell", solve_potential_boundary, pot_e)):
                args = ((bk, meta, elem, charge, pot, *geom, p.nn_dist, model._lattice_t, pbc,
                         model.vmax) if op_name == "banded" else
                        (elem, charge, pot, t.k_neigh_idx, t.metal_edge, *geom))
                out[dot_name][op_name + "_warm_cg"], _ = cg_turns(
                    dev, f"pbc={int(pbc)} warm {op_name} K-CG, {dot_name}",
                    functools.partial(fn, *args, graphs=graphs), graphs, dot, K_MODULES,
                    firsts=(1, 4))
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


def large_banded_solve(dev) -> dict:
    """One cold banded K solve at 1 V on ``synthetic_stack(n_yz =
    LARGE_BANDED_N_YZ)``, its lists built on the card: the device loop
    against the host loop, bit-equal, timed, with the build's seconds."""
    from akmc_tpu_torch.runtime import synth_deck
    from akmc_tpu_torch.solvers.banded import solve_potential_boundary_banded

    t0 = time.perf_counter()
    wd = os.path.join(SYNTH_DIR + f"_n{LARGE_BANDED_N_YZ}")
    shutil.rmtree(wd, ignore_errors=True)
    deck = synth_deck.write_synth_deck(DECK, wd, LARGE_BANDED_N_YZ)
    p, lat, model, elem, charge, zeros = _k_system(deck, dev, False,
                                                   pair_tiling_min_n=1 << 62)
    bk, meta = model.banded, model.band_meta
    bk.values(meta)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    def banded():
        return solve_potential_boundary_banded(
            bk, meta, elem, charge, zeros, 1.0, p.high_G, p.low_G, p.num_atoms_first_layer,
            p.nn_dist, model._lattice_t, False, model.vmax, graphs=model.cg_graphs)

    line, _ = cg_turns(dev, f"banded K-CG at {lat.N} sites", banded, model.cg_graphs,
                       modules=K_MODULES, turns=1)
    nb, T, W = bk.blocks.shape
    out = {"n_yz": LARGE_BANDED_N_YZ, "sites": lat.N, "band_blocks": [nb, T, W],
           "half_band": meta.half_band, "int8_codes_bytes": nb * T * W,
           "decoded_bytes": nb * T * W * 8, "build_s": build_s, **line}
    del model, bk
    torch.cuda.empty_cache()
    return out


LISTS_N_YZ = (24, 48)                # synthetic_stack: 31,088 and 124,412 sites


def disordered_lists(dev) -> dict:
    """The on-card list builder (``lattice_device.py``) against the k-d tree
    on ``synthetic_stack`` at n_yz = 24 (the stand-in: the neighbor list, the
    periodic K adjacency and the cutoff list) and at n_yz = 48 (124,412
    sites: the neighbor list and the periodic K adjacency; its cutoff list
    would hold some 0.4e9 entries), with the deck's cutoffs: equal entry for
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
    times = PartTimes()
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
    with cg_as(dot=f64_vdot, modules=K_MODULES):
        _, rows_sum, counts_sum = drive(deck, os.path.join(SYNTH_DIR, "out_sum_dot"))
    dist_sum = golden.distance(gold, golden.summarize(os.path.join(SYNTH_DIR, "out_sum_dot")))
    # and with the K-CG's host loop: every row but its time equal to the
    # device loop's (the counts the golden is read against do not move)
    plain_dir = os.path.join(SYNTH_DIR, "out_plain_cg")
    with cg_as(plain=True):
        # host loops cannot run inside a captured superstep: the per-loop path
        _, rows_plain, counts_plain = drive(deck, plain_dir, step_program=False)
    if _rows_but_time(plain_dir) != _rows_but_time(out_dir):
        bad.append("the sweep with the K-CG's host loop differs from the device loop's: "
                   + _first_difference(_rows_but_time(out_dir), _rows_but_time(plain_dir)))

    times.mark("sweeps")
    solves = [cold_k_solves(deck, dev, pbc) for pbc in (False, True)]
    times.mark("cold_k_solves")
    large = large_banded_solve(dev)
    times.mark("large_banded_solve")
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
        "large_banded_solve": large,
        "plain_cg_sweep": {
            "rows_equal_but_time": True, "host_syncs_per_superstep":
            counts_plain["host_syncs"] / len(rows_plain),
            "driver_supersteps_s": sum(r["superstep_s"] for r in rows_plain),
            "superstep_s": [r["superstep_s"] for r in rows_plain],
        },
        "lists": disordered_lists(dev), "part_s": times,
    }
    line["cg_loops"] = {f"cold_pbc{int(s['pbc'])}_{op}_{dot}": s[dot][op + "_cg"]
                        for s in solves for dot in ("torch.dot", "sum(a*b)")
                        for op in ("banded", "ell")}
    line["cg_loops"]["large_banded"] = {k: large[k] for k in (
        "sites", "iterations", "bitwise_equal", "plain_ms", "device_ms", "capture_s",
        "plain_ms_per_iteration", "device_ms_per_iteration", "replays", "dead_iterations",
        "host_reads_per_solve_plain", "host_reads_per_solve_device")}
    problems = [s["problem"] for s in solves if s["problem"]]
    if bad:
        problems.append("disordered sweep disagrees with the golden: " + "; ".join(bad[:10]))
    if not _final_potentials_finite(out_dir):
        problems.append("non-finite potentials in the disordered sweep's final snapshot")
    times.mark("lists")
    print("chip_smoke: phase disordered took " + json.dumps(times), flush=True)
    return line, "; ".join(problems) or None


# ---------------------------------------------------------------------------
# the serial superstep as one CUDA graph (models/step_program.py) against the
# per-loop path (VCMModel(step_program=False))
# ---------------------------------------------------------------------------
SG_DIR = os.path.join(HERE, "build", "chip_smoke", "superstep_graph")
SG_BIASES = 2                 # the deck's first bias points, two supersteps at each
SG_NODE_KS = (1, 4, 16)       # events, then iterations, per while-node pass, read on each path
SG_PROFILED = 2               # supersteps in the idle-share window
SG_SPD = 4                    # supersteps per dispatch against one at a time
SG_SPD_CHUNK = 2048           # the rand window of both (superstep_multi's default)
STATE_FIELDS = ("element", "charge", "potential_boundary", "potential_charge", "kmc_time")


def _sg_structures(dev):
    """(name, params, lattice, model options) of the ``sweep`` phase's
    crossbar (DIA, pair table) and the ``disordered`` phase's structure
    (banded, and ELL with the banded form refused)."""
    from akmc_tpu_torch.config import KMCParameters
    from akmc_tpu_torch.lattice import build_lattice
    from akmc_tpu_torch.rng import ReferenceRNG
    from akmc_tpu_torch.runtime import synth_deck
    from akmc_tpu_torch.runtime.driver import load_structure
    from akmc_tpu_torch.state import make_substoichiometric

    _, _, p, lat = crossbar_dia(N_YZ)
    yield "sweep_dia", p, lat, {}
    shutil.rmtree(SG_DIR, ignore_errors=True)
    deck = synth_deck.write_synth_deck(DECK, SG_DIR, N_YZ)
    p = KMCParameters.from_file(deck)
    element, x, y, z = load_structure(p, os.path.dirname(deck))
    element = make_substoichiometric(element, p.initial_vacancy_concentration,
                                     ReferenceRNG(p.rnd_seed))
    lat = build_lattice(element, x, y, z, p, device=dev)
    yield "disordered_banded", p, lat, dict(use_dia_k=False)
    yield "disordered_ell", p, lat, dict(use_dia_k=False, use_banded_k=False)


def _sg_states(model, p, lat, biases, steps_fn):
    """Supersteps of ``model`` from the initial state on a fresh mt19937
    stream, each timed (host clock, the card drained) and its host reads
    counted: (states, stats, ms, reads, loop passes, the stream's next draw)."""
    from akmc_tpu_torch.ops import events as ev
    from akmc_tpu_torch.rng import BufferedStream, ReferenceRNG
    from akmc_tpu_torch.solvers import cg
    from akmc_tpu_torch.state import make_device_state

    dev = model.device
    state = make_device_state(lat, p.background_temp, dev)
    stream = BufferedStream(ReferenceRNG(p.rnd_seed_kmc))
    states, stats, ms, reads, passes = [], [], [], [], []
    for Vd in biases:
        ev.reset_loop_counts()
        cg.reset_cg_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with count_syncs(dev) as caught:
            state, st = steps_fn(model, state, Vd, stream)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        reads.append(n_syncs(caught))
        stats.extend(st)
        states.append({f: getattr(state, f).clone() for f in STATE_FIELDS})
        passes.append({"event_loop": ev.LOOP_COUNTS["serial"]["replays"],
                       "cg": sum(c["replays"] for c in cg.CG_COUNTS.values())})
    return states, stats, ms, reads, passes, stream.peek(1)[0]


def _sg_one(model, state, Vd, stream):
    state, st = model.superstep(state, Vd, stream)
    return state, [st]


def _sg_same(label, a, b) -> None:
    """Fails unless two runs' supersteps are equal to the bit."""
    if a[1] != b[1] or a[5] != b[5]:
        fail(f"superstep_graph {label}: stats or stream differ")
    for i, (sa, sb) in enumerate(zip(a[0], b[0])):
        for f in STATE_FIELDS:
            if not same_bits(sa[f], sb[f]):
                fail(f"superstep_graph {label}: superstep {i} differs in {f}")


def superstep_graph_case(dev, name, p, lat, kw) -> dict:
    """One structure: the per-loop path and the program in turns (loops,
    program, program, loops), every superstep bit-equal; the program's
    reads, passes, capture, redos and continuations; then the program at
    each k of SG_NODE_KS."""
    from torch.profiler import ProfilerActivity, profile

    from akmc_tpu_torch.models.vcm import VCMModel
    from akmc_tpu_torch.ops import dia_matvec as mv
    from akmc_tpu_torch.ops import events as ev
    from akmc_tpu_torch.solvers import cg, dia_cg
    from akmc_tpu_torch.state import make_device_state

    biases = [Vd for Vd in p.V_switch[:SG_BIASES] for _ in range(2)]
    loops = VCMModel(p, lat, device=dev, step_program=False, **kw)
    prog = VCMModel(p, lat, device=dev, **kw)
    desc = prog.describe()
    t0 = time.perf_counter()
    prog._capture_program(make_device_state(lat, p.background_temp, dev), biases[0], 1)
    capture_s = time.perf_counter() - t0
    runs = {False: [], True: []}
    launches = None
    for programmed in (False, True, True, False):
        model = prog if programmed else loops
        if programmed:
            mv.dia_combined_matvec.launches = dia_cg.dia_cg_solve.launches = 0
            dia_cg.reset_iterations_total(dev)
            solves0, iters0 = model.k_solves, model.k_iterations
        counts0 = dict(model.step_counts)
        r = _sg_states(model, p, lat, biases, _sg_one)
        runs[programmed].append(r)
        if programmed:
            launches = {"dia_launches": mv.dia_combined_matvec.launches,
                        "dia_cg_launches": dia_cg.dia_cg_solve.launches,
                        "cg_iterations_counted_on_device": dia_cg.iterations_total(dev),
                        "k_solves": model.k_solves - solves0,
                        "k_iterations": model.k_iterations - iters0}
            steps = {k: model.step_counts[k] - counts0[k] for k in counts0}
    ref = runs[False][0]
    for label, r in (("program 1", runs[True][0]), ("program 2", runs[True][1]),
                     ("loops 2", runs[False][1])):
        _sg_same(f"{name}: {label} against loops 1", ref, r)
    if desc["k_operator"] == "dia":
        # both kernels launched from inside the graph, once per K solve per replay
        if (launches["dia_launches"], launches["dia_cg_launches"]) != (launches["k_solves"],) * 2:
            fail(f"superstep_graph {name}: DIA launches {launches} for the program's K solves")
        if launches["cg_iterations_counted_on_device"] != launches["k_iterations"]:
            fail(f"superstep_graph {name}: the fused CG counted "
                 f"{launches['cg_iterations_counted_on_device']} iterations, the model "
                 f"{launches['k_iterations']}")
    elif launches["dia_launches"] or launches["dia_cg_launches"]:
        fail(f"superstep_graph {name}: a DIA kernel was launched: {launches}")
    best = {pr: min(runs[pr], key=lambda r: sum(r[2])) for pr in (False, True)}
    prog_reads = best[True][3]
    if steps["redos"] == 0 and steps["continues"] == 0 and any(n != 1 for n in prog_reads):
        fail(f"superstep_graph {name}: the program read the host {prog_reads} times")
    warm = [i for i, s in enumerate(ref[1]) if s["cg_iterations"] <= 1]
    cold = [i for i in range(len(ref[1])) if i not in warm]
    out = {
        "model": desc, "supersteps": len(biases), "biases": biases,
        "events": sum(s["n_events"] for s in ref[1]),
        "cg_iterations": [s["cg_iterations"] for s in ref[1]],
        "bitwise_equal": True, "capture_s": capture_s,
        "ms_per_superstep_loops": [sum(r[2]) / len(biases) for r in runs[False]],
        "ms_per_superstep_program": [sum(r[2]) / len(biases) for r in runs[True]],
        "superstep_ms_loops": best[False][2], "superstep_ms_program": best[True][2],
        "warm_ms_mean": {
            "loops": sum(best[False][2][i] for i in warm) / max(1, len(warm)),
            "program": sum(best[True][2][i] for i in warm) / max(1, len(warm))},
        "cold_ms_mean": {
            "loops": sum(best[False][2][i] for i in cold) / max(1, len(cold)),
            "program": sum(best[True][2][i] for i in cold) / max(1, len(cold))},
        "host_reads_per_superstep_loops": sum(best[False][3]) / len(biases),
        "host_reads_per_superstep_program": sum(prog_reads) / len(biases),
        "host_reads_program": prog_reads,
        "while_passes_program": best[True][4], "replays_loops": best[False][4],
        "redos": steps["redos"], "continues": steps["continues"], "program_runs": steps["runs"],
        "node_k": {"cg": cg.CG_NODE_K, "event_loop": ev.SERIAL_NODE_K},
        "launches": launches,
    }
    # each while node's k in turn, the other node at its default
    saved = cg.CG_NODE_K, ev.SERIAL_NODE_K
    out["node_k_readings"] = {}
    nodes = (("event_loop", ev), ("cg", cg)) if desc["k_operator"] != "dia" else (
        ("event_loop", ev),)
    try:
        for node, mod in nodes:
            attr = "SERIAL_NODE_K" if node == "event_loop" else "CG_NODE_K"
            for k in SG_NODE_KS:
                cg.CG_NODE_K, ev.SERIAL_NODE_K = saved
                if k == getattr(mod, attr):      # the turns' own program
                    r = best[True]
                    out["node_k_readings"][f"{node}_k{k}"] = {
                        "ms_per_superstep": sum(r[2]) / len(biases),
                        "warm_ms_mean": sum(r[2][i] for i in warm) / max(1, len(warm)),
                        "cold_ms_mean": sum(r[2][i] for i in cold) / max(1, len(cold)),
                        "passes": r[4], "capture_s": capture_s}
                    continue
                setattr(mod, attr, k)
                t0 = time.perf_counter()
                prog._capture_program(make_device_state(lat, p.background_temp, dev),
                                      biases[0], 1)
                cap = time.perf_counter() - t0
                r = _sg_states(prog, p, lat, biases, _sg_one)
                _sg_same(f"{name}: {node} node k = {k}", ref, r)
                out["node_k_readings"][f"{node}_k{k}"] = {
                    "ms_per_superstep": sum(r[2]) / len(biases),
                    "warm_ms_mean": sum(r[2][i] for i in warm) / max(1, len(warm)),
                    "cold_ms_mean": sum(r[2][i] for i in cold) / max(1, len(cold)),
                    "passes": r[4], "capture_s": cap}
    finally:
        cg.CG_NODE_K, ev.SERIAL_NODE_K = saved
    # the device's idle share over the first SG_PROFILED supersteps under
    # the profiler, against their unprofiled wall (the best run's)
    out["profiled"] = {}
    for pr, model in ((False, loops), (True, prog)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as trace:
            _sg_states(model, p, lat, biases[:SG_PROFILED], _sg_one)
            torch.cuda.synchronize()
        share = busy_share(trace)
        wall = sum(best[pr][2][:SG_PROFILED])
        share["unprofiled_ms"] = wall
        if share.get("busy_ms") is not None:
            share["idle_share_vs_unprofiled"] = 1.0 - share["busy_ms"] / wall
        out["profiled"]["program" if pr else "loops"] = share
    out["program_capture_s_all"] = prog.step_graphs.capture_s()
    out["lifetime"] = lifetime_checks(dev, prog, f"superstep_graph {name}")
    print(f"chip_smoke: superstep_graph {name}: " + json.dumps(out))
    return out


def superstep_graph_spd(dev, p, lat) -> dict:
    """``superstep_multi`` of SG_SPD supersteps per dispatch against one at a
    time (both on windows of SG_SPD_CHUNK draws), on the sweep's crossbar:
    the same stats, states and stream; reads and ms per superstep."""
    from akmc_tpu_torch.models.vcm import VCMModel
    from akmc_tpu_torch.state import make_device_state

    model = VCMModel(p, lat, device=dev)
    biases = list(p.V_switch[:SG_BIASES // 2])
    state0 = make_device_state(lat, p.background_temp, dev)
    t0 = time.perf_counter()
    model._capture_program(state0, biases[0], SG_SPD, SG_SPD_CHUNK)
    model._capture_program(state0, biases[0], 1, SG_SPD_CHUNK)
    capture_s = time.perf_counter() - t0

    def one_at_a_time(m, state, Vd, stream):
        sts = []
        for _ in range(SG_SPD):
            state, st = m.superstep(state, Vd, stream, rand_chunk=SG_SPD_CHUNK)
            sts.append(st)
        return state, sts

    def batched(m, state, Vd, stream):
        return m.superstep_multi(state, Vd, stream, k=SG_SPD, rand_chunk=SG_SPD_CHUNK)

    runs = {}
    for name, fn in (("k1", one_at_a_time), ("spd", batched), ("spd", batched),
                     ("k1", one_at_a_time)):
        counts0 = dict(model.step_counts)
        r = _sg_states(model, p, lat, biases, fn)
        runs.setdefault(name, []).append((r, {k: model.step_counts[k] - counts0[k]
                                              for k in counts0}))
    ref = runs["k1"][0][0]
    for name, rs in runs.items():
        for r, _ in rs:
            _sg_same(f"steps per dispatch {name}", ref, r)
    n = len(biases) * SG_SPD
    best = {name: min(rs, key=lambda x: sum(x[0][2])) for name, rs in runs.items()}
    spd_reads = sum(best["spd"][0][3])
    if best["spd"][1]["discards"] == 0 and spd_reads != len(biases):
        fail(f"superstep_graph: {SG_SPD} supersteps per dispatch read the host {spd_reads} "
             f"times in {len(biases)} dispatches")
    return {
        "supersteps": n, "k": SG_SPD, "rand_chunk": SG_SPD_CHUNK, "bitwise_equal": True,
        "capture_s": capture_s,
        "ms_per_superstep_k1": [sum(r[2]) / n for r, _ in runs["k1"]],
        "ms_per_superstep_spd": [sum(r[2]) / n for r, _ in runs["spd"]],
        "host_reads_per_superstep_k1": sum(best["k1"][0][3]) / n,
        "host_reads_per_superstep_spd": spd_reads / n,
        "discards": best["spd"][1]["discards"], "continues_k1": best["k1"][1]["continues"],
    }


def run_superstep_graph(dev):
    """(superstep_graph line, None): every check fails the script itself."""
    from akmc_tpu_torch.ops import device_loop

    runtime, driver = device_loop.cuda_versions()
    line = {"cuda_runtime": runtime, "cuda_driver": driver,
            "torch": torch.__version__, "torch_cuda": torch.version.cuda}
    crossbar = None
    for name, p, lat, kw in _sg_structures(dev):
        line[name] = superstep_graph_case(dev, name, p, lat, kw)
        if name == "sweep_dia":
            crossbar = (p, lat)
        torch.cuda.empty_cache()
    line["steps_per_dispatch"] = superstep_graph_spd(dev, *crossbar)
    return line, None


# ---------------------------------------------------------------------------
# the production supersteps as one CUDA graph each, drawing from the
# threefry key on the card (models/step_program.py::ProductionProgram,
# csrc/threefry.cu)
# ---------------------------------------------------------------------------
PG_N_YZ = 64                  # 409,600 slots, as the batched phase's crossbar
PG_STEPS = 2                  # batched supersteps a run, the first cold
PG_NODE_KS = (1, 4, 16)       # batches per pass of the while node, read in turn
PG_PROFILED = 1               # supersteps in the idle-share window
PG_SEED = 31                  # the runs' key: PRNGKey(PG_SEED)
PG_MASS_EPS = 1e-3
PG_BATCH = 64
# the n_yz = 24 sweep's batched run, held to its golden (akmc_tpu's driver on
# the CPU, --batched-events 16 --dia-pallas): akmc_tpu's two-stage top-k takes
# at most as many candidates as the table has 256-row blocks, 31 there
BATCHED_GOLDEN = os.path.join(HERE, "akmc_tpu_torch", "golden", "iv_sweep_5nm_n24_batched.json")
BATCHED_SWEEP_DIR = os.path.join(HERE, "build", "chip_smoke", "iv_sweep_n24_batched")
BATCHED_SWEEP_B = 16
# Its KMC times: within GOLDEN_KMC_RTOL at the supersteps whose K-CG stopped
# at the golden's count. Where the card's stops one iteration away (3 of 23
# on the H100), the superstep's one batch races on rates that far from the
# golden's, and its terminating gap moved by 5.54e-4 (ROADMAP §3.4; akmc_tpu's
# own f64-XLA-against---dia-pallas spread on this sweep is 2.24e-4, with
# counts 161 / 162 and 312 / 311 apart). The bound there is that reading,
# rounded up; events, supersteps and final elements are exact.
BATCHED_KMC_RTOL_OTHER_STOP = 1e-3
# clocks a batch draws, timed (f64; 610,304 in f32 too), and the shape whose
# readings the kernels line gives: the flagship's rate table and B
THREEFRY_ROWS = (409_600, 610_304, 4_622_500)
THREEFRY_MAIN = (610_304, 64)
WHILE_PASSES = 10_000


def _production_counts() -> dict:
    from akmc_tpu_torch.ops import device_loop, threefry

    return {"threefry_launches": threefry.draw_step.launches,
            "while_condition_launches": device_loop.while_loop.launches}


def _reset_production_counts() -> None:
    from akmc_tpu_torch.ops import device_loop, threefry

    threefry.draw_step.launches = 0
    device_loop.while_loop.launches = 0


INT32_LANES_PER_SM = 64          # H100: 4 partitions x 16 INT32 lanes a clock


def threefry_int_work() -> dict:
    """The integer work a value of ``csrc/threefry.cu`` needs, read from the
    card's build: ``cuobjdump -sass`` of the library, the instructions of
    ``threefry_step``, and among them the 32-bit integer ones that issue to
    the INT32 (ALU) pipe: IADD3, LOP3, SHF, LEA, ISETP and the like; IMAD,
    which the compiler also uses for moves, issues to the FMA pipe and is
    left out. The block function is unrolled once per kind of value the
    kernel draws, and its 20 rotations are 20 funnel shifts (SHF.L.W), so a
    value's share is the integer instructions over the copies (funnel
    shifts / 20). With the card's SM count and highest SM clock
    (``nvidia-smi``) that gives the integer rate of the bound."""
    ops = [op for _, op, _ in _sass_ops("threefry", "threefry_step")]
    roots = collections.Counter(op.split(".")[0] for op in ops)
    ints = [op for op in ops if op.split(".")[0] in (
        "IADD3", "IADD", "LOP3", "LOP", "SHF", "LEA", "IABS", "ISCADD", "PRMT", "SEL",
        "IMNMX", "ISETP", "FLO", "POPC", "BREV")]
    funnel = sum(op.startswith("SHF.L.W") or op.startswith("SHF.R.W") for op in ops)
    copies = max(1, round(funnel / 20))
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                            "--format=csv,noheader,nounits"], capture_output=True, text=True,
                           timeout=60).stdout.split()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(clock[0]) if clock else float("nan")
    return {"sass_instructions": len(ops), "opcodes": dict(roots.most_common()),
            "int_instructions": len(ints),
            "funnel_shifts": funnel, "block_copies": copies,
            "int_ops_per_value": len(ints) / copies, "sms": sms, "sm_clock_max_mhz": mhz,
            "int32_ops_per_s": sms * INT32_LANES_PER_SM * mhz * 1e6,
            "source": "cuobjdump -sass of the built library; nvidia-smi clocks.max.sm"}


def check_threefry(dev) -> dict:
    """``csrc/threefry.cu`` against its twin (``draw_step_plain``) at the
    main path's shapes: live, live, dead and live steps and the superstep's
    split, every bit of the draws, subkeys and key; then timed by CUDA
    events beside the twin on the card, ``torch.rand`` of the same shapes
    (a yardstick: it computes no threefry) and the bound: the larger of the
    bytes and the integer work (``threefry_int_work``), with the share of it
    reached."""
    from akmc_tpu_torch.ops import threefry

    work = threefry_int_work()

    def case(n, B, dtype, timed=True):
        st_c = threefry.key_state(threefry.prng_key(PG_SEED + n, dev))
        st_h = st_c.cpu()
        u_c = torch.zeros(n, dtype=dtype, device=dev)
        v_c = torch.zeros(B, dtype=torch.float64, device=dev)
        u_h, v_h = u_c.cpu(), v_c.cpu()
        for live in (True, True, False, True, None):
            lc = None if live is None else torch.full((), live, dtype=torch.bool, device=dev)
            lh = None if live is None else torch.tensor(live)
            threefry.draw_step(st_c, lc, *(() if live is None else (u_c, v_c)))
            threefry.draw_step_plain(st_h, lh, *((None, None) if live is None else (u_h, v_h)))
        torch.cuda.synchronize()
        for a, b in ((st_c, st_h), (u_c, u_h), (v_c, v_h)):
            if not torch.equal(a.cpu().view(torch.uint8), b.view(torch.uint8)):
                fail(f"threefry kernel differs from its twin at n = {n}, B = {B}, {dtype}")
        err = max([0.0] + [float((a.cpu().double() - b.double()).abs().max())
                           for a, b in ((u_c, u_h), (v_c, v_h)) if a.numel()])
        if not timed:
            return {"n": n, "B": B, "max_abs_err": err}
        live = torch.ones((), dtype=torch.bool, device=dev)
        st_p = st_c.clone()
        n_bytes = n * u_c.element_size() + B * 8 + 2 * threefry.STATE_LEN * 8
        step = functools.partial(threefry.draw_step, st_c, live, u_c, v_c)
        return {
            "n": n, "B": B, "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
            # the device's time of a launch: 100 launches replayed as one
            # graph (one after another from the host, the launches' host
            # path, about 15 us, is what CUDA events read: "stream_ms")
            "ms": graph_launch_ms(step),
            "stream_ms": cuda_time_ms(step, reps=200),
            "plain_ms": graph_launch_ms(
                lambda: threefry.draw_step_plain(st_p, live, u_c, v_c), n=10),
            "library_ms": graph_launch_ms(lambda: (torch.rand(n, dtype=dtype, device=dev),
                                                   torch.rand(B, dtype=torch.float64, device=dev))),
            "bytes": n_bytes, "bytes_bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
            "int_bound_ms": (n + B) * work["int_ops_per_value"] / work["int32_ops_per_s"] * 1e3,
        }

    shapes = [case(n, PG_BATCH, torch.float64) for n in THREEFRY_ROWS]
    shapes.append(case(THREEFRY_MAIN[0], PG_BATCH, torch.float32))
    for c in shapes:
        c["bound_ms"] = max(c["bytes_bound_ms"], c["int_bound_ms"])
        c["bound_by"] = "operations" if c["int_bound_ms"] > c["bytes_bound_ms"] else "bytes"
        c["share_of_bound"] = c["bound_ms"] / c["ms"]
    for n, B in ((1, 1), (0, 0), (100, 300)):       # the native event, the split, B > n
        case(n, B, torch.float64, timed=False)
    main = next(c for c in shapes if (c["n"], c["B"], c["dtype"]) == (*THREEFRY_MAIN, "float64"))
    print("chip_smoke: threefry kernel against its twin: " + json.dumps(shapes))
    print("chip_smoke: threefry integer work: " + json.dumps(work))
    return {
        "name": "threefry draw_step",
        "route": "cuda",
        "source": "akmc_tpu_torch/csrc/threefry.cu",
        "replaces": "akmc_tpu/ops/events.py:589 (jax.random.split and uniform in the batched "
                    "loop, :834 in the native loop): XLA's threefry, no pallas_call",
        "launches": None,                      # filled in from the production_graph phase
        "max_abs_err": max(c["max_abs_err"] for c in shapes),
        "bitwise_equal_to_twin": True,
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "int_work": work,
        "library_ms": main["library_ms"],
        "library": "torch.rand of the same shapes (Philox, not threefry: a yardstick)",
        "time_source": "CUDA events over a graph of 100 launches (the twin: 10)",
        "shape": {"n": main["n"], "B": main["B"], "dtype": main["dtype"],
                  "bytes": main["bytes"]},
        "shapes": shapes,
    }


def graph_launch_ms(fn, n: int = 100) -> float:
    """Device ms of one call of ``fn``: ``n`` calls captured into one CUDA
    graph, its replays timed by CUDA events (no host path between them)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return cuda_time_ms(graph.replay, reps=5, warmup=1) / n


def check_graph_while(dev) -> dict:
    """``csrc/graph_while.cu``'s while node against its plain version (the
    same body as a host loop that reads the flag each pass): a counter run to
    WHILE_PASSES, equal counts, timed per pass (CUDA events over the replay;
    the host loop on the host clock)."""
    from akmc_tpu_torch.ops import device_loop

    count = torch.zeros((), dtype=torch.int64, device=dev)
    limit = torch.full((), WHILE_PASSES, dtype=torch.int64, device=dev)
    live = torch.zeros((), dtype=torch.bool, device=dev)

    def body():
        count.add_(1)
        live.copy_(count < limit)

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        live.copy_(count < limit)
        device_loop.while_loop(live, body)

    def node():
        count.zero_()
        graph.replay()

    def host():
        count.zero_()
        live.copy_(count < limit)
        while bool(live):
            body()

    node_ms = cuda_time_ms(node, reps=5, warmup=1)
    got_node = int(count)
    t0 = time.perf_counter()
    host()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    if got_node != int(count) or got_node != WHILE_PASSES:
        fail(f"while node ran {got_node} passes, the host loop {int(count)}")
    # per pass: the flag (1 B) and the counter and limit (16 B) read, the
    # counter and the flag written (9 B)
    n_bytes = 26 * WHILE_PASSES
    return {
        "name": "graph_while (conditional while node)",
        "route": "cuda",
        "source": "akmc_tpu_torch/csrc/graph_while.cu",
        "replaces": "none: graph plumbing for akmc_tpu's lax.while_loop "
                    "(akmc_tpu/ops/events.py:795), no pallas_call",
        "launches": None,                      # filled in from the production_graph phase
        "max_abs_err": float(abs(got_node - int(count))),
        "ms": node_ms / WHILE_PASSES, "plain_ms": host_ms / WHILE_PASSES,
        "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3 / WHILE_PASSES, "bound_by": "bytes",
        "library_ms": None,
        "time_source": f"CUDA events over a replay of {WHILE_PASSES} passes (per pass); "
                       "the host loop on the host clock",
        "shape": {"passes": WHILE_PASSES, "body": "counter add, flag compare"},
    }


def _pg_run(model, state0, steps=PG_STEPS, kind="batched"):
    """``steps`` production supersteps from ``state0`` on PRNGKey(PG_SEED),
    each timed (host clock, the card drained) with its host reads counted:
    (states, stats, ms, reads, the key left behind)."""
    from akmc_tpu_torch.ops import events as ev
    from akmc_tpu_torch.ops.threefry import KeyDraws

    draws = KeyDraws.seeded(PG_SEED, model.device)
    state, pb_prev2 = state0, None
    states, stats, ms, reads, passes = [], [], [], [], []
    for _ in range(steps):
        ev.reset_loop_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with count_syncs(model.device) as caught:
            pb = state.potential_boundary
            if kind == "batched":
                state, st = model.superstep_native_batched(
                    state, CROSSBAR_VD, draws, batch=PG_BATCH, mass_eps=PG_MASS_EPS,
                    pb_prev2=pb_prev2)
            else:
                state, st = model.superstep_native(state, CROSSBAR_VD, draws)
            pb_prev2 = pb
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        reads.append(n_syncs(caught))
        stats.append(st)
        states.append({f: getattr(state, f).clone() for f in STATE_FIELDS})
        passes.append(dict(ev.LOOP_COUNTS["batched" if kind == "batched" else "native"]))
    return states, stats, ms, reads, draws.key.tolist(), passes


def _program_replay_ms(model, state0, steps) -> list:
    """The batched supersteps of ``_pg_run`` once more, each graph replay
    bracketed by CUDA events: the card's time of each program run (none on
    the CPU, where no graph runs)."""
    return program_replay_ms(lambda: _pg_run(model, state0, steps))[1]


def program_replay_ms(fn) -> tuple:
    """``fn()`` with every program replay bracketed by CUDA events: (its
    result, the card's ms of each replay)."""
    from akmc_tpu_torch.models import step_program

    times, run = [], step_program._Program.run

    class Bracketed:
        def __init__(self, graph):
            self.graph = graph
            self.events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

        def replay(self):
            self.events[0].record()
            self.graph.replay()
            self.events[1].record()

    def timed(prog, *args):
        if prog.graph is None:
            return run(prog, *args)
        graph = prog.graph
        prog.graph = Bracketed(graph)
        try:
            return run(prog, *args)
        finally:
            a, b = prog.graph.events
            prog.graph = graph
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))

    step_program._Program.run = timed
    try:
        return fn(), times
    finally:
        step_program._Program.run = run


def _pg_same(label, a, b) -> None:
    if a[1] != b[1] or a[4] != b[4]:
        fail(f"production_graph {label}: stats or key differ: {a[1]} / {b[1]}")
    for i, (sa, sb) in enumerate(zip(a[0], b[0])):
        for f in STATE_FIELDS:
            if not same_bits(sa[f], sb[f]):
                fail(f"production_graph {label}: superstep {i} differs in {f}")


@contextlib.contextmanager
def _per_loop(model, on: bool):
    """The model's production supersteps on the per-loop path while ``on``."""
    saved = model.step_program
    model.step_program = not on
    try:
        yield
    finally:
        model.step_program = saved


def production_turns(dev, model, state0, where, kind="batched", steps=PG_STEPS):
    """The per-loop path and the program in turns (loops, program, program,
    loops) from one key: every superstep bit-equal (state, stats, key);
    the program's host reads (one a superstep), launches and ms. Returns
    (readings, the first run)."""
    from akmc_tpu_torch.ops import dia_matvec as mv
    from akmc_tpu_torch.solvers import dia_cg

    runs = {False: [], True: []}
    launches = None
    for programmed in (False, True, True, False):
        with _per_loop(model, not programmed):
            counts0 = dict(model.step_counts)
            if programmed:
                _reset_production_counts()
                since = reset_launches(dev, model)
            r = _pg_run(model, state0, steps, kind)
            steps_done = {k: model.step_counts[k] - counts0[k] for k in counts0}
            if programmed:
                launches = {**_production_counts(),
                            "dia_launches": mv.dia_combined_matvec.launches,
                            "dia_cg_launches": dia_cg.dia_cg_solve.launches,
                            "k_solves": model.k_solves - since[0]}
                if steps_done["runs"] != steps + steps_done["redos"] or steps_done["per_loop"]:
                    fail(f"{where} {kind}: the program path ran {steps_done}")
                if dev.type == "cuda" and not steps_done["redos"] and any(n != 1 for n in r[3]):
                    fail(f"{where} {kind}: the program read the host {r[3]} times")
            elif steps_done["per_loop"] != steps:
                fail(f"{where} {kind}: the per-loop path ran {steps_done}")
        runs[programmed].append(r)
    ref = runs[False][0]
    for label, r in (("program 1", runs[True][0]), ("program 2", runs[True][1]),
                     ("loops 2", runs[False][1])):
        _pg_same(f"{where} {kind}: {label} against loops 1", ref, r)
    # one launch of the threefry kernel for the superstep's split and one per
    # batch or event (k = 1 a pass; each pass is a live step), the while
    # node's condition once per pass and once at entry, per loop
    live = sum(x.get("n_batches", x["n_events"]) for x in ref[1])
    if dev.type == "cuda" and (launches["dia_launches"] != launches["k_solves"]
                               or launches["dia_cg_launches"] != launches["k_solves"]):
        fail(f"{where} {kind}: DIA launches {launches} for the program's K solves")
    if dev.type == "cuda" and (launches["threefry_launches"] < steps + live
                               or launches["while_condition_launches"] < 1):
        fail(f"{where} {kind}: the program launched {launches} for {live} batches or events")
    best = {pr: min(runs[pr], key=lambda x: sum(x[2])) for pr in (False, True)}
    return ref, {
        "supersteps": steps, "bitwise_equal": True,
        "events": [x["n_events"] for x in ref[1]],
        "batches": [x.get("n_batches") for x in ref[1]],
        "cg_iterations": [x["cg_iterations"] for x in ref[1]],
        "ms_loops": best[False][2], "ms_program": best[True][2],
        "ms_per_superstep_loops": [sum(x[2]) / steps for x in runs[False]],
        "ms_per_superstep_program": [sum(x[2]) / steps for x in runs[True]],
        "cold_ms": {"loops": best[False][2][0], "program": best[True][2][0]},
        "warm_ms_mean": {"loops": sum(best[False][2][1:]) / max(1, steps - 1),
                         "program": sum(best[True][2][1:]) / max(1, steps - 1)},
        "host_reads_loops": best[False][3], "host_reads_program": best[True][3],
        "passes_program": [x["replays"] for x in best[True][5]],
        "replays_loops": [x["replays"] for x in best[False][5]],
        "launches": launches,
    }


def batched_sweep(dev) -> dict:
    """The n_yz = 24 sweep through the driver with --batched-events (the
    production programs, the key on the card) against its golden: events,
    supersteps and final elements exactly, KMC times within GOLDEN_KMC_RTOL;
    each K solve launched the DIA kernels once."""
    from akmc_tpu_torch.runtime import golden

    _reset_production_counts()
    summary, rows, counts = drive(DECK, BATCHED_SWEEP_DIR, synthesize_crossbar=N_YZ,
                                  dia_pallas=True, batched_events=BATCHED_SWEEP_B)
    counts.update(_production_counts())
    check_launches("batched sweep", summary, rows, counts)
    if torch.cuda.is_available() and \
            counts["threefry_launches"] < len(rows) + sum(r["n_batches"] for r in rows):
        fail(f"the batched sweep launched the threefry kernel {counts['threefry_launches']} "
             f"times in {len(rows)} supersteps")
    got = golden.summarize(BATCHED_SWEEP_DIR)
    with open(BATCHED_GOLDEN) as f:
        gold = json.load(f)
    bad = golden.compare(gold, got, BATCHED_KMC_RTOL_OTHER_STOP)
    rel_same = [abs(h["kmc_time"] - g["kmc_time"]) / abs(g["kmc_time"])
                for g, h in zip(gold["supersteps"], got["supersteps"])
                if g["cg_iterations"] == h["cg_iterations"]]
    if max(rel_same, default=0.0) > GOLDEN_KMC_RTOL:
        bad.append(f"KMC time {max(rel_same):.3e} from the golden at a superstep with the "
                   f"golden's CG count (rtol {GOLDEN_KMC_RTOL})")
    dist = golden.distance(gold, got)
    with open(BATCHED_SWEEP_DIR + ".record.json", "w") as f:
        json.dump(got, f)
    line = {"batched_events": BATCHED_SWEEP_B, "supersteps": len(rows),
            "events": sum(r["n_events"] for r in rows),
            "batches": sum(r["n_batches"] for r in rows),
            "kmc_time_max_rel_vs_golden": dist["kmc_time_max_rel"],
            "kmc_time_max_rel_vs_golden_same_stop": max(rel_same, default=0.0),
            "cg_iterations_differ_from_golden": dist["cg_iterations_differ"],
            "golden_kmc_rtol_same_stop": GOLDEN_KMC_RTOL,
            "golden_kmc_rtol_other_stop": BATCHED_KMC_RTOL_OTHER_STOP,
            "superstep_s": [r["superstep_s"] for r in rows],
            "driver_total_s": summary["total_time_s"],
            "host_syncs_per_superstep": counts["host_syncs"] / len(rows),
            **{k: counts[k] for k in ("dia_launches", "dia_cg_launches", "threefry_launches",
                                      "while_condition_launches", "peak_mem_gb")}}
    print("chip_smoke: production_graph batched sweep: " + json.dumps(line))
    if bad:
        fail("the batched sweep disagrees with its golden: " + "; ".join(bad[:10]))
    return line


def run_production_graph(dev):
    """(production_graph line, None): the batched and native production
    supersteps of the n_yz = 64 crossbar (409,600 slots, 15 V) as one CUDA
    graph each against the per-loop path, the batched node at each k of
    PG_NODE_KS, the idle share profiled and unprofiled, and the n_yz = 24
    batched sweep against its golden. Every check fails the script."""
    from torch.profiler import ProfilerActivity, profile

    from akmc_tpu_torch.ops import events as ev
    from akmc_tpu_torch.state import make_device_state

    sweep = batched_sweep(dev)
    p, lat, model, desc, build = crossbar_model(dev, PG_N_YZ)
    state0 = make_device_state(lat, p.background_temp, dev)
    t0 = time.perf_counter()
    warm = model.warmup(state0, CROSSBAR_VD, batched=PG_BATCH)
    capture_s = time.perf_counter() - t0
    with _per_loop(model, True):
        t0 = time.perf_counter()
        warm_loops = model.warmup(state0, CROSSBAR_VD, batched=PG_BATCH)
        capture_loops_s = time.perf_counter() - t0
    line = {"slots": lat.N, "Vd": CROSSBAR_VD, "model": desc, **build,
            "rate_table_rows": int(model.tables.act_neigh.shape[0]),
            "warmup_program": warm, "warmup_program_s": capture_s,
            "warmup_loops": warm_loops, "warmup_loops_s": capture_loops_s,
            "B": PG_BATCH, "mass_eps": PG_MASS_EPS, "node_k": ev.BATCHED_NODE_K}
    ref, line["batched"] = production_turns(dev, model, state0, "production_graph")
    print("chip_smoke: production_graph batched: " + json.dumps(line["batched"]))
    # the batched while node at each other k, in the table's order, the same
    # supersteps (k = BATCHED_NODE_K is the turns' program)
    saved = ev.BATCHED_NODE_K
    line["node_k_readings"] = {f"k{saved}": {
        "ms": line["batched"]["ms_program"],
        "ms_per_superstep": sum(line["batched"]["ms_program"]) / PG_STEPS,
        "warm_ms_mean": line["batched"]["warm_ms_mean"]["program"],
        "passes": line["batched"]["passes_program"],
        "program_capture_s": model._production_program(state0, PG_BATCH, False).capture_s}}
    try:
        for k in PG_NODE_KS:
            if k == saved:
                continue
            ev.BATCHED_NODE_K = k
            t0 = time.perf_counter()
            prog = model._capture_production(state0, CROSSBAR_VD, PG_BATCH, False)
            cap = time.perf_counter() - t0
            r = _pg_run(model, state0)
            _pg_same(f"node k = {k}", ref, r)
            line["node_k_readings"][f"k{k}"] = {
                "ms": r[2], "ms_per_superstep": sum(r[2]) / PG_STEPS,
                "warm_ms_mean": sum(r[2][1:]) / (PG_STEPS - 1),
                "passes": [x["replays"] for x in r[5]], "capture_s": cap,
                "program_capture_s": prog.capture_s}
    finally:
        ev.BATCHED_NODE_K = saved
    print("chip_smoke: production_graph node k: " + json.dumps(line["node_k_readings"]))
    # one native superstep each way, from the first batched superstep's state
    state1 = ref[0][0]
    state1 = state0.replace(**{f: state1[f] for f in STATE_FIELDS})
    with _per_loop(model, True):
        model.warmup(state1, CROSSBAR_VD)
    t0 = time.perf_counter()
    model._capture_production(state1, CROSSBAR_VD, 0, False)
    line["native_capture_s"] = time.perf_counter() - t0
    _, line["native"] = production_turns(dev, model, state1, "production_graph",
                                         kind="native", steps=1)
    print("chip_smoke: production_graph native: " + json.dumps(line["native"]))
    line["program_capture_s_all"] = model.step_graphs.capture_s()
    line["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    # the device's idle share over the first PG_PROFILED supersteps, against
    # their unprofiled wall (the best run's): the per-loop path under the
    # profiler; the program by CUDA events around each replay (the graph's
    # time on the card), as since PR 14, when torch.profiler's trace of its
    # replays here ended in an illegal memory access (no longer so: the
    # profiler_fault phase)
    line["profiled"] = {"supersteps": PG_PROFILED}
    with _per_loop(model, True):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as trace:
            _pg_run(model, state0, PG_PROFILED)
            torch.cuda.synchronize()
    share = busy_share(trace)
    wall = sum(line["batched"]["ms_loops"][:PG_PROFILED])
    share["unprofiled_ms"] = wall
    if share.get("busy_ms") is not None:
        share["idle_share_vs_unprofiled"] = 1.0 - share["busy_ms"] / wall
    line["profiled"]["loops"] = share
    replay_ms = _program_replay_ms(model, state0, PG_PROFILED)
    wall = sum(line["batched"]["ms_program"][:PG_PROFILED])
    line["profiled"]["program"] = {
        "source": "CUDA events around each replay", "graph_ms": replay_ms,
        "busy_ms": sum(replay_ms), "unprofiled_ms": wall,
        "idle_share_vs_unprofiled": 1.0 - sum(replay_ms) / wall}
    print("chip_smoke: production_graph idle share: " + json.dumps(line["profiled"]))
    line["lifetime"] = lifetime_checks(dev, model, "production_graph")
    line["batched_sweep"] = sweep
    return line, None


def pair_tiled_work(tiling, r_tile, pos, charge, cutoff_radius, qmax, cand_cap, block=512):
    """(pairs the f32 kernel tests, pairs of them inside the cutoff) in one
    call: each tile's real sites times its first ``cand_cap`` in-reach
    candidates, and those of the pairs that pass the f32 cutoff and self
    tests."""
    from akmc_tpu_torch.ops import pairwise as pw

    f32 = torch.float32
    q_idx, qv, q_pos, _, _ = pw._charged_list(pos, charge, qmax)
    sel, cand, _ = pw.tile_candidates(tiling, r_tile, q_pos, qv, cutoff_radius,
                                      min(cand_cap, qmax))
    real = tiling.tile_sites >= 0
    tested = int((real.sum(dim=1) * sel.sum(dim=1)).sum())
    cut2 = torch.tensor(cutoff_radius ** 2, dtype=torch.float64).to(f32)
    p32, q32 = tiling.pos_tiles.to(f32), q_pos.to(f32)
    inside = 0
    for s in range(0, sel.shape[0], block):
        c, b = cand[s:s + block], slice(s, s + block)
        d2 = pw._d2(*(p32[b, :, None, a] - q32[c][:, None, :, a] for a in range(3)))
        inside += int(((d2 < cut2) & sel[b, None, :] & real[b, :, None]
                       & (tiling.tile_sites[b, :, None] != q_idx[c][:, None, :])).sum())
    return tested, inside


def pair_tiled_bound(inside: int) -> dict:
    """The least time of the f32 tiled pairwise solve for ``inside`` pairs
    in the cutoff, on the card's issue rate or its MUFU rate."""
    issue, mufu = PAIR_ISSUE * inside / LANE_INSTR_PER_S, PAIR_MUFU * inside / MUFU_PER_S
    return {"bound_ms": 1e3 * max(issue, mufu), "bound_by": "issue" if issue >= mufu else "mufu"}


def pair_tiled_issue_ms(tested: int, inside: int) -> float:
    """The issue time of the instructions the f32 kernel's SASS spends on
    that work: a diagnostic beside the bound, not a bound."""
    return 1e3 * (PAIR_TEST_INSTR * tested + PAIR_TERM_INSTR * inside) / LANE_INSTR_PER_S


def pair_tiled_readings(model, charge, where: str, timed: bool = True) -> dict:
    """The tiled pairwise kernel (``csrc/pair_tiled.cu``) against its plain
    twin on ``model``'s tiling (a rank's share included) and ``charge``:
    potential and both flags bit-equal in the f32 and the f64 plane, or the
    run fails. With ``timed``: the launch alone and the whole call (each a
    graph of calls, CUDA events; the outputs checked again after), the
    twin's call, the pairs and the bound of the f32 plane's work, the
    kernel's own issue time, and the seconds all this took."""
    from akmc_tpu_torch.ops import pairwise as pw

    t0 = time.perf_counter()
    p, t = model.params, model.tables
    args = (t.pair_tiling, model._pair_r_tile, t.pos, charge, p.cutoff_radius, p.sigma, p.k)
    kw = dict(qmax=model.qmax, cand_cap=model.pair_cand_cap)
    T, S = t.pair_tiling.tile_sites.shape
    out = {"bitwise_equal_to_twin": True, "tiles": T, "tile_slots": S, "qmax": model.qmax,
           "cand_cap": min(model.pair_cand_cap, model.qmax),
           "charged_sites": int((charge != 0).sum())}

    def same(got, want, plane, when=""):
        flags = ([bool(f) for f in got[1:]], [bool(f) for f in want[1:]])
        if not torch.equal(got[0], want[0]) or flags[0] != flags[1]:
            fail(f"the pair_tiled kernel ({plane} plane) differs from its twin on the "
                 f"{where}{when} at {int((got[0] != want[0]).sum())} sites, max abs "
                 f"{float((got[0] - want[0]).abs().max()):.3e}; flags {flags}")

    for plane in ("f32", "f64"):
        f32 = plane == "f32"
        launch, got = pw.kernel_call(*args, plane_f32=f32, **kw)
        launch()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = pw.pairwise_potential_tiled_plain(*args, plane_f32=f32, **kw)
        end.record()
        torch.cuda.synchronize()
        same(got, want, plane)
        if timed:
            out[f"plain_ms_{plane}"] = start.elapsed_time(end)
            out[f"kernel_ms_{plane}"] = device_ms(launch, reps=20)
            out[f"call_ms_{plane}"] = device_ms(lambda: pw.pairwise_potential_tiled(
                *args, plane_f32=f32, **kw), reps=20)
            same(got, want, plane, " after its timed launches")
    print(f"chip_smoke: pair_tiled == twin on the {where} (T={T}, S={S}, "
          f"{out['charged_sites']} charged sites, f32 and f64 planes)")
    if timed:
        tested, inside = pair_tiled_work(*args[:4], p.cutoff_radius, model.qmax,
                                         model.pair_cand_cap)
        out.update(ms=out["kernel_ms_f32"], plain_ms=out["plain_ms_f32"],
                   **pair_tiled_bound(inside), issue_ms=pair_tiled_issue_ms(tested, inside),
                   pairs_tested=tested, pairs_in_cutoff=inside)
    out["check_s"] = time.perf_counter() - t0
    return out


def check_pair_tiled(dev, p, lat) -> dict:
    """The tiled pairwise kernel on the n_yz=24 crossbar, tiled as the model
    tiles a structure whose pair table does not fit, on the charges of its
    first superstep: the ``kernels`` line's entry, the paths' readings are
    added to it."""
    from akmc_tpu_torch.models.vcm import VCMModel

    model = VCMModel(p, lat, device=dev, rate_normalize=True, pair_table_budget=0.0,
                     pair_tiling_min_n=0)
    _, charge = crossbar_state(p, lat, dev)
    return {"name": "pairwise_potential_tiled", "n_yz": N_YZ,
            **pair_tiled_readings(model, charge, f"n_yz={N_YZ} crossbar")}


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

    kernel = pair_tiled_readings(m, charge, f"n_yz={TILED_N_YZ} crossbar")

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
        **times, "kernel": kernel,
        "max_abs_tiled_minus_on_the_fly": err64,
        "max_abs_tiled_f32_minus_on_the_fly": err32, "max_abs_potential": scale,
        "shell_ambiguous_sites": int(ambiguous.sum()),
        "supersteps": len(rows), "events": sum(r["n_events"] for r in rows),
        "cg_per_superstep": [r["cg_iterations"] for r in rows],
        "superstep_s": [r["superstep_s"] for r in rows],
        "dia_launches": counts["dia_launches"], "dia_cg_launches": counts["dia_cg_launches"],
        "pair_tiled_launches": counts["pair_tiled_launches"],
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
    """The DIA kernels on the crossbar's own operator and K system, and the
    tiled pairwise kernel on its tiling (where the model took it), as its
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
    pair = (pair_tiled_readings(model, charge, where) if t.pair_tiling is not None else None)
    return {
        "pairwise_potential_tiled": pair,
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
    card) reads the device at most once per replay of its loop, or, run as
    one program (a ``KeyDraws`` source), once a superstep. ``steps`` holds a
    row per superstep. Serial supersteps draw from ``stream``, batched ones
    from ``draws``."""

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
        capture_s = None
        runs0 = dict(model.step_counts)
        # "timed": the serial superstep with the model's spans on
        model.spans = kind == "timed"
        if kind in ("serial", "timed") and dev.type == "cuda" and model._programmed():
            # the superstep's program is captured before its timed run: the
            # warm run that precedes a capture reads the host per pass
            t0 = time.perf_counter()
            model._capture_program(self.state, CROSSBAR_VD, 1)
            capture_s = time.perf_counter() - t0
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ev.reset_loop_counts()
        t0 = time.perf_counter()
        with count_syncs(dev) as caught:
            if kind in ("serial", "timed"):
                self.state, stats = model.superstep(self.state, CROSSBAR_VD, self.stream)
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
            programs = {c: model.step_counts[c] - runs0[c] for c in ("runs", "redos")}
            row.update(batches=nb, events_per_batch=stats["n_events"] / nb,
                       cut_conflict=stats["n_cut_conflict"], cut_mass=stats["n_cut_mass"],
                       done=stats["done"], **kw)
            if not stats["done"]:
                fail(f"{name} did not end done: {stats['n_events']} events in {nb} batches")
            if programs["runs"]:
                # one program: fields and loop in one replay, one read (and
                # one more per redo)
                row.update(program_runs=programs["runs"], redos=programs["redos"],
                           fields_s=None, ms_per_batch=1e3 * wall / nb,
                           loop_k=ev.BATCHED_NODE_K)
                if dev.type == "cuda" and syncs != programs["runs"]:
                    fail(f"{name}: the program read the device {syncs} times in "
                         f"{programs['runs']} runs, at {sync_sites(caught)}")
            else:
                k = ev.BATCHED_K if dev.type == "cuda" else 1
                row.update(host_syncs_in_fields=syncs - in_loop,
                           host_syncs_in_loop_per_batch=in_loop / nb, fields_s=model.fields_s,
                           loop_ms_per_batch=1e3 * (wall - model.fields_s) / nb, loop_k=k)
                # no card, no count: the check is the card's. The device loop
                # reads the host once per replay of k batches
                if dev.type == "cuda" and in_loop > math.ceil(nb / k) + 1:
                    fail(f"{name}: the batched loop read the device {in_loop} times in {nb} "
                         f"batches (k = {k}), at {sync_sites(caught)}")
        else:
            row["host_syncs_per_event"] = syncs / max(1, stats["n_events"])
            row["loop_k"] = (1 if dev.type != "cuda" else ev.SERIAL_NODE_K
                             if kind in ("serial", "timed") and model._programmed()
                             else ev.SERIAL_K)
            if capture_s is not None:
                row["program_capture_s"] = capture_s
            if i == 0:
                row["host_sync_sites"] = sync_sites(caught)
            if dev.type == "cuda" and in_loop > loop["replays"]:
                fail(f"{name}: the serial loop read the device {in_loop} times in "
                     f"{loop['replays']} replays, at {sync_sites(caught)}")
        if kind == "timed":
            from akmc_tpu_torch.runtime.driver import MODULE_SPANS

            model.spans = False
            spans = model.last_spans
            row.update({k: spans[name]["ms"] * 1e-3 for k, name in MODULE_SPANS.items()})
            row["spans_ms"] = {name: s["ms"] for name, s in spans.items()}
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
LOOP_SERIAL_DRAWS = 2048          # the serial loops are held on a chunk of this many draws
LOOP_FILES = ("events.py", "device_loop.py")   # where the event loops read the host
# k read at the flagship beside the loops' own (SERIAL_K 64, BATCHED_K 32)
LOOP_KS = {"serial": (32, 128), "batched": (16, 64)}
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


def superstep_turns(dev, model, state, where, mass_eps, profiled=True) -> dict:
    """One batched superstep (B = 64, f64 clocks) from ``state`` with the
    plain loop and with the device loop, each from a generator of one seed:
    in turns plain, device, device, plain on the host clock (every result
    equal to the first: events, batches, waiting time, elements), then, with
    ``profiled``, one of each under ``torch.profiler`` for the device's idle
    share."""
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
    for turn in ("plain", "device") if profiled else ():
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
    from akmc_tpu_torch.ops import pairwise
    from akmc_tpu_torch.solvers import dia_cg

    mv.dia_combined_matvec.launches = 0
    dia_cg.dia_cg_solve.launches = 0
    pairwise.pairwise_potential_tiled.launches = 0
    dia_cg.reset_iterations_total(dev.type)
    return model.k_solves, model.k_iterations


def crossbar_launches(dev, model, steps, since, where="crossbar") -> dict:
    """The kernels' launches since ``reset_launches`` (which returned
    ``since``) against the model's count of K solves: one fused CG and one
    matvec (the conductive-vacancy degrees) per solve, those repeated for a
    grown cap too, the tiled pairwise kernel once per solve where the model
    took the tiled path, and the iterations the fused kernel counted on the
    device equal to the model's."""
    from akmc_tpu_torch.ops import dia_matvec as mv
    from akmc_tpu_torch.ops import pairwise
    from akmc_tpu_torch.solvers import dia_cg

    launches = (mv.dia_combined_matvec.launches, dia_cg.dia_cg_solve.launches)
    pair_launches = pairwise.pairwise_potential_tiled.launches
    k_solves = model.k_solves - since[0]
    if k_solves < len(steps):
        fail(f"{k_solves} K solves in {len(steps)} supersteps on the {where}")
    if dev.type == "cuda" and launches != (k_solves, k_solves):
        fail(f"the {where} path launched the DIA kernels {launches} times for {k_solves} K solves")
    tiled = model.tables.pair_tiling is not None
    if dev.type == "cuda" and pair_launches != (k_solves if tiled else 0):
        fail(f"the {where} path launched the tiled pairwise kernel {pair_launches} times for "
             f"{k_solves} K solves (tiled path: {tiled})")
    cg = model.k_iterations - since[1]
    if dev.type == "cuda" and dia_cg.iterations_total(dev.type) != cg:
        fail(f"the fused solves counted {dia_cg.iterations_total(dev.type)} iterations on the "
             f"device, the model's K solves {cg}")
    if k_solves == len(steps) and cg != sum(r["cg_iterations"] for r in steps):
        fail(f"the K solves ran {cg} iterations, the supersteps report "
             f"{sum(r['cg_iterations'] for r in steps)}")
    grid = dia_cg.dia_cg_solve.last_grid
    return {"dia_launches": launches[0], "dia_cg_launches": launches[1],
            "pair_tiled_launches": pair_launches, "k_solves": k_solves,
            "cg_iterations_counted_on_device": dia_cg.iterations_total(dev.type),
            "dia_cg_grid": {"blocks": grid[0], "rows_in_registers": grid[1]} if grid else None}


def batched_summary(rows) -> dict:
    """Events, batches and times of batched supersteps; the fields and the
    loop apart where they ran apart (the per-loop path), not in a program."""
    ev, nb = sum(r["events"] for r in rows), sum(r["batches"] for r in rows)
    wall = sum(r["wall_s"] for r in rows)
    out = {"supersteps": len(rows), "events": ev, "batches": nb, "events_per_batch": ev / nb,
           "wall_s_mean": wall / len(rows), "superstep_ms_per_event": 1e3 * wall / ev,
           "superstep_ms_per_batch": 1e3 * wall / nb,
           "cg_iterations": [r["cg_iterations"] for r in rows]}
    if all(r["fields_s"] is not None for r in rows):
        loop = wall - sum(r["fields_s"] for r in rows)
        out.update(fields_s_mean=(wall - loop) / len(rows), loop_ms_per_batch=1e3 * loop / nb,
                   loop_ms_per_event=1e3 * loop / ev)
    return out


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
            # the idle share is read at the flagship (``run_flagship``)
            out["superstep_turns"] = superstep_turns(dev, model, run.state, f"n_yz={n_yz}",
                                                     1e-3, profiled=False)
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
    times = PartTimes()
    line = {"replay": batched_replay(dev)}
    times.mark("replay")
    line["law"] = batched_law(dev)
    times.mark("law")
    line["crossbar"] = batched_crossbar(dev, widths[0], depth=1, incremental=True)
    times.mark(f"crossbar_n_yz_{widths[0]}")
    for n_yz in widths[1:]:
        gc.collect()         # the last crossbar's model and graphs
        torch.cuda.empty_cache()
        line[f"crossbar_n_yz_{n_yz}"] = batched_crossbar(dev, n_yz, depth=1)
        times.mark(f"crossbar_n_yz_{n_yz}")
    gc.collect()
    torch.cuda.empty_cache()
    line["driver"] = batched_driver(dev, serial_rows)
    times.mark("driver")
    line["part_s"] = times
    print("chip_smoke: phase batched took " + json.dumps(times), flush=True)
    return line, None


# ---------------------------------------------------------------------------
# phase 7: full physics
# ---------------------------------------------------------------------------
def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b else (0.0 if a == b else math.inf)


@contextlib.contextmanager
def full_physics_probe():
    """Per-superstep readings of the driver's model, taken from outside it:
    after each ``superstep_full`` its ``power_timing`` (on the per-loop path
    the W-block build and the power solve, in host seconds ending in a device
    read; on both paths the energy-loop bounds and the power CG's
    iterations), ``fields_s`` (per-loop path), its host time and its host
    reads (inside a ``count_syncs`` block); after each ``update_cb_edge`` its
    CG iterations and host time. The third list receives the model."""
    from akmc_tpu_torch.models.vcm import VCMModel

    steps, cb, models = [], [], []
    full, cb_edge = VCMModel.superstep_full, VCMModel.update_cb_edge

    def probed_full(self, *args, **kwargs):
        log = SYNC_LOGS[-1] if SYNC_LOGS else []
        n0 = n_syncs(log)
        t0 = time.perf_counter()
        out = full(self, *args, **kwargs)        # ends with a read of its stats
        wall = time.perf_counter() - t0
        timing = dict(self.power_timing)
        timing.update(_power_spans(self))
        steps.append({**timing, "fields_s": self.fields_s if not self._programmed() else None,
                      "superstep_s": wall, "host_reads": n_syncs(log) - n0})
        if not models:
            models.append(self)
        return out

    def probed_cb(self, state, Vd):
        log = SYNC_LOGS[-1] if SYNC_LOGS else []
        n0 = n_syncs(log)
        t0 = time.perf_counter()
        out = cb_edge(self, state, Vd)
        cb.append({"Vd": Vd, "iterations": self.cb_iterations,
                   "ms": 1e3 * (time.perf_counter() - t0), "host_reads": n_syncs(log) - n0})
        return out

    VCMModel.superstep_full, VCMModel.update_cb_edge = probed_full, probed_cb
    try:
        yield steps, cb, models
    finally:
        VCMModel.superstep_full, VCMModel.update_cb_edge = full, cb_edge


def _power_spans(model) -> dict:
    """The last dispatch's ``wkb_build`` and ``power_solve`` spans in ms, where
    the model's spans were on (``VCMModel.last_spans``), else nothing."""
    spans = model.last_spans
    return {f"{name}_device_ms": spans[name]["ms"] for name in ("wkb_build", "power_solve")
            if name in spans}


def _summarize_steps(steps: list) -> dict:
    """The probe's per-superstep readings, as lists and their sums (the
    build/solve split where the model's spans were on, and the fields' time
    on the per-loop path)."""
    def col(k):
        return [r[k] for r in steps]

    out = {"ct_loop_bounds": col("ct_loop_bounds"), "power_cg_iterations": col("iterations"),
           "superstep_ms": [1e3 * v for v in col("superstep_s")],
           "host_reads": col("host_reads"),
           "host_reads_per_superstep": sum(col("host_reads")) / max(1, len(steps))}
    if steps and steps[0]["fields_s"] is not None:
        out["fields_ms"] = [1e3 * v for v in col("fields_s")]
    if not steps or "wkb_build_device_ms" not in steps[0]:
        return out
    wkb, solve, its = col("wkb_build_device_ms"), col("power_solve_device_ms"), col("iterations")
    return {
        **out, "wkb_build_device_ms": wkb, "power_solve_device_ms": solve,
        "power_ms_per_iteration": [v / k for v, k in zip(solve, its)],
        "wkb_build_ms_total": sum(wkb), "power_solve_ms_total": sum(solve),
    }


def full_model(deck: str, dev, synth_dir=None, pair_table_budget=0.0, lists_on=None,
               **model_kw):
    """The port's model and first state for ``deck`` on the N_YZ crossbar, or
    with ``synth_dir`` on the disordered stand-in's files there, built as the
    driver builds them; no static pair table unless ``pair_table_budget``
    says so (power solves alone need none); ``lists_on``: the device that
    builds the neighbor lists (None: the host's k-d tree). ``model_kw`` goes
    to the model."""
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
    lat = build_lattice(element, x, y, z, p, device=lists_on)
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
        device = _power_spans(model)
        row = {"rtol_scale": scale, "I_macro": I_macro, "I_macro_akmc_tpu": g["I_macro"],
               "P_tot": P_tot, "P_tot_akmc_tpu": g["P_tot"],
               "power_cg_iterations": iters, "power_cg_iterations_akmc_tpu":
               g["power_cg_iterations"], "ms": ms, **device,
               **model.power_timing,
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


def power_solve(model, state, Vd, rtol_scale, gather=False, m_prev=None):
    """A function that runs ``solve_power`` at ``Vd`` on ``state`` (its
    charges and CB edge) with the model's CG programs, the system built
    once, as ``VCMModel._power`` builds it; ``gather``: the gather operator
    in place of the power band."""
    from akmc_tpu_torch.lattice import ELEM
    from akmc_tpu_torch.solvers.current import build_power_system, solve_power

    p, ct = model.params, model.current_tables
    high_G, loop_G = p.high_G * 100000, p.high_G * 10000000
    band = None if gather else model.power_band
    ae, ac = state.element[ct.atom_ind], state.charge[ct.atom_ind]
    ps, _ = build_power_system(ct, ae, ac, state.cb_edge[ct.atom_ind], model._lattice_t,
                               bool(p.pbc), p.nn_dist, high_G, p.low_G, loop_G, p.q * 0.01,
                               p.m_e, p.V0, vmax=model.vmax, ne_max=model.ne_max)
    cvac = (ae == int(ELEM.VACANCY)) & (ac == 0)
    m0 = torch.zeros(model.n_atom + 2, dtype=torch.float64, device=model.device)
    if m_prev is not None:
        m0 = m_prev
    return lambda: solve_power(
        ct, ps, Vd, high_G, loop_G, 2 * 3.8612e-5 * 1e-5, 1.0, m0, ae, band=band,
        band_meta=None if band is None else model._power_band_meta, cvac=cvac,
        nn_dist=p.nn_dist, lattice=model._lattice_t, pbc=bool(p.pbc), rtol_scale=rtol_scale,
        graphs=model.cg_graphs)


def full_cg_loops(dev, model, state) -> dict:
    """The full-physics CGs on the disordered stand-in (finite CB edge, live
    tunneling) at 8 V, each with its device loop and its host loop in turns
    (``cg_turns``, bit-equal): the CB-edge solve, the power CG with the band
    (k read at CG_KS; then from its own solution, the first replay 1 and 4
    iterations long) and with the gather operator, the steady local heat
    solve on that power (the heating deck copies' constants). With the
    decoded power band's bytes: what its product must read per iteration."""
    from akmc_tpu_torch.runtime.synth_deck import HEAT_CONSTANTS
    from akmc_tpu_torch.solvers.heat import update_temperature_local_steady

    g, Vd = model.cg_graphs, 8.0
    out = {}

    def cb_edge():          # the CG's own loop: the per-loop path (a program's is a node)
        with _per_loop(model, True):
            return model.update_cb_edge(state, Vd).cb_edge

    out["cb_edge"], _ = cg_turns(dev, "stand-in CB-edge CG", cb_edge, g)
    state = model.update_cb_edge(state, Vd)
    out["power_band"], (_, atom_power, m, _) = cg_turns(
        dev, "stand-in power CG, band", power_solve(model, state, Vd, 1.0), g, ks=CG_KS)
    out["power_band_warm"], _ = cg_turns(
        dev, "stand-in power CG, band, from its solution", power_solve(
            model, state, Vd, 1.0, m_prev=m), g, firsts=(1, 4))
    out["power_gather"], _ = cg_turns(dev, "stand-in power CG, gather",
                                      power_solve(model, state, Vd, 1.0, gather=True), g)
    power = torch.zeros_like(state.temperature)
    power[model.current_tables.atom_ind] = atom_power
    hp = model.params.replace(**{k: float(HEAT_CONSTANTS[k]) for k in (
        "k_th_non_vacancy", "k_th_vacancies", "L_char")})
    out["heat_steady"], _ = cg_turns(dev, "stand-in steady heat CG", lambda: (
        update_temperature_local_steady(
            model.local_heat, state.temperature, power, state.element, hp.background_temp,
            hp.nn_dist * 1e-10, hp.k_th_interface, hp.k_th_vacancies, graphs=g)), g)
    band = model.power_band.values(model._power_band_meta)
    out["power_band_bytes"] = band.numel() * band.element_size()
    out["power_band_bytes_ms"] = out["power_band_bytes"] / HBM_BYTES_PER_S * 1e3
    out["programs"] = len(g.programs)
    out["capture_s_all"] = g.capture_s()
    return out


# the full-physics superstep as one CUDA graph (models/step_program.py::FullProgram)
FP_SUPERSTEPS = 4               # crossbar supersteps a run in turns: the deck's first biases, two each
FP_STANDIN_SUPERSTEPS = 2       # the stand-in's, as its golden part
FP_SPD = 4                      # supersteps per dispatch against one at a time
FP_SPD_CHUNK = 2048             # the rand window of both (superstep_full_multi's default)
FP_LARGE_N_YZ = LARGE_BANDED_N_YZ   # the stand-in at 124,412 sites: one superstep
FP_LARGE_VD = 8.0
FULL_STATE = STATE_FIELDS + ("power", "temperature", "T_bg")


def _fp_run(model, p, state0, biases, steps_fn=None):
    """Full-physics supersteps of ``model`` from ``state0`` at ``biases`` on a
    fresh mt19937 stream, stepped as the driver steps them (the CB edge
    solved at each new bias, outside the timing; the warm start threaded;
    the power tolerance by the driver's "auto" rule), each timed (host
    clock, the card drained) with its host reads counted: (states, stats,
    ms, reads, loop passes, the stream's next draw, the last warm start).
    ``steps_fn(model, state, Vd, stream, m, rscale)``: one dispatch (default
    ``superstep_full``), returning (state, stats list, m)."""
    from akmc_tpu_torch.ops import events as ev
    from akmc_tpu_torch.rng import BufferedStream, ReferenceRNG
    from akmc_tpu_torch.solvers import cg

    if steps_fn is None:
        def steps_fn(m_, state, Vd, stream, m, rscale):
            state, st, m = m_.superstep_full(state, Vd, stream, m_prev=m, rtol_scale=rscale)
            return state, [st], m
    dev = model.device
    stream = BufferedStream(ReferenceRNG(p.rnd_seed_kmc))
    state, m, last_I, bias = state0, None, None, None
    states, stats, ms, reads, passes = [], [], [], [], []
    for Vd in biases:
        if Vd != bias:
            state, bias = model.update_cb_edge(state, Vd), Vd
        rscale = 1e-2 if last_I is not None and abs(last_I) < 1e-9 else 1.0
        ev.reset_loop_counts()
        cg.reset_cg_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with count_syncs(dev) as caught:
            state, st, m = steps_fn(model, state, Vd, stream, m, rscale)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        reads.append(n_syncs(caught))
        stats.extend(st)
        last_I = st[-1]["I_macro"]
        states.append({f: getattr(state, f).clone() for f in FULL_STATE})
        passes.append({"event_loop": ev.LOOP_COUNTS["serial"]["replays"],
                       "cg": sum(c["replays"] for c in cg.CG_COUNTS.values())})
    return states, stats, ms, reads, passes, stream.peek(1)[0], m


def _fp_same(label, a, b) -> None:
    """Fails unless two runs' supersteps are equal to the bit: stats, the
    stream, the warm start and every state field after each dispatch."""
    if a[1] != b[1] or a[5] != b[5]:
        fail(f"full program {label}: stats or stream differ: {a[1][:2]} / {b[1][:2]}")
    if not same_bits(a[6], b[6]):
        fail(f"full program {label}: the power solve's warm start differs")
    for i, (sa, sb) in enumerate(zip(a[0], b[0])):
        for f in FULL_STATE:
            if not same_bits(sa[f], sb[f]):
                fail(f"full program {label}: dispatch {i} differs in {f}")


def full_turns(dev, model, p, lat, biases, where) -> dict:
    """The per-loop path and the program in turns (loops, program, program,
    loops) from one state and stream, every superstep bit-equal: ms a
    superstep (cold: the first at a bias, warm: the rest), host reads a
    superstep, capture s, while passes, the nodes' k, and the card's idle
    share of the program's wall by CUDA events around its replays."""
    from akmc_tpu_torch.ops import events as ev
    from akmc_tpu_torch.solvers import cg, current, heat
    from akmc_tpu_torch.state import make_device_state

    state0 = model.update_cb_edge(make_device_state(lat, p.background_temp, dev), biases[0])
    t0 = time.perf_counter()
    prog = model._capture_full(state0, biases[0], 1)
    capture_s = time.perf_counter() - t0
    runs = {False: [], True: []}
    wkb_launches = {"loops": [], "program": []}
    steps = None
    for programmed in (False, True, True, False):
        with _per_loop(model, not programmed):
            counts0 = dict(model.step_counts)
            current.wkb_contact_trap_kernel.launches = 0
            r = _fp_run(model, p, state0, biases)
            done = {k: model.step_counts[k] - counts0[k] for k in counts0}
            if programmed:
                steps = done
                if done["per_loop"] or done["runs"] != len(biases) + done["redos"]:
                    fail(f"full program {where}: the program path ran {done}")
            elif done["per_loop"] != len(biases):
                fail(f"full program {where}: the per-loop path ran {done}")
            # the contact-trap kernel: one launch a power build, a build a
            # program run (redos included) or a per-loop superstep
            launched = current.wkb_contact_trap_kernel.launches
            builds = done["runs"] if programmed else done["per_loop"]
            if dev.type == "cuda" and launched != builds:
                fail(f"full program {where}: the wkb_ct kernel launched {launched} times for "
                     f"{builds} power builds ({'program' if programmed else 'per-loop'} path)")
            wkb_launches["program" if programmed else "loops"].append(launched)
        runs[programmed].append(r)
    ref = runs[False][0]
    for label, r in (("program 1", runs[True][0]), ("program 2", runs[True][1]),
                     ("loops 2", runs[False][1])):
        _fp_same(f"{where}: {label} against loops 1", ref, r)
    best = {pr: min(runs[pr], key=lambda x: sum(x[2])) for pr in (False, True)}
    if dev.type == "cuda" and not (steps["redos"] or steps["continues"]) and any(
            n != 1 for n in best[True][3]):
        fail(f"full program {where}: the program read the host {best[True][3]} times")
    first = [i for i, Vd in enumerate(biases) if i == 0 or biases[i - 1] != Vd]
    rest = [i for i in range(len(biases)) if i not in first]

    def mean(xs, idx):
        return sum(xs[i] for i in idx) / max(1, len(idx))

    _, replay_ms = program_replay_ms(lambda: _fp_run(model, p, state0, biases))
    out = {
        "supersteps": len(biases), "biases": biases, "bitwise_equal": True,
        "events": [x["n_events"] for x in ref[1]],
        "event_time": [x["event_time"] for x in ref[1]],
        "cg_iterations": [x["cg_iterations"] for x in ref[1]],
        "power_cg_iterations": [x["power_cg_iterations"] for x in ref[1]],
        "I_macro": [x["I_macro"] for x in ref[1]], "T_bg": [x["T_bg"] for x in ref[1]],
        "temperature_moved": int((ref[0][-1]["temperature"] != p.background_temp).sum()),
        "ct_loop_bounds_last": model.power_timing.get("ct_loop_bounds"),
        "capture_s": capture_s, "program_capture_s": prog.capture_s,
        "ms_per_superstep_loops": [sum(x[2]) / len(biases) for x in runs[False]],
        "ms_per_superstep_program": [sum(x[2]) / len(biases) for x in runs[True]],
        "superstep_ms_loops": best[False][2], "superstep_ms_program": best[True][2],
        "first_at_bias_ms_mean": {"loops": mean(best[False][2], first),
                                  "program": mean(best[True][2], first)},
        "rest_ms_mean": {"loops": mean(best[False][2], rest),
                         "program": mean(best[True][2], rest)},
        "host_reads_per_superstep_loops": sum(best[False][3]) / len(biases),
        "host_reads_per_superstep_program": sum(best[True][3]) / len(biases),
        "while_passes_program": best[True][4], "replays_loops": best[False][4],
        "redos": steps["redos"], "continues": steps["continues"],
        "node_k": {"cg": cg.CG_NODE_K, "event_loop": ev.SERIAL_NODE_K,
                   "wkb_energy_steps": current.WKB_PASS_STEPS,
                   "heat_transient_steps": heat.HEAT_PASS_STEPS},
        "program_replay_device_ms": replay_ms,
        "idle_share_program_vs_its_wall": (
            1.0 - sum(replay_ms) / sum(best[True][2]) if replay_ms else None),
        "per_loop_idle_share": "not measured: its host-driven loops leave no replays to "
                               "bracket",
        "wkb_ct_launches": wkb_launches,
    }
    _drop_programs(model)
    print(f"chip_smoke: full program {where}: " + json.dumps(out))
    return out


def _drop_programs(model) -> None:
    """Free the model's superstep programs (a full-physics program holds its
    W blocks in its graph's pool)."""
    model.step_graphs.programs.clear()
    gc.collect()
    torch.cuda.empty_cache()


def full_spd(dev, model, p, lat) -> dict:
    """``superstep_full_multi`` of FP_SPD supersteps per dispatch against one
    at a time (both on windows of FP_SPD_CHUNK draws) on the sweep's
    crossbar, bit-equal, one read a dispatch; then the same from a vmax of
    half the crossbar's vacancies: the first batch overflows it and is
    discarded and replayed step by step (each step redone at the grown cap),
    bit-equal to one at a time from the same cap (a fresh model for each of
    the two runs)."""
    from akmc_tpu_torch.lattice import ELEM
    from akmc_tpu_torch.state import make_device_state

    biases = list(p.V_switch[:2])
    state0 = model.update_cb_edge(make_device_state(lat, p.background_temp, dev), biases[0])
    model._capture_full(state0, biases[0], FP_SPD)

    def one_at_a_time(m_, state, Vd, stream, m, rscale):
        sts = []
        for _ in range(FP_SPD):
            state, st, m = m_.superstep_full(state, Vd, stream, m_prev=m, rtol_scale=rscale,
                                             rand_chunk=FP_SPD_CHUNK)
            sts.append(st)
        return state, sts, m

    def batched(m_, state, Vd, stream, m, rscale):
        return m_.superstep_full_multi(state, Vd, stream, FP_SPD, m_prev=m, rtol_scale=rscale,
                                       rand_chunk=FP_SPD_CHUNK)

    small = max(1, int((lat.element0 == int(ELEM.VACANCY)).sum()) // 2)

    def small_cap():
        m_, _ = full_model(DECK, dev, pair_table_budget=8e9, vmax=small)
        return m_

    out = {"k": FP_SPD, "rand_chunk": FP_SPD_CHUNK, "bitwise_equal": True}
    turns = (("k1", one_at_a_time), ("spd", batched), ("spd", batched), ("k1", one_at_a_time))
    for label, make in (("spd", lambda: model), ("discard", small_cap)):
        runs = {}
        # the discard needs a fresh model a run (its cap grows): one run each way
        for name, fn in turns if label == "spd" else turns[:2]:
            m_ = make()
            counts0 = dict(m_.step_counts)
            r = _fp_run(m_, p, state0, biases, fn)
            runs.setdefault(name, []).append(
                (r, {k: m_.step_counts[k] - counts0[k] for k in counts0}))
            if m_ is not model:
                if name == "spd":      # the discarded batch, its steps redone
                    out["discard_lifetime"] = lifetime_checks(dev, m_, "full discard")
                _drop_programs(m_)
                del m_
                torch.cuda.empty_cache()
        ref = runs["k1"][0][0]
        for name, rs in runs.items():
            for r, _ in rs:
                _fp_same(f"steps per dispatch, {label}, {name}", ref, r)
        n = len(biases) * FP_SPD
        best = {name: min(rs, key=lambda x: sum(x[0][2])) for name, rs in runs.items()}
        steps = best["spd"][1]
        if dev.type == "cuda" and label == "spd" and not steps["discards"] and sum(
                best["spd"][0][3]) != len(biases):
            fail(f"full program: {FP_SPD} supersteps a dispatch read the host "
                 f"{best['spd'][0][3]} times in {len(biases)} dispatches")
        if label == "discard" and not (steps["discards"] and steps["redos"]):
            fail(f"full program: a vmax of {small} discarded no batch: {steps}")
        out[label] = {
            "supersteps": n,
            "ms_per_superstep_k1": [sum(r[2]) / n for r, _ in runs["k1"]],
            "ms_per_superstep_spd": [sum(r[2]) / n for r, _ in runs["spd"]],
            "host_reads_per_dispatch_spd": best["spd"][0][3],
            "host_reads_per_superstep_k1": sum(best["k1"][0][3]) / n,
            "discards": steps["discards"], "continues": steps["continues"],
            "redos": steps["redos"], **({"vmax_from": small} if label == "discard" else {})}
    _drop_programs(model)
    print("chip_smoke: full program, steps per dispatch: " + json.dumps(out))
    return out


def standin_heating(dev, synth, synth_dir, event_times) -> dict:
    """The stand-in's first supersteps with the global heat model and with
    the local one (the heating deck copies' constants), each through both
    paths in turns, bit-equal. The local model's delta_t puts 1e3 * delta_t
    between the shortest and the longest of ``event_times`` (the same
    supersteps without heat, ``full_turns``'s: the local model moves no
    rate), so that one superstep is steady and one transient."""
    from akmc_tpu_torch.models.vcm import VCMModel
    from akmc_tpu_torch.runtime.synth_deck import HEAT_CONSTANTS

    lo, hi = min(event_times), max(event_times)
    if not 0 < lo < hi:
        fail(f"full program: the stand-in's event times {event_times} leave no delta_t "
             "between a steady and a transient superstep")
    delta_t = math.sqrt(lo * hi) / 1e3
    base, state = full_model(synth, dev, synth_dir=synth_dir)
    p0, lat = base.params, base.lat
    del base
    out = {}
    for kind in ("global", "local"):
        p = p0.replace(solve_heating_global=kind == "global", solve_heating_local=kind == "local",
                       **{k: float(v) for k, v in HEAT_CONSTANTS.items()},
                       A=p0.lattice[1] * p0.lattice[2] * 1e-20)
        if kind == "local":
            p = p.replace(delta_t=delta_t)
        model = VCMModel(p, lat, device=dev, rate_normalize=True, pair_table_budget=0.0)
        biases = list(p.V_switch[:1]) * FP_STANDIN_SUPERSTEPS
        r = full_turns(dev, model, p, lat, biases, f"stand-in, heat {kind}")
        if kind == "local":
            steady = [t > 1e3 * delta_t for t in event_times]
            r.update(delta_t=delta_t, steady_supersteps=steady)
        out[kind] = r
        del model
        torch.cuda.empty_cache()
    return out


def full_large(dev) -> dict:
    """One full-physics superstep of the disordered stand-in at 124,412
    sites (``LARGE_BANDED_N_YZ``, 8 V, tunnelling live) through the program
    and through the per-loop path, bit-equal: the W blocks' bytes, the energy
    bounds, ms and host reads of each, the capture and the peak memory; the
    tiled pairwise kernel and the contact-trap kernel launched once a K
    solve on each path, and each held against its twin at this shape."""
    from akmc_tpu_torch.ops import pairwise
    from akmc_tpu_torch.runtime import synth_deck
    from akmc_tpu_torch.solvers import current
    from akmc_tpu_torch.state import make_device_state

    wd = SYNTH_DIR + f"_full_n{FP_LARGE_N_YZ}"
    shutil.rmtree(wd, ignore_errors=True)
    deck = synth_deck.write_synth_deck(DECK, wd, FP_LARGE_N_YZ)
    gc.collect()             # the earlier models' graphs wait in reference cycles
    torch.cuda.empty_cache()
    allocated_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, state = full_model(deck, dev, synth_dir=wd, lists_on=dev)
    p, lat = model.params, model.lat
    state0 = model.update_cb_edge(state, FP_LARGE_VD)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model._capture_full(state0, FP_LARGE_VD, 1)
    capture_s = time.perf_counter() - t0
    runs, pair_launches, wkb_launches = {}, {}, {}
    tiled = model.tables.pair_tiling is not None
    for programmed in (True, False):
        with _per_loop(model, not programmed):
            pairwise.pairwise_potential_tiled.launches = 0
            current.wkb_contact_trap_kernel.launches = 0
            k0 = model.k_solves
            runs[programmed] = _fp_run(model, p, state0, [FP_LARGE_VD])
            timing = dict(model.power_timing, **_power_spans(model))
            path = "program" if programmed else "per_loop"
            pair_launches[path] = pairwise.pairwise_potential_tiled.launches
            wkb_launches[path] = current.wkb_contact_trap_kernel.launches
            k_solves = model.k_solves - k0
            if pair_launches[path] != (k_solves if tiled else 0):
                fail(f"full program at {lat.N} sites, {path}: the tiled pairwise kernel "
                     f"launched {pair_launches[path]} times for {k_solves} K solves "
                     f"(tiled path: {tiled})")
            if wkb_launches[path] != k_solves:
                fail(f"full program at {lat.N} sites, {path}: the wkb_ct kernel launched "
                     f"{wkb_launches[path]} times for {k_solves} K solves")
    _fp_same("124,412 sites: program against loops", runs[False], runs[True])
    pair = None
    if tiled:
        _, charge = crossbar_state(p, lat, dev)
        pair = {"launches": pair_launches,
                **pair_tiled_readings(model, charge, f"{lat.N}-site stand-in")}
    out = {
        "n_yz": FP_LARGE_N_YZ, "sites": lat.N, "atoms": model.n_atom, "Vd": FP_LARGE_VD,
        "allocated_before_gb": allocated_before / 1e9,
        "model": model.describe(), "vmax": model.vmax,
        "contacts": int(model.current_tables.contact_idx.shape[0]),
        "w_block_bytes": dict(model.power_bytes),
        "ct_loop_bounds": timing.get("ct_loop_bounds"),
        "stats": runs[True][1], "bitwise_equal": True, "build_s": build_s,
        "capture_s": capture_s,
        "ms_program": runs[True][2], "ms_loops": runs[False][2],
        "host_reads_program": runs[True][3], "host_reads_loops": runs[False][3],
        "wkb_build_ms_loops": timing.get("wkb_build_device_ms", float("nan")),
        "power_solve_ms_loops": timing.get("power_solve_device_ms", float("nan")),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "pair_tiled": pair,
    }
    out["wkb_ct"] = {"launches": wkb_launches,
                     **wkb_kernel_readings(model, state, FP_LARGE_VD, f"{lat.N}-site stand-in")}
    if not any(b > 1 for b in out["ct_loop_bounds"] or []):
        fail(f"full program at {lat.N} sites: no energy loop ran past one step: {out}")
    _drop_programs(model)
    del model, state, state0
    torch.cuda.empty_cache()
    print(f"chip_smoke: full program at {lat.N} sites: " + json.dumps(out))
    return out


def run_full(dev):
    """(full line, what is wrong with it or None)."""
    from akmc_tpu_torch.runtime import golden, synth_deck

    with open(FULL_GOLDEN) as f:
        gold = json.load(f)
    spread = gold["spread"]["band_vs_gather"]
    parts = gold["parts"]
    problems = []
    times = PartTimes()

    # the whole sweep through the driver, held to the golden: each superstep
    # one program run (FullProgram, one CUDA graph), the driver's default
    from akmc_tpu_torch.ops import device_loop

    _reset_production_counts()
    with full_physics_probe() as (steps, cb, models):
        summary, rows, counts = drive(DECK, FULL_DIR, synthesize_crossbar=N_YZ,
                                      committed_parity=False, dia_pallas=True)
    while_launches = device_loop.while_loop.launches
    check_launches("full", summary, rows, counts)
    if counts["wkb_ct_launches"] != summary["k_solves"]:
        fail(f"the full path launched the wkb_ct kernel {counts['wkb_ct_launches']} times for "
             f"{summary['k_solves']} supersteps' builds (one a K solve)")
    step_counts = dict(models[0].step_counts)
    sweep_lifetime = lifetime_checks(dev, models[0], "full sweep")
    cb_counts = dict(models[0].cb_counts)
    del models[:]
    times.mark("sweep")
    if step_counts["per_loop"] or step_counts["runs"] != len(rows) + step_counts["redos"]:
        problems.append(f"the full sweep did not run one program a superstep: {step_counts}")
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
        "pair_tiled_launches": counts["pair_tiled_launches"],
        "wkb_ct_launches": counts["wkb_ct_launches"],
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
        counts["host_syncs"] / len(rows), "host_sync_sites": counts["host_sync_sites"],
        "peak_mem_gb": counts["peak_mem_gb"],
        "wall_s": counts["wall_s"], "step_counts": step_counts, "cb_counts": cb_counts,
        "while_condition_launches": while_launches, "lifetime": sweep_lifetime,
    }
    print(f"chip_smoke: full sweep: {len(rows)} supersteps, P_tot {dist['P_tot_max_rel']:.3e} "
          f"and I_macro {dist['I_macro_max_rel']:.3e} from the golden (relative)")
    moved = [i for i, (a, b) in enumerate(dist["power_cg_iterations"]) if a != b]
    if moved or len(dist["power_cg_iterations"]) != len(rows):
        problems.append(f"the power CG's counts differ from the golden's at supersteps {moved}")

    # the same sweep on the per-loop path (each loop on its own, host reads
    # between them): every row but its time equal
    with full_physics_probe() as (steps_l, _, _):
        _, rows_l, counts_l = drive(DECK, FULL_DIR + "_per_loop", synthesize_crossbar=N_YZ,
                                    committed_parity=False, dia_pallas=True, step_program=False)
    if _rows_but_time(FULL_DIR + "_per_loop") != _rows_but_time(FULL_DIR):
        problems.append("the full sweep on the per-loop path differs from the program's: "
                        + _first_difference(_rows_but_time(FULL_DIR),
                                            _rows_but_time(FULL_DIR + "_per_loop")))
    loop_steps = _summarize_steps(steps_l)
    line["per_loop_sweep"] = {
        "rows_equal_but_time": True, "driver_supersteps_s": sum(r["superstep_s"] for r in rows_l),
        "host_syncs_per_superstep": counts_l["host_syncs"] / len(rows_l),
        **{k: loop_steps[k] for k in ("superstep_ms", "host_reads", "host_reads_per_superstep")},
        **{k: loop_steps.get(k) for k in ("fields_ms", "wkb_build_device_ms",
                                          "power_solve_device_ms")}}

    # the same sweep with the host loops of its CGs (power, CB edge) on the
    # per-loop path (a host loop cannot be captured): every row but its time
    # equal; host reads and superstep times before and after
    with full_physics_probe() as (steps_p, _, _), cg_as(plain=True):
        _, rows_p, counts_p = drive(DECK, FULL_DIR + "_plain_cg", synthesize_crossbar=N_YZ,
                                    committed_parity=False, dia_pallas=True, step_program=False)
    if _rows_but_time(FULL_DIR + "_plain_cg") != _rows_but_time(FULL_DIR):
        problems.append("the full sweep with the host-loop CGs differs from the device loops': "
                        + _first_difference(_rows_but_time(FULL_DIR),
                                            _rows_but_time(FULL_DIR + "_plain_cg")))
    plain_steps = _summarize_steps(steps_p)
    line["plain_cg_sweep"] = {
        "rows_equal_but_time": True,
        "host_syncs_per_superstep": counts_p["host_syncs"] / len(rows_p),
        "driver_supersteps_s": sum(r["superstep_s"] for r in rows_p),
        "superstep_ms": plain_steps["superstep_ms"],
        "host_reads_per_superstep": plain_steps["host_reads_per_superstep"],
        "power_solve_device_ms": plain_steps.get("power_solve_device_ms"),
        "power_ms_per_iteration": plain_steps.get("power_ms_per_iteration"),
    }

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
    times.mark("per_loop_plain_cg_wkb_f32_sweeps")
    line["tolerances_crossbar"] = tolerance_solves(model, state, parts["rtol"], "crossbar",
                                                   power_rtol=CROSSBAR_SOLVE_POWER_RTOL)
    synth_dir = FULL_DIR + "_synth"
    shutil.rmtree(synth_dir, ignore_errors=True)
    synth = synth_deck.write_synth_deck(DECK, synth_dir, N_YZ)
    model, state = full_model(synth, dev, synth_dir=synth_dir)
    line["tolerances_disordered"] = tolerance_solves(
        model, state, parts["synth_rtol"], "disordered stand-in",
        current_rtol=(STANDIN_SOLVE_CURRENT_RTOL,) * 3, power_rtol=(STANDIN_SOLVE_POWER_RTOL,) * 3)
    line["cg_loops"] = full_cg_loops(dev, model, state)
    del model, state
    times.mark("tolerances_and_cg_loops")
    for key in ("tolerances_crossbar", "tolerances_disordered"):
        problems += line[key].pop("problems")

    # three supersteps of the stand-in through the driver, tunneling live:
    # through the program, then on the per-loop path (every row but its time equal)
    ref = parts["synth_sweep"]
    with full_physics_probe() as (steps_s, cb_s, _):
        _, rows_s, counts_s = drive(synth, synth_dir + "_out", committed_parity=False,
                                    max_supersteps=len(ref["supersteps"]))
    with full_physics_probe() as (steps_sl, _, _):
        _, rows_sl, _ = drive(synth, synth_dir + "_out_per_loop", committed_parity=False,
                              max_supersteps=len(ref["supersteps"]), step_program=False)
    if _rows_but_time(synth_dir + "_out_per_loop") != _rows_but_time(synth_dir + "_out"):
        problems.append("the stand-in's supersteps on the per-loop path differ from the "
                        "program's")
    bounds_s = [b for r in steps_s for b in r["ct_loop_bounds"]]
    if not any(b > 1 for b in bounds_s):
        problems.append(f"no energy loop of the stand-in ran past one step: {bounds_s}")
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
        "per_loop": {"rows_equal_but_time": True, **_summarize_steps(steps_sl)},
    }

    # the two heat models, four supersteps each
    for kind in ("global", "local"):
        h = heating_part(dev, kind, parts["heating_" + kind])
        problems += h.pop("problems")
        line["heating_" + kind] = h

    # the program against the per-loop path in turns: the sweep's crossbar,
    # the stand-in (with the WKB integral's k per pass), the stand-in's heat
    # models, k supersteps a dispatch, the stand-in at 124,412 sites
    prog = line["program"] = {}
    model, state = full_model(DECK, dev, pair_table_budget=8e9)
    p = model.params
    biases = [Vd for Vd in p.V_switch[: FP_SUPERSTEPS // 2] for _ in range(2)]
    times.mark("standin_supersteps")
    prog["sweep_crossbar"] = full_turns(dev, model, p, model.lat, biases, "crossbar")
    prog["steps_per_dispatch"] = full_spd(dev, model, p, model.lat)
    times.mark("crossbar_turns_and_spd")
    del model, state
    torch.cuda.empty_cache()
    model, _ = full_model(synth, dev, synth_dir=synth_dir)
    p = model.params
    prog["standin"] = full_turns(dev, model, p, model.lat,
                                 list(p.V_switch[:1]) * FP_STANDIN_SUPERSTEPS, "stand-in")
    del model
    torch.cuda.empty_cache()
    prog["standin_heating"] = standin_heating(dev, synth, synth_dir,
                                              prog["standin"]["event_time"])
    times.mark("standin_turns_and_heating")
    prog["large_standin"] = full_large(dev)
    times.mark("large_standin")
    line["part_s"] = times
    print("chip_smoke: phase full took " + json.dumps(times), flush=True)
    return line, "; ".join(problems) or None


# ---------------------------------------------------------------------------
# the contact-trap block's kernel (csrc/wkb_ct.cu)
# ---------------------------------------------------------------------------
WKB_VD = 8.0                       # tsys102k.iv_set's top bias: its longest windows
WKB_DIR = os.path.join(HERE, "build", "chip_smoke", "wkb_synth")
# H100 SXM: 132 SMs, each with 4 x 16 f64 lanes, at 1,980 MHz; each of the 4
# partitions issues one warp instruction a clock (LANE_INSTR_PER_S), an f64
# one holding the partition's f64 lanes two clocks
F64_LANE_INSTR_PER_S = 132 * 64 * 1.98e9
# What a term issues in this kernel's SASS (cuobjdump -sass, nvcc 12.9, the
# -fmad=true build; wkb_kernel's "sass" entry has the loops): every term 76
# instructions, 20 of them f64 (the table reads, the window test, E2, the
# select, the exp: a range reduction and a degree-11 polynomial, the sum);
# a term with E2 > 0 183 more, 86 of them f64 (pow's special-case tests and
# its out-of-line log and exp in extended precision, 159 of the call's 171)
WKB_TERM_INSTR, WKB_TERM_F64 = 76, 20
WKB_POW_INSTR, WKB_POW_F64 = 183, 86
# The build those counts were read from: the kernel's instructions and each
# of its loops' (instructions, f64 instructions), as wkb_ct_sass parses them.
# A build that differs leaves the counts unchecked: the phase then fails,
# until they are read again from the new listing.
WKB_SASS_READ = (1096, ((88, 18), (127, 31), (318, 58), (7, 0), (7, 0)))


def _is_f64(op: str) -> bool:
    """Whether a SASS opcode issues to the f64 pipe."""
    root = op.split(".")[0]
    return root in ("DFMA", "DMUL", "DADD", "DSETP", "DMNMX", "DSET") or (
        root in ("F2F", "I2F", "F2I", "FRND") and "F64" in op)


def _sass_ops(name: str, function: str) -> list:
    """(address, opcode, branch target or None) of each instruction of
    ``function`` in ``cuobjdump -sass`` of ``csrc/<name>.cu``'s library (the
    whole listing is kept in chiprun_out/<name>.sass)."""
    from akmc_tpu_torch.ops import cuda_build

    tool = shutil.which("cuobjdump") or os.path.join(os.path.dirname(cuda_build._nvcc()),
                                                     "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(cuda_build.library_path(name))],
                          capture_output=True, text=True, timeout=120).stdout
    os.makedirs(SASS_DIR, exist_ok=True)
    with open(os.path.join(SASS_DIR, f"{name}.sass"), "w") as f:
        f.write(sass)
    ops, inside = [], False
    for ln in sass.splitlines():
        if "Function :" in ln:
            inside = function in ln
        elif inside:
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*)", ln)
            if m:
                tgt = re.search(r"0x([0-9a-f]+)", m.group(3)) if m.group(2) == "BRA" else None
                ops.append((int(m.group(1), 16), m.group(2), int(tgt.group(1), 16) if tgt else None))
    return ops


def wkb_ct_sass() -> dict:
    """The kernel's own SASS: its opcodes, and those of its loops (each
    backward branch and the instructions back to its target), f64 ones
    apart (they issue to the f64 pipe, 16 lanes a partition)."""
    ops = _sass_ops("wkb_ct", "wkb_ct")
    loops = []
    for addr, op, tgt in ops:
        if tgt is not None and tgt < addr:
            body = [o for a, o, _ in ops if tgt <= a <= addr]
            loops.append({"from": hex(tgt), "to": hex(addr), "instructions": len(body),
                          "f64": sum(map(_is_f64, body)),
                          "mufu": sum(o.startswith("MUFU") for o in body)})
    parsed = (len(ops), tuple((x["instructions"], x["f64"]) for x in loops))
    return {"instructions": len(ops), "f64_instructions": sum(_is_f64(o) for _, o, _ in ops),
            "opcodes": dict(collections.Counter(o.split(".")[0] for _, o, _ in ops).most_common()),
            "loops": loops, "sass_file": "chiprun_out/wkb_ct.sass",
            "source": "cuobjdump -sass of the built library",
            "term_counts_read_from_this_build": parsed == WKB_SASS_READ}


def wkb_ct_work(w, con, vac, rows: int = 1024) -> dict:
    """The block's work from its inputs (the kernel's formulas, in row
    blocks on the card): eligible pairs, terms (each pair's steps below its
    bound with iv < dE) and terms with E2 > 0 (a pow each)."""
    from akmc_tpu_torch.config import EV_TO_J
    from akmc_tpu_torch.solvers import current

    step, E0 = EV_TO_J * 0.01, EV_TO_J * w.V0
    pairs = terms = pow_terms = 0
    for s in range(0, con.pos.shape[0], rows):
        a = con.rows(slice(s, s + rows))
        _, d = current._pair_dist_m(a.pos, vac.pos, w.lattice, w.pbc)
        dE = (a.cb[:, None] - vac.cb[None, :]).abs()
        ok = (a.mask[:, None] & vac.mask[None, :] & (a.idx[:, None] != vac.idx[None, :])
              & ~(d < w.nn_dist) & (dE > w.tol))
        n = torch.clamp(torch.ceil(dE / step), max=w.ne_max)
        # steps with E0 + iv <= dE: E2 <= 0, no pow
        low = torch.clamp(torch.floor((dE - E0) / step) + 1, min=0)
        pairs += int(ok.sum())
        terms += int(torch.where(ok, n, 0.0).sum())
        pow_terms += int(torch.where(ok, torch.clamp(n - low, min=0), 0.0).sum())
    return {"pairs": pairs, "terms": terms, "pow_terms": pow_terms}


def wkb_ct_bound(work: dict) -> dict:
    """The least issue time of the block's terms at this kernel's SASS
    counts (every term, and the more a pow costs), on all four partitions'
    issue or on the f64 lanes, whichever is longer."""
    terms, pows = work["terms"], work["pow_terms"]
    issue = (WKB_TERM_INSTR * terms + WKB_POW_INSTR * pows) / LANE_INSTR_PER_S
    f64 = (WKB_TERM_F64 * terms + WKB_POW_F64 * pows) / F64_LANE_INSTR_PER_S
    return {"bound_ms": 1e3 * max(issue, f64), "bound_by": "issue" if issue >= f64 else "f64",
            "issue_ms": 1e3 * issue, "f64_ms": 1e3 * f64}


def wkb_kernel_readings(model, state, Vd: float, where: str, rows=None,
                        timed: bool = True) -> dict:
    """The kernel against its plain twin (``current.wkb_block_plain``) on
    ``model``'s integrated block at ``Vd`` (the CB edge solved there), or on
    the contact rows ``rows`` (a rank's window, ``Mesh.split``): the block
    and its chunks' bounds bit-equal and one launch, or the run fails; the
    terms and the lane efficiency from the kernel's counters. ``timed``: the
    launch alone by CUDA events over a graph of launches, the twin's build
    once, the work and the bound."""
    from akmc_tpu_torch.solvers import current

    t0 = time.perf_counter()
    dev, p, ct = model.device, model.params, model.current_tables
    state = model.update_cb_edge(state, Vd)
    vac, con = current.tunnel_sites(ct, state.element[ct.atom_ind], state.cb_edge[ct.atom_ind],
                                    model.vmax)
    if rows is not None:
        con = con.rows(slice(*rows))
    w = current.WkbInputs(model._lattice_t, bool(p.pbc), p.nn_dist, p.q * 0.01, p.m_e, p.V0,
                          model.ne_max, False)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    twin_bounds = []
    start.record()
    twin = current.wkb_block_plain(w, con, vac, True, twin_bounds)
    end.record()
    torch.cuda.synchronize()
    twin_ms = start.elapsed_time(end)
    current.reset_wkb_ct_counts(dev)
    before = current.wkb_contact_trap_kernel.launches
    bounds = []
    got = current.wkb_block(w, con, vac, True, bounds)
    torch.cuda.synchronize()
    launches = current.wkb_contact_trap_kernel.launches - before
    terms, issued = current.wkb_ct_counts(dev)
    tb, kb = [int(b) for b in twin_bounds], [int(b) for b in bounds]
    if launches != 1 or tb != kb or not torch.equal(got, twin):
        fail(f"the wkb_ct kernel differs from its twin on the {where}: {launches} launches, "
             f"bounds {kb} / {tb}, {int((got != twin).sum())} entries differ, max abs "
             f"{float((got - twin).abs().max()):.3e}")
    del twin
    out = {"rows": con.pos.shape[0], "cols": vac.pos.shape[0], "Vd": Vd, "ct_bounds": kb,
           "bitwise_equal_to_twin": True, "launches": launches,
           "terms_counted": terms, "lane_steps_issued": issued,
           "lane_efficiency": terms / max(1, issued)}
    if rows is not None:
        out["row_window"] = list(rows)
    if timed:
        ms = device_ms(lambda: current.wkb_block(w, con, vac, True, []), reps=5)
        again = current.wkb_block(w, con, vac, True, [])
        if not torch.equal(again, got):
            fail(f"the wkb_ct kernel's block changed over its timed launches on the {where}")
        work = wkb_ct_work(w, con, vac)
        bound = wkb_ct_bound(work)
        out.update(ms=ms, twin_ms=twin_ms, work=work, **bound,
                   share_of_bound=bound["bound_ms"] / ms)
    out["check_s"] = time.perf_counter() - t0
    print(f"chip_smoke: wkb_ct == twin on the {where} ({out['rows']} x {out['cols']}, "
          f"bounds {kb}): " + (f"{out['ms']:.3f} ms, twin {twin_ms:.1f} ms, " if timed else "")
          + f"lane efficiency {out['lane_efficiency']:.4f}", flush=True)
    return out


def run_wkb_kernel(dev):
    """(wkb_kernel line, None): the kernel against its twin at
    ``tsys102k.iv_set``'s shape (portbench's configuration and builder, 8 V)
    and at the stand-in's, timed; its SASS; the issue bound of the terms."""
    from akmc_tpu_torch.runtime import synth_deck

    from portbench import harness

    times = PartTimes()
    line = {"sass": wkb_ct_sass()}
    problem = None
    if not line["sass"]["term_counts_read_from_this_build"]:
        problem = (f"the wkb_ct build's SASS ({line['sass']['instructions']} instructions, "
                   f"loops {[(x['instructions'], x['f64']) for x in line['sass']['loops']]}) is "
                   f"not the one WKB_TERM_INSTR / WKB_POW_INSTR were read from "
                   f"{WKB_SASS_READ}: read them again from chiprun_out/wkb_ct.sass")
    config, traffic = harness.load("configs", "tsys102k"), harness.load("traffic", "iv_set")
    setup = harness.module("builders", config["builder"]).build(
        config, dev, config["model"], traffic.get("params", {}))
    times.mark("tsys102k_build")
    line["tsys102k"] = wkb_kernel_readings(setup.model, setup.state0, WKB_VD, "tsys102k stack")
    del setup
    gc.collect()
    torch.cuda.empty_cache()
    times.mark("tsys102k")
    synth = synth_deck.write_synth_deck(DECK, WKB_DIR, N_YZ)
    model, state = full_model(synth, dev, synth_dir=WKB_DIR)
    line["standin"] = wkb_kernel_readings(model, state, WKB_VD, "stand-in")
    times.mark("standin")
    line["part_s"] = times
    return line, problem


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
            "pair_tiled_launches": counts["pair_tiled_launches"],
            "wkb_ct_launches": counts["wkb_ct_launches"], "k_solves": summary["k_solves"]}


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


# ---------------------------------------------------------------------------
# fault A: what a program's graph binds, and memory it does not own poisoned
# (ops/device_loop.py::tracing_bindings, stale_bindings, poison_free_blocks)
# ---------------------------------------------------------------------------
def _replay_outputs(prog) -> list:
    """One replay of a captured program on its loaded inputs, outside its
    dispatch (no count applied, the fused CG's running total kept): copies of
    its outputs and packed vector."""
    from akmc_tpu_torch.solvers import dia_cg

    with dia_cg.iterations_total_kept(prog.device):
        prog.graph.replay()
    torch.cuda.synchronize()
    out, stats, _ = prog.captured
    return [t.clone() for t in out.values() if isinstance(t, torch.Tensor)] + [stats.clone()]


def _graph_loops(model):
    """The captured ``StepProgram``s of the model's event and CG device loops."""
    for graphs in (model.loop_graphs, model.cg_graphs):
        for prog in graphs.programs.values():
            loop = getattr(prog, "_loop", None)
            if loop is not None:
                yield from (sp for sp in loop.programs.values() if sp.graph is not None)


def lifetime_checks(dev, model, label: str) -> dict:
    """Fault A's two checks over every program ``model`` holds (its
    ``step_graphs``), captured with ``device_loop.TRACE_BINDINGS`` on: each
    span its graph binds from outside its private pools lies inside a live
    block of ``torch.cuda.memory_snapshot()``; then a replay, every free block
    of the default pool, the program's own pool and the while bodies' pools
    filled with NaN bytes, and a second replay equal to the first to the bit.
    The captured replays of its device loops (``loop_graphs``, ``cg_graphs``)
    get the first check. Fails the script on any finding."""
    from akmc_tpu_torch.ops import device_loop

    if dev.type != "cuda":
        return {}
    kinds, spans, poisoned, loops = {}, 0, 0, 0
    allocated, t0 = torch.cuda.memory_allocated(dev), time.perf_counter()
    for prog in list(model.step_graphs.programs.values()):
        if prog.graph is None:
            continue
        name = type(prog).__name__
        if not prog.bound:
            fail(f"{label}: the capture of a {name} recorded no binding (the trace was off)")
        stale = device_loop.stale_bindings(prog.bound, dev)
        if stale:
            fail(f"{label}: a {name} binds {len(stale)} spans outside every live block: "
                 f"{stale[:4]}")
        before = _replay_outputs(prog)
        poisoned += device_loop.poison_free_blocks(
            dev, [prog.graph.pool(), *device_loop.private_pools(dev)])
        after = _replay_outputs(prog)
        if len(before) != len(after) or not all(same_bits(a, b) for a, b in zip(before, after)):
            fail(f"{label}: a {name} replayed over memory filled with NaN differs from its "
                 "replay before")
        kinds[name] = kinds.get(name, 0) + 1
        spans += len(prog.bound)
    for sp in _graph_loops(model):
        stale = device_loop.stale_bindings(sp.bound, dev)
        if stale:
            fail(f"{label}: a device loop's replay binds {len(stale)} spans outside every "
                 f"live block: {stale[:4]}")
        loops += 1
        spans += len(sp.bound)
    return {"programs": kinds, "graph_loops": loops, "bound_spans": spans, "stale_spans": 0,
            "poisoned_gb": poisoned / 1e9, "poisoned_replays_bitwise_equal": True,
            "allocated_gb": [allocated / 1e9, torch.cuda.memory_allocated(dev) / 1e9],
            "reserved_gb": torch.cuda.memory_reserved(dev) / 1e9, "s": time.perf_counter() - t0}


REDO_VD = 8.0                 # the deck's highest bias
REDO_CHUNK = 2                # a window of one event: a superstep of two runs out
REDO_FIELDS = STATE_FIELDS + ("power", "temperature", "T_bg", "cb_edge")
PROGRAM_KINDS = ("SuperstepProgram", "ProductionProgram", "FullProgram", "FieldsProgram",
                 "EventsOnlyProgram", "CbEdgeProgram")


def _redo_sequence(model, state):
    """Every program kind of ``model`` after the redo paths, in one run from
    ``state`` on a vmax below the vacancies: the CB edge; a
    ``superstep_multi`` of 2 on windows of REDO_CHUNK draws, whose first
    step outgrows the cap, so that the batch is discarded and replayed step
    by step, that step redone at the grown cap (the outgrown programs
    dropped) and, firing more events than its window holds, continued; a
    superstep; a native and a batched production superstep; a full one and
    a ``superstep_full_multi`` of 2 on such windows; the fields only; an
    events-only step on such a window; the CB edge again. (the states after
    each call, their stats, the stream's next draw, the key)."""
    from akmc_tpu_torch.ops.threefry import KeyDraws
    from akmc_tpu_torch.rng import BufferedStream, ReferenceRNG

    stream = BufferedStream(ReferenceRNG(model.params.rnd_seed_kmc))
    draws = KeyDraws.seeded(PG_SEED, model.device)
    Vd, c = REDO_VD, REDO_CHUNK
    states, stats, mw = [], [], None

    def keep(st):
        states.append({f: getattr(state, f).clone() for f in REDO_FIELDS})
        stats.append(st)

    state = model.update_cb_edge(state, Vd)
    keep({"cb_iterations": model.cb_iterations})
    state, st = model.superstep_multi(state, Vd, stream, 2, rand_chunk=c)
    keep(st)
    state, st = model.superstep(state, Vd, stream)
    keep(st)
    state, st = model.superstep_native(state, Vd, draws)
    keep(st)
    state, st = model.superstep_native_batched(state, Vd, draws, batch=BATCHED_SWEEP_B)
    keep(st)
    state, st, mw = model.superstep_full(state, Vd, stream, rand_chunk=c)
    keep(st)
    state, st, mw = model.superstep_full_multi(state, Vd, stream, 2, m_prev=mw, rand_chunk=c)
    keep(st)
    state, st = model.fields_only(state, Vd)
    keep(st)
    state, st = model.superstep_events_only(state, stream, rand_chunk=c)
    keep(st)
    state = model.update_cb_edge(state, Vd)       # its program was dropped with the caps
    keep({"cb_iterations": model.cb_iterations})
    return states, stats, stream.peek(1)[0], draws.key.tolist()


def program_redo_paths(dev) -> dict:
    """Every program kind after its redo paths (``_redo_sequence``) on the
    n_yz = 24 crossbar, against the per-loop path from the same state, the
    same cap and the same stream and key: every call's state and stats
    equal to the bit; then ``lifetime_checks`` over the programs that are
    left, every kind among them."""
    from akmc_tpu_torch.lattice import ELEM
    from akmc_tpu_torch.models.vcm import VCMModel

    model, state0 = full_model(DECK, dev, pair_table_budget=8e9)
    p, lat = model.params, model.lat
    small = max(1, int((state0.element == int(ELEM.VACANCY)).sum()) // 2)
    del model
    runs = {}
    for programmed in (False, True):
        model = VCMModel(p, lat, device=dev, rate_normalize=True, pair_table_budget=8e9,
                         vmax=small, step_program=programmed)
        t0 = time.perf_counter()
        runs[programmed] = (_redo_sequence(model, state0), dict(model.step_counts),
                            dict(model.cb_counts), time.perf_counter() - t0)
        if programmed:
            lifetime = lifetime_checks(dev, model, "redo paths")
        del model
        torch.cuda.empty_cache()
    (ref, _, _, _), (got, counts, cb_counts, wall) = runs[False], runs[True]
    if ref[1] != got[1] or ref[2:] != got[2:]:
        fail(f"redo paths: the programs' stats or stream differ from the per-loop path's")
    for i, (a, b) in enumerate(zip(ref[0], got[0])):
        for f in REDO_FIELDS:
            if not same_bits(a[f], b[f]):
                fail(f"redo paths: call {i} differs from the per-loop path in {f}")
    if dev.type == "cuda" and not (counts["redos"] and counts["continues"]
                                   and counts["discards"] and not counts["per_loop"]):
        fail(f"redo paths: the programs ran {counts}: a redo, a continuation and a "
             "discard expected")
    if dev.type == "cuda" and set(lifetime["programs"]) != set(PROGRAM_KINDS):
        fail(f"redo paths: the checks saw {lifetime['programs']}, not every kind")
    return {"vmax_from": small, "Vd": REDO_VD, "rand_chunk": REDO_CHUNK, "calls": len(got[0]),
            "bitwise_equal": True, "step_counts": counts, "cb_counts": cb_counts,
            "wall_s": wall, "lifetime": lifetime if dev.type == "cuda" else None}


DECK_FIELDS = ("element", "charge", "potential_boundary", "potential_charge", "kmc_time",
               "cb_edge")


def _deck_calls(model, kind, state0, biases):
    """``kind`` ("fields", "events_only", "cb_edge") once per bias from
    ``state0`` (events only on a fresh mt19937 stream), each call timed
    (host clock, the card drained) and its host reads counted: (states,
    stats, ms, reads, the stream's next draw)."""
    from akmc_tpu_torch.rng import BufferedStream, ReferenceRNG

    dev = model.device
    stream = BufferedStream(ReferenceRNG(model.params.rnd_seed_kmc))
    state, states, stats, ms, reads = state0, [], [], [], []
    for Vd in biases:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with count_syncs(dev) as caught:
            if kind == "fields":
                state, st = model.fields_only(state, Vd)
            elif kind == "events_only":
                state, st = model.superstep_events_only(state, stream)
            else:
                state, st = model.update_cb_edge(state, Vd), {"cg_iterations": None}
                st["cg_iterations"] = model.cb_iterations
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        reads.append(n_syncs(caught))
        states.append({f: getattr(state, f).clone() for f in DECK_FIELDS})
        stats.append(st)
    return states, stats, ms, reads, stream.peek(1)[0]


def deck_turns(dev, name, p, lat, kind, biases, model_kw=None) -> dict:
    """``kind`` on the per-loop path and as one program a call in turns
    (loops, program, program, loops), every call bit-equal to the first
    run's: ms and host reads a call, the program's capture seconds, and on
    the DIA operator the kernels' launches from inside the program's graph
    (one each per K solve, the fused CG's iterations counted on the device
    equal to the model's). Then ``lifetime_checks`` on the program's model."""
    from akmc_tpu_torch.models.vcm import VCMModel
    from akmc_tpu_torch.ops import dia_matvec as mv
    from akmc_tpu_torch.ops import pairwise
    from akmc_tpu_torch.solvers import current, dia_cg
    from akmc_tpu_torch.state import make_device_state

    kw = model_kw or {}
    loops = VCMModel(p, lat, device=dev, step_program=False, **kw)
    prog = VCMModel(p, lat, device=dev, **kw)
    state0 = make_device_state(lat, p.background_temp, dev)
    t0 = time.perf_counter()
    captured = prog._capture_deck(kind, state0, biases[0])
    capture_s = time.perf_counter() - t0
    runs, launches = {False: [], True: []}, None
    for programmed in (False, True, True, False):
        model = prog if programmed else loops
        counts0 = dict(model.cb_counts if kind == "cb_edge" else model.step_counts)
        if programmed:
            mv.dia_combined_matvec.launches = dia_cg.dia_cg_solve.launches = 0
            pairwise.pairwise_potential_tiled.launches = 0
            current.wkb_contact_trap_kernel.launches = 0
            dia_cg.reset_iterations_total(dev)
            solves0, iters0 = model.k_solves, model.k_iterations
        r = _deck_calls(model, kind, state0, biases)
        counts = model.cb_counts if kind == "cb_edge" else model.step_counts
        done = {k: counts[k] - counts0[k] for k in counts0}
        if programmed:
            launches = {"dia_launches": mv.dia_combined_matvec.launches,
                        "dia_cg_launches": dia_cg.dia_cg_solve.launches,
                        "pair_tiled_launches": pairwise.pairwise_potential_tiled.launches,
                        "wkb_ct_launches": current.wkb_contact_trap_kernel.launches,
                        "cg_iterations_counted_on_device": dia_cg.iterations_total(dev),
                        "k_solves": model.k_solves - solves0,
                        "k_iterations": model.k_iterations - iters0}
            if done["per_loop"] or done["runs"] != len(biases) + done.get("redos", 0):
                fail(f"{name} {kind}: the program path ran {done}")
            if dev.type == "cuda" and not (done.get("redos") or done.get("continues")) and any(
                    n != 1 for n in r[3]):
                fail(f"{name} {kind}: a program call read the host {r[3]} times")
        elif done["per_loop"] != len(biases):
            fail(f"{name} {kind}: the per-loop path ran {done}")
        runs[programmed].append((r, done))
    ref = runs[False][0][0]
    for label, (r, _) in (("program 1", runs[True][0]), ("program 2", runs[True][1]),
                          ("loops 2", runs[False][1])):
        if r[1] != ref[1] or r[4] != ref[4]:
            fail(f"{name} {kind}: {label}'s stats or stream differ from loops 1's")
        for i, (a, b) in enumerate(zip(ref[0], r[0])):
            for f in DECK_FIELDS:
                if not same_bits(a[f], b[f]):
                    fail(f"{name} {kind}: {label}'s call {i} differs from loops 1's in {f}")
    if dev.type != "cuda":
        pass
    elif prog.dia is not None and kind == "fields":
        if (launches["dia_launches"], launches["dia_cg_launches"]) != (launches["k_solves"],) * 2:
            fail(f"{name} fields: DIA launches {launches} for the program's K solves")
        if launches["cg_iterations_counted_on_device"] != launches["k_iterations"]:
            fail(f"{name} fields: the fused CG counted {launches} iterations")
    elif launches["dia_launches"] or launches["dia_cg_launches"]:
        fail(f"{name} {kind}: a DIA kernel was launched: {launches}")
    tiled = prog.tables.pair_tiling is not None and kind == "fields"
    if dev.type == "cuda" and launches["pair_tiled_launches"] != (
            launches["k_solves"] if tiled else 0):
        fail(f"{name} {kind}: tiled pairwise launches {launches} (tiled path: {tiled})")
    if launches["wkb_ct_launches"]:
        fail(f"{name} {kind}: the wkb_ct kernel was launched without a power build: {launches}")
    best = {pr: min(runs[pr], key=lambda x: sum(x[0][2])) for pr in (False, True)}
    n = len(biases)
    out = {
        "model": prog.describe(), "calls": n, "bitwise_equal": True,
        "capture_s": capture_s, "program_capture_s": captured.capture_s,
        "ms_per_call_loops": [sum(r[2]) / n for r, _ in runs[False]],
        "ms_per_call_program": [sum(r[2]) / n for r, _ in runs[True]],
        "ms_loops": best[False][0][2], "ms_program": best[True][0][2],
        "host_reads_per_call_loops": sum(best[False][0][3]) / n,
        "host_reads_per_call_program": sum(best[True][0][3]) / n,
        "host_reads_program": best[True][0][3],
        "program_counts": best[True][1], "launches": launches,
        "stats": [{k: v for k, v in s.items() if k != "event_time"} for s in ref[1]],
        "lifetime": lifetime_checks(dev, prog, f"{name} {kind}"),
    }
    del loops, prog
    torch.cuda.empty_cache()
    print(f"chip_smoke: deck program {name} {kind}: " + json.dumps(
        {k: v for k, v in out.items() if k not in ("stats", "ms_loops", "ms_program")}))
    return out


def fields_once(dev, name, p, lat, Vd, model_kw=None) -> dict:
    """One fields-only call of a large structure at ``Vd`` on each path (the
    program captured first), bit-equal: ms, host reads."""
    from akmc_tpu_torch.models.vcm import VCMModel
    from akmc_tpu_torch.state import make_device_state

    out, ref = {"Vd": Vd}, None
    for programmed in (False, True):
        model = VCMModel(p, lat, device=dev, step_program=programmed, **(model_kw or {}))
        state0 = make_device_state(lat, p.background_temp, dev)
        if programmed:
            t0 = time.perf_counter()
            model._capture_deck("fields", state0, Vd)
            out["capture_s"] = time.perf_counter() - t0
        r = _deck_calls(model, "fields", state0, [Vd])
        key = "program" if programmed else "loops"
        out[f"ms_{key}"], out[f"host_reads_{key}"] = r[2][0], r[3][0]
        out["cg_iterations"] = r[1][0]["cg_iterations"]
        if programmed:
            out["lifetime"] = lifetime_checks(dev, model, f"{name} fields")
            if r[1] != ref[1] or not all(same_bits(ref[0][0][f], r[0][0][f])
                                         for f in DECK_FIELDS):
                fail(f"{name}: the fields-only program differs from the per-loop path")
        ref = r
        out["model"] = model.describe()
        del model
        torch.cuda.empty_cache()
    out["bitwise_equal"] = True
    print(f"chip_smoke: deck program {name} fields once: " + json.dumps(out))
    return out


def deck_programs(dev, synth, synth_dir) -> dict:
    """The deck modes and the CB edge on both paths (``deck_turns``): fields
    only at the deck's 15 biases and events only for N_SWEEP supersteps on
    the sweep's crossbar, the CB edge at the 15 biases on the crossbar and on
    the disordered stand-in; one fields-only call of the stand-in (banded,
    31,088 sites) and of the n_yz = 64 crossbar (409,600 slots) each way
    (``fields_once``); every program kind after its redo paths
    (``program_redo_paths``)."""
    from akmc_tpu_torch.config import KMCParameters
    from akmc_tpu_torch.lattice import build_lattice
    from akmc_tpu_torch.models import crossbar
    from akmc_tpu_torch.rng import ReferenceRNG
    from akmc_tpu_torch.runtime.driver import load_structure
    from akmc_tpu_torch.state import make_substoichiometric

    t0 = time.perf_counter()
    _, _, p, lat = crossbar_dia(N_YZ)
    biases = [float(v) for v in p.V_switch]
    out = {"crossbar_fields": deck_turns(dev, "crossbar", p, lat, "fields", biases),
           "crossbar_events_only": deck_turns(dev, "crossbar", p, lat, "events_only",
                                              biases[:1] * N_SWEEP),
           "crossbar_cb_edge": deck_turns(dev, "crossbar", p, lat, "cb_edge", biases)}
    sp = KMCParameters.from_file(synth)
    element, x, y, z = load_structure(sp, synth_dir)
    element = make_substoichiometric(element, sp.initial_vacancy_concentration,
                                     ReferenceRNG(sp.rnd_seed))
    slat = build_lattice(element, x, y, z, sp, device=dev)
    out["standin_cb_edge"] = deck_turns(dev, "stand-in", sp, slat, "cb_edge",
                                        [float(v) for v in sp.V_switch])
    out["standin_fields"] = fields_once(dev, "stand-in", sp, slat, float(sp.V_switch[0]))
    if out["standin_fields"]["model"]["k_operator"] != "banded":
        fail(f"the stand-in's fields took {out['standin_fields']['model']}, not the band")
    cp, clat = crossbar.build_grid_crossbar(
        n_yz=PG_N_YZ, contact_slices=10, oxide_slices=22, ti_slices=8,
        defect_fraction=0.1, vacancy_concentration=0.05, seed=0)
    out[f"crossbar_n{PG_N_YZ}_fields"] = fields_once(dev, f"crossbar n_yz={PG_N_YZ}", cp, clat,
                                                     CROSSBAR_VD, dict(rate_normalize=True))
    del clat
    t1 = time.perf_counter()
    out["redo_paths"] = program_redo_paths(dev)
    out["part_s"] = {"turns_and_fields_once": t1 - t0, "redo_paths": time.perf_counter() - t1}
    print("chip_smoke: redo paths: " + json.dumps(out["redo_paths"]))
    print("chip_smoke: deck programs took " + json.dumps(out["part_s"]), flush=True)
    return out


# ---------------------------------------------------------------------------
# fault A: torch.profiler over replays, each case in a process of its own
# (``--only profiler_fault``)
# ---------------------------------------------------------------------------
PROFILER_CASES = ("bare_while", "superstep", "production_native", "production_batched",
                  "full", "fields", "events_only", "cb_edge", "production_graph_window")
PROFILER_REPLAYS = 3
PROFILER_FAULTS = ("illegal memory access", "CUDA error", "CUPTI", "cudaError")


def profiler_case(name: str) -> int:
    """In a process of its own: ``torch.profiler`` (CPU and CUDA activities)
    over PROFILER_REPLAYS replays of one graph, then a device read. ``name``:
    "bare_while", a graph with one while node whose body is one elementwise
    add (and the compare that sets its flag); a program kind of the n_yz =
    24 crossbar, captured and run once first; or "production_graph_window",
    what ended in an illegal memory access in PR 14: the production_graph
    phase's idle-share window on the program path (its two batched
    supersteps at 409,600 slots, each a dispatch with its read). Prints one
    JSON line."""
    from torch.profiler import ProfilerActivity, profile

    import_port()
    from akmc_tpu_torch.ops import device_loop
    from akmc_tpu_torch.ops.threefry import KeyDraws
    from akmc_tpu_torch.rng import BufferedStream, ReferenceRNG

    dev = torch.device("cuda", torch.cuda.current_device())
    if name == "bare_while":
        x = torch.zeros((), dtype=torch.float64, device=dev)
        live = torch.zeros((), dtype=torch.bool, device=dev)

        def body():
            x.add_(1.0)
            torch.lt(x, 10.0, out=live)

        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            x.zero_()
            live.fill_(True)
            device_loop.while_loop(live, body)
        replay = graph.replay
    elif name == "production_graph_window":
        from akmc_tpu_torch.state import make_device_state

        p, lat, model, _, _ = crossbar_model(dev, PG_N_YZ)
        state0 = make_device_state(lat, p.background_temp, dev)
        model.warmup(state0, CROSSBAR_VD, batched=PG_BATCH)
        _pg_run(model, state0, 1)

        def replay():
            _pg_run(model, state0, 2)
    else:
        model, state = full_model(DECK, dev, pair_table_budget=8e9)
        Vd = float(model.params.V_switch[-1])
        stream = BufferedStream(ReferenceRNG(model.params.rnd_seed_kmc))
        if name == "superstep":
            prog = model._capture_program(state, Vd, 1)
        elif name.startswith("production"):
            batch = BATCHED_SWEEP_B if name.endswith("batched") else 0
            prog = model._capture_production(state, Vd, batch, False)
            prog.load(state, Vd, KeyDraws.seeded(PG_SEED, dev).key)
        elif name == "full":
            state = model.update_cb_edge(state, Vd)
            prog = model._capture_full(state, Vd, 1)
        else:
            prog = model._capture_deck(name, state, Vd)
        if name in ("superstep", "full"):
            prog.load(state, Vd, stream.peek(prog.k * prog.chunk), *(
                (torch.zeros(model.n_atom + 2, dtype=torch.float64, device=dev), 1.0)
                if name == "full" else ()))
        prog.run()
        replay = prog.graph.replay
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as trace:
        for _ in range(PROFILER_REPLAYS):
            replay()
        torch.cuda.synchronize()
    events = trace.key_averages()
    device_us = sum(getattr(e, "self_device_time_total", 0) or 0 for e in events)
    print(json.dumps({"case": name, "ok": True, "kernels": len(events),
                      "device_us": device_us}))
    return 0


def run_profiler_fault(dev):
    """(profiler_fault line, None): each case of PROFILER_CASES profiled in a
    process of its own (``--profiler-case``), its exit code and the last
    lines of its errors kept. A case that ends its process is the finding,
    not a failure of this phase; a case that cannot start is."""
    line = {"replays": PROFILER_REPLAYS, "cases": {}}
    for name in PROFILER_CASES:
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--profiler-case", name],
                           capture_output=True, text=True, timeout=600, cwd=HERE)
        last = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
        errors = [ln for ln in r.stderr.splitlines() if ln.strip()][-6:]
        # a signal, or an error the card or the profiler raised, is the finding;
        # anything else is a fault of the case itself
        on_card = r.returncode < 0 or any(k in r.stderr for k in PROFILER_FAULTS)
        line["cases"][name] = {"returncode": r.returncode, "ended": r.returncode != 0,
                               "result": json.loads(last[-1]) if last else None,
                               "stderr_tail": errors, "s": time.perf_counter() - t0}
        print(f"chip_smoke: profiler case {name}: " + json.dumps(line["cases"][name]))
        if r.returncode != 0 and not on_card:
            fail(f"profiler case {name} failed in its own code: {errors}")
    line["ended"] = [n for n, c in line["cases"].items() if c["ended"]]
    return line, None


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
    # the same sweep on the per-loop path (``step_program=False``): its rows
    wd_loops = os.path.join(DRIVER_DIR, "fields_only_loops")
    summary_l, rows_l, counts_l = drive(deck, wd_loops, synthesize_crossbar=N_YZ,
                                       dia_pallas=True, step_program=False)
    check_launches("fields-only per-loop", summary_l, rows_l, counts_l)
    if _rows_but_time(wd_loops) != _rows_but_time(wd) or _log_but_time(wd_loops) != _log_but_time(
            wd):
        problems.append("the fields-only sweep's programs and its per-loop path differ")
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
        "per_loop": {"superstep_s": [r["superstep_s"] for r in rows_l],
                     "driver_total_s": summary_l["total_time_s"],
                     "host_syncs_per_pass": counts_l["host_syncs"] / len(rows_l),
                     "rows_equal_but_time": True},
    }

    # events only, on the stale (zero) potential: no K solve, no kernel
    deck = synth_deck.write_mode_deck(DECK, DRIVER_DIR, "events_only")
    wd = os.path.join(DRIVER_DIR, "events_only")
    summary, rows, counts = drive(deck, wd, synthesize_crossbar=N_YZ, max_supersteps=N_SWEEP)
    launches["events_only"] = _launches_of(counts, summary)
    if any(launches["events_only"].values()):
        problems.append(f"the events-only sweep solved or launched: {launches['events_only']}")
    wd_loops = os.path.join(DRIVER_DIR, "events_only_loops")
    _, rows_l, counts_l = drive(deck, wd_loops, synthesize_crossbar=N_YZ,
                                max_supersteps=N_SWEEP, step_program=False)
    if _rows_but_time(wd_loops) != _rows_but_time(wd) or _log_but_time(wd_loops) != _log_but_time(
            wd):
        problems.append("the events-only sweep's programs and its per-loop path differ")
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
        "per_loop": {"superstep_s": [r["superstep_s"] for r in rows_l],
                     "host_syncs_per_superstep": counts_l["host_syncs"] / len(rows_l),
                     "rows_equal_but_time": True},
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
    launches["warmup"] = {k: warm[True][k] for k in ("dia_launches", "dia_cg_launches",
                                                     "pair_tiled_launches", "wkb_ct_launches",
                                                     "k_solves")}
    line["warmup"] = {"with": warm[True], "without": warm[False]}

    # the deck modes and the CB edge as one program a call, against the
    # per-loop path; every program kind after its redo paths
    synth_dir = os.path.join(DRIVER_DIR, "synth")
    synth = synth_deck.write_synth_deck(DECK, synth_dir, N_YZ)
    line["programs"] = deck_programs(dev, synth, synth_dir)
    launches["fields_program"] = {
        k: line["programs"]["crossbar_fields"]["launches"][k]
        for k in ("dia_launches", "dia_cg_launches", "pair_tiled_launches", "wkb_ct_launches",
                  "k_solves")}

    # the disordered stand-in: --cache-dir twice, the second run reading the file
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
SHARDED_SWEEP_STEPS = 2             # the sweep's first supersteps, of 24, on 2 and 4 ranks
SHARDED_BATCHED_STEPS = 1
SHARDED_FULL_STEPS = 1
SHARDED_SYNTH_STEPS = 1
SHARDED_CONCERN_STEPS = 1
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
        "time_source": ("CUDA events over a graph of launches" if dev_ms["kernel"] is not None
                        else "CUDA events"),
        "library": "torch.sparse_csr_tensor @ vector on the window's rows",
    }


def _reset_counts():
    from akmc_tpu_torch.ops import dia_matvec as mv
    from akmc_tpu_torch.ops import pairwise
    from akmc_tpu_torch.solvers import current, dia_cg

    mv.dia_combined_matvec.launches = 0
    dia_cg.dia_cg_solve.launches = 0
    pairwise.pairwise_potential_tiled.launches = 0
    current.wkb_contact_trap_kernel.launches = 0
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()


def _rank_counts(summary=None) -> dict:
    from akmc_tpu_torch.ops import dia_matvec as mv
    from akmc_tpu_torch.ops import pairwise
    from akmc_tpu_torch.solvers import current, dia_cg

    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
    out = {"row_window_launches": mv.dia_combined_matvec.launches,
           "dia_cg_launches": dia_cg.dia_cg_solve.launches,
           "pair_tiled_launches": pairwise.pairwise_potential_tiled.launches,
           "wkb_ct_launches": current.wkb_contact_trap_kernel.launches,
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
    if dev.type == "cuda" and model.tables.pair_tiling is not None:
        # the kernel against its twin on this rank's share of the tiles
        where = "409,600-slot crossbar" + ("" if mesh is None else f", rank {mesh.rank}")
        pair_tiled_readings(model, state.charge, where, timed=False)
    if mesh is None or mesh.rank == 0:
        out["element"] = state.element.cpu().numpy()
        out["charge"] = state.charge.cpu().numpy()
    return out


def _sharded_wkb_rows(mesh):
    """The contact-trap kernel against its twin on this rank's window of the
    disordered stand-in's contact rows at 8 V, cut as the sharded power
    build cuts them (``Mesh.split``), untimed."""
    from akmc_tpu_torch.runtime import synth_deck

    wd = os.path.join(SHARDED_DIR, f"wkb_rows_{mesh.rank}")
    synth = synth_deck.write_synth_deck(DECK, wd, N_YZ)
    model, state = full_model(synth, mesh.device, synth_dir=wd)
    window = mesh.split(int(model.current_tables.contact_idx.shape[0]))[mesh.rank]
    return wkb_kernel_readings(model, state, WKB_VD,
                               f"stand-in's rows of rank {mesh.rank} of {mesh.size}",
                               rows=window, timed=False)


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
        elif name == "wkb_rows":
            out[name] = _sharded_wkb_rows(mesh)
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
    head_dir = os.path.join(SHARDED_DIR, "one_sweep_head")
    drive(DECK, head_dir, synthesize_crossbar=N_YZ, max_supersteps=SHARDED_SWEEP_STEPS)
    refs["sweep"] = golden.summarize(head_dir)
    refs["sweep_rows"] = sweep_rows[:SHARDED_SWEEP_STEPS]
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
                                  "synthesize_crossbar": N_YZ,
                                  "max_supersteps": SHARDED_SWEEP_STEPS})

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
                ("wkb_rows", {}),
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
    # the golden's first supersteps, ending in the one-rank run's elements there
    gold = {"supersteps": gold["supersteps"][:SHARDED_SWEEP_STEPS],
            "final_elements": refs["sweep"]["final_elements"]}
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
            tiled = bt["describe"]["pairwise"] == "tiled"
            for rk, got in enumerate(per_rank):
                b = got["batched"]
                if b["row_window_launches"] != b["k_iterations"] + b["k_solves"]:
                    problems.append(f"rank {rk} of {size}: batched row-window launches "
                                    f"{b['row_window_launches']} != {b['k_iterations']} + "
                                    f"{b['k_solves']}")
                if dev.type == "cuda" and b["pair_tiled_launches"] != (
                        b["k_solves"] if tiled else 0):
                    problems.append(f"rank {rk} of {size}: batched tiled pairwise launches "
                                    f"{b['pair_tiled_launches']} for {b['k_solves']} K solves "
                                    f"(tiled path: {tiled})")
            line[f"batched_{size}"] = {
                "stats": bt["stats"], "wall_s": bt["wall_s"], "one_rank_wall_s": one["wall_s"],
                "kmc_time": bt["kmc_time"], "describe": bt["describe"],
                "peak_mem_gb": [g["batched"]["peak_mem_gb"] for g in per_rank],
                "one_rank_peak_mem_gb": one["peak_mem_gb"],
                "held_bytes": [g["batched"]["held_bytes"] for g in per_rank],
                "one_rank_held_bytes": one["held_bytes"],
                "pair_tiled_launches": [g["batched"]["pair_tiled_launches"] for g in per_rank],
                "one_rank_pair_tiled_launches": one["pair_tiled_launches"],
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
    # the contact-trap kernel: one launch a K solve on every rank (each over
    # its own contact rows), and bit-equal to its twin on each rank's window
    # of the stand-in's rows (asserted on the rank)
    for rk, got in enumerate(per_rank):
        f = got["full"]
        if f["wkb_ct_launches"] != f["k_solves"]:
            problems.append(f"rank {rk} of 4: full-physics wkb_ct launches "
                            f"{f['wkb_ct_launches']} for {f['k_solves']} K solves")
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
        "wkb_ct_launches": [g["full"]["wkb_ct_launches"] for g in per_rank],
        "k_solves": [g["full"]["k_solves"] for g in per_rank],
        "wkb_ct_row_windows": [g["wkb_rows"] for g in per_rank],
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
FLAGSHIP_STEPS = 2
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
    from akmc_tpu_torch.ops.threefry import KeyDraws
    from akmc_tpu_torch.rng import BufferedStream, ReferenceRNG
    from akmc_tpu_torch.state import make_device_state

    parts = PartTimes()
    p, lat, model, desc, build = crossbar_model(
        dev, FLAGSHIP_N_YZ, pair_f32=True, event_select_incremental=True)
    parts.mark("build")
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
    parts.mark("warmup_and_kernels")

    since = reset_launches(dev, model)
    # the batched supersteps draw from the threefry key on the card: one
    # program each (models/step_program.py::ProductionProgram)
    run = CrossbarSteps(dev, model, state, BufferedStream(ReferenceRNG(p.rnd_seed_kmc)),
                        KeyDraws.seeded(7, dev), where="flagship")
    run.step("serial")
    after_serial = run.state
    _reset_production_counts()
    first_batched = None
    for _ in range(FLAGSHIP_STEPS):
        run.step("batched", mass_eps=FLAGSHIP_MASS_EPS, clock_f32=FLAGSHIP_CLOCK_F32)
        first_batched = first_batched or (run.state, run.steps[-1])
    production_launches = _production_counts()
    if dev.type == "cuda" and production_launches["threefry_launches"] < sum(
            1 + r["batches"] for r in run.steps if r["kind"] == "batched"):
        fail(f"the flagship's batched programs launched {production_launches}")
    launches = crossbar_launches(dev, model, run.steps, since, where="flagship")
    peak = torch.cuda.max_memory_allocated() / 1e9
    # the first batched superstep once more on the per-loop path (device
    # loops drawing in their steps, the same key): bit-equal to the program
    with _per_loop(model, True):
        (per_loop, st), per_loop_s, _ = synced_s(lambda: model.superstep_native_batched(
            after_serial, CROSSBAR_VD, KeyDraws.seeded(7, dev), batch=64,
            mass_eps=FLAGSHIP_MASS_EPS, clock_f32=FLAGSHIP_CLOCK_F32,
            pb_prev2=state.potential_boundary))
    prog_state, prog_row = first_batched
    if (st["n_events"], st["n_batches"]) != (prog_row["events"], prog_row["batches"]) or \
            not all(same_bits(getattr(per_loop, f), getattr(prog_state, f))
                    for f in STATE_FIELDS):
        bad = [f for f in STATE_FIELDS
               if not same_bits(getattr(per_loop, f), getattr(prog_state, f))]
        fail(f"flagship: the per-loop batched superstep differs from the program's in {bad} "
             f"({st['n_events']} events in {st['n_batches']} batches against "
             f"{prog_row['events']} in {prog_row['batches']})")
    program_vs_per_loop = {"bitwise_equal": True, "per_loop_wall_s": per_loop_s,
                           "program_wall_s": prog_row["wall_s"],
                           "events": st["n_events"], "batches": st["n_batches"]}
    parts.mark("supersteps")

    # the three loops against their plain loops, then a batched superstep
    # with each, on the last state; one batched loop replayed on the CPU,
    # from the same fields and the same uniforms
    fr = model.fields(run.state, CROSSBAR_VD)
    loops = loop_turns(dev, model, run.state, fr, "flagship", FLAGSHIP_MASS_EPS, ks=True)
    parts.mark("loop_turns")
    turns = superstep_turns(dev, model, run.state, "flagship", FLAGSHIP_MASS_EPS)
    parts.mark("superstep_turns")
    peak_loops = torch.cuda.max_memory_allocated() / 1e9
    replay = replay_case(dev, run.state, fr, model.tables, p.freq, 215, 64, FLAGSHIP_CLOCK_F32,
                         FLAGSHIP_MASS_EPS, "the flagship's fields, B=64")
    parts.mark("cpu_replay")
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
    parts.mark("rate_scale_and_f32_probe")
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
        "production_launches": production_launches,
        "program_vs_per_loop": program_vs_per_loop,
        "program_capture_s": model.step_graphs.capture_s(), "part_s": parts,
    }
    print("chip_smoke: flagship " + json.dumps({k: line[k] for k in (
        "slots", "build_s", "model_s", "warmup_s", "peak_mem_gb", "part_s")}))
    return line, None


def crossbar_lines(lines):
    """(name, line) of each run that held the kernels at its own shapes:
    the batched phase's crossbars and the flagship."""
    out = [(name, line) for name, line in lines.get("batched", {}).items()
           if name.startswith("crossbar")]
    return out + ([("flagship", lines["flagship"])] if "flagship" in lines else [])


PHASES = ("kernels", "sweep", "disordered", "superstep_graph", "production_graph", "tiled",
          "batched", "full", "wkb_kernel", "driver", "sharded", "flagship")
OPT_IN = ("nccl", "schedules", "profiler_fault")   # run only when --only names them
LIFETIME_PHASES = ("superstep_graph", "production_graph", "full", "driver")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated phases to run (default: all)")
    ap.add_argument("--crossbar-n-yz", default=",".join(map(str, CROSSBAR_N_YZ)),
                    help="widths of the batched phase's crossbar runs (default 64,104: 409,600 "
                         "and 1,081,600 slots), the first at full depth")
    ap.add_argument("--profiler-case", choices=PROFILER_CASES,
                    help="(the profiler_fault phase's child process) profile one case's replays")
    args = ap.parse_args(argv)
    if args.profiler_case:
        if not torch.cuda.is_available():
            fail("no CUDA device: this smoke run needs the card")
        return profiler_case(args.profiler_case)
    phases = args.only.split(",")
    if set(phases) - set(PHASES) - set(OPT_IN):
        fail(f"--only takes phases of {PHASES + OPT_IN}")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs the card")
    import_port()
    from akmc_tpu_torch.ops import cuda_build, device_loop

    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    cuda_build.build(KERNELS + PLUMBING)
    for name in KERNELS + PLUMBING:
        cuda_build.load(name)
        for line in cuda_build.log_path(name).read_text().splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"chip_smoke: {name}: {line.strip()}")
    print(f"chip_smoke: built and loaded {', '.join(KERNELS + PLUMBING)} in "
          f"{time.perf_counter() - t0:.1f} s")

    kernels, lines, problems = [], {}, []
    if "kernels" in phases:
        parts = PartTimes()
        dia, meta, p, lat = crossbar_dia(N_YZ)
        parts.mark("crossbar")
        kernels = []
        for name, check in (("dia_matvec", lambda: check_dia_kernel(dev, dia, meta)),
                            ("dia_cg", lambda: check_dia_cg(dev, dia, meta, p, lat)),
                            ("threefry", lambda: check_threefry(dev)),
                            ("graph_while", lambda: check_graph_while(dev)),
                            ("pair_tiled", lambda: check_pair_tiled(dev, p, lat))):
            kernels.append(check())
            parts.mark(name)
        print("chip_smoke: phase kernels took " + json.dumps(parts), flush=True)
    sweep_rows, sweep_held = [], {}

    def sweep():
        line, problem = run_sweep()
        sweep_rows.extend(line.pop("rows"))
        sweep_held.update(line["held_bytes"])
        return line, problem

    for name, run in (("sweep", sweep), ("disordered", lambda: run_disordered(dev)),
                      ("superstep_graph", lambda: run_superstep_graph(dev)),
                      ("production_graph", lambda: run_production_graph(dev)),
                      ("tiled", lambda: run_tiled(dev)),
                      ("batched", lambda: run_batched(
                          dev, [int(n) for n in args.crossbar_n_yz.split(",")],
                          sweep_rows or None)),
                      ("full", lambda: run_full(dev)),
                      ("wkb_kernel", lambda: run_wkb_kernel(dev)),
                      ("driver", lambda: run_driver(dev, sweep_rows or None)),
                      ("sharded", lambda: run_sharded(dev, sweep_rows or None, sweep_held)),
                      ("nccl", lambda: run_sharded(dev, sweep_rows or None, sweep_held,
                                                   device="cuda", backend="nccl")),
                      ("flagship", lambda: run_flagship(dev)),
                      ("schedules", lambda: run_schedules(dev)),
                      ("profiler_fault", lambda: run_profiler_fault(dev))):
        if name in phases:
            # in the phases that check program lifetimes (fault A;
            # ``lifetime_checks``) every capture records what its graph binds
            device_loop.TRACE_BINDINGS = name in LIFETIME_PHASES
            # the models of the phases before are garbage in reference cycles,
            # and each holds its graphs' pools: free them before this phase
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            lines[name], problem = run()
            lines[name]["phase_s"] = time.perf_counter() - t0
            print(f"chip_smoke: phase {name} took {lines[name]['phase_s']:.1f} s", flush=True)
            if problem:
                problems.append(problem)
    # the threefry kernel and the while nodes: launches on the production
    # programs' paths (the crossbar's supersteps, the batched sweep, the flagship)
    for kern, key in zip(kernels[2:], ("threefry_launches", "while_condition_launches")):
        if "production_graph" in lines:
            pg = lines["production_graph"]
            kern["launches"] = pg["batched"]["launches"][key]
            kern["launches_native_path"] = pg["native"]["launches"][key]
            kern["launches_batched_sweep"] = pg["batched_sweep"][key]
        if "flagship" in lines:
            kern["launches_flagship_path"] = lines["flagship"]["production_launches"][key]
        if "full" in lines and key == "while_condition_launches":
            # the full-physics sweep through its programs' while nodes
            kern["launches_full_path"] = lines["full"]["while_condition_launches"]
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
    # the tiled pairwise kernel: launches on each path, counted over that
    # path alone (one a K solve where the model took the tiled path), and its
    # readings at the shapes of the paths that run it
    pair = next((k for k in kernels if k["name"] == "pairwise_potential_tiled"), None)
    if pair is not None:
        if "tiled" in lines:
            pair["launches_tiled_path"] = lines["tiled"]["pair_tiled_launches"]
            pair["tiled_path"] = lines["tiled"]["kernel"]
        if "full" in lines:
            pair["launches_full_path"] = lines["full"]["pair_tiled_launches"]
            pair["full_large_path"] = lines["full"]["program"]["large_standin"].pop("pair_tiled")
        if "driver" in lines:
            pair["launches_driver_path"] = {
                path: n["pair_tiled_launches"] for path, n in lines["driver"]["launches"].items()}
        if "sharded" in lines and "batched_4" in lines["sharded"]:
            pair["launches_sharded_path"] = {
                "batched_4_ranks": lines["sharded"]["batched_4"]["pair_tiled_launches"]}
        for name, line in crossbar_lines(lines):
            pair[name + "_path"] = {"launches": line["pair_tiled_launches"],
                                    **line["kernels_at_this_shape"][pair["name"]]}
    # the contact-trap kernel: launches on each path that builds the power
    # system, counted over that path alone (one a power build: a K solve, a
    # program run or a per-loop superstep; none on the deck programs), and
    # its readings against the twin at the shapes of the paths that run it
    wkb = {"name": "wkb_contact_trap_kernel"}
    if "full" in lines:
        full, prog = lines["full"], lines["full"]["program"]
        wkb["launches_full_path"] = full["wkb_ct_launches"]
        wkb["k_solves_full_path"] = full["k_solves"]
        wkb["launches_full_turns"] = {
            "sweep_crossbar": prog["sweep_crossbar"]["wkb_ct_launches"],
            "standin": prog["standin"]["wkb_ct_launches"],
            **{f"standin_heat_{kind}": prog["standin_heating"][kind]["wkb_ct_launches"]
               for kind in ("global", "local")}}
        wkb["full_large_path"] = prog["large_standin"].pop("wkb_ct")
    if "wkb_kernel" in lines:
        wkb["wkb_kernel_phase"] = {
            where: {k: lines["wkb_kernel"][where][k] for k in (
                "rows", "cols", "launches", "bitwise_equal_to_twin", "ms", "lane_efficiency")}
            for where in ("tsys102k", "standin")}
    if "driver" in lines:
        wkb["launches_driver_path"] = {
            path: n.get("wkb_ct_launches") for path, n in lines["driver"]["launches"].items()}
    if "sharded" in lines and "full_4" in lines["sharded"]:
        f4 = lines["sharded"]["full_4"]
        wkb["launches_sharded_path"] = {"full_4_ranks": f4["wkb_ct_launches"],
                                        "k_solves": f4["k_solves"]}
        wkb["sharded_row_windows"] = f4.pop("wkb_ct_row_windows")
    if kernels:                      # now in the kernels line
        for _, line in crossbar_lines(lines):
            del line["kernels_at_this_shape"]
    if len(wkb) > 1:
        kernels.append(wkb)
    # the device loops against their plain loops: one line for both widths
    loops = {name: line.pop("loops") for name, line in crossbar_lines(lines) if "loops" in line}
    if loops:
        lines["loops"] = loops
    # the CG device loops against their host loops: one line for both phases
    cg_loops = {name: lines[name].pop("cg_loops") for name in ("disordered", "full")
                if "cg_loops" in lines.get(name, {})}
    if cg_loops:
        lines["cg_loops"] = cg_loops

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
