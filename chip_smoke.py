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
           with D = 36 > 32 and N = 300,000, which takes the kernel's general
           case with several chunks per block): iteration count equal and
           ``x``, ``r``, ``residual_sq`` bit-equal to ``dia_cg_solve_plain``;
           then timed per solve and per iteration beside the host-loop CG
           (``jacobi_cg`` over the kernel matvec, one host read per iteration)
           and beside the same number of grid syncs with no work between them;
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
5. tiled   the pairwise paths at a size that needs them: three supersteps of
           the deck on a synthesized crossbar at n_yz=32 (104,448 slots, pair
           table past its 8e9-byte budget). The model must have taken the tiled
           path and the DIA operator, both kernels must have been launched,
           every superstep finite. On the first superstep's charges the tiled
           potential is held against the on-the-fly plane (f64: rtol 1e-12;
           f32 plane: rtol 2e-5 off the cutoff shell), and both are timed.

Output: a ``kernels`` JSON line, one JSON line each for ``sweep``,
``disordered`` and ``tiled``, the card's name and power limit from nvidia-smi,
and last ``{"ok": true, "device": {...}}``. ``--only PHASE[,PHASE]`` (of
kernels, sweep, disordered, tiled) runs a part of it while developing.
Needs one card, no network, and no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
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
    """One block-diagonal CSR matrix [[W, 0], [0, adjacency]] on the card:
    ``M @ [x; xv]`` is the DIA function in one PyTorch sparse product."""
    D, n = diags.shape
    c = diags.cpu().numpy()
    d_idx, rows = np.nonzero(c)
    cols = rows + offsets.cpu().numpy()[d_idx]
    keep = (cols >= 0) & (cols < n)
    d_idx, rows, cols = d_idx[keep], rows[keep], cols[keep]
    w = np.where(c[d_idx, rows] == 2, val_high, val_low)
    all_rows = np.concatenate([rows, rows + n])
    all_cols = np.concatenate([cols, cols + n])
    vals = np.concatenate([w, np.ones_like(w)])
    order = np.lexsort((all_cols, all_rows))
    crow = np.zeros(2 * n + 1, np.int64)
    np.cumsum(np.bincount(all_rows, minlength=2 * n), out=crow[1:])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # "sparse CSR support is in beta"
        return torch.sparse_csr_tensor(
            torch.from_numpy(crow), torch.from_numpy(all_cols[order]),
            torch.from_numpy(vals[order]), size=(2 * n, 2 * n), dtype=torch.float64,
            check_invariants=True,
        ).to(dev)


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
    n_bytes = D * n + D * 8 + 2 * n * 8 + 2 * n * 8   # codes + offsets + x, xv in + y, v out
    n_ops = 2 * nnz + 3 * n                           # A/B add + V add per code; 2 mul + 1 add per row
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / F64_FLOP_PER_S * 1e3
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
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": times["library"],
        "library": "torch.sparse_csr_tensor @ vector, block-diagonal [[W, 0], [0, adjacency]]",
        "empty_kernel_ms": times["empty"],     # the floor of one launch on this grid
        "time_source": "profiler device time" if dev_ms["kernel"] is not None else "CUDA events",
        "call_ms": call_ms,                    # back-to-back calls, host launch gaps included
        "host_path_us": host_path_us,
        "shape": {"D": D, "N": n, "nnz": nnz, "bytes": n_bytes, "ops": n_ops},
    }


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


def check_dia_cg(dev, dia, meta, p, lat) -> dict:
    import ctypes

    from akmc_tpu_torch.ops import cuda_build
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

    def compare(name, op_c, ks, tol, max_it, want_regs):
        got = dia_cg.dia_cg_solve(op_c, *ks, tol, max_it)
        blocks, regs = dia_cg.dia_cg_solve.last_grid
        torch.cuda.synchronize()
        ref = dia_cg.dia_cg_solve_plain(op_c, *ks, tol, max_it)
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
        return got, k, blocks

    systems = {Vd: k_system(dia, meta, element, charge, zeros, Vd, *geom) for Vd in CG_BIASES}
    cold = {Vd: compare(f"n_yz={N_YZ} crossbar, cold, Vd={Vd}", op, ks, rtol, 10000, True)
            for Vd, ks in systems.items()}
    warm_ks = k_system(dia, meta, element, charge, cold[CG_BIASES[0]][0].x, 2.0, *geom)
    compare(f"n_yz={N_YZ} crossbar, warm from Vd={CG_BIASES[0]}, Vd=2.0", op, warm_ks,
            rtol, 10000, True)
    _, k_cut, _ = compare(f"n_yz={N_YZ} crossbar, max_iterations=10", op,
                          systems[CG_BIASES[0]], rtol, 10, True)
    if k_cut != 11:
        fail(f"a solve cut at max_iterations=10 must return k=11, got {k_cut}")
    compare("random, far offsets", *random_k_system(rng, 4000, [1, 3, 1999, 2000], dev),
            1e-10, 500, True)
    big = [1, 2, 3, 5, 8, 13, 21, 34, 55, 89, 144, 233, 377, 610, 987, 1597, 2584, 150000]
    compare("random, D=36, several chunks per block", *random_k_system(rng, 300_000, big, dev),
            1e-10, 500, False)

    # timing on the first cold solve of the sweep's operator
    Vd = CG_BIASES[0]
    ks, (_, k, blocks) = systems[Vd], cold[Vd]

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

    call_ms = cuda_time_ms(fused, reps=20, warmup=2)
    dev_ms = device_ms(fused, reps=20)
    host_ms, host_res = wall_ms(host_loop, 2)
    plain_ms, _ = wall_ms(lambda: dia_cg.dia_cg_solve_plain(op, *ks, rtol, 10000), 1)
    ms = dev_ms if dev_ms is not None else call_ms
    one_it_ms = cuda_time_ms(lambda: dia_cg.dia_cg_solve(op, *ks, rtol, 0), reps=200)

    # the floor under an iteration: grid syncs alone on the solve's grid, the
    # difference of a long and an empty run of them
    sync_floor = cuda_build.load("dia_cg").dia_cg_sync_floor_launch
    sync_floor.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    sync_floor.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream

    def syncs_only(count):
        if sync_floor(blocks, count, stream) != 0:
            fail("the grid-sync kernel did not launch")

    n_syncs = 3 * k
    sync_ms = (cuda_time_ms(lambda: syncs_only(n_syncs), reps=20, warmup=2)
               - cuda_time_ms(lambda: syncs_only(0), reps=20, warmup=2)) / n_syncs

    nnz = int((op.diags != 0).sum())
    cv_f = ks.cvac.to(torch.float64)
    nnz_cv = int(op.matvec(cv_f, cv_f)[1].sum())      # edges into a conductive vacancy
    # in: codes, offsets, two masks, five vectors; out: x and r
    n_bytes = D * n + D * 8 + 2 * n + 5 * n * 8 + 2 * n * 8
    # A is applied k times (2 flops per edge, 1 per conductive-vacancy edge, 4
    # per row), and each of the k - 1 iterations adds 11 flops per row
    n_ops = k * (2 * nnz + nnz_cv + 4 * n) + (k - 1) * 11 * n
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / F64_FLOP_PER_S * 1e3
    # what an iteration streams if nothing stays on the chip: the codes, two
    # masks, and eleven passes over f64 vectors
    iter_bytes = D * n + 2 * n + 11 * n * 8
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
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "library": None,                       # no single PyTorch call computes a CG
        "host_loop_ms": host_ms,               # jacobi_cg over the kernel matvec, same inputs
        "host_loop_iterations": host_res.iterations,
        "iterations": k,
        "ms_per_iteration": ms / k,
        "host_loop_ms_per_iteration": host_ms / host_res.iterations,
        "iteration_bytes_bound_ms": iter_bytes / HBM_BYTES_PER_S * 1e3,
        "call_ms": call_ms,                    # back-to-back solves, wrapper included
        "launch_only_call_ms": one_it_ms,      # max_iterations=0: start, two dots, no iteration
        "grid_blocks": blocks,
        "grid_syncs_per_iteration": 3,
        "grid_sync_ms": sync_ms,               # one sync of this grid with no work around it
        "time_source": "profiler device time" if dev_ms is not None else "CUDA events",
        "timed_case": f"n_yz={N_YZ} crossbar, cold start, Vd={Vd}",
        "shape": {"D": D, "N": n, "nnz": nnz, "nnz_into_cvac": nnz_cv, "bytes": n_bytes,
                  "ops": n_ops, "iteration_bytes": iter_bytes},
    }


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
    with warnings.catch_warnings(record=True) as syncs:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")   # one warning per host synchronisation
        try:
            summary = driver.run(deck, workdir=workdir, log=False, **options)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    counts = {
        "wall_s": time.perf_counter() - t0,
        "dia_launches": mv.dia_combined_matvec.launches,
        "dia_cg_launches": dia_cg.dia_cg_solve.launches,
        "cg_iterations_counted_on_device": dia_cg.iterations_total("cuda"),
        "host_syncs": sum("synchroniz" in str(w.message) for w in syncs),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    for r in rows:
        if not all(math.isfinite(r[k]) for k in ("kmc_time", "event_time", "superstep_s")):
            fail(f"non-finite superstep: {r}")
    return summary, rows, counts


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
        "driver_snapshot_s": summary["snapshot_s"],
        "driver_other_s": summary["total_time_s"] - summary["supersteps_s"] - summary["snapshot_s"],
        "superstep_s": [r["superstep_s"] for r in rows],
        "cg_per_superstep": [r["cg_iterations"] for r in rows],
        "kmc_time": [r["kmc_time"] for r in rows],
        "host_syncs": n_syncs, "host_syncs_per_superstep": n_syncs / len(rows),
        "kmc_time_max_rel_vs_golden": dist["kmc_time_max_rel"],
        "golden_kmc_rtol": GOLDEN_KMC_RTOL,
        "peak_mem_gb": counts["peak_mem_gb"],
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
    # one fused CG and one matvec per K solve; a cap that grew repeats the solve
    if counts["dia_cg_launches"] < len(rows) or counts["dia_launches"] < len(rows):
        fail(f"the tiled path did not go through the DIA kernels: {counts}")
    cg = sum(r["cg_iterations"] for r in rows)
    if counts["cg_iterations_counted_on_device"] < cg:
        fail(f"the fused solves counted {counts['cg_iterations_counted_on_device']} "
             f"iterations, metrics.jsonl {cg}")
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


def _final_potentials_finite(workdir: str) -> bool:
    from akmc_tpu_torch.runtime.golden import _final_snapshot

    with open(_final_snapshot(workdir)) as f:
        vals = [float(ln.split()[4]) for ln in f.read().splitlines()[2:] if ln.strip()]
    return bool(vals) and all(math.isfinite(v) for v in vals)


PHASES = ("kernels", "sweep", "disordered", "tiled")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated phases to run (default: all)")
    phases = ap.parse_args(argv).only.split(",")
    if set(phases) - set(PHASES):
        fail(f"--only takes phases of {PHASES}")
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
    for name, run in (("sweep", run_sweep), ("disordered", lambda: run_disordered(dev)),
                      ("tiled", lambda: run_tiled(dev))):
        if name in phases:
            t0 = time.perf_counter()
            lines[name], problem = run()
            lines[name]["phase_s"] = time.perf_counter() - t0
            if problem:
                problems.append(problem)
    # launches on each path that runs the kernels, counted over that path alone
    for kern, key in zip(kernels, ("dia_launches", "dia_cg_launches")):
        if "sweep" in lines:
            kern["launches"] = lines["sweep"][key]
            kern["launches_per_superstep"] = kern["launches"] / lines["sweep"]["supersteps"]
        if "tiled" in lines:
            kern["launches_tiled_path"] = lines["tiled"][key]
        if "disordered" in lines:
            kern["launches_disordered_path"] = 0      # asserted: no DIA form there

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
