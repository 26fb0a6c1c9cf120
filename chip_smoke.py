"""Smoke run of akmc_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero before the last
line is printed):

1. build   the hand-written kernel from its source in ``akmc_tpu_torch/csrc``
           (``nvcc`` for sm_90a, then loaded with ctypes);
2. kernels each kernel's wrapper on tensors on the card at the main path's
           shapes, held against its plain PyTorch twin on the same inputs
           (the DIA matvec: the n_yz=24 crossbar's operator, N = 58,752 and
           D = 32, plus three random offset sets; bound 1e-12 relative to the
           largest entry), then timed beside the twin and beside one PyTorch
           sparse product computing the same function (a yardstick only);
3. sweep   the port's main path through its driver: the whole 15-point I-V
           sweep of ``decks/iv_sweep_5nm.txt`` on a synthesized grid-native
           crossbar at n_yz=24 (58,752 slots), with every launch counter set
           to 0 just before and read just after. The DIA kernel must have run
           once per CG matvec plus once per K solve (the conductive-vacancy
           degrees), every superstep must be finite, and events,
           superstep count and final elements must equal the committed golden
           of ``akmc_tpu`` on the same command; KMC times within GOLDEN_KMC_RTOL.

Output: a ``kernels`` JSON line, a ``sweep`` JSON line, the card's name and
power limit from nvidia-smi, and last ``{"ok": true, "device": {...}}``.
Needs one card, no network, and no JAX.
"""

from __future__ import annotations

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
MATVEC_RTOL = 1e-12
# Each KMC time is an exponential of potentials the CG returns only to its
# stop tolerance (rtol 1e-14 * n_int on a kappa ~ 1e8 system), so any change
# of reduction order moves it: akmc_tpu's own f64 XLA and two-f32 Pallas
# formulations are 2.8e-4 apart on this sweep. The port reads 5.7e-5 from
# the golden on the H100 (bit-identical run to run) and 1.4e-4 on the CPU;
# the bound sits above both and below akmc_tpu's own spread.
GOLDEN_KMC_RTOL = 2e-4
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
    """The DIA operator the driver builds for the deck at ``n_yz``."""
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
    return built


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


def check_dia_kernel(dev) -> dict:
    from akmc_tpu_torch.ops import dia_matvec as mv

    rng = np.random.default_rng(2024)
    dia, meta = crossbar_dia(N_YZ)
    diags, offsets = dia.diags.to(dev), dia.offsets.to(dev)
    D, n = diags.shape
    cases = [("n_yz=24 crossbar", diags, offsets, meta.val_low, meta.val_high)]
    for name, offs in (
        ("clustered", [-136, -129, -128, -127, -64, -9, -1, 1, 9, 64, 127, 128, 129, 136]),
        ("far", [-5000, -4999, -3, -1, 1, 3, 4999, 5000]),
        ("tight", [-2, -1, 1, 2]),
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
    calls = {
        "kernel": lambda: mv.dia_combined_matvec(diags, offsets, meta.val_low,
                                                 meta.val_high, x, xv),
        "plain": lambda: mv.dia_combined_matvec_plain(diags, offs_list, meta.val_low,
                                                      meta.val_high, x, xv),
        "library": lambda: lib @ xcat,
    }
    call_ms = {k: cuda_time_ms(f, reps=50 if k == "plain" else 1000) for k, f in calls.items()}
    dev_ms = {k: device_ms(f) for k, f in calls.items()}
    times = {k: dev_ms[k] if dev_ms[k] is not None else call_ms[k] for k in calls}

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
        "time_source": "profiler device time" if dev_ms["kernel"] is not None else "CUDA events",
        "call_ms": call_ms,                    # back-to-back calls, host launch gaps included
        "shape": {"D": D, "N": n, "nnz": nnz, "bytes": n_bytes, "ops": n_ops},
    }


def run_sweep() -> dict:
    """The main path through the driver on the card."""
    from akmc_tpu_torch.ops import dia_matvec as mv
    from akmc_tpu_torch.runtime import driver, golden

    shutil.rmtree(WORKDIR, ignore_errors=True)
    mv.dia_combined_matvec.launches = 0
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as syncs:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")   # one warning per host synchronisation
        try:
            summary = driver.run(DECK, workdir=WORKDIR, synthesize_crossbar=N_YZ,
                                 dia_pallas=True, log=False)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = mv.dia_combined_matvec.launches
    n_syncs = sum("synchroniz" in str(w.message) for w in syncs)

    with open(os.path.join(WORKDIR, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    cg = sum(r["cg_iterations"] for r in rows)
    # one K solve per superstep (the q/v caps never grow on this sweep; a
    # growth would redo the solve): one launch per CG matvec plus the
    # solve's conductive-vacancy degree product
    expected = cg + len(rows)
    if launches != expected:
        fail(f"DIA kernel launches {launches} != CG matvecs {cg} + K solves {len(rows)}")
    for r in rows:
        if not all(math.isfinite(r[k]) for k in ("kmc_time", "event_time", "superstep_s")):
            fail(f"non-finite superstep: {r}")
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
        "dia_launches": launches,
        "wall_s": wall_s, "driver_total_s": summary["total_time_s"],
        "superstep_s": [r["superstep_s"] for r in rows],
        "cg_per_superstep": [r["cg_iterations"] for r in rows],
        "kmc_time": [r["kmc_time"] for r in rows],
        "host_syncs": n_syncs,
        "kmc_time_max_rel_vs_golden": dist["kmc_time_max_rel"],
        "golden_kmc_rtol": GOLDEN_KMC_RTOL,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    if bad or not pot_ok:
        print("sweep " + json.dumps(sweep))
        fail("sweep disagrees with the golden: " + "; ".join(bad[:10])
             if bad else "non-finite potentials in the final snapshot")
    return sweep


def _final_potentials_finite(workdir: str) -> bool:
    from akmc_tpu_torch.runtime.golden import _final_snapshot

    with open(_final_snapshot(workdir)) as f:
        vals = [float(ln.split()[4]) for ln in f.read().splitlines()[2:] if ln.strip()]
    return bool(vals) and all(math.isfinite(v) for v in vals)


def main() -> int:
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs the card")
    import_port()
    from akmc_tpu_torch.ops import cuda_build

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cuda_build.load("dia_matvec")
    print(f"chip_smoke: built and loaded dia_matvec in {time.perf_counter() - t0:.1f} s")

    kern = check_dia_kernel(dev)
    torch.cuda.reset_peak_memory_stats()
    sweep = run_sweep()
    kern["launches"] = sweep["dia_launches"]
    kern["launches_per_superstep"] = sweep["dia_launches"] / sweep["supersteps"]

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    print(json.dumps({"kernels": [kern]}))
    print("sweep " + json.dumps(sweep))
    print(smi[0] if smi else "nvidia-smi: no output")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
