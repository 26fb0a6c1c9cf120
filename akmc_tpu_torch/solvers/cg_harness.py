"""Standalone distributed-CG harness, as ``akmc_tpu/solvers/cg_harness.py``
defines it.

Reference equivalent: dist_iterative_test/, a driver that exercises the
distributed solver library against stored matrices (main_test.cpp:46-56) and
checks the relative error of the solution. Here the systems are synthetic
and the same as ``akmc_tpu``'s (the generators are copied, so the same seed
gives the same arrays), and the solve runs on one device or over ``devices``
ranks (``parallel/launch.py``). Two system classes:

* K-class (``make_system``): SPD graph Laplacian + boundary ties,
  high_G/low_G contrast: the boundary-potential system.
* T-class (``make_system_split``): a sparse neighbor part over all nodes plus
  a dense tunnel subblock on a node subset, ~43% dense (the reference's
  flagship instance: 102,722 nodes, a 14,854-node subblock, 94.2 M nnz;
  main_test.cpp:46-52).

Over several ranks the neighbor table and the dense subblock are
row-sharded: each rank computes its rows of the gather part and of the dense
product (gathered whole, ``Mesh.gather_rows``) and its rows' part of the
transposed scatter (added over ranks in rank order, ``Mesh.sum_partials``).
The CG vectors stay whole on every rank, so every rank holds the same
iterates. On one device the CG is the device loop of ``solvers/cg.py`` (one
program for a run's solves); over ranks, its host loop (gloo collectives
cannot be captured into a graph).

CLI:
    python -m akmc_tpu_torch.solvers.cg_harness --n 100000 --devices 4 --contrast 1e8
    python -m akmc_tpu_torch.solvers.cg_harness --t-class --n 102722 --sub 14854 --devices 4
(``--device cpu`` runs gloo ranks on the CPU; on CUDA one card per rank over
NCCL, or ``--device cuda:0 --backend gloo`` to share one card.)
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from akmc_tpu_torch.device import resolve_device
from akmc_tpu_torch.ops.device_loop import LoopGraphs
from akmc_tpu_torch.solvers.cg import Operator, jacobi_cg, jacobi_cg_plain


def make_system(n: int, nnz_per_row: int = 12, contrast: float = 1e8, seed: int = 0):
    """Random SPD system with K-matrix character: banded sparse graph
    Laplacian with bimodal edge weights {1, 1/contrast} + diagonal ties."""
    rng = np.random.RandomState(seed)
    bw = max(4, nnz_per_row * 4)
    nbr = (np.arange(n)[:, None] + rng.randint(1, bw, size=(n, nnz_per_row))) % n
    w = np.where(rng.rand(n, nnz_per_row) < 0.2, 1.0, 1.0 / contrast)
    return nbr.astype(np.int32), w


def make_system_split(
    n: int,
    n_sub: int,
    density: float = 0.43,
    nnz_per_row: int = 12,
    contrast: float = 1e8,
    seed: int = 0,
):
    """T-class split system: the K-class sparse part over all n nodes plus a
    dense symmetric tunnel subblock on ``n_sub`` random nodes at ``density``,
    zero diagonal, positive weights. Returns (nbr, w, sub_idx, W_off,
    sub_rowsum)."""
    rng = np.random.RandomState(seed + 7)
    nbr, w = make_system(n, nnz_per_row=nnz_per_row, contrast=contrast, seed=seed)
    sub_idx = np.sort(rng.choice(n, size=n_sub, replace=False)).astype(np.int32)
    mask = rng.rand(n_sub, n_sub) < density
    mask = np.triu(mask, 1)
    mask = mask | mask.T
    W_off = np.where(mask, rng.rand(n_sub, n_sub), 0.0)
    W_off = 0.5 * (W_off + W_off.T)
    sub_rowsum = W_off.sum(axis=1)
    return nbr, w, sub_idx, W_off, sub_rowsum


def _solve(mesh, device, n, contrast, rtol_coeff, n_sub=None, density=0.43, more_rtol=()):
    """Build the system, shard it over ``mesh`` (None: one device), solve
    A x = A x_true from zero and return the readings; ``more_rtol``: solve
    the same system again at each of these tolerance coefficients too
    (``by_rtol_coeff``: their iterations and errors)."""
    dev = torch.device(device) if mesh is None else mesh.device
    if n_sub is None:
        nbr, w = make_system(n, contrast=contrast)
        sub_idx = W_off = None
    else:
        nbr, w, sub_idx, W_off, sub_rowsum = make_system_split(
            n, n_sub, density=density, contrast=contrast)
    colsum = np.zeros(n)
    np.add.at(colsum, nbr.reshape(-1), w.reshape(-1))
    diag_np = 0.5 * (w.sum(1) + colsum) + 1.0
    if sub_idx is not None:
        diag_np[sub_idx] += sub_rowsum

    rows = (0, n) if mesh is None else mesh.rows(n)
    ranges = None if mesh is None else mesh.split(n)
    nbr_t = torch.as_tensor(nbr[rows[0]:rows[1]], dtype=torch.int64, device=dev)
    w_t = torch.as_tensor(w[rows[0]:rows[1]], device=dev)
    diag = torch.as_tensor(diag_np, device=dev)
    if sub_idx is not None:
        srows = (0, n_sub) if mesh is None else mesh.rows(n_sub)
        sranges = None if mesh is None else mesh.split(n_sub)
        sub_t = torch.as_tensor(sub_idx, dtype=torch.int64, device=dev)
        W_t = torch.as_tensor(W_off[srows[0]:srows[1]], device=dev)   # the rank's rows
        del W_off
    flat = nbr_t.reshape(-1)

    def whole(t, rr):
        return t if mesh is None else mesh.gather_rows(t, rr)

    def over_ranks(t):
        return t if mesh is None else mesh.sum_partials(t)

    def A(x):
        # -0.5 W via gather (row action) and -0.5 W^T via scatter (transpose
        # action): together the symmetric off-diagonal part
        y = diag * x - 0.5 * whole(torch.sum(w_t * x[nbr_t], dim=1), ranges)
        contrib = 0.5 * w_t * x[rows[0]:rows[1], None]
        # flat repeats its indices: index_put_ adds each index's values in
        # their order on the CPU and, sorted, on a card (index_add_'s atomics
        # would add them in whatever order they land)
        y = y - over_ranks(torch.zeros_like(x).index_put_((flat,), contrib.reshape(-1),
                                                          accumulate=True))
        if sub_idx is not None:
            # tunnel subblock: gather the subvector, dense rows, scatter-add
            y = y.index_add(0, sub_t, -whole(torch.mv(W_t, x[sub_t]), sranges))
        return y

    x_true = torch.as_tensor(np.random.RandomState(1).randn(n), device=dev)
    b = A(x_true)
    op, graphs = Operator("harness", A), LoopGraphs()

    def solve(coeff):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        x0 = torch.zeros(n, dtype=torch.float64, device=dev)
        if mesh is None:       # one program for every tolerance's solve
            res = jacobi_cg(op, b, x0, 1.0 / diag, coeff * n, 20000, graphs=graphs)
        else:                  # gloo collectives cannot be captured: the host loop
            res = jacobi_cg_plain(op, b, x0, 1.0 / diag, coeff * n, 20000)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        err = float(torch.linalg.norm(res.x - x_true) / torch.linalg.norm(x_true))
        return int(res.iterations), dt, err

    iters, dt, rel_err = solve(rtol_coeff)
    out = {"n": n, "devices": 1 if mesh is None else mesh.size,
           "iterations": iters, "wall_s": dt, "rel_l2_error": rel_err, "rtol_coeff": rtol_coeff,
           "device": str(dev)}
    if more_rtol:
        out["by_rtol_coeff"] = {c: dict(zip(("iterations", "wall_s", "rel_l2_error"), solve(c)))
                                for c in more_rtol}
    if sub_idx is not None:
        out.update(n_sub=n_sub, subblock_density=density,
                   W_bytes_rank=W_t.numel() * W_t.element_size())
    return out


def _spawned(mesh, n, contrast, rtol_coeff, n_sub, density):
    return _solve(mesh, None, n, contrast, rtol_coeff, n_sub, density)


def _run(n, devices, contrast, rtol_coeff, n_sub, density, device, backend, timeout):
    dev = resolve_device(device)
    if devices <= 1:
        return _solve(None, dev, n, contrast, rtol_coeff, n_sub, density)
    from akmc_tpu_torch.parallel.launch import spawn

    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    outs = spawn(_spawned, devices, str(dev), backend, n, contrast, rtol_coeff, n_sub,
                 density, timeout=timeout)
    return outs[0]


def run(n: int, devices: int, contrast: float, rtol_coeff: float = 1e-14,
        device=None, backend: Optional[str] = None, timeout: float = 600.0) -> dict:
    """Solve the K-class system on ``devices`` ranks (1: in this process)."""
    return _run(n, devices, contrast, rtol_coeff, None, 0.43, device, backend, timeout)


def run_split(n: int, n_sub: int, devices: int, contrast: float = 1e8, density: float = 0.43,
              rtol_coeff: float = 1e-14, device=None, backend: Optional[str] = None,
              timeout: float = 600.0) -> dict:
    """Solve the T-class split system (sparse neighbor part plus the dense
    tunnel subblock, row-sharded) with the same Jacobi-CG."""
    return _run(n, devices, contrast, rtol_coeff, n_sub, density, device, backend, timeout)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=100000)
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--contrast", type=float, default=1e8)
    ap.add_argument("--t-class", action="store_true",
                    help="split T-class system (sparse + dense tunnel subblock, "
                         "main_test_cg_split.cpp equivalent)")
    ap.add_argument("--sub", type=int, default=None,
                    help="T-class subblock size (default: 14.46%% of n, the "
                         "reference instance's ratio)")
    ap.add_argument("--density", type=float, default=0.43,
                    help="T-class subblock density (reference: 94.2M nnz in "
                         "14854^2 = 43%%)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda: one card per rank over nccl; "
                         "'cpu': gloo ranks; 'cuda:0' with --backend gloo: ranks share a card)")
    ap.add_argument("--backend", default=None, help="gloo or nccl (default: by device)")
    args = ap.parse_args(argv)
    if args.t_class:
        n_sub = args.sub if args.sub is not None else max(2, int(args.n * 0.1446))
        print(run_split(args.n, n_sub, args.devices, args.contrast, args.density,
                        device=args.device, backend=args.backend))
    else:
        print(run(args.n, args.devices, args.contrast, device=args.device,
                  backend=args.backend))


if __name__ == "__main__":
    main()
