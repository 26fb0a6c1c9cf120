"""Start the ranks of a sharded run: one process per rank.

``spawn(fn, n, device, backend, *args)`` starts ``n`` processes with the
``spawn`` start method, joins them into one ``torch.distributed`` group
through a ``FileStore`` in a fresh temporary directory (no TCP port to race
for), and calls ``fn(mesh, *args)`` in each, with ``mesh`` the rank's
``parallel.mesh.Mesh``. It returns the ranks' return values in rank order.

Devices. ``device="cpu"``: every rank on the CPU (backend ``gloo``).
``device="cuda"``: rank r on ``cuda:r`` (backend ``nccl``; needs n visible
cards). ``device="cuda:K"``: every rank on the one card K, which NCCL refuses
("Duplicate GPU detected"), so only with ``gloo``; that form is for tests and
the smoke script on a one-card machine. The backend is the caller's choice and
is never changed behind its back.

A rank that raises ends the run: the others are killed and ``spawn`` raises
with the failing rank's traceback. A run that passes ``timeout`` seconds is
killed and raises too, and a collective that waits longer than that (or than
``COLLECTIVE_TIMEOUT_S`` with no ``timeout``) fails, so a hung rank fails the
run instead of hanging it.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

current_device = torch.device("cpu")   # this process's rank device, once ``spawn`` set it
COLLECTIVE_TIMEOUT_S = 1800.0          # a collective's limit when the run has none


def rank_device(device: str, rank: int) -> torch.device:
    """The device rank ``rank`` computes on (see the module docstring)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank)
    return dev


def check_devices(n: int, device: str, backend: str) -> None:
    """Raise before anything starts when ``n`` ranks cannot run on ``device``
    under ``backend``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the ranks need a CUDA card and none is available")
        if dev.index is None:
            if backend != "nccl":
                raise ValueError("one card per rank runs over nccl; pass backend='nccl'")
            if torch.cuda.device_count() < n:
                raise ValueError(
                    f"{n} ranks need {n} visible cards, only {torch.cuda.device_count()} "
                    "visible (several ranks share one card only over gloo, with an "
                    "explicit device such as 'cuda:0')")
        elif backend == "nccl" and n > 1:
            raise ValueError("nccl refuses two ranks on one card; share a card over gloo")
    elif backend != "gloo":
        raise ValueError(f"CPU ranks run over gloo, not {backend}")


def _worker(rank, n, store_path, device, backend, timeout_s, fn, args, results, received):
    global current_device
    from akmc_tpu_torch.parallel.mesh import Mesh

    try:
        dev = current_device = rank_device(device, rank)
        if dev.type == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=f"file://{store_path}", rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=timeout_s),
        )
        try:
            mesh = Mesh(rank, n, dev, backend)
            out = fn(mesh, *args)
            results.put((rank, True, out))
        finally:
            dist.destroy_process_group()
    except BaseException:                       # noqa: BLE001 - reported to the parent
        results.put((rank, False, traceback.format_exc()))
    # a tensor in the result travels as a file descriptor that this process
    # hands out on request: stay until the parent has read every result
    received.wait(timeout_s)


def spawn(fn: Callable, n: int, device: str, backend: str, *args,
          timeout: Optional[float] = 600.0) -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``n`` ranks; their return values in rank
    order. ``fn`` and ``args`` must pickle, and so must what ``fn`` returns.
    ``timeout`` in seconds bounds the run (None: no bound)."""
    check_devices(n, device, backend)
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="akmc_ranks_")
    results, received = ctx.Queue(), ctx.Event()
    procs = [ctx.Process(target=_worker, daemon=False,
                         args=(r, n, os.path.join(tmp, "store"), device, backend,
                               float(timeout or COLLECTIVE_TIMEOUT_S), fn, args, results,
                               received))
             for r in range(n)]
    deadline = time.monotonic() + (timeout if timeout is not None else float("inf"))
    out: dict = {}
    try:
        for p in procs:
            p.start()
        while len(out) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{n} ranks did not finish within {timeout} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and results.empty():
                    time.sleep(0.5)             # a rank's last message may be in flight
                    if results.empty():
                        raise RuntimeError(
                            f"rank process exited with code {dead[0].exitcode} "
                            "without a result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {n} failed:\n{value}")
            out[rank] = value
        received.set()
        for p in procs:
            p.join(max(1.0, min(60.0, deadline - time.monotonic())))
    finally:
        received.set()
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(n)]
