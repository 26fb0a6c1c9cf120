"""Checkpoint / resume.

The reference restarts only from xyz snapshots (``restart = 1`` +
``restart_xyz_file``, input_parser.cpp:25-31, kmc_main.cpp:128-148) and loses
RNG state, in-bias kmc_time, temperature and field vectors across restarts.
A full checkpoint (npz) captures everything: element, charge and the field
vectors, T_bg, kmc_time, bias index, superstep count, and the exact mt19937
position of the KMC stream with its unconsumed draws, so a resumed serial run
is bit-identical to an uninterrupted one. In a sharded run rank 0 writes the
file and every rank reads it. The generator of the batched event
loop is not stored: a resumed ``--batched-events`` run is a valid run of the
same law from a reseeded generator.

The file has the field names, dtypes and shapes of
``akmc_tpu/runtime/checkpoint.py``: a checkpoint written by either package
loads in the other.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from akmc_tpu_torch.device import resolve_device
from akmc_tpu_torch.rng import BufferedStream
from akmc_tpu_torch.state import DeviceState

_INT_FIELDS = ("element", "charge")
_F64_FIELDS = ("potential_boundary", "potential_charge", "power", "temperature",
               "cb_edge", "T_bg", "kmc_time")


def save_checkpoint(
    path: str,
    state: DeviceState,
    kmc_stream: BufferedStream,
    vt_counter: int = 0,
    kmc_step_count: int = 0,
    extra: Optional[dict] = None,
    mesh=None,
) -> None:
    """Save the run's state. Under a mesh (``parallel/mesh.py``) every rank
    calls it: rank 0 writes, and no rank returns before the file is whole,
    so every rank can read it back at once."""
    if mesh is not None and mesh.rank != 0:
        mesh.barrier()
        return
    mt, mti, buf = kmc_stream.get_state()
    payload = {name: getattr(state, name).cpu().numpy() for name in _INT_FIELDS + _F64_FIELDS}
    payload.update(
        kmc_mt_state=mt,
        kmc_mt_pos=np.asarray(mti),
        kmc_buf=buf,
        vt_counter=np.asarray(vt_counter),
        kmc_step_count=np.asarray(kmc_step_count),
        meta=np.frombuffer(json.dumps(extra or {}).encode(), dtype=np.uint8),
    )
    # written beside the target and moved over it, so a run killed while
    # saving leaves the previous checkpoint whole; savez appends ".npz" to a
    # name that lacks it
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **payload)
    os.replace(tmp, path)
    if mesh is not None:
        mesh.barrier()


def load_checkpoint(path: str, device=None) -> Tuple[DeviceState, BufferedStream, int, int, dict]:
    """(state on ``device``, kmc_stream, vt_counter, kmc_step_count, extra).
    ``device`` defaults to the CUDA card, as everywhere in this package."""
    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as d:
        fields = {name: torch.as_tensor(d[name], dtype=torch.int32, device=dev)
                  for name in _INT_FIELDS}
        fields.update({name: torch.as_tensor(d[name], dtype=torch.float64, device=dev)
                       for name in _F64_FIELDS})
        stream = BufferedStream.from_state(d["kmc_mt_state"], int(d["kmc_mt_pos"]), d["kmc_buf"])
        extra = json.loads(bytes(d["meta"]).decode() or "{}")
        return DeviceState(**fields), stream, int(d["vt_counter"]), int(d["kmc_step_count"]), extra
