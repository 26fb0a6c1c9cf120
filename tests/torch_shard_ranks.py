"""Rank functions of the sharding tests (``tests/test_torch_sharding.py``).

They run in processes that ``akmc_tpu_torch/parallel/launch.py::spawn``
starts, so this module imports no JAX and nothing of ``akmc_tpu``. Each
function also runs with ``mesh=None``: the one-device run it is held to.
"""

from __future__ import annotations

import numpy as np
import torch

from akmc_tpu_torch.models.crossbar import build_grid_crossbar, toy_device
from akmc_tpu_torch.models.vcm import VCMModel
from akmc_tpu_torch.ops.events import GeneratorDraws
from akmc_tpu_torch.parallel.mesh import (
    ConcernGroups,
    check_replicas,
    pad_lattice,
    replicate_state,
    shard_model,
    state_checksum,
)
from akmc_tpu_torch.rng import BufferedStream, ReferenceRNG
from akmc_tpu_torch.state import make_device_state

PAD = 8       # akmc_tpu's tests pad the toy to a multiple of their 8 devices


def structure(kind: str):
    """(params, lattice) of a test structure: the toy device padded as
    ``tests/test_sharding.py::_padded_toy`` pads it, or the small grid-native
    crossbar of ``tests/test_torch_superstep.py``."""
    if kind == "crossbar":
        return build_grid_crossbar(
            n_yz=6, contact_slices=2, oxide_slices=6, ti_slices=2,
            defect_fraction=0.3, vacancy_concentration=0.1, seed=3,
        )
    p, lat = toy_device(nx=12, ny=4, nz=4)
    lat, _ = pad_lattice(lat, PAD, pad_layer=len(p.layers) - 1)
    return p, lat


FULL = dict(solve_current=True, solve_heating_global=True, dissipation_constant=1e-13,
            t_ox=5e-9, A=(12 * 2.0e-10) ** 2, c_p=1.92)


def _model(mesh, kind, model_kw, params_kw):
    p, lat = structure(kind)
    if params_kw:
        p = p.replace(**params_kw)
    dev = "cpu" if mesh is None else mesh.device
    model = VCMModel(p, lat, device=dev, **model_kw)
    state = make_device_state(lat, p.background_temp, model.device)
    if mesh is not None:
        shard_model(model, mesh)
        state = replicate_state(state, mesh)
    return p, model, state


def _out(state, rows, model, extra=None):
    return {
        "rows": rows,
        "element": state.element.cpu().numpy(),
        "charge": state.charge.cpu().numpy(),
        "potential_boundary": state.potential_boundary.cpu().numpy(),
        "potential_charge": state.potential_charge.cpu().numpy(),
        "power": state.power.cpu().numpy(),
        "T_bg": float(state.T_bg),
        "kmc_time": float(state.kmc_time),
        "checksum": state_checksum(state).cpu().numpy(),
        "describe": model.describe(),
        **(extra or {}),
    }


def supersteps(mesh, kind="toy", mode="superstep", steps=3, Vd=2.0, model_kw=None,
               params_kw=None):
    """``steps`` supersteps of one kind on ``kind``'s structure: rank 0's
    state, per-step stats and the model's description. Every rank's state is
    checked against rank 0's after every superstep."""
    model_kw = dict(model_kw or {})
    if mode == "full":
        params_kw = {**FULL, **(params_kw or {})}
        model_kw.setdefault("vmax", 64)
        model_kw.setdefault("ne_max", 256)
    p, model, state = _model(mesh, kind, model_kw, params_kw)
    stream = BufferedStream(ReferenceRNG(1))
    draws = GeneratorDraws.seeded(5, model.device)
    rows = []
    if mode == "full":
        state = model.update_cb_edge(state, Vd)
    m = None
    pb_prev2 = None
    if mode == "multi":
        state, stats_list = model.superstep_multi(state, Vd, stream, k=steps, rand_chunk=512)
        rows = [dict(s) for s in stats_list]
        check_replicas(state, mesh)
    for _ in range(steps if mode != "multi" else 0):
        if mode == "superstep":
            state, stats = model.superstep(state, Vd, stream)
        elif mode == "full":
            state, stats, m = model.superstep_full(state, Vd, stream, m_prev=m)
        elif mode == "native":
            state, stats = model.superstep_native(state, Vd, draws)
        elif mode == "batched":
            pb = state.potential_boundary
            state, stats = model.superstep_native_batched(
                state, Vd, draws, batch=16, pb_prev2=pb_prev2, k_extrap=1.0)
            pb_prev2 = pb
        elif mode == "fields_only":
            state, stats = model.fields_only(state, Vd)
        elif mode == "events_only":
            state, stats = model.superstep_events_only(state, stream)
        else:
            raise ValueError(mode)
        rows.append({k: (v if not torch.is_tensor(v) else float(v)) for k, v in stats.items()})
        check_replicas(state, mesh)
    return _out(state, rows, model, {"k_solves": model.k_solves})


def concern_fields(mesh, kind="toy", ratio=(1, 3), steps=3, Vd=2.0):
    """The split fields of the first state, then ``steps`` supersteps through
    ``ConcernGroups``; with ``mesh=None`` the sequential ``_fields`` and
    ``superstep_events_only`` after each one's fields."""
    p, lat = structure(kind)
    dev = "cpu" if mesh is None else mesh.device
    model = VCMModel(p, lat, device=dev)
    state = make_device_state(lat, p.background_temp, model.device)
    stream = BufferedStream(ReferenceRNG(1))
    if mesh is None:
        fr = model._fields_grown(state, Vd)
        first = (fr.charge, fr.potential_boundary, fr.potential_sum, fr.cg_iterations)
        rows = []
        for _ in range(steps):
            fr = model._fields_grown(state, Vd)
            mid = state.replace(charge=fr.charge, potential_boundary=fr.potential_boundary,
                                potential_charge=fr.potential_sum)
            state, stats = model.superstep_events_only(mid, stream)
            stats["cg_iterations"] = fr.cg_iterations
            rows.append(stats)
        groups = None
    else:
        state = replicate_state(state, mesh)
        groups = ConcernGroups(model, mesh, ratio=ratio)
        f = groups.fields(state.element, state.charge, state.potential_boundary, state.T_bg, Vd)
        first = (f[0], f[1], f[2], f[3])
        rows = []
        for _ in range(steps):
            state, stats = groups.superstep(state, Vd, stream)
            rows.append(stats)
            check_replicas(state, mesh)
    extra = {
        "first_charge": first[0].cpu().numpy(),
        "first_pot_b": first[1].cpu().numpy(),
        "first_pot_sum": first[2].cpu().numpy(),
        "first_cg": int(first[3]),
    }
    if groups is not None:
        extra["groups"] = (groups.mesh_k.ranks, groups.mesh_pair.ranks)
    return _out(state, [{k: float(v) for k, v in r.items()} for r in rows], model, extra)


def table_bytes(mesh, kind="toy", model_kw=None, params_kw=None):
    """Bytes this rank holds of each sharded table, and of the W blocks of
    one power system on the first state."""
    params_kw = {**FULL, **(params_kw or {})}
    model_kw = {"vmax": 64, "ne_max": 256, **(model_kw or {})}
    p, model, state = _model(mesh, kind, model_kw, params_kw)
    state = model.update_cb_edge(state, 2.0)
    model.update_power(state, 2.0)
    return model.held_bytes()


def divergence(mesh):
    """``check_replicas`` on a state that rank 1 (alone) changed in one bit:
    whether every rank raised."""
    p, model, state = _model(mesh, "toy", {}, None)
    check_replicas(state, mesh)              # equal: no raise
    if mesh.rank == 1:
        state = state.replace(kmc_time=state.kmc_time + 1e-300)
    try:
        check_replicas(state, mesh)
    except RuntimeError as e:
        return "ranks [1]" in str(e)
    return False


SCENARIOS = {
    # test_sharding.py's cases, on the toy device padded to 8 sites
    "superstep": (supersteps, dict(kind="toy", mode="superstep")),
    "full": (supersteps, dict(kind="toy", mode="full", steps=2)),
    "multi": (supersteps, dict(kind="toy", mode="multi", steps=2)),
    "concern": (concern_fields, dict(kind="toy", ratio=(1, 3))),
    "tiled": (supersteps, dict(kind="toy", mode="superstep",
                               model_kw={"pair_table_budget": 0, "pair_tiling_min_n": 1})),
    "bytes": (table_bytes, dict(kind="toy")),
    # the DIA crossbar, every other operator and pairwise path, the other loops
    "crossbar": (supersteps, dict(kind="crossbar", mode="superstep")),
    "banded": (supersteps, dict(kind="toy", mode="superstep", model_kw={"use_dia_k": False})),
    "ell": (supersteps, dict(kind="toy", mode="superstep",
                             model_kw={"use_dia_k": False, "use_banded_k": False})),
    "banded_carry": (supersteps, dict(kind="crossbar", mode="multi", steps=3, model_kw={
        "use_dia_k": False, "k_carry_residual": True})),
    "on_the_fly": (supersteps, dict(kind="toy", mode="superstep",
                                    model_kw={"pair_table_budget": 0})),
    "native": (supersteps, dict(kind="toy", mode="native")),
    "batched": (supersteps, dict(kind="crossbar", mode="batched")),
    "fields_only": (supersteps, dict(kind="toy", mode="fields_only", steps=2)),
    "events_only": (supersteps, dict(kind="toy", mode="events_only", steps=2)),
    "full_crossbar": (supersteps, dict(kind="crossbar", mode="full", steps=2)),
}


def scenarios(mesh, names):
    """Every named scenario on this rank, in order: {name: (result, this
    rank's state checksum or None)}; rank 0 keeps the results, the other
    ranks only their checksums."""
    out = {}
    for name in names:
        if name == "divergence":
            out[name] = divergence(mesh)
            continue
        fn, kw = SCENARIOS[name]
        res = fn(mesh, **kw)
        out[name] = res if mesh.rank == 0 or name == "bytes" else {
            "checksum": res.get("checksum")}
    return out
