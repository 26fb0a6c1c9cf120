"""Carry objects of ``akmc_tpu`` across to this package.

Each function takes the JAX package's object, reads its fields as numpy
arrays (``np.asarray`` works on JAX arrays without importing JAX), and
returns this package's counterpart with tensors on ``device``. The tests use
it to feed both packages exactly the same inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from akmc_tpu_torch.config import KMCParameters, Layer
from akmc_tpu_torch.lattice import Lattice
from akmc_tpu_torch.models.vcm import FieldsResult, StaticTables
from akmc_tpu_torch.ops.pairwise import PairTiling
from akmc_tpu_torch.solvers.banded import BandedK, BandMeta, KCarry
from akmc_tpu_torch.solvers.current import CurrentTables, PowerSystem
from akmc_tpu_torch.solvers.dia import make_dia
from akmc_tpu_torch.solvers.heat import LocalHeat
from akmc_tpu_torch.rng import BufferedStream
from akmc_tpu_torch.state import DeviceState


def tensor(a, device="cpu") -> torch.Tensor:
    """numpy view of ``a`` as a tensor; integer index arrays widen to int64
    (PyTorch indexes with int64), int8 and bool keep their type."""
    arr = np.asarray(a)
    if arr.dtype in (np.int16, np.int32, np.uint8):
        arr = arr.astype(np.int64)
    return torch.as_tensor(np.array(arr), device=device)


def params(p) -> KMCParameters:
    out = {f.name: getattr(p, f.name) for f in dataclasses.fields(KMCParameters)}
    out["layers"] = [
        Layer(**{f.name: getattr(l, f.name) for f in dataclasses.fields(Layer)})
        for l in p.layers
    ]
    for name in ("shifts", "lattice", "metals", "V_switch", "t_switch", "alpha"):
        out[name] = list(out[name])
    return KMCParameters(**out)


def lattice(lat) -> Lattice:
    return Lattice(
        element0=np.asarray(lat.element0, np.int32).copy(),
        x=np.asarray(lat.x, np.float64).copy(),
        y=np.asarray(lat.y, np.float64).copy(),
        z=np.asarray(lat.z, np.float64).copy(),
        lattice=np.asarray(lat.lattice, np.float64).copy(),
        pbc=bool(lat.pbc),
        nn_dist=float(lat.nn_dist),
        neigh_idx=np.asarray(lat.neigh_idx).copy(),
        k_neigh_idx=np.asarray(lat.k_neigh_idx).copy(),
        site_layer=np.asarray(lat.site_layer).copy(),
        grid=None if lat.grid is None else tuple(lat.grid),
        cutoff_idx=np.asarray(lat.cutoff_idx).copy(),
    )


def state(s, device="cpu") -> DeviceState:
    def t(a, dtype):
        return torch.as_tensor(np.array(np.asarray(a)), dtype=dtype, device=device)

    return DeviceState(
        element=t(s.element, torch.int32),
        charge=t(s.charge, torch.int32),
        potential_boundary=t(s.potential_boundary, torch.float64),
        potential_charge=t(s.potential_charge, torch.float64),
        power=t(s.power, torch.float64),
        temperature=t(s.temperature, torch.float64),
        cb_edge=t(s.cb_edge, torch.float64),
        T_bg=t(s.T_bg, torch.float64),
        kmc_time=t(s.kmc_time, torch.float64),
    )


def dia(d, meta, device="cpu"):
    """(DiaK, DiaMeta) out of akmc_tpu's DiaK NamedTuple and DiaMeta."""
    dk, dm = make_dia(
        np.asarray(d.diags), np.asarray(d.deg_static), np.asarray(d.lsum),
        np.asarray(d.rsum), np.asarray(d.pos), np.asarray(d.active_row),
        meta.offsets, meta.val_low, meta.val_high,
    )
    return dk.to(torch.device(device)), dm


def banded(bk, meta, device="cpu"):
    """(BandedK, BandMeta) out of akmc_tpu's BandedK NamedTuple and BandMeta."""
    out = BandedK(**{name: tensor(getattr(bk, name), device) for name in bk._fields})
    return out, BandMeta(*meta)


def k_carry(c, device="cpu") -> KCarry:
    """KCarry out of akmc_tpu's (the residual of a previous banded solve)."""
    return KCarry(*(tensor(a, device) for a in c))


def pair_tiling(t, device="cpu") -> PairTiling:
    return PairTiling(*(tensor(a, device) for a in t))


def tables(t, device="cpu") -> StaticTables:
    """StaticTables out of akmc_tpu's (full-f64 pair table storage, or none)."""
    if t.pair_gT is not None and t.pair_gT.full is None:
        raise ValueError("only the full-f64 static pair table carries across")
    return StaticTables(
        pos=tensor(t.pos, device),
        neigh_idx=tensor(t.neigh_idx, device),
        k_neigh_idx=tensor(t.k_neigh_idx, device),
        any_metal_nbr=tensor(t.any_metal_nbr, device),
        metal_edge=tensor(t.metal_edge, device),
        metal_or_edge=tensor(t.metal_or_edge, device),
        E_gen=tensor(t.E_gen, device),
        E_rec=tensor(t.E_rec, device),
        E_Vdiff=tensor(t.E_Vdiff, device),
        E_Odiff=tensor(t.E_Odiff, device),
        act_idx=tensor(t.act_idx, device),
        abs2act=tensor(t.abs2act, device),
        act_neigh=tensor(t.act_neigh, device),
        act_self2=tensor(t.act_self2, device),
        act_layer=tensor(t.act_layer, device),
        act_zero_rows=tensor(t.act_zero_rows, device),
        pair_table=None if t.pair_gT is None else tensor(t.pair_gT.full, device),
        pair_tiling=None if t.pair_tiling is None else pair_tiling(t.pair_tiling, device),
    )


def current_tables(ct, device="cpu") -> CurrentTables:
    """CurrentTables out of akmc_tpu's (the atom tables of the current solver)."""
    return CurrentTables(**{
        name: tensor(getattr(ct, name), device) if name not in ("n_inj", "n_ext")
        else int(getattr(ct, name))
        for name in ct._fields
    })


def power_system(ps, device="cpu") -> PowerSystem:
    """PowerSystem out of akmc_tpu's (one superstep's transmission-system pieces;
    the W blocks keep their type, f32 under ``wkb_f32``)."""
    return PowerSystem(
        G_nbr=tensor(ps.G_nbr, device), vac_idx=tensor(ps.vac_idx, device),
        W_tt=tensor(ps.W_tt, device), W_ct=tensor(ps.W_ct, device),
        W_cc=tensor(ps.W_cc, device), diag=tensor(ps.diag, device),
        diag0=float(ps.diag0), diag1=float(ps.diag1),
    )


def local_heat(lh, device="cpu") -> LocalHeat:
    """LocalHeat out of akmc_tpu's (the local heat model's static tables)."""
    return LocalHeat(if_mask=tensor(lh.if_mask, device), neigh_idx=tensor(lh.neigh_idx, device),
                     deg=tensor(lh.deg, device), n_if=int(lh.n_if))


def fields(fr, device="cpu") -> FieldsResult:
    """A frozen fields state (charges, potentials, the rate table, event types,
    the log rate scale and, after a carried-residual solve, the K solve's
    carry) out of akmc_tpu's FieldsResult."""
    def flag(a):
        return torch.as_tensor(False if a is None else bool(a), device=device)

    return FieldsResult(
        charge=torch.as_tensor(np.array(fr.charge), dtype=torch.int32, device=device),
        potential_boundary=tensor(fr.potential_boundary, device),
        potential_sum=tensor(fr.potential_sum, device),
        P=tensor(fr.P, device),
        etype=torch.as_tensor(np.array(fr.etype), dtype=torch.int32, device=device),
        cg_iterations=int(fr.cg_iterations),
        q_overflow=flag(fr.q_overflow),
        v_overflow=flag(fr.v_overflow),
        ln_S=None if fr.ln_S is None else tensor(fr.ln_S, device),
        c_overflow=flag(fr.c_overflow),
        k_carry=None if fr.k_carry is None else k_carry(fr.k_carry, device),
    )


def stream(s) -> BufferedStream:
    """akmc_tpu's BufferedStream at its current position: the twister's state
    words, its index, and the draws generated but not yet consumed (the three
    pieces a checkpoint stores)."""
    mt = s._rng._mt
    return BufferedStream.from_state(np.asarray(mt.mt), int(mt.mti), np.asarray(s._buf))
