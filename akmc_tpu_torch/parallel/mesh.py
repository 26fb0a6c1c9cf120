"""The rank's view of a sharded run, the sharding rules of the model's
tables, and the deterministic collectives of the sharded solves.

The layout is ``akmc_tpu/parallel/mesh.py``'s, one process per rank:

* O(N) field vectors (element, charge, potentials) are REPLICATED: every rank
  holds all of them and computes the same values from them;
* the large tables are ROW-SHARDED: each rank keeps only its rows of the
  pairwise table (over its site columns), of the tiled planes (over tiles,
  when the tile count divides the ranks), of the band blocks, of the DIA
  codes, of the rate table's static columns and of the interface rows of
  the ELL and CB-edge operators, and drops the rest (``shard_model``);
* a sharded solve computes its rows and gathers them (``Mesh.gather_rows``);
  a dot product gathers per-rank partial sums and every rank adds them in
  rank order (``Mesh.sum_partials``), so all ranks hold the same bits;
* the event loop is serial and replicated-redundant: every rank runs it on
  the same gathered rate table and the same uniforms, as every rank of the
  reference applies the broadcast event (kmc_events.cu:494-504).

Collectives. Under NCCL, and under gloo on CPU tensors, they run on the
tensors as they are. Under gloo on CUDA tensors (several ranks sharing one
card, which NCCL refuses) they are staged through host buffers: gloo's
support for CUDA tensors is narrower than NCCL's.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

Range = Tuple[int, int]


class Mesh:
    """One rank of a group: ``rank``, ``size``, the process ``group`` (None:
    the default group), the ``device`` it computes on, and ``ranks``, the
    global ranks of the group in order."""

    def __init__(self, rank: int, size: int, device, backend: str, group=None,
                 ranks: Optional[Sequence[int]] = None):
        self.rank, self.size = int(rank), int(size)
        self.device = torch.device(device)
        self.backend = backend
        self.group = group
        self.ranks = list(range(size)) if ranks is None else list(ranks)
        self.staged = backend == "gloo" and self.device.type == "cuda"

    # ---------------------------------------------------------------- layout
    def split(self, n: int, unit: int = 1) -> List[Range]:
        """[start, stop) of each rank over ``n`` rows cut in whole units of
        ``unit`` rows, as evenly as the units allow; the last rank's range
        takes the ragged end."""
        units = -(-n // unit)
        cuts = [min(n, (r * units // self.size) * unit) for r in range(self.size + 1)]
        cuts[-1] = n
        return [(cuts[r], cuts[r + 1]) for r in range(self.size)]

    def rows(self, n: int, unit: int = 1) -> Range:
        return self.split(n, unit)[self.rank]

    # ----------------------------------------------------------- collectives
    def _gather_equal(self, t: torch.Tensor, to_host: bool = False) -> List[torch.Tensor]:
        """all_gather of equally shaped tensors, in rank order, on ``t``'s
        device (bool travels as uint8); ``to_host`` with staging: left on the
        host where the exchange put them."""
        dtype = t.dtype
        src = t.to(torch.uint8) if dtype == torch.bool else t
        src = src.contiguous()
        if self.staged:
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        if self.staged and not to_host:
            parts = [p.to(t.device) for p in parts]
        if dtype == torch.bool:
            parts = [p.to(torch.bool) for p in parts]
        return parts

    def gather_rows(self, local: torch.Tensor, ranges: Sequence[Range]) -> torch.Tensor:
        """The row-sharded tensor whole on every rank: ``local`` holds this
        rank's rows ``ranges[rank]``; uneven ranges travel padded to the
        largest and are cut back."""
        if self.size == 1:
            return local
        width = max(b - a for a, b in ranges)
        pad = width - local.shape[0]
        if pad:
            local = torch.cat([local, local.new_zeros((pad, *local.shape[1:]))])
        parts = self._gather_equal(local)
        return torch.cat([p[: b - a] for p, (a, b) in zip(parts, ranges)])

    def gather_flat(self, pieces) -> List[torch.Tensor]:
        """Several row-sharded 1-D tensors whole in ONE all-gather: each piece
        is (this rank's rows, every rank's ranges, the device to return it
        on). Under staging a piece bound for the CPU never goes back to the
        card, so scalars read from it cost no device read of their own."""
        widths = [max(b - a for a, b in rr) for _, rr, _ in pieces]
        local = torch.cat([torch.nn.functional.pad(t, (0, w - t.shape[0]))
                           for (t, _, _), w in zip(pieces, widths)])
        parts = self._gather_equal(local, to_host=self.staged)
        out, off = [], 0
        for (_, rr, dev), w in zip(pieces, widths):
            whole = torch.cat([p[off: off + (b - a)] for p, (a, b) in zip(parts, rr)])
            out.append(whole.to(dev))
            off += w
        return out

    def gather_partials(self, local: torch.Tensor) -> torch.Tensor:
        """(size, *local.shape): every rank's ``local``, in rank order."""
        return torch.stack(self._gather_equal(local))

    def sum_partials(self, local: torch.Tensor) -> torch.Tensor:
        """Sum over ranks of ``local``, added in rank order on every rank, so
        that all ranks hold the same bits."""
        parts = self._gather_equal(local)
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        return acc

    def any(self, flag) -> bool:
        """Whether ``flag`` is set on any rank (the same answer everywhere)."""
        t = torch.as_tensor(bool(flag), device=self.device).reshape(1)
        return bool(self.gather_partials(t).any())

    def min(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise minimum over ranks (exact, so order-free)."""
        return torch.amin(self.gather_partials(t), dim=0)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``t`` as global rank ``src`` holds it, on every rank of the group
        (``t`` gives the shape and type elsewhere)."""
        dtype = t.dtype
        buf = (t.to(torch.uint8) if dtype == torch.bool else t).contiguous()
        if self.staged:
            buf = buf.cpu()
        else:
            buf = buf.clone()
        dist.broadcast(buf, src=src, group=self.group)
        buf = buf.to(t.device)
        return buf.to(torch.bool) if dtype == torch.bool else buf

    def barrier(self) -> None:
        dist.barrier(group=self.group)


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """This process's rank of the default group, as a ``Mesh`` on the
    device ``parallel/launch.py`` gave the rank. Raises when the group is
    smaller than ``n_devices``."""
    from akmc_tpu_torch.parallel import launch

    size = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is not None and size < n_devices:
        raise ValueError(
            f"mesh needs {n_devices} ranks, only {size} in the process group "
            "(on the CPU start them as gloo ranks: parallel/launch.py::spawn(fn, "
            f"{n_devices}, 'cpu', 'gloo'))"
        )
    if not dist.is_initialized():
        raise ValueError("make_mesh needs an initialized process group (parallel/launch.py)")
    return Mesh(dist.get_rank(), size, launch.current_device, dist.get_backend())


def pad_lattice(lat, multiple: int, pad_element: Optional[int] = None,
                pad_layer: Optional[int] = None):
    """Pad the site axis with far-away, isolated, inert sites so rows shard
    evenly over ``multiple`` ranks: ``akmc_tpu``'s padding, site for site.
    Returns ``(lat_padded, n_real)``.

    Pad sites are metal (default Ti): outside the active event species (zero
    rates for ever), never charged (no neighbors), absent from every
    adjacency table (all -1 rows) and placed ~1e6 Angstrom away. Padding
    breaks the grid-native slot enumeration, so ``grid`` is dropped."""
    from akmc_tpu_torch.lattice import ELEM, Lattice

    n = lat.N
    pad = (-n) % multiple
    if pad == 0:
        return lat, n
    if pad_element is None:
        pad_element = int(ELEM.Ti)
    if pad_layer is None:
        pad_layer = int(np.max(lat.site_layer))
    far = 1e6 + np.arange(pad) * 1e3

    def rows(a):
        return np.concatenate([a, np.full((pad, a.shape[1]), -1, a.dtype)])

    cutoff = lat.cutoff_idx
    lat2 = Lattice(
        element0=np.concatenate([lat.element0, np.full(pad, pad_element, lat.element0.dtype)]),
        x=np.concatenate([lat.x, far]),
        y=np.concatenate([lat.y, np.zeros(pad)]),
        z=np.concatenate([lat.z, np.zeros(pad)]),
        lattice=lat.lattice,
        pbc=lat.pbc,
        nn_dist=lat.nn_dist,
        neigh_idx=rows(lat.neigh_idx),
        k_neigh_idx=rows(lat.k_neigh_idx),
        site_layer=np.concatenate([lat.site_layer, np.full(pad, pad_layer, lat.site_layer.dtype)]),
        grid=None,
        cutoff_idx=None if cutoff is None else rows(cutoff),
    )
    return lat2, n


def shard_model(model, mesh: Mesh):
    """Keep on this rank only its rows of the model's large tables (in
    place), and route the model's solves through the sharded forms. A mesh
    of one rank leaves the model as it is.

    Which tables shard, and over what (``akmc_tpu``'s rules, ``_ROW_SHARDED``
    and ``shard_model`` there):
      * the static pairwise table over its site columns;
      * the tiled-pairwise tables over tiles when the tile count divides the
        ranks, else replicated;
      * the DIA codes over whole 256-row chunks (the last rank takes the
        ragged end), each rank's slab an array of its own;
      * the banded K blocks and the power band's blocks over the block axis;
      * the rate table's static columns (``act_self2``, ``act_layer``) over
        its rows; the event loop's tables stay whole, as the loop runs on
        every rank;
      * the K adjacency (``k_neigh_idx``, ``metal_edge``, ``metal_or_edge``)
        over the interface rows of the ELL and CB-edge solves.
    The W blocks of the power system shard over their rows when they are
    built (``VCMModel._shard_power_system``)."""
    if mesh is None or mesh.size == 1:
        model.mesh = None
        return model
    from akmc_tpu_torch.solvers.dia import DiaK
    from akmc_tpu_torch.solvers.dia_cg import CHUNK

    t = model.tables
    n = model.lat.N
    shards = {}
    na = t.act_idx.shape[0]
    shards["act"] = ar = mesh.split(na)
    a0, a1 = ar[mesh.rank]
    model.act_local = (t.act_idx[a0:a1].clone(), t.act_neigh[a0:a1].clone())
    t.act_self2 = t.act_self2[a0:a1].clone()
    t.act_layer = t.act_layer[a0:a1].clone()

    L = model.params.num_atoms_first_layer
    shards["int"] = ir = mesh.split(n - 2 * L)
    i0, i1 = ir[mesh.rank]
    for name in ("k_neigh_idx", "metal_edge", "metal_or_edge"):
        setattr(t, name, getattr(t, name)[L + i0 : L + i1].clone())

    shards["sites"] = sr = mesh.split(n)
    if t.pair_table is not None:
        c0, c1 = sr[mesh.rank]
        t.pair_table = t.pair_table[:, c0:c1].clone()
    if t.pair_tiling is not None:
        nt = t.pair_tiling.tile_sites.shape[0]
        if nt % mesh.size == 0:
            shards["tiles"] = tr = mesh.split(nt)
            s0, s1 = tr[mesh.rank]
            t.pair_tiling = type(t.pair_tiling)(*(a[s0:s1].clone() for a in t.pair_tiling))

    if model.dia is not None:
        shards["dia"] = dr = mesh.split(n, CHUNK)
        r0, r1 = dr[mesh.rank]
        d = model.dia
        model.dia = DiaK(
            diags=d.diags[:, r0:r1].clone(), offsets=d.offsets,
            deg_static=d.deg_static[r0:r1].clone(), lsum=d.lsum[r0:r1].clone(),
            rsum=d.rsum[r0:r1].clone(), pos=d.pos, active_row=d.active_row[r0:r1].clone(),
        )
    if model.banded is not None:
        model.banded, shards["band"] = _shard_band(model.banded, mesh)
    model.shards = shards
    model.mesh = mesh
    return model


def _shard_band(bk, mesh: Mesh):
    """A ``BandedK`` holding this rank's blocks only, and every rank's block
    range."""
    from akmc_tpu_torch.solvers.banded import BandedK

    br = mesh.split(bk.blocks.shape[0])
    b0, b1 = br[mesh.rank]
    parts = {name: getattr(bk, name) for name in bk.__dataclass_fields__}
    parts["blocks"] = bk.blocks[b0:b1].clone()
    return BandedK(**parts), br


def replicate_state(state, mesh: Mesh):
    """``state`` on the rank's device, every field as rank 0 holds it."""
    if mesh is None or mesh.size == 1:
        return state
    fields = {name: mesh.broadcast(getattr(state, name).to(mesh.device), src=mesh.ranks[0])
              for name in state.__dataclass_fields__}
    return type(state)(**fields)


_STATE_FIELDS = ("element", "charge", "potential_boundary", "potential_charge", "power",
                 "temperature", "cb_edge", "T_bg", "kmc_time")


def state_checksum(state) -> torch.Tensor:
    """(fields,) int64: per field of ``state`` a sum of its bit patterns
    weighted by position (integer arithmetic, so exact and order-free). Two
    states with equal checksums are, for any practical purpose, equal to the
    bit."""
    out = []
    for name in _STATE_FIELDS:
        t = getattr(state, name).reshape(-1)
        bits = t.view(torch.int64) if t.dtype == torch.float64 else t.to(torch.int64)
        w = torch.arange(1, bits.shape[0] + 1, dtype=torch.int64, device=bits.device)
        out.append(torch.sum(bits * (2 * w + 1)))
    return torch.stack(out)


def check_replicas(state, mesh: Mesh) -> None:
    """Raise unless every rank's ``state`` equals rank 0's (checksums
    gathered on every rank): the event loop runs on every rank, and a
    rank whose loop went another way must stop the run."""
    if mesh is None or mesh.size == 1:
        return
    sums = mesh.gather_partials(state_checksum(state)).cpu()
    bad = [r for r in range(mesh.size) if not torch.equal(sums[r], sums[0])]
    if bad:
        fields = [_STATE_FIELDS[i] for i in range(len(_STATE_FIELDS))
                  if any(sums[r][i] != sums[0][i] for r in bad)]
        raise RuntimeError(f"ranks {bad} hold another state than rank 0 (fields {fields})")


# ----------------------------------------------------------------------
# Concern groups (the reference's split=true, KMC_comm.h:132-223): the K
# solve and the pairwise solve on two disjoint groups of ranks at the same
# time; the potentials are combined on every rank, and the event step runs
# on every rank.
# ----------------------------------------------------------------------
def split_concern_groups(mesh: Mesh, ratio=(1, 3)) -> Tuple[Mesh, Mesh]:
    """(K group, pair group): the first ranks of ``mesh`` in proportion
    ``ratio`` (reference default {8, 24}, kmc_main.cpp:163) and the rest,
    each at least one rank. Every rank of ``mesh`` must call it (it creates
    the groups); a rank outside a group gets that group's ``Mesh`` with
    ``rank`` -1."""
    if mesh.size < 2:
        raise ValueError("concern-group splitting needs >= 2 devices")
    nk = min(mesh.size - 1, max(1, (mesh.size * ratio[0]) // sum(ratio)))
    members = (mesh.ranks[:nk], mesh.ranks[nk:])
    out = []
    for ranks in members:
        group = dist.new_group(ranks)
        me = mesh.ranks[mesh.rank]
        out.append(Mesh(ranks.index(me) if me in ranks else -1, len(ranks), mesh.device,
                        mesh.backend, group=group, ranks=ranks))
    return out[0], out[1]


class ConcernGroups:
    """The fields of a superstep split over two rank groups: the K group
    updates the charges and solves the K system, the pair group updates the
    charges and computes the pairwise potential, both at once on their own
    ranks. Each group computes the unsharded function on each of its ranks,
    so the result is the sequential ``_fields``'s to the bit. Then every rank
    receives the boundary potential from the K group's first rank and the
    pairwise potential and the cap flags from the pair group's first rank,
    adds them, and runs the event step.

    ``model`` must be unsharded (``model.mesh`` None); each rank drops the
    tables its group does not use."""

    def __init__(self, model, mesh: Mesh, ratio=(1, 3)):
        if model.mesh is not None:
            raise ValueError("concern groups take an unsharded model")
        self.model, self.mesh = model, mesh
        self.mesh_k, self.mesh_pair = split_concern_groups(mesh, ratio)
        self.in_k = self.mesh_k.rank >= 0
        if self.in_k:
            model.tables.pair_table = None      # the pair group's
            model.tables.pair_tiling = None
        else:
            model.dia = model.banded = None     # the K group's

    def fields(self, element, charge, pb_prev, T_bg, Vd):
        """(charge, pot_b, pot_sum, cg_iters, q_ovf, c_ovf, v_ovf) on every
        rank, as ``akmc_tpu``'s ``ConcernGroups.fields`` returns them."""
        from akmc_tpu_torch.lattice import ELEM
        from akmc_tpu_torch.ops.charge import update_charge_compact

        model, t = self.model, self.model.tables
        dev = element.device
        v_ovf = torch.sum(element == int(ELEM.VACANCY)) > model.vmax
        charge = update_charge_compact(element, charge, t.neigh_idx, t.any_metal_nbr, model.vmax)
        pot_b = torch.zeros_like(pb_prev)
        pot_pair = torch.zeros_like(pb_prev)
        iters = torch.zeros(1, dtype=torch.int64, device=dev)
        flags = torch.zeros(3, dtype=torch.bool, device=dev)
        if self.in_k:
            pot_b, cg = model._solve_boundary(element, charge, pb_prev, Vd)
            iters = torch.tensor([int(cg.iterations)], dtype=torch.int64, device=dev)
        else:
            pot_pair, q_ovf, c_ovf = model._pairwise(charge)
            flags = torch.stack([q_ovf, c_ovf, v_ovf]).reshape(3)
        k0, p0 = self.mesh_k.ranks[0], self.mesh_pair.ranks[0]
        pot_b = self.mesh.broadcast(pot_b, src=k0)
        iters = self.mesh.broadcast(iters, src=k0)
        pot_pair = self.mesh.broadcast(pot_pair, src=p0)
        flags = self.mesh.broadcast(flags, src=p0)
        pot_sum = pot_pair + pot_b               # sum_AB_into_A (psg.cu:1130-1151)
        return charge, pot_b, pot_sum, int(iters[0]), flags[0], flags[1], flags[2]

    def superstep(self, state, Vd: float, stream, rand_chunk: int = 8192):
        """One superstep with the fields split over the groups, then the
        event step on every rank (``VCMModel.superstep_events_only``). A cap
        that overflowed grows on every rank and the fields run again."""
        model = self.model
        while True:
            charge, pot_b, pot_sum, cg_iters, q_ovf, c_ovf, v_ovf = self.fields(
                state.element, state.charge, state.potential_boundary, state.T_bg, Vd)
            if not model._grow(*torch.stack([q_ovf, v_ovf, c_ovf]).tolist()):
                break
        mid = state.replace(charge=charge, potential_boundary=pot_b, potential_charge=pot_sum)
        new_state, stats = model.superstep_events_only(mid, stream, rand_chunk)
        stats["cg_iterations"] = cg_iters
        return new_state, stats
