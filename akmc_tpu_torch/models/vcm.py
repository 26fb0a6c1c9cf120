"""The valence-change-memory (VCM) device model on PyTorch.

One KMC superstep (reference module sequence, kmc_main.cpp:328-540):

    charge update -> K-system CG boundary potential -> pairwise Coulomb
    potential -> potential sum -> rate table -> residence-time event loop

The K solve runs through whichever operator the structure supports: DIA
(grid-native structures; the whole CG as one CUDA kernel), banded dense
blocks (narrow-band disordered structures like the 5 nm device), or the
matrix-free ELL gather. The pairwise potential comes from the static table
when it fits ``pair_table_budget``, else from the tiled plane (large
structures), else from the on-the-fly plane.

``VCMModel`` owns the static tables as tensors on its device;
``DeviceState`` carries the dynamic fields. ``superstep`` is the
committed-parity path of ``akmc_tpu/models/vcm.py::VCMModel.superstep``; it and
``superstep_multi`` run as one program per dispatch
(``models/step_program.py``: on a card one CUDA graph, its loops conditional
while nodes, one host read), as ``akmc_tpu`` runs them as one executable;
``superstep_native`` and ``superstep_native_batched`` are the production
paths, which draw their own uniforms and, batched, fire many events per loop
iteration; on ``akmc_tpu``'s threefry key (``ops/threefry.py::KeyDraws``)
each runs as one program too (``ProductionProgram``), drawing inside it.
``superstep_full`` is the full-physics superstep (``--full-physics``):
the fields, then the current and dissipated power on this superstep's charge,
then the events, then the heat model over their time; ``update_cb_edge`` solves
the conduction-band edge once per bias point. The deck modes (``fields_only``,
``superstep_events_only``) and ``update_cb_edge`` run as one program a call
too, as ``akmc_tpu`` runs ``_fields_jit``, ``_events_only_jit`` and ``_cb_jit``.

``VCMModel.spans`` (default False) turns on the spans of every dispatch
(``runtime/profiling.py``): device stamps at the module boundaries inside the
programs (``superstep``; ``charge``, ``k_solve``, ``pairwise``, ``rates`` in
``_fields``; ``key_split``; ``event_loop`` around each loop's while node;
``batch.race`` and ``batch.resolve`` in each batch; ``wkb_build``,
``power_solve`` and ``heat`` under full physics, ``cb_edge`` around the CB
edge's solve) and the host phases of a dispatch (``load``, ``launch``,
``read``, ``unpack``), kept in ``last_spans``. Switching it captures the
programs again: it is part of every program's key. Off, nothing is stamped
and the programs are the same graphs as without spans.
"""

from __future__ import annotations

import contextlib
import gc
import math
import time
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from scipy.special import erfc

from akmc_tpu_torch.config import KMCParameters
from akmc_tpu_torch.device import resolve_device
from akmc_tpu_torch.lattice import ELEM, Lattice, metal_mask
from akmc_tpu_torch.models.step_program import (
    CbEdgeProgram,
    EventsOnlyProgram,
    FieldsProgram,
    FullProgram,
    ProductionProgram,
    SuperstepProgram,
)
from akmc_tpu_torch.ops import device_loop
from akmc_tpu_torch.ops import events as events_mod
from akmc_tpu_torch.ops.charge import update_charge_compact
from akmc_tpu_torch.ops.device_loop import LoopGraphs
from akmc_tpu_torch.ops.events import (
    _BLK,
    build_event_table,
    run_event_loop,
    run_event_loop_batched,
    run_event_loop_native,
)
from akmc_tpu_torch.ops.pairwise import (
    PairTiling,
    build_pair_table,
    build_pair_tiling,
    pairwise_potential,
    pairwise_potential_table,
    pairwise_potential_tiled,
)
from akmc_tpu_torch.ops.threefry import KeyDraws
from akmc_tpu_torch.runtime import profiling
from akmc_tpu_torch.solvers import cg as cg_mod
from akmc_tpu_torch.solvers.banded import (
    BandedK,
    BandMeta,
    KCarry,
    build_banded_k,
    solve_potential_boundary_banded,
    solve_potential_boundary_banded_carry,
)
from akmc_tpu_torch.solvers.cg import COUNT_KEYS
from akmc_tpu_torch.solvers.current import (
    CurrentTables,
    PowerShard,
    build_current_tables,
    build_power_band,
    build_power_system,
    solve_power,
)
from akmc_tpu_torch.solvers.dia import (
    DiaK,
    build_dia_k,
    solve_potential_boundary_dia,
    solve_potential_boundary_dia_sharded,
)
from akmc_tpu_torch.solvers.heat import (
    LocalHeat,
    build_local_heat,
    update_temperature_global,
    update_temperature_local_ref,
    update_temperature_local_steady,
)
from akmc_tpu_torch.solvers.poisson import solve_cb_edge, solve_potential_boundary
from akmc_tpu_torch.state import DeviceState

_ACTIVE = (ELEM.DEFECT, ELEM.O, ELEM.VACANCY, ELEM.OXYGEN_DEFECT)
RAND_CHUNK = 8192    # mt19937 draws per serial loop call of a superstep


@dataclass
class StaticTables:
    """Static per-structure tensors on the model's device."""

    pos: torch.Tensor            # (N, 3) f64
    neigh_idx: torch.Tensor      # (N, NN) int64, -1 padded
    k_neigh_idx: torch.Tensor    # (N, NN) int64 PBC-aware K adjacency, -1 padded
    any_metal_nbr: torch.Tensor  # (N,) bool
    metal_edge: torch.Tensor     # (N, NN) bool: metal_i & metal_j on k_neigh_idx
    metal_or_edge: torch.Tensor  # (N, NN) bool: metal_i | metal_j on k_neigh_idx (CB edge)
    E_gen: torch.Tensor          # (num_layers,) f64 [eV]
    E_rec: torch.Tensor
    E_Vdiff: torch.Tensor
    E_Odiff: torch.Tensor
    # event tables compacted to the statically event-capable rows (element
    # in {DEFECT, O, V, Od}), padded to a multiple of 256 rows with
    # all-zero-rate pad rows, and to the active neighbor columns
    act_idx: torch.Tensor        # (NA,) int64 absolute site per row, -1 padded
    abs2act: torch.Tensor        # (N,) int64 site -> row; inactive -> last pad row
    act_neigh: torch.Tensor      # (NA, NN') int64 absolute neighbor ids
    act_self2: torch.Tensor      # (NA, NN') f64 v_solve(d, 2)
    act_layer: torch.Tensor      # (NA, NN') int64 neighbor layer id
    act_zero_rows: torch.Tensor  # (NA, 1+NN') int64 {r} ∪ abs2act[neigh[r]]
    # static (NP_pad, N) f64 pairwise table: present when NP*N*8 fits
    # pair_table_budget; None => tiled or on-the-fly path
    pair_table: Optional[torch.Tensor] = None
    # spatial tiling for structures too large for the table
    pair_tiling: Optional[PairTiling] = None


class FieldsResult(NamedTuple):
    charge: torch.Tensor
    potential_boundary: torch.Tensor
    potential_sum: torch.Tensor     # pairwise + boundary (site_potential_charge)
    P: torch.Tensor                 # (NA, NN') event rates
    etype: torch.Tensor             # (NA, NN') event types
    cg_iterations: int
    q_overflow: torch.Tensor        # charged count exceeded qmax
    v_overflow: torch.Tensor        # vacancy count exceeded vmax
    ln_S: Optional[torch.Tensor]    # log rate scale (rate_normalize mode)
    c_overflow: torch.Tensor        # tiled pairwise: per-tile candidate cap exceeded
    k_carry: Optional[KCarry] = None  # the banded solve's carry (``k_carry_residual``)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class VCMModel:
    """Static data + physics for one device structure."""

    def __init__(
        self,
        params: KMCParameters,
        lat: Lattice,
        device: Optional[Union[str, torch.device]] = None,
        qmax: Optional[int] = None,
        vmax: Optional[int] = None,
        rate_normalize: bool = False,
        pair_table_budget: float = 8e9,
        act_pad: int = 256,
        use_banded_k: bool = True,
        use_dia_k: bool = True,
        pair_cand_cap: Optional[int] = None,
        pair_tiling_min_n: int = 100_000,
        pair_f32: bool = False,
        ne_max: int = 2048,
        wkb_f32: bool = False,
        power_rtol_scale: float = 1.0,
        k_carry_residual: bool = False,
        event_select_incremental: bool = False,
        step_program: bool = True,
    ):
        """``qmax``/``vmax``: static caps on the charged and vacancy counts
        (sized from the initial population; doubled on overflow).
        ``rate_normalize``: shifted-exponent rates + log-space waiting
        times. ``pair_table_budget``: largest static pairwise table [bytes];
        0 disables it. ``use_dia_k`` / ``use_banded_k``: build the DIA
        operator when the structure's offset set is small, else the banded
        operator when the band is narrow, else solve over the ELL table.
        ``pair_tiling_min_n``: build the pairwise tiling when the table does
        not fit and N is at least this. ``pair_cand_cap``: per-tile
        charged-candidate cap of the tiled path; None sizes it from the
        initial charged population with 1.5x headroom; doubled on overflow.
        ``pair_f32``: the tiled plane in f32 (the f64 plane is the default
        and the oracle).

        Full physics: ``ne_max`` caps the contact-trap energy loop (WKB);
        ``wkb_f32`` evaluates the W_tt / W_ct / W_cc transmission planes in
        f32 (Kahan-compensated integral; f64 is the default and the oracle);
        ``power_rtol_scale`` is the default multiplier on the power CG's
        relative tolerance.

        ``k_carry_residual``: in ``superstep_multi`` on the banded operator,
        steps 2..k of a batch start their K-CG from the previous step's final
        residual rebased by the exact change of the matrix
        (``solve_potential_boundary_banded_carry``) instead of a fresh matvec;
        the first step of every batch runs the fresh one.

        ``event_select_incremental``: the serial loop of every mt19937-stream
        superstep carries its selection's block sums and sums again only the
        touched blocks per event (``ops/events.py::run_event_loop``): the
        same trajectory to the bit.

        ``step_program``: ``superstep`` and ``superstep_multi`` run as one
        program per dispatch (``models/step_program.py``; on one device
        only: under a mesh the collectives keep the loops on the host), and
        so do ``superstep_native`` and ``superstep_native_batched`` on a
        ``KeyDraws`` source, the full-physics supersteps, the deck modes and
        ``update_cb_edge``. False runs the fields and each loop as their
        own device loops, with host reads between them: the same results to
        the bit."""
        self.params, self.lat = params, lat
        self.step_program = bool(step_program)
        self.k_carry_residual = bool(k_carry_residual)
        self.event_select_incremental = bool(event_select_incremental)
        self.ne_max = int(ne_max)
        self.wkb_f32 = bool(wkb_f32)
        self.power_rtol_scale = power_rtol_scale
        self._current_tables: Optional[CurrentTables] = None
        self._power_band_built = False
        self._power_band = self._power_band_meta = self._power_grounded = None
        self._local_heat: Optional[LocalHeat] = None
        self.cb_iterations = 0      # CG iterations of the last ``update_cb_edge``
        # ``update_cb_edge`` calls as a program run (one host read each) and on
        # the per-loop path: counted apart from the supersteps' ``step_counts``
        self.cb_counts = dict.fromkeys(("runs", "per_loop"), 0)
        self.power_timing = {}      # the last power solve's energy-loop bounds and iterations
        self.power_bytes = {}       # bytes this rank held of the last power system's blocks
        self.device = dev = resolve_device(device)
        self.rate_normalize = bool(rate_normalize)
        self.pair_cand_cap = pair_cand_cap
        self.pair_f32 = bool(pair_f32)
        self.k_solves = 0           # K-system solves made so far (``_solve_boundary``)
        self.k_iterations = 0       # and the CG iterations of all of them
        self.fields_s = 0.0         # host seconds of the last ``_fields_grown``
        # the spans of every dispatch (runtime/profiling.py), part of every
        # program's key; ``last_spans``: the last dispatch's, device and host
        self.spans = False
        self.last_spans = {}
        self._host_spans = None     # the host phases of the dispatch under way
        self._loop_tables = {}      # the per-loop path's span tables, made on first use
        # the event loops' programs (ops/device_loop.py): their state tensors
        # and, on a card, their CUDA graphs, captured once per shape
        self.loop_graphs = LoopGraphs()
        # the CG device loops' programs (solvers/cg.py): one per operator key
        # (the K, CB-edge, power and heat solves), beside the event loops'
        self.cg_graphs = LoopGraphs()
        # the superstep programs (models/step_program.py), by k, chunk, carry and
        # caps, and what the dispatches did: program runs (one host read each),
        # steps redone on a grown cap, events-only chunks after a window ran
        # out, batches of ``superstep_multi`` discarded and replayed, and the
        # supersteps and deck-mode calls that took the per-loop path instead
        self.step_graphs = LoopGraphs()
        self.step_counts = dict.fromkeys(
            ("runs", "redos", "continues", "discards", "per_loop"), 0)
        # what the CG device loops did since the previous superstep ended
        # (solves, replays: one host read each, iterations run and live)
        self._cg_mark = self._cg_totals()
        self.cg_step_counts = dict.fromkeys(COUNT_KEYS, 0)
        # sharded runs (parallel/mesh.py::shard_model): the rank's Mesh, every
        # rank's row ranges per sharded table, and the rank's rows of the
        # event table's row sites and neighbors
        self.mesh = None
        self.shards = {}
        self.act_local = None
        p = params
        i64 = dict(dtype=torch.int64, device=dev)
        f64 = dict(dtype=torch.float64, device=dev)

        pos_np = np.stack([lat.x, lat.y, lat.z], axis=1)
        is_metal_np = metal_mask(lat.element0, p.metals)
        jc = np.clip(lat.neigh_idx, 0, None)
        kjc = np.clip(lat.k_neigh_idx, 0, None)

        n_v = int((lat.element0 == int(ELEM.VACANCY)).sum())
        n_od = int((lat.element0 == int(ELEM.OXYGEN_DEFECT)).sum())
        self.qmax = qmax if qmax is not None else _round_up(max(256, int(1.5 * (n_v + n_od))), 256)
        self.vmax = vmax if vmax is not None else _round_up(max(256, int(1.5 * n_v) + 1), 256)

        # static active-row compaction: rows outside {d, O, V, Od} carry
        # exactly-zero rates forever
        active_np = np.isin(lat.element0, [int(e) for e in _ACTIVE])
        act = np.nonzero(active_np)[0]

        # screened-Coulomb self-interaction v_solve(d, 2) of each active
        # row's neighbors, non-PBC distances in meters (kmc_events.cu:154-155)
        jc_act = jc[act]
        d = np.sqrt(((pos_np[act][:, None, :] - pos_np[jc_act]) ** 2).sum(-1)) * 1e-10
        d[lat.neigh_idx[act] < 0] = 1.0
        coincident = d == 0.0
        d[coincident] = 1.0
        self2_act = 2.0 * erfc(d / (p.sigma * np.sqrt(2.0))) * p.k * 1.60217663e-19 / d
        self2_act[coincident] = 0.0

        na_pad = _round_up(len(act) + 1, act_pad)     # >= 1 all-zero pad row
        act_idx_np = np.full(na_pad, -1, np.int64)
        act_idx_np[: len(act)] = act
        abs2act_np = np.full(lat.N, na_pad - 1, np.int64)
        abs2act_np[act] = np.arange(len(act))

        # column compaction: only active-active pairs can carry a rate
        nbr_act_rows = lat.neigh_idx[act]
        keep = (nbr_act_rows >= 0) & active_np[np.clip(nbr_act_rows, 0, None)]
        nn_act = max(8, int(keep.sum(axis=1).max()))
        order_cols = np.argsort(~keep, axis=1, kind="stable")[:, :nn_act]
        act_neigh_np = np.full((na_pad, nn_act), -1, np.int64)
        act_neigh_np[: len(act)] = np.where(
            np.take_along_axis(keep, order_cols, axis=1),
            np.take_along_axis(nbr_act_rows, order_cols, axis=1),
            -1,
        )
        act_self2_np = np.zeros((na_pad, nn_act))
        act_self2_np[: len(act)] = np.take_along_axis(self2_act, order_cols, axis=1)
        act_layer_np = np.zeros((na_pad, nn_act), np.int64)
        act_layer_np[: len(act)] = np.take_along_axis(lat.site_layer[jc_act], order_cols, axis=1)
        act_zero_np = np.concatenate(
            [np.arange(na_pad)[:, None], abs2act_np[np.clip(act_neigh_np, 0, None)]],
            axis=1,
        )

        pos_t = torch.as_tensor(pos_np, **f64)
        layers = p.layers
        self.tables = StaticTables(
            pos=pos_t,
            neigh_idx=torch.as_tensor(lat.neigh_idx, **i64),
            k_neigh_idx=torch.as_tensor(lat.k_neigh_idx, **i64),
            any_metal_nbr=torch.as_tensor(
                (is_metal_np[jc] & (lat.neigh_idx >= 0)).any(axis=1), device=dev
            ),
            metal_edge=torch.as_tensor(
                is_metal_np[:, None] & is_metal_np[kjc] & (lat.k_neigh_idx >= 0), device=dev
            ),
            metal_or_edge=torch.as_tensor(
                (is_metal_np[:, None] | is_metal_np[kjc]) & (lat.k_neigh_idx >= 0), device=dev
            ),
            E_gen=torch.tensor([l.E_gen_0 for l in layers], **f64),
            E_rec=torch.tensor([l.E_rec_1 for l in layers], **f64),
            E_Vdiff=torch.tensor([l.E_diff_2 for l in layers], **f64),
            E_Odiff=torch.tensor([l.E_diff_3 for l in layers], **f64),
            act_idx=torch.as_tensor(act_idx_np, **i64),
            abs2act=torch.as_tensor(abs2act_np, **i64),
            act_neigh=torch.as_tensor(act_neigh_np, **i64),
            act_self2=torch.as_tensor(act_self2_np, **f64),
            act_layer=torch.as_tensor(act_layer_np, **i64),
            act_zero_rows=torch.as_tensor(act_zero_np, **i64),
        )

        # static pairwise interaction table (charged sites are always drawn
        # from the active class, so its rows cover every possible source);
        # abs2act doubles as the site -> table-row map
        if 0 < len(act) * lat.N * 8 <= pair_table_budget:
            self.tables.pair_table = build_pair_table(
                pos_t, torch.as_tensor(act, **i64), p.cutoff_radius, p.sigma, p.k
            )
        self._pair_r_tile = None
        if self.tables.pair_table is None and lat.N >= pair_tiling_min_n:
            # tile edge = cutoff/2, as akmc_tpu sizes it
            tiling, self._pair_r_tile = build_pair_tiling(
                pos_np, p.cutoff_radius, tile_edge=p.cutoff_radius / 2.0
            )
            self.tables.pair_tiling = tiling.to(dev)
            if self.pair_cand_cap is None:
                # size the per-tile candidate cap from the initial charged
                # population (superset: every V/Od before charge rules); an
                # under-estimate is caught by the candidate-cap growth path
                q0 = np.isin(lat.element0, [int(ELEM.VACANCY), int(ELEM.OXYGEN_DEFECT)])
                mx = 0
                if q0.any():
                    mx = _max_in_reach_count(
                        tiling.tile_center.numpy(), pos_np[q0],
                        p.cutoff_radius + self._pair_r_tile,
                    )
                self.pair_cand_cap = _round_up(max(64, int(1.5 * mx)), 64)
        if self.pair_cand_cap is None:
            self.pair_cand_cap = 256

        self.dia: Optional[DiaK] = None
        self.dia_meta = None
        self.banded: Optional[BandedK] = None
        self.band_meta: Optional[BandMeta] = None
        if use_dia_k:
            if lat.grid is not None and not lat.pbc:
                # analytic, bit-identical to build_dia_k on grid-native structures
                from akmc_tpu_torch.models.crossbar import grid_dia_k

                n_yz_g, nx_g, a_g = lat.grid
                built = grid_dia_k(
                    n_yz_g, nx_g, a_g, p.nn_dist, is_metal_np,
                    p.num_atoms_first_layer, p.high_G, p.low_G, pos_np,
                    null_mask=lat.element0 == int(ELEM.NULL_ELEMENT),
                )
            else:
                built = build_dia_k(
                    pos_np, lat.k_neigh_idx, is_metal_np,
                    p.num_atoms_first_layer, p.high_G, p.low_G,
                )
            if built is not None:
                self.dia, self.dia_meta = built[0].to(dev), built[1]
        if self.dia is None and use_banded_k:
            built = build_banded_k(
                pos_np, lat.k_neigh_idx, is_metal_np, lat.element0,
                p.num_atoms_first_layer, p.high_G, p.low_G,
            )
            if built is not None:
                self.banded, self.band_meta = built[0].to(dev), built[1]
        self._lattice_t = torch.tensor(np.asarray(p.lattice, np.float64), device=dev)

    @property
    def kop(self):
        """The active K operator (DIA > banded > None: the ELL fallback)."""
        return self.dia if self.dia is not None else self.banded

    def describe(self) -> dict:
        """Which operator and which pairwise path this structure got, with
        the sizes and caps that go with them."""
        t = self.tables
        kop = self.kop
        out = {
            "N": self.lat.N,
            "ranks": 1 if self.mesh is None else self.mesh.size,
            "k_operator": {DiaK: "dia", BandedK: "banded"}.get(type(kop), "ell"),
            "pairwise": "table" if t.pair_table is not None
            else "tiled" if t.pair_tiling is not None else "on_the_fly",
            "qmax": self.qmax, "vmax": self.vmax,
        }
        if isinstance(kop, BandedK):
            out["band_blocks"] = list(kop.blocks.shape)
            out["half_band"] = self.band_meta.half_band
        if t.pair_tiling is not None:
            out["tiles"], out["tile_slots"] = t.pair_tiling.tile_sites.shape
            out["pair_cand_cap"] = self.pair_cand_cap
        return out

    def held_bytes(self) -> dict:
        """Bytes this process holds of each table that a mesh shards: the
        pairwise table, the DIA codes, the band blocks, and the last power
        system's W blocks and G_nbr (``power_bytes``)."""
        t = self.tables
        out = {}
        if t.pair_table is not None:
            out["pair_table"] = t.pair_table.numel() * t.pair_table.element_size()
        if t.pair_tiling is not None:
            out["pair_tiling"] = sum(a.numel() * a.element_size() for a in t.pair_tiling)
        if self.dia is not None:
            out["dia_codes"] = self.dia.diags.numel()
        if self.banded is not None:
            out["band_blocks"] = self.banded.blocks.numel()
        if self._power_band is not None:
            out["power_band_blocks"] = self._power_band.blocks.numel()
        out.update(self.power_bytes)
        return out

    # ------------------------------------------------------------------
    def _build_rates(self, element, charge, pot_sum, T_bg):
        """The rate table; under a mesh each rank builds its rows and the
        table is gathered whole (the event loop runs on every rank)."""
        t, p, mesh = self.tables, self.params, self.mesh
        rows, neigh = (t.act_idx, t.act_neigh) if mesh is None else self.act_local
        P, etype, ln_S = build_event_table(
            element, charge, pot_sum, T_bg,
            neigh, t.act_self2, t.act_layer,
            t.E_gen, t.E_rec, t.E_Vdiff, t.E_Odiff,
            p.freq, rows=rows, normalize=self.rate_normalize,
            reduce_min=None if mesh is None else mesh.min,
        )
        if mesh is not None:
            P = mesh.gather_rows(P, self.shards["act"])
            etype = mesh.gather_rows(etype, self.shards["act"])
        return P, etype, ln_S

    def _shard(self, name):
        """(mesh, every rank's ranges of table ``name``) under a mesh, else None."""
        return None if self.mesh is None else (self.mesh, self.shards[name])

    def _solve_boundary(self, element, charge, pb_prev, Vd, max_iterations=10000):
        """K-system solve through whichever operator the structure supports
        (under a mesh, its sharded form). ``k_solves`` and ``k_iterations``
        count the solves and their CG iterations, those of a pass that a
        grown cap discards included."""
        t, p = self.tables, self.params
        kop = self.kop
        if isinstance(kop, DiaK) and self.mesh is not None:
            pot, cg = solve_potential_boundary_dia_sharded(
                kop, self.dia_meta, self.mesh, self.shards["dia"], element, charge,
                pb_prev, Vd, p.high_G, p.low_G, p.num_atoms_first_layer,
                max_iterations=max_iterations,
            )
        elif isinstance(kop, DiaK):
            pot, cg = solve_potential_boundary_dia(
                kop, self.dia_meta, element, charge, pb_prev, Vd,
                p.high_G, p.low_G, p.num_atoms_first_layer, max_iterations=max_iterations,
            )
        elif isinstance(kop, BandedK):
            pot, cg = solve_potential_boundary_banded(
                kop, self.band_meta, element, charge, pb_prev, Vd,
                p.high_G, p.low_G, p.num_atoms_first_layer, p.nn_dist,
                self._lattice_t, bool(p.pbc), self.vmax, max_iterations=max_iterations,
                shard=self._shard("band"), graphs=self.cg_graphs,
            )
        else:
            pot, cg = solve_potential_boundary(
                element, charge, pb_prev, t.k_neigh_idx, t.metal_edge, Vd,
                p.high_G, p.low_G, p.num_atoms_first_layer, max_iterations=max_iterations,
                shard=self._shard("int"), graphs=self.cg_graphs,
            )
        self._count_k_solve(cg.iterations)
        return pot, cg

    def _count_k_solve(self, iterations) -> None:
        """One K solve in ``k_solves`` and its iterations in ``k_iterations``;
        inside a program, once its read gives the count."""
        def add(v):
            self.k_solves += 1
            self.k_iterations += int(v[0])
        if device_loop.in_program():
            device_loop.record((torch.as_tensor(iterations, device=self.device),), add)
        else:
            add([iterations])

    def _pairwise(self, charge):
        """Pairwise potential through the path the structure got: (potential,
        qmax overflow, candidate-cap overflow). Under a mesh each rank
        computes its site columns of the table, its tiles (when the tiles
        are sharded) or its rows of the on-the-fly plane, and the potential
        is gathered whole; the flags are the same on every rank."""
        t, p, mesh = self.tables, self.params, self.mesh
        c_overflow = torch.zeros((), dtype=torch.bool, device=self.device)
        if t.pair_table is not None:
            pot_pair, q_overflow = pairwise_potential_table(
                t.pair_table, t.abs2act, charge, self.qmax
            )
            if mesh is not None:
                pot_pair = mesh.gather_rows(pot_pair, self.shards["sites"])
        elif t.pair_tiling is not None:
            pot_pair, q_overflow, c_overflow = pairwise_potential_tiled(
                t.pair_tiling, self._pair_r_tile, t.pos, charge,
                p.cutoff_radius, p.sigma, p.k, qmax=self.qmax,
                cand_cap=self.pair_cand_cap, plane_f32=self.pair_f32,
            )
            if mesh is not None and "tiles" in self.shards:
                # each site lies in one tile, so the other ranks add exact zeros
                pot_pair = mesh.sum_partials(pot_pair)
                c_overflow = torch.tensor(mesh.any(c_overflow), device=self.device)
        else:
            pot_pair, q_overflow = pairwise_potential(
                t.pos, charge, p.cutoff_radius, p.sigma, p.k, qmax=self.qmax,
                row_range=None if mesh is None else self.shards["sites"][mesh.rank],
            )
            if mesh is not None:
                pot_pair = mesh.gather_rows(pot_pair, self.shards["sites"])
        return pot_pair, q_overflow, c_overflow

    def _solve_boundary_carry(self, element, charge, pb_prev, Vd, carry):
        """The banded K solve with a carried residual (``carry`` None: the
        fresh entry matvec), counted as ``_solve_boundary`` counts."""
        p = self.params
        pot, cg, new_carry = solve_potential_boundary_banded_carry(
            self.banded, self.band_meta, element, charge, pb_prev, Vd,
            p.high_G, p.low_G, p.num_atoms_first_layer, p.nn_dist,
            self._lattice_t, bool(p.pbc), self.vmax, carry=carry, shard=self._shard("band"),
            graphs=self.cg_graphs,
        )
        self._count_k_solve(cg.iterations)
        return pot, cg, new_carry

    def _fields(self, element, charge, potential_boundary_prev, T_bg, Vd,
                k_carry=None) -> FieldsResult:
        """The fields before an event loop. ``k_carry``: None runs the plain
        K solve; on the banded operator "init" runs the carry solve with a
        fresh entry matvec and a ``KCarry`` the rebased one, and the result
        holds the new carry (other operators ignore it, as akmc_tpu's do)."""
        t = self.tables
        with profiling.span("charge"):
            # every vmax-capped compaction (charge update, cvac correction)
            # truncates at vmax; vacancy generation grows the population, so
            # detect the overflow here and let superstep grow the cap
            v_overflow = torch.sum(element == int(ELEM.VACANCY)) > self.vmax
            charge = update_charge_compact(
                element, charge, t.neigh_idx, t.any_metal_nbr, self.vmax
            )
        k_carry_new = None
        with profiling.span("k_solve"):
            if k_carry is not None and isinstance(self.kop, BandedK):
                pot_boundary, cg, k_carry_new = self._solve_boundary_carry(
                    element, charge, potential_boundary_prev, Vd,
                    None if isinstance(k_carry, str) else k_carry,
                )
            else:
                pot_boundary, cg = self._solve_boundary(
                    element, charge, potential_boundary_prev, Vd
                )
        with profiling.span("pairwise"):
            pot_pair, q_overflow, c_overflow = self._pairwise(charge)
        with profiling.span("rates"):
            pot_sum = pot_pair + pot_boundary   # sum_AB_into_A (psg.cu:1130-1151)
            P, etype, ln_S = self._build_rates(element, charge, pot_sum, T_bg)
        return FieldsResult(
            charge=charge, potential_boundary=pot_boundary, potential_sum=pot_sum,
            P=P, etype=etype, cg_iterations=cg.iterations,
            q_overflow=q_overflow, v_overflow=v_overflow, ln_S=ln_S,
            c_overflow=c_overflow, k_carry=k_carry_new,
        )

    def _grow(self, q_ovf, v_ovf, c_ovf) -> bool:
        """Double every cap whose overflow flag is set; whether one was."""
        if q_ovf:
            self.qmax *= 2
        if v_ovf:
            self.vmax *= 2
        if c_ovf:
            self.pair_cand_cap *= 2
        return bool(q_ovf or v_ovf or c_ovf)

    def _fields_grown(self, state: DeviceState, Vd: float, pb_start=None,
                      k_carry=None) -> FieldsResult:
        """``_fields`` on ``state`` (K solve started from ``pb_start``, default
        the state's boundary potential; ``k_carry`` as ``_fields`` takes it).
        On an overflow of qmax, vmax or the tiled path's candidate cap, the
        exceeded caps double and the fields are recomputed from the same
        inputs. Draws nothing, so the event loops that follow never have to
        replay a draw. ``fields_s`` keeps the host time of the last call: the
        read of the cap flags drains the device, so that is the fields' time
        on a card too."""
        t0 = time.perf_counter()
        pb = state.potential_boundary if pb_start is None else pb_start
        while True:
            fr = self._fields(state.element, state.charge, pb, state.T_bg, Vd, k_carry)
            if not self._grow(*torch.stack(
                    [fr.q_overflow, fr.v_overflow, fr.c_overflow]).tolist()):
                self.fields_s = time.perf_counter() - t0
                return fr

    def fields(self, state: DeviceState, Vd: float) -> FieldsResult:
        """The fields of ``state`` at bias ``Vd`` as a superstep computes them
        before its event loop (charges, potentials, rate table), caps grown:
        a frozen table to run event loops on."""
        return self._fields_grown(state, Vd)

    def _events(self, element, charge, P, etype, stream, rand_chunk,
                event_time_in=None, ln_S=None):
        t = self.tables
        rand_buf = torch.as_tensor(stream.peek(rand_chunk), dtype=torch.float64,
                                   device=self.device)
        res = run_event_loop(
            element, charge, P, etype, t.act_neigh, rand_buf, self.params.freq,
            t.act_idx, t.abs2act, t.act_zero_rows,
            event_time_in=event_time_in, ln_S=ln_S,
            incremental_select=self.event_select_incremental, graphs=self.loop_graphs,
        )
        stream.advance(res.draws_used)
        return res

    def _events_to_the_end(self, element, charge, P, etype, ln_S, stream, rand_chunk):
        """The serial loop on the rate table ``P`` until the superstep is
        done: (last chunk's result with the events of all chunks)."""
        with profiling.span("event_loop"):
            res = self._events(element, charge, P, etype, stream, rand_chunk, ln_S=ln_S)
            n_events = res.n_events
            while not res.done:
                # the rand buffer ran out mid-superstep: continue with the
                # mutated table and the carried waiting time
                res = self._events(res.element, res.charge, res.P, etype, stream,
                                   rand_chunk, event_time_in=res.event_time, ln_S=ln_S)
                n_events += res.n_events
        return res._replace(n_events=n_events)

    def superstep(
        self, state: DeviceState, Vd: float, stream, rand_chunk: int = RAND_CHUNK
    ) -> Tuple[DeviceState, dict]:
        """One full KMC superstep. ``stream`` is a ``rng.BufferedStream``
        over the KMC mt19937 stream; it advances by exactly the draws the
        event loop used.

        As ``akmc_tpu``'s ``superstep`` runs it: one program (fields and
        event loop; on a card one CUDA graph) on a window of ``rand_chunk``
        draws and one read of its diagnostics; on an overflow of a cap the
        exceeded caps double and the step is redone from the same inputs
        (the stream has not advanced); if the window ran out before the
        superstep was done, the loop goes on in events-only chunks. Without
        ``step_program`` (or under a mesh): the fields with their caps grown
        first (``_fields_grown``), then the loop, each a device loop of its
        own."""
        if not self._programmed():
            new_state, stats, _ = self._step(state, Vd, stream, rand_chunk)
            return new_state, stats
        window = stream.peek(rand_chunk)
        while True:
            prog = self._superstep_program(state, 1, rand_chunk, False)
            out, (d,) = self._dispatch(prog, state, Vd, window)
            self.step_counts["runs"] += 1
            if not self._grow(d[5], d[6], d[7]):
                break
            self.step_counts["redos"] += 1
            self._drop_stale_programs()
        stream.advance(int(d[1]))
        n_events, ev_time, ev_h = int(d[0]), out["event_time"], d[2]
        element, charge = out["element"], out["charge"]
        if not d[3]:
            element, charge, n_events, ev_time, ev_h = self._continue(
                out, element, charge, n_events, ev_time, stream, rand_chunk)
        self._count_cg_step()
        new_state = state.replace(
            element=element, charge=charge,
            potential_boundary=out["potential_boundary"],
            potential_charge=out["potential_charge"],
            kmc_time=state.kmc_time + ev_time,
        )
        return new_state, {"n_events": n_events, "event_time": ev_h,
                           "cg_iterations": int(d[4])}

    def _continue(self, out, element, charge, n_events, ev_time, stream, rand_chunk):
        """A program's window ran out mid-superstep: the serial loop goes on in
        events-only chunks on the program's rate table (``out``) with the
        carried waiting time, as akmc_tpu goes on. Returns (element, charge,
        events in all, event_time, event_time as read)."""
        P, etype, ln_S = out["P"], out["etype"], out["ln_S"]
        done = False
        while not done:
            self.step_counts["continues"] += 1
            res = self._events(element, charge, P, etype, stream, rand_chunk,
                               event_time_in=ev_time, ln_S=ln_S)
            element, charge, P = res.element, res.charge, res.P
            n_events += res.n_events
            ev_time, done = res.event_time, res.done
        return element, charge, n_events, ev_time, res.event_time_h

    def _dispatch(self, prog, *args, **kwargs):
        """One run of ``prog`` on the inputs ``prog.load(*args, **kwargs)``
        copies in: (outputs, diagnostics). With ``spans`` the host phases
        are timed (``load`` here, ``launch``, ``read`` and ``unpack`` in
        ``run``) and ``last_spans`` holds the program's device spans and
        these; a caller may add to ``unpack`` (``_host_spans``)."""
        host = self._host_spans = profiling.HostSpans(prog.LABEL) if self.spans else None
        with profiling.host_span(host, "load"):
            prog.load(*args, **kwargs)
        out = prog.run(host)
        if host is not None:
            self.last_spans = {**prog.last_spans, **host.spans}
            profiling.dispatched(self.last_spans)
        return out

    @contextlib.contextmanager
    def _loop_spans(self, kind: str = "superstep"):
        """A dispatch of the per-loop path as one span ``superstep`` in the
        model's own table of ``kind`` (the supersteps', the CB edge's),
        stamped where the device loops stand, and read once at its end (one
        more host read, with ``spans`` only) into ``last_spans``. Nothing
        without ``spans``."""
        if not self.spans:
            yield
            return
        table = self._loop_tables.get(kind)
        if table is None:
            table = self._loop_tables[kind] = profiling.SpanTable(self.device)
        table.reset()
        table.stamp_anchor()
        with profiling.spanning(table), profiling.span("superstep"):
            yield
        values = [v for t in table.tensors() for v in t.to(torch.float64).tolist()]
        self.last_spans = dict(table.read(values))
        profiling.dispatched(self.last_spans)

    def _programmed(self) -> bool:
        """Whether the serial supersteps run as programs (one device)."""
        return self.step_program and self.mesh is None

    def _incremental_select(self) -> bool:
        """The serial loop's incremental selection, where the rate table's
        rows allow it (``ops/events.py::run_event_loop``)."""
        return self.event_select_incremental and self.tables.act_neigh.shape[0] % _BLK == 0

    def _superstep_program(self, state: DeviceState, k: int, chunk: int,
                           carry: bool) -> SuperstepProgram:
        """The program of k supersteps on windows of ``chunk`` draws at the
        current caps, built once per key (caps, k, chunk, carry, the loops'
        steps per pass, the options its body reads, the state's types, the
        static tables' addresses, ``spans``)."""
        t = self.tables
        key = (k, chunk, carry, self.qmax, self.vmax, self.pair_cand_cap,
               cg_mod.CG_NODE_K, events_mod.SERIAL_NODE_K, self._incremental_select(),
               self.pair_f32, state.element.dtype, state.charge.dtype,
               tuple((x.data_ptr(), tuple(x.shape)) for x in
                     (t.act_neigh, t.act_idx, t.abs2act, t.act_zero_rows)), self.spans)
        return self.step_graphs.get(
            key, lambda: SuperstepProgram(self, state, k, chunk, carry))

    def _drop_stale_programs(self) -> None:
        """Forget the programs of caps below the current ones: caps only grow,
        so they would never run again. Each holds its graph's memory (a
        full-physics program its W blocks, gigabytes at large widths), which
        is given back now: a dropped graph waits in a reference cycle for the
        cyclic collector."""
        caps = (self.qmax, self.vmax, self.pair_cand_cap)
        progs = self.step_graphs.programs
        stale = [key for key in progs if key[3:6] != caps]
        for key in stale:
            del progs[key]
        if stale and self.device.type == "cuda":
            gc.collect()
            torch.cuda.empty_cache()

    def _capture_program(self, state: DeviceState, Vd: float, k: int,
                         chunk: Optional[int] = None) -> SuperstepProgram:
        """Build, and on a card capture, the program ``superstep`` (k = 1)
        or ``superstep_multi`` (k > 1) takes next on windows of ``chunk``
        draws (default: theirs), warmed on ``state`` and a window of zeros.
        Changes no state."""
        if chunk is None:
            chunk = RAND_CHUNK if k == 1 else 2048
        carry = k > 1 and self.k_carry_residual and isinstance(self.kop, BandedK)
        prog = self._superstep_program(state, k, chunk, carry)
        prog.load(state, Vd, np.zeros(k * chunk))
        prog.capture()
        return prog

    def _step(self, state, Vd, stream, rand_chunk, k_carry=None):
        """The superstep of the per-loop path with ``_fields``'s ``k_carry``:
        (state', stats, the fields' new carry)."""
        with self._loop_spans():
            fr = self._fields_grown(state, Vd, k_carry=k_carry)
            res = self._events_to_the_end(state.element, fr.charge, fr.P, fr.etype, fr.ln_S,
                                          stream, rand_chunk)
        return (*self._finish(state, fr, res), fr.k_carry)

    def superstep_multi(
        self, state: DeviceState, Vd: float, stream, k: int, rand_chunk: int = 2048,
    ) -> Tuple[DeviceState, list]:
        """k supersteps that share one rand buffer through a running cursor:
        the same stats list, the same final state and the same advance of
        ``stream`` as k sequential ``superstep(..., rand_chunk=rand_chunk)``
        calls (``akmc_tpu/models/vcm.py::superstep_multi``). With
        ``k_carry_residual`` on the banded operator, step 1 runs the carry
        solve with a fresh entry matvec and steps 2..k rebase the previous
        step's residual.

        As akmc_tpu runs it: the k steps as one program (on a card one CUDA
        graph) on a buffer of k * ``rand_chunk`` draws and one read of the
        (k, 8) diagnostics; if any step ran out of its window or overflowed
        a cap, the batch is discarded (the stream was only peeked, the state
        not touched) and replayed step by step with ``superstep``, which
        grows the caps. Without ``step_program`` (or under a mesh) the k
        steps run one after the other on the per-loop path, caps grown
        before any draw and a window that runs out continued in the next,
        which gives the same result (on a grown cap the carry is kept)."""
        use_kc = self.k_carry_residual and isinstance(self.kop, BandedK)
        if not self._programmed():
            kc = "init" if use_kc else None
            stats_list = []
            for _ in range(k):
                state, stats, kc = self._step(state, Vd, stream, rand_chunk, k_carry=kc)
                stats_list.append(stats)
            return state, stats_list
        prog = self._superstep_program(state, k, rand_chunk, use_kc)
        out, diag = self._dispatch(prog, state, Vd, stream.peek(k * rand_chunk))
        self.step_counts["runs"] += 1
        if any(d[3] == 0.0 or d[5] or d[6] or d[7] for d in diag):
            self.step_counts["discards"] += 1
            stats_list = []
            for _ in range(k):
                state, stats = self.superstep(state, Vd, stream, rand_chunk)
                stats_list.append(stats)
            return state, stats_list
        stream.advance(sum(int(d[1]) for d in diag))
        self._count_cg_step()
        new_state = state.replace(
            element=out["element"], charge=out["charge"],
            potential_boundary=out["potential_boundary"],
            potential_charge=out["potential_charge"], kmc_time=out["kmc_time"],
        )
        return new_state, [{"n_events": int(d[0]), "event_time": d[2],
                            "cg_iterations": int(d[4])} for d in diag]

    def fields_only(self, state: DeviceState, Vd: float) -> Tuple[DeviceState, dict]:
        """Charges and both potentials without the event step
        (``perturb_structure = 0``, kmc_main.cpp:484), caps grown: the
        state's charge, boundary and summed potentials replaced.

        As ``akmc_tpu`` runs it (``_fields_jit``): one program
        (``FieldsProgram``; on a card one CUDA graph) and one read of its
        four diagnostics; on an overflow of a cap the exceeded caps double
        and the fields are redone from the same inputs. Without
        ``step_program`` (or under a mesh): ``_fields_grown``, the per-loop
        path (``step_counts["per_loop"]``); the same bits."""
        if not self._programmed():
            self.step_counts["per_loop"] += 1
            with self._loop_spans():
                fr = self._fields_grown(state, Vd)
            charge, pb, pc, iters = (fr.charge, fr.potential_boundary, fr.potential_sum,
                                     fr.cg_iterations)
        else:
            while True:
                prog = self._deck_program("fields", state)
                out, d = self._dispatch(prog, state, Vd)
                self.step_counts["runs"] += 1
                if not self._grow(d[1], d[2], d[3]):
                    break
                self.step_counts["redos"] += 1
                self._drop_stale_programs()
            charge, pb, pc, iters = (out["charge"], out["potential_boundary"],
                                     out["potential_sum"], int(d[0]))
        new_state = state.replace(charge=charge, potential_boundary=pb, potential_charge=pc)
        self._count_cg_step()
        return new_state, {"cg_iterations": iters}

    def superstep_events_only(
        self, state: DeviceState, stream, rand_chunk: int = RAND_CHUNK
    ) -> Tuple[DeviceState, dict]:
        """The event step on the state's current (stale) charge and summed
        potential (``solve_potential = 0``: the reference's event step reads
        whatever ``site_potential_charge`` holds, kmc_main.cpp:491): the rate
        table, then the serial loop to its end over rand chunks; ``stream``
        advances by exactly the draws used.

        As ``akmc_tpu`` runs it (``_events_only_jit``): one program
        (``EventsOnlyProgram``; on a card one CUDA graph) on a window of
        ``rand_chunk`` draws and one read of its four diagnostics; a window
        that runs out goes on in events-only chunks (``_continue``), as
        ``akmc_tpu`` goes on chunk by chunk. Without ``step_program`` (or
        under a mesh): the per-loop path (``step_counts["per_loop"]``); the
        same bits."""
        if not self._programmed():
            self.step_counts["per_loop"] += 1
            with self._loop_spans():
                with profiling.span("rates"):
                    P, etype, ln_S = self._build_rates(
                        state.element, state.charge, state.potential_charge, state.T_bg)
                res = self._events_to_the_end(state.element, state.charge, P, etype, ln_S,
                                              stream, rand_chunk)
            element, charge, n_events = res.element, res.charge, res.n_events
            ev_time, ev_h = res.event_time, res.event_time_h
        else:
            prog = self._deck_program("events_only", state, rand_chunk)
            out, (d,) = self._dispatch(prog, state, stream.peek(rand_chunk))
            self.step_counts["runs"] += 1
            stream.advance(int(d[1]))
            n_events, ev_time, ev_h = int(d[0]), out["event_time"], d[2]
            element, charge = out["element"], out["charge"]
            if not d[3]:
                element, charge, n_events, ev_time, ev_h = self._continue(
                    out, element, charge, n_events, ev_time, stream, rand_chunk)
        new_state = state.replace(element=element, charge=charge,
                                  kmc_time=state.kmc_time + ev_time)
        self._count_cg_step()
        return new_state, {"n_events": n_events, "event_time": ev_h, "cg_iterations": 0}

    def _deck_program(self, kind: str, state: DeviceState, chunk: int = 0):
        """The program of a deck mode or of the CB edge at the current caps
        (``kind`` "fields": ``FieldsProgram``; "events_only":
        ``EventsOnlyProgram`` on windows of ``chunk`` draws; "cb_edge":
        ``CbEdgeProgram``), built once per key:
        kind, chunk, caps (at the serial programs' places, which
        ``_drop_stale_programs`` reads), the loops' steps per pass, the
        options its body reads, the state's types, the static tables'
        addresses and ``spans``."""
        t = self.tables
        key = (kind, 1, chunk, self.qmax, self.vmax, self.pair_cand_cap,
               cg_mod.CG_NODE_K, events_mod.SERIAL_NODE_K, self._incremental_select(),
               self.pair_f32, self.rate_normalize, state.element.dtype, state.charge.dtype,
               tuple((x.data_ptr(), tuple(x.shape)) for x in
                     (t.act_neigh, t.act_idx, t.abs2act, t.act_zero_rows, t.k_neigh_idx)),
               self.spans)
        make = {"fields": lambda: FieldsProgram(self, state),
                "events_only": lambda: EventsOnlyProgram(self, state, chunk),
                "cb_edge": lambda: CbEdgeProgram(self, state)}[kind]
        return self.step_graphs.get(key, make)

    def _capture_deck(self, kind: str, state: DeviceState, Vd: float):
        """Build, and on a card capture, the program of ``kind``
        (``_deck_program``; events only on ``RAND_CHUNK`` draws) warmed on
        ``state`` at ``Vd`` (a window of zeros). Changes no state."""
        prog = self._deck_program(kind, state, RAND_CHUNK if kind == "events_only" else 0)
        if kind == "events_only":
            prog.load(state, np.zeros(RAND_CHUNK))
        else:
            prog.load(state, Vd)
        prog.capture()
        return prog

    def _cg_totals(self) -> dict:
        """The counts of every CG program of ``cg_graphs``, summed."""
        progs = self.cg_graphs.programs.values()
        return {k: sum(p.counts[k] for p in progs) for k in COUNT_KEYS}

    def _count_cg_step(self) -> None:
        """``cg_step_counts``: what the CG device loops did since the last
        superstep ended (a new bias point's CB-edge solve included). The
        stats keep ``akmc_tpu``'s keys, so the counts live here."""
        now = self._cg_totals()
        self.cg_step_counts = {k: now[k] - self._cg_mark[k] for k in now}
        self._cg_mark = now

    def _finish(self, state, fr, res, **more) -> Tuple[DeviceState, dict]:
        """The new state and the stats every superstep returns."""
        self._count_cg_step()
        new_state = state.replace(
            element=res.element,
            charge=res.charge,
            potential_boundary=fr.potential_boundary,
            potential_charge=fr.potential_sum,
            kmc_time=state.kmc_time + res.event_time,
        )
        stats = {
            "n_events": res.n_events,
            "event_time": res.event_time_h,
            "cg_iterations": fr.cg_iterations,
            **more,
        }
        return new_state, stats

    # ------------------------------------------------------------------
    # production supersteps: uniforms from a draws source (akmc_tpu's
    # threefry key, ``ops/threefry.py::KeyDraws``, as the driver makes it;
    # or a ``GeneratorDraws``), not the reference's mt19937 stream
    # ------------------------------------------------------------------
    def superstep_native(self, state: DeviceState, Vd: float, draws) -> Tuple[DeviceState, dict]:
        """Production-mode superstep with the serial loop
        (``run_event_loop_native``): the exact residence-time law on the
        caller's draws source. Not reference-stream parity.

        On a ``KeyDraws`` source (``akmc_tpu``'s threefry key) it is
        ``akmc_tpu``'s ``superstep_native``: ``key, sub = split(key)``, the
        loop drawing from ``sub``, the source moved on to ``key``; with
        ``step_program`` on one device as one program (``_production``).
        Otherwise, or on another source (a generator, a replay), the per-loop
        path: the fields with their caps grown, then the device loop."""
        if isinstance(draws, KeyDraws) and self._programmed():
            return self._production(state, Vd, draws, 0, False)
        self.step_counts["per_loop"] += 1
        t = self.tables
        with self._loop_spans():
            fr = self._fields_grown(state, Vd)
            if isinstance(draws, KeyDraws):
                draws = draws.split()
            with profiling.span("event_loop"):
                res = run_event_loop_native(
                    state.element, fr.charge, fr.P, fr.etype, t.act_neigh, draws,
                    self.params.freq, act_idx=t.act_idx, abs2act=t.abs2act, ln_S=fr.ln_S,
                    zero_rows=t.act_zero_rows, graphs=self.loop_graphs,
                )
        return self._finish(state, fr, res)

    def superstep_native_batched(
        self, state: DeviceState, Vd: float, draws, batch: int = 64,
        mass_eps: float = 1e-3, clock_f32: bool = False,
        pb_prev2: Optional[torch.Tensor] = None, k_extrap: float = 0.0,
    ) -> Tuple[DeviceState, dict]:
        """Production superstep with the multi-event batched loop
        (``run_event_loop_batched``): exponential-race candidate selection and
        an exact prefix-conflict cut in place of one event per iteration, the
        event path of crossbar-scale structures. ``mass_eps`` is the
        killed-mass staleness bound, the one knob that trades gap-law
        exactness for events per batch.

        ``pb_prev2`` / ``k_extrap``: linear-extrapolation warm start of the K
        solve, x0 = pb + k_extrap * (pb - pb_prev2), with ``pb_prev2`` the
        boundary potential of the superstep before the last. The CG stops
        relative to ||b||, so a closer x0 saves iterations where the
        potential drifts smoothly; the converged tolerance is unchanged.
        ``k_extrap = 0.0`` is the plain warm start bit for bit.

        On a ``KeyDraws`` source it is ``akmc_tpu``'s
        ``superstep_native_batched`` draw for draw (``key, sub =
        split(key)``, the loop on ``sub``), with ``step_program`` on one
        device as one program (``_production``: one replay and one host read,
        ``mass_eps`` and ``k_extrap`` tensors of the program); else the
        per-loop path.

        A loop that used up its batches without one event
        raises: with ``clock_f32`` every live row's shifted rate can
        underflow f32, all clocks are then infinite, and a caller that adds
        the returned waiting time of 0 to its clock would never advance."""
        if isinstance(draws, KeyDraws) and self._programmed():
            return self._production(state, Vd, draws, batch, clock_f32, pb_prev2=pb_prev2,
                                    mass_eps=mass_eps, k_extrap=k_extrap)
        self.step_counts["per_loop"] += 1
        t = self.tables
        with self._loop_spans():
            pb = state.potential_boundary
            pb_ws = pb + k_extrap * (pb - (pb if pb_prev2 is None else pb_prev2))
            fr = self._fields_grown(state, Vd, pb_start=pb_ws)
            if isinstance(draws, KeyDraws):
                draws = draws.split()
            with profiling.span("event_loop"):
                res = run_event_loop_batched(
                    state.element, fr.charge, fr.P, fr.etype, t.act_neigh, draws,
                    self.params.freq, batch=batch, act_idx=t.act_idx, abs2act=t.abs2act,
                    ln_S=fr.ln_S, mass_eps=mass_eps, clock_f32=clock_f32,
                    graphs=self.loop_graphs,
                )
        self._check_batched(res.done, res.n_events, res.n_batches, Vd, clock_f32)
        return self._finish(
            state, fr, res, n_batches=res.n_batches, done=res.done,
            n_cut_conflict=res.n_cut_conflict, n_cut_mass=res.n_cut_mass,
        )

    @staticmethod
    def _check_batched(done, n_events, n_batches, Vd, clock_f32) -> None:
        if not done and n_events == 0:
            raise RuntimeError(
                f"the batched event loop ran {n_batches} batches at Vd = {Vd} V without "
                "an event or a terminating gap"
                + (": with clock_f32 the rates may lie below f32's range, run with f64 clocks"
                   if clock_f32 else ""))

    def _production_program(self, state: DeviceState, batch: int,
                            clock_f32: bool) -> ProductionProgram:
        """The production program (``batch`` 0: native) at the current caps,
        built once per key: kind, B, the clock's type, caps (at the serial
        programs' places, ``_drop_stale_programs`` reads them there), the
        nodes' steps per pass, options, the state's types, the static
        tables' addresses and ``spans``."""
        t = self.tables
        key = ("production", batch, clock_f32, self.qmax, self.vmax, self.pair_cand_cap,
               cg_mod.CG_NODE_K, events_mod.SERIAL_NODE_K, events_mod.BATCHED_NODE_K,
               self.pair_f32, self.rate_normalize, state.element.dtype, state.charge.dtype,
               tuple((x.data_ptr(), tuple(x.shape)) for x in
                     (t.act_neigh, t.act_idx, t.abs2act, t.act_zero_rows)), self.spans)
        return self.step_graphs.get(
            key, lambda: ProductionProgram(self, state, batch, clock_f32))

    def _production(self, state: DeviceState, Vd: float, draws: KeyDraws, batch: int,
                    clock_f32: bool, pb_prev2=None, mass_eps: float = 1e-3,
                    k_extrap: float = 0.0) -> Tuple[DeviceState, dict]:
        """A production superstep as one program: the key copied in, one run
        and one read of its diagnostics; on an overflow of a cap the exceeded
        caps double and the step is redone from the same key (the source has
        not moved), as ``akmc_tpu`` redoes it (``vcm.py:1126-1137``)."""
        while True:
            prog = self._production_program(state, batch, clock_f32)
            out, d = self._dispatch(prog, state, Vd, draws.key, pb_prev2=pb_prev2,
                                    mass_eps=mass_eps, k_extrap=k_extrap)
            self.step_counts["runs"] += 1
            if not self._grow(d[5], d[6], d[7]):
                break
            self.step_counts["redos"] += 1
            self._drop_stale_programs()
        n_events, done = int(d[0]), bool(d[3])
        stats = {"n_events": n_events, "event_time": d[2], "cg_iterations": int(d[4])}
        if batch:
            self._check_batched(done, n_events, int(d[1]), Vd, clock_f32)
            stats.update(n_batches=int(d[1]), done=done, n_cut_conflict=int(d[8]),
                         n_cut_mass=int(d[9]))
        with profiling.host_span(self._host_spans, "unpack"):
            draws.key = out["key"]
            self._count_cg_step()
            new_state = state.replace(
                element=out["element"], charge=out["charge"],
                potential_boundary=out["potential_boundary"],
                potential_charge=out["potential_charge"],
                kmc_time=state.kmc_time + out["event_time"],
            )
        return new_state, stats

    def _capture_production(self, state: DeviceState, Vd: float, batch: int,
                            clock_f32: bool) -> ProductionProgram:
        """Build, and on a card capture, the production program a run takes
        next (``batch`` 0: native), warmed on ``state`` and a zero key.
        Changes no state and draws from no source."""
        prog = self._production_program(state, batch, clock_f32)
        prog.load(state, Vd, torch.zeros(2, dtype=torch.int64, device=self.device))
        prog.capture()
        return prog

    def warmup(self, state: DeviceState, Vd: float, full_physics: bool = False,
               batched: int = 0, clock_f32: bool = False,
               steps_per_dispatch: int = 1) -> dict:
        """What superstep 0 would otherwise pay for, done before it. On a
        CUDA device: both kernel sources built (``ops/cuda_build.py``) and,
        on the DIA operator, each kernel loaded by one K solve from ``state``
        at ``Vd`` cut off after its entry matvec (``max_iterations = 0``;
        counted in ``k_solves`` and ``k_iterations`` as any solve). On every
        device the event loop the run takes is built, and on a card captured
        into its CUDA graph (``_capture_loops``): the serial loop, or with
        ``batched`` B the batched loop with B candidates and ``clock_f32``'s
        clocks, drawing from a throwaway generator. Under
        ``full_physics`` the lazy tables the run uses: ``current_tables``,
        ``power_band`` and, with the local heat model, ``local_heat``. On a
        card the CG programs the run takes are captured into ``cg_graphs``
        (``_capture_cgs``). No tensor of ``state`` changes and no stream is
        drawn from (akmc_tpu's ``warmup`` compiles its executables, while
        loops included, instead). On a card, on the serial path, the
        superstep program of ``steps_per_dispatch`` supersteps is built and
        captured (``_capture_program``), or with ``batched`` the batched
        production program (``_capture_production``, which then stands in for
        the batched loop: the run's ``KeyDraws`` source takes it). Returns
        the host seconds of each item. Under ``full_physics`` on a card the
        full-physics program of ``steps_per_dispatch`` supersteps is
        captured instead (``_capture_full``), warmed on ``state`` as it is
        (its CB edge as the caller last solved it), and the CB edge's
        program (``_capture_deck``). On a deck mode (the params'
        ``perturb_structure = 0``: fields only; else ``solve_potential =
        0`` without ``full_physics``: events only) its program instead of
        the superstep's."""
        out = {}
        p = self.params
        deck = ("fields" if not p.perturb_structure
                else "events_only" if not p.solve_potential and not full_physics else None)

        def timed(name, fn):
            t0 = time.perf_counter()
            fn()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            out[name] = time.perf_counter() - t0

        if self.device.type == "cuda":
            from akmc_tpu_torch.ops import cuda_build
            from akmc_tpu_torch.ops import dia_matvec
            from akmc_tpu_torch.solvers import dia_cg

            timed("cuda_build", lambda: cuda_build.build(
                [dia_matvec._KERNEL, dia_cg._KERNEL, "graph_while", "threefry", "pair_tiled"]
                + (["wkb_ct"] if full_physics else [])))
            if isinstance(self.kop, DiaK):
                timed("dia_kernels", lambda: self._empty_dia_solve(state, Vd))
        production = bool(batched) and self.device.type == "cuda" and self._programmed()
        if not production:
            timed(f"batched_B{batched}" if batched else "serial_loop",
                  lambda: self._capture_loops(state, batched, clock_f32))
        if full_physics:
            timed("current_tables", lambda: self.current_tables)
            timed("power_band", lambda: self.power_band)
            if self.params.solve_heating_local:
                timed("local_heat", lambda: self.local_heat)
        if self.device.type == "cuda":
            timed("cg_loops", lambda: self._capture_cgs(state, Vd, full_physics))
        programmed = self.device.type == "cuda" and self._programmed()
        if programmed and full_physics:
            timed("cb_edge_program", lambda: self._capture_deck("cb_edge", state, Vd))
        if programmed and deck:
            timed(f"{deck}_program", lambda: self._capture_deck(deck, state, Vd))
        elif production and not full_physics:
            timed(f"production_program_B{batched}",
                  lambda: self._capture_production(state, Vd, batched, clock_f32))
        elif programmed and full_physics:
            timed("full_program", lambda: self._capture_full(state, Vd, steps_per_dispatch))
        elif programmed and not batched:
            timed("superstep_program",
                  lambda: self._capture_program(state, Vd, steps_per_dispatch))
        self._cg_mark = self._cg_totals()
        return out

    def _capture_cgs(self, state: DeviceState, Vd: float, full_physics: bool) -> None:
        """Each CG a superstep of this model runs on one device, cut at
        ``max_iterations = 0`` so that its program is built and captured
        into ``cg_graphs`` at this model's shapes: the banded or ELL K solve
        (counted in ``k_solves`` and ``k_iterations`` as any solve) and,
        under ``full_physics``, the CB-edge and power solves and, with the
        local heat model, the steady heat solve (on zero power); the CB-edge
        solve only on the per-loop path. Under a mesh the CGs are host loops:
        nothing to capture."""
        if self.mesh is not None:
            return
        if not isinstance(self.kop, DiaK):
            self._solve_boundary(state.element, state.charge, state.potential_boundary, Vd,
                                 max_iterations=0)
        if not full_physics:
            return
        p, t = self.params, self.tables
        if not self._programmed():       # else the CB edge runs as a program (``warmup``)
            solve_cb_edge(state.element, state.charge, state.cb_edge, t.k_neigh_idx,
                          t.metal_or_edge, Vd, p.high_G * 100000, p.low_G,
                          p.num_atoms_first_layer, max_iterations=0, graphs=self.cg_graphs)
        m0 = torch.zeros(self.n_atom + 2, dtype=torch.float64, device=self.device)
        self._power(state.element, state.charge, state.cb_edge, m0, Vd, self.power_rtol_scale,
                    max_iterations=0)
        if p.solve_heating_local:
            update_temperature_local_steady(
                self.local_heat, state.temperature, torch.zeros_like(state.temperature),
                state.element, p.background_temp, p.nn_dist * 1e-10, p.k_th_interface,
                p.k_th_vacancies, graphs=self.cg_graphs)

    def _capture_loops(self, state: DeviceState, batched: int, clock_f32: bool) -> None:
        """The event loop a run takes, called once on a dead input (an
        all-zero rate table, no batch allowed or a waiting time of inf) so
        that its program is built, and on a card captured, into
        ``loop_graphs`` at the shapes of this model's supersteps: nothing
        fires. The batched loop is the one a ``KeyDraws`` source takes
        (the driver's), on a throwaway key."""
        t, dev = self.tables, self.device
        P = torch.zeros(t.act_neigh.shape, dtype=torch.float64, device=dev)
        etype = torch.zeros(t.act_neigh.shape, dtype=torch.int32, device=dev)
        ln_S = torch.zeros((), dtype=torch.float64, device=dev) if self.rate_normalize else None
        if batched:
            run_event_loop_batched(
                state.element, state.charge, P, etype, t.act_neigh,
                KeyDraws.seeded(0, dev), self.params.freq, batch=batched, max_batches=0,
                act_idx=t.act_idx, abs2act=t.abs2act, ln_S=ln_S, clock_f32=clock_f32,
                graphs=self.loop_graphs)
        else:
            run_event_loop(
                state.element, state.charge, P, etype, t.act_neigh,
                torch.zeros(RAND_CHUNK, dtype=torch.float64, device=dev), self.params.freq,
                t.act_idx, t.abs2act, t.act_zero_rows,
                event_time_in=torch.full((), math.inf, dtype=torch.float64, device=dev),
                ln_S=ln_S, incremental_select=self.event_select_incremental,
                graphs=self.loop_graphs)

    def _empty_dia_solve(self, state: DeviceState, Vd: float) -> None:
        """One DIA K solve of ``state`` cut off after its entry matvec: one
        launch of each kernel, which loads it (under a mesh: two launches of
        the row-window matvec)."""
        self._solve_boundary(state.element, state.charge, state.potential_boundary, Vd,
                             max_iterations=0)

    # ------------------------------------------------------------------
    # full physics: CB edge, current and dissipated power, heat
    # (update_power_gpu, current_solver_gpu.cu:2382-2573; heat_solver.cpp)
    # ------------------------------------------------------------------
    def update_cb_edge(self, state: DeviceState, Vd: float) -> DeviceState:
        """The conduction-band edge at bias ``Vd`` (once per bias point). As
        ``akmc_tpu`` runs it (``_cb_jit``): one program (``CbEdgeProgram``;
        on a card one CUDA graph, its CG a while node) and one read of its
        iteration count; without ``step_program`` (or under a mesh) the CG's
        device loop (host loop under a mesh), the same bits. ``cb_counts``
        counts which ran."""
        if self._programmed():
            prog = self._deck_program("cb_edge", state)
            out, d = self._dispatch(prog, state, Vd)
            self.cb_counts["runs"] += 1
            self.cb_iterations = int(d[0])
            return state.replace(cb_edge=out["cb_edge"])
        self.cb_counts["per_loop"] += 1
        p, t = self.params, self.tables
        with self._loop_spans("cb_edge"), profiling.span("cb_edge"):
            cb, res = solve_cb_edge(
                state.element, state.charge, state.cb_edge, t.k_neigh_idx, t.metal_or_edge,
                Vd, p.high_G * 100000, p.low_G, p.num_atoms_first_layer,
                shard=self._shard("int"), graphs=self.cg_graphs,
            )
        self.cb_iterations = res.iterations
        return state.replace(cb_edge=cb)

    @property
    def current_tables(self) -> CurrentTables:
        if self._current_tables is None:
            p, lat = self.params, self.lat
            pos = np.stack([lat.x, lat.y, lat.z], axis=1)
            # rail-tie counts are ATOM counts (create_X indexes the atom array,
            # current_solver_gpu.cu:2296-2306): grid-native crossbar slices
            # interleave NULL placeholder slots, so count the physical atoms of
            # the first and last slot slice
            L = p.num_atoms_first_layer
            not_atom = (int(ELEM.DEFECT), int(ELEM.OXYGEN_DEFECT), int(ELEM.NULL_ELEMENT))
            n_inj = int((~np.isin(lat.element0[:L], not_atom)).sum())
            n_ext = int((~np.isin(lat.element0[-L:], not_atom)).sum())
            self._current_tables = build_current_tables(
                lat.element0, pos, np.asarray(p.lattice), bool(p.pbc), p.nn_dist, p.metals,
                n_inj, n_ext, p.num_layers_contact, max_num_neighbors=p.max_num_neighbors,
            ).to(self.device)
        return self._current_tables

    @property
    def n_atom(self) -> int:
        return int(self.current_tables.atom_ind.shape[0])

    @property
    def power_band(self):
        """The static int8 band over the atom adjacency for ``solve_power``'s
        neighbor part (``build_power_band``; None: the gather operator)."""
        if not self._power_band_built:
            ct = self.current_tables
            built = build_power_band(
                ct, np.asarray(self.lat.element0)[ct.atom_ind.cpu().numpy()],
                self.params.high_G * 100000, self.params.low_G,
            )
            if built is not None:
                # the grounded (last) atom's slot in the band's frame, read once
                # here, on the host, so that no solve reads it
                self._power_grounded = int(built[0].inv_perm[self.n_atom - 1])
                self._power_band, self._power_band_meta = built[0].to(self.device), built[1]
                if self.mesh is not None:
                    from akmc_tpu_torch.parallel.mesh import _shard_band

                    self._power_band, self.shards["power_band"] = _shard_band(
                        self._power_band, self.mesh)
            self._power_band_built = True
        return self._power_band

    def _shard_power_system(self) -> Optional[PowerShard]:
        """Under a mesh, this rank's rows of the next power system: the
        compacted vacancy list (W_tt), the contact list (W_cc, W_ct), the
        atoms (G_nbr) and the power band's blocks, as ``build_power_system``
        and ``solve_power`` take them; None on one device. Each rank then
        holds about 1/ranks of the W bytes (akmc_tpu row-shards the same
        blocks, ``_shard_power_system`` there)."""
        if self.mesh is None:
            return None
        mesh, ct, n = self.mesh, self.current_tables, self.n_atom
        band = self.shards.get("power_band")
        T = None if band is None else self._power_band_meta.block_rows
        return PowerShard(
            mesh, vac=mesh.split(self.vmax), con=mesh.split(ct.contact_idx.shape[0]),
            atom=mesh.split(n), band=band,
            band_rows=None if band is None else [(min(a * T, n), min(b * T, n)) for a, b in band],
        )

    @property
    def local_heat(self) -> LocalHeat:
        if self._local_heat is None:
            self._local_heat = build_local_heat(
                self.lat.neigh_idx, self.lat.N, self.params.num_atoms_contact
            ).to(self.device)
        return self._local_heat

    def _power(self, element, charge, cb_edge, m_prev, Vd, rtol_scale, max_iterations=10000):
        """Current and dissipated power on (element, charge, cb_edge): (I_macro
        (0-d), site power (N,), m (N_atom+2,), CG iterations, whether the
        vacancies outnumber ``vmax``, akmc_tpu's ``pw_ovf``). ``Vd`` and
        ``rtol_scale``: floats or 0-d device tensors. ``power_timing`` keeps
        the energy-loop bounds and the iterations (inside a program,
        ``device_loop.in_program``, recorded for the program's read). The
        W-block build and the solve are the spans ``wkb_build`` and
        ``power_solve``."""
        p, ct = self.params, self.current_tables
        high_G = p.high_G * 100000          # kmc_main.cpp:294-302 constants
        loop_G = p.high_G * 10000000
        G0 = 2 * 3.8612e-5 * 1e-5
        tol = p.q * 0.01
        alpha = 1.0                          # kmc_main.cpp:302 (p.alpha unused)

        pband = self.power_band             # built on first use, outside the spans
        shard = self._shard_power_system()
        with profiling.span("wkb_build"):
            atom_elem = element[ct.atom_ind]
            atom_charge = charge[ct.atom_ind]
            ps, wkb = build_power_system(
                ct, atom_elem, atom_charge, cb_edge[ct.atom_ind], self._lattice_t,
                bool(p.pbc), p.nn_dist, high_G, p.low_G, loop_G, tol, p.m_e, p.V0,
                vmax=self.vmax, ne_max=self.ne_max, wkb_f32=self.wkb_f32, shard=shard,
            )
        self.power_bytes = {name: getattr(ps, name).numel() * getattr(ps, name).element_size()
                            for name in ("W_tt", "W_ct", "W_cc", "G_nbr")}
        with profiling.span("power_solve"):
            cvac = (atom_elem == int(ELEM.VACANCY)) & (atom_charge == 0)
            I_macro, atom_power, m, iters = solve_power(
                ct, ps, Vd, high_G, loop_G, G0, alpha, m_prev, atom_elem,
                band=pband, band_meta=self._power_band_meta if pband is not None else None,
                cvac=cvac, nn_dist=p.nn_dist, lattice=self._lattice_t, pbc=bool(p.pbc),
                rtol_scale=rtol_scale, shard=shard, max_iterations=max_iterations,
                graphs=self.cg_graphs, grounded=self._power_grounded,
            )
            site_power = torch.zeros(element.shape[0], dtype=atom_power.dtype,
                                     device=self.device)
            site_power[ct.atom_ind] = atom_power
        pw_ovf = torch.sum(atom_elem == int(ELEM.VACANCY)) > self.vmax
        bounds = wkb.ct_bounds
        if device_loop.in_program():
            def keep(v):
                self.power_timing = {"ct_loop_bounds": [int(b) for b in v[:-1]],
                                     "iterations": int(v[-1])}
            device_loop.record((*bounds, torch.as_tensor(iters, device=self.device)), keep)
            return I_macro, site_power, m, iters, pw_ovf
        self.power_timing = {"ct_loop_bounds": torch.stack(bounds).tolist() if bounds else [],
                             "iterations": iters}
        return I_macro, site_power, m, iters, pw_ovf

    def update_power(self, state: DeviceState, Vd: float, m_prev=None, rtol_scale=None):
        """Current and dissipated power on ``state``: (state with its power,
        I_macro [A], m, power CG iterations). ``vmax`` grows first if the
        vacancies outnumber it."""
        if m_prev is None:
            m_prev = torch.zeros(self.n_atom + 2, dtype=torch.float64, device=self.device)
        if rtol_scale is None:
            rtol_scale = self.power_rtol_scale
        while self._grow(False, bool(torch.sum(state.element == int(ELEM.VACANCY)) > self.vmax),
                         False):
            pass
        I_macro, site_power, m, iters, _ = self._power(
            state.element, state.charge, state.cb_edge, m_prev, Vd, rtol_scale)
        return state.replace(power=site_power), float(I_macro), m, iters

    def _heat(self, T_bg, temperature, site_power, element, event_time, event_time_h=None):
        """(T_bg, temperature) after the heat model over ``event_time`` (a 0-d
        device tensor): the global capacitative model if
        ``solve_heating_global``, else the local Laplacian model if
        ``solve_heating_local`` (steady state or transient by the reference's
        rule: chosen on the host from ``event_time_h``, the same time as read,
        where given; else as ``update_temperature_local_ref`` chooses), else
        both unchanged."""
        p = self.params
        with profiling.span("heat"):
            if p.solve_heating_global:
                T_bg = update_temperature_global(
                    T_bg, site_power, event_time, p.dissipation_constant,
                    p.background_temp, p.t_ox, p.A, p.c_p,
                )
            elif p.solve_heating_local:
                temperature = update_temperature_local_ref(
                    self.local_heat, temperature, site_power, element,
                    event_time if event_time_h is None else event_time_h, p.delta_t,
                    p.tau, p.background_temp, p.nn_dist * 1e-10, p.k_th_interface,
                    p.k_th_vacancies, graphs=self.cg_graphs,
                )
        return T_bg, temperature

    def update_temperature(self, state: DeviceState, event_time: float) -> DeviceState:
        """The heat update (Device::updateTemperature, heat_solver.cpp:55-97)
        on the state's power over ``event_time``."""
        T_bg, temperature = self._heat(
            state.T_bg, state.temperature, state.power, state.element,
            torch.tensor(float(event_time), dtype=torch.float64, device=self.device),
            float(event_time),
        )
        return state.replace(T_bg=T_bg, temperature=temperature)

    def superstep_full(
        self, state: DeviceState, Vd: float, stream, m_prev=None,
        rand_chunk: int = RAND_CHUNK, rtol_scale=None,
    ) -> Tuple[DeviceState, dict, torch.Tensor]:
        """The full-physics superstep, in the reference's module order
        (kmc_main.cpp:334-508): the fields, the current and dissipated power
        on this superstep's charge, the event loop to its end, the heat model
        over this superstep's event time. Returns (state', stats, m_warm):
        ``m_warm`` warm-starts the next power solve; ``rtol_scale`` (default
        ``power_rtol_scale``) tightens the power CG.

        As ``akmc_tpu``'s ``superstep_full`` runs it (``_step_full``, one
        executable): one program (``FullProgram``; on a card one CUDA graph)
        on a window of ``rand_chunk`` draws and one read of its 12
        diagnostics. On an overflow of a cap the exceeded caps double and the
        step is redone from the same inputs. If the window ran out before the
        superstep was done, the loop goes on in events-only chunks on the
        mutated table, as ``superstep`` does, and the heat model is applied
        again, on the host path, over the whole event time (the program's
        heat output is dropped). ``akmc_tpu`` instead throws such a step away
        and runs it again from the same cursor on a window four times larger
        (``akmc_tpu/models/vcm.py:1633-1638``); the two give the same events,
        draws and elements and the same heat up to the CGs' sum order
        (``tests/test_torch_full_program.py::test_window_runs_out_as_akmc_tpu``),
        and the continuation solves neither the fields nor the power again,
        so the port keeps it. Without ``step_program`` (or under a mesh):
        the per-loop path (``step_counts["per_loop"]``), the fields with
        their caps grown first, then each loop on its own; the same bits."""
        if m_prev is None:
            m_prev = torch.zeros(self.n_atom + 2, dtype=torch.float64, device=self.device)
        if rtol_scale is None:
            rtol_scale = self.power_rtol_scale
        if not self._programmed():
            self.step_counts["per_loop"] += 1
            new_state, stats, m_new, on_device = self._full_step(
                state, Vd, stream, m_prev, rand_chunk, rtol_scale)
            _add_full_stats(stats, on_device.tolist())
            return new_state, stats, m_new
        window = stream.peek(rand_chunk)
        while True:
            prog = self._full_program(state, 1, rand_chunk)
            out, (d,) = self._dispatch(prog, state, Vd, window, m_prev, rtol_scale)
            self.step_counts["runs"] += 1
            if not self._grow(d[5], d[6], d[11]):
                break
            self.step_counts["redos"] += 1
            self._drop_stale_programs()
        stream.advance(int(d[1]))
        n_events, ev_time, ev_h = int(d[0]), out["event_time"], d[2]
        element, charge = out["element"], out["charge"]
        T_bg, temperature, T_h = out["T_bg"], out["temperature"], d[8]
        if not d[3]:
            # then the heat model over the whole event time
            element, charge, n_events, ev_time, ev_h = self._continue(
                out, element, charge, n_events, ev_time, stream, rand_chunk)
            T_bg, temperature = self._heat(state.T_bg, state.temperature, out["power"],
                                           element, ev_time, ev_h)
            T_h = float(T_bg)
        self._count_cg_step()
        new_state = state.replace(
            element=element, charge=charge,
            potential_boundary=out["potential_boundary"],
            potential_charge=out["potential_charge"],
            kmc_time=state.kmc_time + ev_time, power=out["power"],
            temperature=temperature, T_bg=T_bg,
        )
        return new_state, _full_stats(n_events, ev_h, d, T_h), out["m"]

    def _full_step(self, state, Vd, stream, m_prev, rand_chunk, rtol_scale):
        """The per-loop path's full-physics superstep without the read of its
        device scalars: (state', stats, m, the (I_macro, T_bg, P_tot) tensor)."""
        with self._loop_spans():
            fr = self._fields_grown(state, Vd)
            I_macro, site_power, m_new, pow_iters, _ = self._power(
                state.element, fr.charge, state.cb_edge, m_prev, Vd, rtol_scale)
            res = self._events_to_the_end(state.element, fr.charge, fr.P, fr.etype, fr.ln_S,
                                          stream, rand_chunk)
            T_new, temp_new = self._heat(state.T_bg, state.temperature, site_power,
                                         res.element, res.event_time, res.event_time_h)
        new_state, stats = self._finish(state, fr, res, power_cg_iterations=pow_iters)
        new_state = new_state.replace(power=site_power, temperature=temp_new, T_bg=T_new)
        return new_state, stats, m_new, torch.stack([I_macro, T_new, torch.sum(site_power)])

    def superstep_full_multi(
        self, state: DeviceState, Vd: float, stream, k: int, m_prev=None,
        rand_chunk: int = 2048, rtol_scale=None,
    ) -> Tuple[DeviceState, list, torch.Tensor]:
        """k full-physics supersteps on one rand cursor, the power solve's warm
        start ``m`` threaded from each step to the next and ``rtol_scale``
        held for the batch: the same (state', stats list, m) as k sequential
        ``superstep_full(..., rand_chunk=rand_chunk)`` calls, under the
        batching contract of ``superstep_multi``.

        As akmc_tpu runs it: the k steps as one program (``FullProgram``; on
        a card one CUDA graph) on a buffer of k * ``rand_chunk`` draws and
        one read of the (k, 12) diagnostics; if any step ran out of its
        window or overflowed a cap, the batch is discarded (the stream was
        only peeked, the state not touched) and replayed step by step with
        ``superstep_full``. Without ``step_program`` (or under a mesh) the k
        steps run one after the other on the per-loop path, their I_macro,
        T_bg and P_tot read once at the end."""
        if m_prev is None:
            m_prev = torch.zeros(self.n_atom + 2, dtype=torch.float64, device=self.device)
        if rtol_scale is None:
            rtol_scale = self.power_rtol_scale
        if not self._programmed():
            self.step_counts["per_loop"] += 1
            stats_list, on_device = [], []
            m = m_prev
            for _ in range(k):
                state, stats, m, scalars = self._full_step(state, Vd, stream, m, rand_chunk,
                                                            rtol_scale)
                stats_list.append(stats)
                on_device.append(scalars)
            for stats, vals in zip(stats_list, torch.stack(on_device).tolist()):
                _add_full_stats(stats, vals)
            return state, stats_list, m
        prog = self._full_program(state, k, rand_chunk)
        out, diag = self._dispatch(prog, state, Vd, stream.peek(k * rand_chunk), m_prev,
                                   rtol_scale)
        self.step_counts["runs"] += 1
        if any(d[3] == 0.0 or d[5] or d[6] or d[11] for d in diag):
            self.step_counts["discards"] += 1
            stats_list = []
            for _ in range(k):
                state, stats, m_prev = self.superstep_full(state, Vd, stream, m_prev,
                                                           rand_chunk, rtol_scale)
                stats_list.append(stats)
            return state, stats_list, m_prev
        stream.advance(sum(int(d[1]) for d in diag))
        self._count_cg_step()
        new_state = state.replace(
            element=out["element"], charge=out["charge"],
            potential_boundary=out["potential_boundary"],
            potential_charge=out["potential_charge"], kmc_time=out["kmc_time"],
            power=out["power"], temperature=out["temperature"], T_bg=out["T_bg"],
        )
        return new_state, [_full_stats(int(d[0]), d[2], d, d[8]) for d in diag], out["m"]

    def _full_program(self, state: DeviceState, k: int, chunk: int) -> FullProgram:
        """The full-physics program of k supersteps on windows of ``chunk``
        draws at the current caps, built once per key: kind, k, chunk, caps
        (at the serial programs' places, ``_drop_stale_programs`` reads them
        there), the loops' steps per pass, the options its body reads, the
        state's types, the static tables' addresses and ``spans``."""
        from akmc_tpu_torch.solvers import current, heat

        t, p = self.tables, self.params
        key = ("full", k, chunk, self.qmax, self.vmax, self.pair_cand_cap,
               cg_mod.CG_NODE_K, events_mod.SERIAL_NODE_K, current.WKB_PASS_STEPS,
               heat.HEAT_PASS_STEPS, self._incremental_select(), self.pair_f32, self.wkb_f32,
               self.ne_max, bool(p.solve_heating_global), bool(p.solve_heating_local),
               self.power_band is None, state.element.dtype, state.charge.dtype,
               tuple((x.data_ptr(), tuple(x.shape)) for x in
                     (t.act_neigh, t.act_idx, t.abs2act, t.act_zero_rows)), self.spans)
        return self.step_graphs.get(key, lambda: FullProgram(self, state, k, chunk))

    def _build_heat_program(self, state: DeviceState) -> None:
        """Make the steady local heat solve's CG program as a program's body
        makes it, on zero power (a solve dead at entry), so that a capture
        finds it built: it runs under a ``device_loop.cond``, which a warm
        run may not take, and no program is made inside a captured body."""
        p = self.params
        with device_loop.recording(device_loop.Recording()):
            update_temperature_local_steady(
                self.local_heat, state.temperature, torch.zeros_like(state.temperature),
                state.element, p.background_temp, p.nn_dist * 1e-10, p.k_th_interface,
                p.k_th_vacancies, graphs=self.cg_graphs)

    def _capture_full(self, state: DeviceState, Vd: float, k: int) -> FullProgram:
        """Build, and on a card capture, the full-physics program
        ``superstep_full`` (k = 1) or ``superstep_full_multi`` (k > 1) takes
        next, on their default windows, warmed on ``state``, a window of
        zeros and a zero warm start. Changes no state."""
        chunk = RAND_CHUNK if k == 1 else 2048
        prog = self._full_program(state, k, chunk)
        prog.load(state, Vd, np.zeros(k * chunk),
                       torch.zeros(self.n_atom + 2, dtype=torch.float64, device=self.device),
                       self.power_rtol_scale)
        prog.capture()
        return prog


def _full_stats(n_events: int, event_time: float, d, T_bg: float) -> dict:
    """A programmed full-physics superstep's stats from its diagnostics
    ``d``, in akmc_tpu's key order."""
    return {"n_events": n_events, "event_time": event_time, "cg_iterations": int(d[4]),
            "I_macro": d[7], "T_bg": T_bg, "power_cg_iterations": int(d[9]), "P_tot": d[10]}


def _add_full_stats(stats: dict, vals) -> None:
    """A full-physics superstep's stats with its (I_macro, T_bg, P_tot)
    values, in akmc_tpu's key order."""
    I_h, T_h, P_h = vals
    iters = stats.pop("power_cg_iterations")
    stats.update(I_macro=I_h, T_bg=T_h, power_cg_iterations=iters, P_tot=P_h)


def _max_in_reach_count(
    cen: np.ndarray, pos_q: np.ndarray, reach: float, budget: int = 1024
) -> int:
    """max over tile centers of |{q : |q - center| < reach}| without the
    O(T*Q) all-pairs count.

    Branch and bound: bucket the Q points on a grid of cell edge reach/2
    (every in-reach point of a center lies in the center's 5^3-cell
    window, so the window count upper-bounds the tile's), then count
    exactly in DESCENDING upper-bound order, stopping as soon as the best
    exact count meets the next tile's bound — exact when it stops, and an
    underestimate only if the ``budget`` backstop trips first. The
    backstop case is a near-uniform charged field, where tile maxima are
    near-ties and the top-``budget`` sample tracks the global max
    closely; the 1.5x sizing margin plus the runtime candidate-cap
    overflow growth cover the residual. Counting runs in f32 above 1e7
    pair evaluations (a +-1 count at the fp boundary is irrelevant to a
    cap)."""
    cen = np.asarray(cen)
    h = reach / 2.0
    lo = pos_q.min(axis=0)
    ci = np.floor((pos_q - lo) / h).astype(np.int64)
    dims = ci.max(axis=0) + 1
    ub = None
    if int(np.prod(dims + 4)) <= int(1e8):
        grid = np.zeros(tuple(dims), np.int64)
        np.add.at(grid, tuple(ci.T), 1)
        pad = np.pad(grid, 2)
        nb = np.zeros_like(grid)
        for dx in range(5):
            for dy in range(5):
                for dz in range(5):
                    nb += pad[dx:dx + dims[0], dy:dy + dims[1], dz:dz + dims[2]]
        # a center outside the charged bbox clips to a border cell whose
        # window contains every point within reach of it (all points live
        # inside the bbox), so the bound stays valid
        tcell = np.clip(np.floor((cen - lo) / h).astype(np.int64), 0, dims - 1)
        ub = nb[tuple(tcell.T)]
        order = np.argsort(-ub)
    else:                                    # degenerate tiny-reach case
        order = np.arange(cen.shape[0])
    mx = 0
    chunk = max(1, min(256, int(2e8 // max(1, pos_q.shape[0]))))
    dt = np.float32 if chunk * pos_q.shape[0] > int(1e7) else np.float64
    pq = pos_q.astype(dt)
    cen_d = cen.astype(dt)
    qq2 = (pq * pq).sum(axis=1)
    qT = pq.T.copy()
    for s in range(0, order.shape[0], chunk):
        if ub is not None and s > 0 and mx >= int(ub[order[s]]):
            break                            # proven exact
        if ub is not None and s >= budget:
            break                            # approximate: growth path
        cc = cen_d[order[s:s + chunk]]
        # |c-q|^2 = |c|^2 + |q|^2 - 2 c.q as one matrix product
        d2q = (cc * cc).sum(axis=1)[:, None] + qq2[None, :] - 2.0 * (cc @ qT)
        mx = max(mx, int((d2q < dt(reach * reach)).sum(axis=1).max()))
    return mx
