"""The valence-change-memory (VCM) device model on PyTorch.

One KMC superstep (reference module sequence, kmc_main.cpp:328-540):

    charge update -> K-system CG boundary potential (DIA operator, the
    whole CG as one CUDA kernel) -> pairwise Coulomb potential (static table) ->
    potential sum -> rate table -> residence-time event loop

``VCMModel`` owns the static tables as tensors on its device;
``DeviceState`` carries the dynamic fields. This is the committed-parity
path of ``akmc_tpu/models/vcm.py::VCMModel.superstep`` on grid-native
structures.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from scipy.special import erfc

from akmc_tpu_torch.config import KMCParameters
from akmc_tpu_torch.device import resolve_device
from akmc_tpu_torch.lattice import ELEM, Lattice, metal_mask
from akmc_tpu_torch.ops.charge import update_charge_compact
from akmc_tpu_torch.ops.events import build_event_table, run_event_loop
from akmc_tpu_torch.ops.pairwise import build_pair_table, pairwise_potential_table
from akmc_tpu_torch.solvers.dia import build_dia_k, solve_potential_boundary_dia
from akmc_tpu_torch.state import DeviceState

_ACTIVE = (ELEM.DEFECT, ELEM.O, ELEM.VACANCY, ELEM.OXYGEN_DEFECT)


@dataclass
class StaticTables:
    """Static per-structure tensors on the model's device."""

    pos: torch.Tensor            # (N, 3) f64
    neigh_idx: torch.Tensor      # (N, NN) int64, -1 padded
    any_metal_nbr: torch.Tensor  # (N,) bool
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
    pair_table: torch.Tensor     # (NP_pad, N) f64 static pairwise table


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


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class VCMModel:
    """Static data + physics for one grid-native device structure."""

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
    ):
        """``qmax``/``vmax``: static caps on the charged and vacancy counts
        (sized from the initial population; doubled on overflow).
        ``rate_normalize``: shifted-exponent rates + log-space waiting
        times. ``pair_table_budget``: largest static pairwise table [bytes]."""
        self.params, self.lat = params, lat
        self.device = dev = resolve_device(device)
        self.rate_normalize = bool(rate_normalize)
        p = params
        i64 = dict(dtype=torch.int64, device=dev)
        f64 = dict(dtype=torch.float64, device=dev)

        pos_np = np.stack([lat.x, lat.y, lat.z], axis=1)
        is_metal_np = metal_mask(lat.element0, p.metals)
        jc = np.clip(lat.neigh_idx, 0, None)

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

        if not 0 < len(act) * lat.N * 8 <= pair_table_budget:
            raise NotImplementedError(
                "the static pairwise table does not fit pair_table_budget; the "
                "on-the-fly and tiled pairwise paths are not ported yet: "
                "ROADMAP queue 1, 'pairwise_potential and the tiled pairwise path'"
            )
        pos_t = torch.as_tensor(pos_np, **f64)
        layers = p.layers
        self.tables = StaticTables(
            pos=pos_t,
            neigh_idx=torch.as_tensor(lat.neigh_idx, **i64),
            any_metal_nbr=torch.as_tensor(
                (is_metal_np[jc] & (lat.neigh_idx >= 0)).any(axis=1), device=dev
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
            pair_table=build_pair_table(
                pos_t, torch.as_tensor(act, **i64), p.cutoff_radius, p.sigma, p.k
            ),
        )

        if lat.grid is not None and not lat.pbc:
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
        if built is None:
            raise NotImplementedError(
                "this structure has no DIA form (too many K offsets); the banded "
                "and ELL K operators are not ported yet: ROADMAP queue 1, "
                "'the banded and ELL K operators with the 5 nm main path'"
            )
        dia, self.dia_meta = built
        self.dia = dia.to(dev)

    # ------------------------------------------------------------------
    def _build_rates(self, element, charge, pot_sum, T_bg):
        t, p = self.tables, self.params
        return build_event_table(
            element, charge, pot_sum, T_bg,
            t.act_neigh, t.act_self2, t.act_layer,
            t.E_gen, t.E_rec, t.E_Vdiff, t.E_Odiff,
            p.freq, rows=t.act_idx, normalize=self.rate_normalize,
        )

    def _fields(self, element, charge, potential_boundary_prev, T_bg, Vd) -> FieldsResult:
        t, p = self.tables, self.params
        v_overflow = torch.sum(element == int(ELEM.VACANCY)) > self.vmax
        charge = update_charge_compact(
            element, charge, t.neigh_idx, t.any_metal_nbr, self.vmax
        )
        pot_boundary, cg = solve_potential_boundary_dia(
            self.dia, self.dia_meta, element, charge, potential_boundary_prev, Vd,
            p.high_G, p.low_G, p.num_atoms_first_layer,
        )
        pot_pair, q_overflow = pairwise_potential_table(
            t.pair_table, t.abs2act, charge, self.qmax
        )
        pot_sum = pot_pair + pot_boundary   # sum_AB_into_A (psg.cu:1130-1151)
        P, etype, ln_S = self._build_rates(element, charge, pot_sum, T_bg)
        return FieldsResult(
            charge=charge, potential_boundary=pot_boundary, potential_sum=pot_sum,
            P=P, etype=etype, cg_iterations=cg.iterations,
            q_overflow=q_overflow, v_overflow=v_overflow, ln_S=ln_S,
        )

    def _events(self, element, charge, P, etype, stream, rand_chunk,
                event_time_in=None, ln_S=None):
        t = self.tables
        rand_buf = torch.as_tensor(stream.peek(rand_chunk), dtype=torch.float64,
                                   device=self.device)
        res = run_event_loop(
            element, charge, P, etype, t.act_neigh, rand_buf, self.params.freq,
            t.act_idx, t.abs2act, t.act_zero_rows,
            event_time_in=event_time_in, ln_S=ln_S,
        )
        stream.advance(res.draws_used)
        return res

    def superstep(
        self, state: DeviceState, Vd: float, stream, rand_chunk: int = 8192
    ) -> Tuple[DeviceState, dict]:
        """One full KMC superstep. ``stream`` is a ``rng.BufferedStream``
        over the KMC mt19937 stream; it advances by exactly the draws the
        event loop used. On a qmax/vmax overflow the caps double and the
        fields are recomputed from the same inputs."""
        while True:
            fr = self._fields(
                state.element, state.charge, state.potential_boundary, state.T_bg, Vd
            )
            q_ovf, v_ovf = torch.stack([fr.q_overflow, fr.v_overflow]).tolist()
            if not (q_ovf or v_ovf):
                break
            if q_ovf:
                self.qmax *= 2
            if v_ovf:
                self.vmax *= 2

        res = self._events(state.element, fr.charge, fr.P, fr.etype, stream,
                           rand_chunk, ln_S=fr.ln_S)
        n_events = res.n_events
        while not res.done:
            # the rand buffer ran out mid-superstep: continue with the
            # mutated table and the carried waiting time
            res = self._events(res.element, res.charge, res.P, fr.etype, stream,
                               rand_chunk, event_time_in=res.event_time, ln_S=fr.ln_S)
            n_events += res.n_events

        new_state = state.replace(
            element=res.element,
            charge=res.charge,
            potential_boundary=fr.potential_boundary,
            potential_charge=fr.potential_sum,
            kmc_time=state.kmc_time + res.event_time,
        )
        stats = {
            "n_events": n_events,
            "event_time": float(res.event_time),
            "cg_iterations": fr.cg_iterations,
        }
        return new_state, stats
