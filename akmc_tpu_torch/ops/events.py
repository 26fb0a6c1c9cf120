"""KMC event engine: rate-table build + residence-time loop.

Reference: kmc_events.cu. The (site, neighbor-slot) rate table follows
build_event_list_split (kmc_events.cu:130-229); the loop follows the
committed path of execute_kmc_step_mpi (kmc_events.cu:448-516), as
``akmc_tpu/ops/events.py`` does:
  * the loop runs while the LAST single-event waiting time < 1/freq,
  * each iteration executes an event first and draws its waiting time after,
  * the returned event_time is the final (loop-breaking) waiting time, which
    the driver adds to kmc_time.

Selection is two-level (block sums over 256 rows, cumsum over the blocks,
cumsum inside the chosen block), and after an event only the rows that can
hold a pair touching the two changed sites are zeroed — the reference's
zero-out semantics (zero_out_events_split, kmc_events.cu:247-266).

The loop is a host loop over device tensors: every event ends with one
read of (ok, waiting time) back to the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from akmc_tpu_torch.config import KB_EV
from akmc_tpu_torch.lattice import ELEM, EVENT

_EPS_OVERFLOW = 1e-200   # exponential overflow guard (kmc_events.cu:150)
_BLK = 256


def build_event_table(
    element: torch.Tensor,     # (N,) int32
    charge: torch.Tensor,      # (N,) int32
    potential: torch.Tensor,   # (N,) f64 summed site potential [V]
    T_bg: torch.Tensor,        # () f64 [K]
    neigh_idx: torch.Tensor,   # (R, NN) int64 absolute neighbor ids, -1 padded
    self2_nn: torch.Tensor,    # (R, NN) f64 v_solve(d_ij, 2) [V] (static)
    layer_nbr: torch.Tensor,   # (R, NN) int64 layer id of neighbor (static)
    E_gen: torch.Tensor,       # (num_layers,) f64 [eV] per-layer energies
    E_rec: torch.Tensor,
    E_Vdiff: torch.Tensor,
    E_Odiff: torch.Tensor,
    freq: float,
    rows: torch.Tensor,        # (R,) int64 absolute site of each row, -1 padded
    normalize: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Rates P (R, NN) f64, event types (R, NN) int32 and ln_S.

    The table is compacted to the statically event-capable rows ``rows``
    (element in {DEFECT, O, V, Od}, a set closed under every event type).
    Distances are non-PBC; the field term comes from the summed potential.

    ``normalize=False``: P = freq / (exp(EA / kB T_bg) + 1e-200), ln_S None.
    ``normalize=True``: shifted-exponent rates P~ = exp(z_min - z) <= 1 with
    z = EA / kB T_bg (same selection order, sums bounded by the row count)
    and the log scale ln_S = ln(freq) - z_min, from which the event loop
    rebuilds waiting times in log space."""
    f64 = potential.dtype
    valid = neigh_idx >= 0
    j = neigh_idx.clamp(min=0)
    rc = rows.clamp(min=0)     # -1 pad rows read site 0; killed by `valid`
    ei = element[rc][:, None]
    qi = charge[rc][:, None].to(f64)
    pot_i = potential[rc][:, None]

    codej = (element * 4 + (torch.div(charge, 2, rounding_mode="floor") + 1))[j]
    ej = torch.div(codej, 4, rounding_mode="floor")
    qj = ((codej % 4) - 1).to(f64) * 2.0
    phi = pot_i - potential[j]

    is_gen = (ei == int(ELEM.DEFECT)) & (ej == int(ELEM.O))
    is_rec = (ei == int(ELEM.OXYGEN_DEFECT)) & (ej == int(ELEM.VACANCY))
    is_vdiff = (ei == int(ELEM.VACANCY)) & (ej == int(ELEM.O))
    is_odiff = (ei == int(ELEM.OXYGEN_DEFECT)) & (ej == int(ELEM.DEFECT))

    # v_solve is linear in charge and distances are static: the erfc kernel
    # is precomputed as self2_nn = v_solve(d, 2)
    self_2 = self2_nn
    self_qi = (qi / 2.0) * self2_nn

    # zero-field activation energies by the NEIGHBOR's layer
    # (kmc_events.cu:162, 178, 199, 217)
    Eg = E_gen[layer_nbr]
    Er = E_rec[layer_nbr]
    Ev = E_Vdiff[layer_nbr]
    Eo = E_Odiff[layer_nbr]

    cs = qi - qj
    E_gen_t = 2.0 * phi
    E_rec_t = cs * (phi + (cs / 2.0) * self_2)
    E_vdiff_t = cs * (phi + torch.where(qi != 0, self_qi, 0.0))
    E_odiff_t = cs * (phi - torch.where(qi != 0, self_2, 0.0))

    EA = torch.where(
        is_gen, Eg - E_gen_t,
        torch.where(
            is_rec, Er - E_rec_t,
            torch.where(is_vdiff, Ev - E_vdiff_t, Eo - E_odiff_t),
        ),
    )

    any_event = (is_gen | is_rec | is_vdiff | is_odiff) & valid
    kT = KB_EV * T_bg
    ln_S = None
    if not normalize:
        P = freq * (1.0 / (torch.exp(EA / kT) + _EPS_OVERFLOW))
        P = torch.where(any_event, P, 0.0)
    else:
        z = EA / kT
        z_min = torch.min(torch.where(any_event, z, math.inf))
        z_min = torch.where(torch.isfinite(z_min), z_min, 0.0)
        P = torch.where(any_event, torch.exp(z_min - z), 0.0)
        ln_S = math.log(freq) - z_min

    null = torch.full_like(neigh_idx, int(EVENT.NULL_EVENT), dtype=torch.int32)
    etype = torch.where(
        is_gen, int(EVENT.VACANCY_GENERATION),
        torch.where(
            is_rec, int(EVENT.VACANCY_RECOMBINATION),
            torch.where(
                is_vdiff, int(EVENT.VACANCY_DIFFUSION),
                torch.where(is_odiff, int(EVENT.ION_DIFFUSION), null),
            ),
        ),
    )
    etype = torch.where(any_event, etype, null)
    return P, etype, ln_S


def _select_site(R: torch.Tensor, r_sel: torch.Tensor):
    """Two-level site selection over the row sums R (len a multiple of 256):
    block partial sums, cumsum over the blocks, cumsum inside the selected
    block — searchsorted(cumsum(R), r_sel*total, right) up to the
    reassociated partial sums. Returns (site, prev_cum_below_site, total,
    target), all 0-d device tensors."""
    n = R.shape[0]
    if n % _BLK:
        raise ValueError(f"event table rows ({n}) must be a multiple of {_BLK}")
    bs = torch.sum(R.reshape(n // _BLK, _BLK), dim=1)
    return _select_site_bs(R, bs, r_sel)


def _select_site_bs(R: torch.Tensor, bs: torch.Tensor, r_sel: torch.Tensor):
    """Second level of the selection given the block partial sums."""
    nb = bs.shape[0]
    cumb = torch.cumsum(bs, dim=0)
    total = cumb[-1]
    target = r_sel * total
    blk = torch.searchsorted(cumb, target, right=True).clamp(0, nb - 1)
    prev_b = torch.where(blk > 0, cumb[(blk - 1).clamp(min=0)], 0.0)
    cumr = torch.cumsum(R.reshape(nb, _BLK)[blk], dim=0)
    off = torch.searchsorted(cumr, target - prev_b, right=True).clamp(0, _BLK - 1)
    site = blk * _BLK + off
    prev = prev_b + torch.where(off > 0, cumr[(off - 1).clamp(min=0)], 0.0)
    return site, prev, total, target


# packed element+charge codes (code = element*4 + charge//2 + 1) of the
# fixed event outcomes (execute_event, kmc_events.cu:292-331)
_CODE_OD_NEG = int(ELEM.OXYGEN_DEFECT) * 4 + 0   # Od, q=-2
_CODE_V_POS = int(ELEM.VACANCY) * 4 + 2          # V,  q=+2
_CODE_D_0 = int(ELEM.DEFECT) * 4 + 1             # d,  q=0
_CODE_O_0 = int(ELEM.O) * 4 + 1                  # O,  q=0


def _execute_event_code(code, isel, jsel, etype):
    """Apply an executed event to the packed code vector (a new tensor):
    generation and recombination write fixed codes, diffusions swap."""
    ci = code[isel]
    cj = code[jsel]
    gen = etype == int(EVENT.VACANCY_GENERATION)
    rec = etype == int(EVENT.VACANCY_RECOMBINATION)
    swap = (etype == int(EVENT.VACANCY_DIFFUSION)) | (etype == int(EVENT.ION_DIFFUSION))
    new_ci = torch.where(gen, _CODE_OD_NEG, torch.where(rec, _CODE_D_0, torch.where(swap, cj, ci)))
    new_cj = torch.where(gen, _CODE_V_POS, torch.where(rec, _CODE_O_0, torch.where(swap, ci, cj)))
    code = code.clone()
    code[isel] = new_ci.to(code.dtype)
    code[jsel] = new_cj.to(code.dtype)
    return code


class EventLoopResult(NamedTuple):
    element: torch.Tensor
    charge: torch.Tensor
    P: torch.Tensor           # the rate table, zeroed in place by the loop
    event_time: torch.Tensor  # () final (loop-breaking) waiting time [s]
    n_events: int             # events executed in this chunk
    draws_used: int           # rands consumed
    done: bool                # superstep finished (vs. buffer exhausted)


def run_event_loop(
    element: torch.Tensor,     # (N,) int32
    charge: torch.Tensor,      # (N,) int32
    P: torch.Tensor,           # (R, NN) rate table — updated IN PLACE
    etype: torch.Tensor,       # (R, NN) int32 event types
    neigh_idx: torch.Tensor,   # (R, NN) int64 absolute neighbor ids
    rand_buf: torch.Tensor,    # (L,) f64 uniform draws on P's device
    freq: float,
    act_idx: torch.Tensor,     # (R,) int64 absolute site per row, -1 padded
    abs2act: torch.Tensor,     # (N,) int64 site -> row (all-zero pad row if none)
    zero_rows: torch.Tensor,   # (R, 1+NN) int64 static zero-out rows {r} ∪ abs2act[neigh[r]]
    event_time_in: Optional[torch.Tensor] = None,
    ln_S: Optional[torch.Tensor] = None,
) -> EventLoopResult:
    """Residence-time loop (execute_kmc_step_mpi, kmc_events.cu:430-528).

    Runs until the latest single-event waiting time reaches 1/freq, or the
    rand buffer is exhausted (the caller then refills and resumes with
    ``event_time_in`` and the returned P)."""
    nn = P.shape[1]
    buf_len = rand_buf.shape[0]
    inv_freq = 1.0 / freq
    R = torch.sum(P, dim=1)
    code = element * 4 + (torch.div(charge, 2, rounding_mode="floor") + 1)
    if event_time_in is None:
        ev_time = torch.zeros((), dtype=P.dtype, device=P.device)
    else:
        ev_time = event_time_in
    ev_h = float(ev_time)
    cnt = 0
    n_ev = 0
    while ev_h < inv_freq and cnt + 2 <= buf_len:
        site, prev, total, target = _select_site(R, rand_buf[cnt])
        rowcum = torch.cumsum(P[site], dim=0)
        slot = torch.searchsorted(rowcum, target - prev, right=True).clamp(0, nn - 1)
        isel = act_idx[site].clamp(min=0)
        jsel = neigh_idx[site, slot].clamp(min=0)
        ok = total > 0.0

        code = torch.where(ok, _execute_event_code(code, isel, jsel, etype[site, slot]), code)

        # zero out every pair involving isel or jsel: the two sites' rows
        # and their neighbors' rows (duplicates write identical values)
        jrow = abs2act[jsel]
        ar = torch.cat([zero_rows[site], zero_rows[jrow]])
        rows_P = P[ar]
        rows_nbr = neigh_idx[ar]
        kill = (
            (ar == site)[:, None]
            | (ar == jrow)[:, None]
            | (rows_nbr == isel)
            | (rows_nbr == jsel)
        )
        new_rows = torch.where(kill & ok, 0.0, rows_P)
        P[ar] = new_rows
        R[ar] = torch.sum(new_rows, dim=1)

        r_time = rand_buf[cnt + 1]
        if ln_S is None:
            ev_time = torch.where(ok, -torch.log(r_time) / total, math.inf)
        else:
            # -ln(r) / (S * total~) in log space: S itself may be out of range
            ev_time = torch.where(
                ok,
                torch.exp(
                    torch.log(-torch.log(r_time))
                    - torch.log(torch.where(ok, total, 1.0)) - ln_S
                ),
                math.inf,
            )
        ok_h, ev_h = torch.stack([ok.to(P.dtype), ev_time]).tolist()
        # a total-rate-0 iteration executes nothing, consumes no draws and
        # ends the loop through ev_time = inf
        if ok_h:
            cnt += 2
            n_ev += 1
    return EventLoopResult(
        element=torch.div(code, 4, rounding_mode="floor").to(element.dtype),
        charge=(((code % 4) - 1) * 2).to(charge.dtype),
        P=P,
        event_time=ev_time,
        n_events=n_ev,
        draws_used=cnt,
        done=ev_h >= inv_freq,
    )
