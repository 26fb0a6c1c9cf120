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

Three loops share that machinery. ``run_event_loop`` draws from a buffer of
the replicated mt19937 stream (reference-stream parity). ``run_event_loop_native``
is the same serial law on a draws source (``akmc_tpu``'s threefry key in
production, ``ops/threefry.py::KeyDraws``; a device generator; a replay).
``run_event_loop_batched`` fires many events per iteration through the
exponential-race formulation, the loop the crossbar-scale runs use.

Each loop keeps its state on the device and runs k guarded steps between two
host reads of one packed vector of flags and counters
(``ops/device_loop.py``): on a card the k steps are one CUDA graph, replayed;
on the CPU they run eagerly. ``akmc_tpu`` runs the same loops as one
``lax.while_loop`` each. The host loops they replace stay as the plain
versions (``run_event_loop_plain``, ``run_event_loop_native_plain``,
``run_event_loop_batched_plain``: one read per event or per batch); the tests
and ``chip_smoke.py`` hold each device loop bit-equal to its plain loop.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from akmc_tpu_torch.config import KB_EV, Q_C
from akmc_tpu_torch.lattice import ELEM, EVENT
from akmc_tpu_torch.ops import device_loop, threefry
from akmc_tpu_torch.ops.device_loop import GraphLoop, Prefill, program
from akmc_tpu_torch.ops.threefry import KeyDraws
from akmc_tpu_torch.runtime import profiling

_EPS_OVERFLOW = 1e-200   # exponential overflow guard (kmc_events.cu:150)
_BLK = 256


def v_solve(d: torch.Tensor, charge, sigma, k) -> torch.Tensor:
    """Screened point-charge potential [V], d in meters (v_solve_gpu,
    gpu_solvers.h:321-327). The rate table and the pair potentials inline
    it: ``VCMModel``'s ``act_self2`` is v_solve(d, 2)."""
    root2 = torch.sqrt(torch.tensor(2.0, dtype=d.dtype, device=d.device))
    return charge * torch.special.erfc(d / (sigma * root2)) * k * Q_C / d


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
    reduce_min=None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Rates P (R, NN) f64, event types (R, NN) int32 and ln_S.

    The table is compacted to the statically event-capable rows ``rows``
    (element in {DEFECT, O, V, Od}, a set closed under every event type).
    Distances are non-PBC; the field term comes from the summed potential.

    ``normalize=False``: P = freq / (exp(EA / kB T_bg) + 1e-200), ln_S None.
    ``normalize=True``: shifted-exponent rates P~ = exp(z_min - z) <= 1 with
    z = EA / kB T_bg (same selection order, sums bounded by the row count)
    and the log scale ln_S = ln(freq) - z_min, from which the event loop
    rebuilds waiting times in log space. ``reduce_min``: where ``rows`` are a
    rank's share of the table, the function that turns this share's z_min
    into the whole table's (the minimum over ranks)."""
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
        if reduce_min is not None:
            z_min = reduce_min(z_min)
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


def _cumsum(v: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a vector in one association on every device
    and in every run: rows of 256 each scanned along the row, then the row
    totals (recursively), each row's exclusive offset added once. A 1-D
    ``torch.cumsum`` of more than one tile runs CUB's decoupled look-back on
    a card, whose association of floats depends on timing (a graph's replay
    and an eager run differ in the last bits); a scan along the rows of a
    matrix does not. On the CPU, up to 256 entries, it is ``torch.cumsum``
    bit for bit."""
    n = v.shape[0]
    if n <= _BLK:
        return torch.cumsum(v.reshape(1, n), dim=1).reshape(n)
    m = -(-n // _BLK)
    rows = torch.cat([v, v.new_zeros(m * _BLK - n)]).reshape(m, _BLK)
    inner = torch.cumsum(rows, dim=1)
    offsets = torch.cat([v.new_zeros(1), _cumsum(inner[:, -1])[:-1]])
    return (offsets[:, None] + inner).reshape(-1)[:n]


def _row(table: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``table[i]`` for a 0-d index tensor ``i`` on the tensors' device.
    Plain indexing with a 0-d tensor reads it back to the host first (one
    device synchronisation per index); ``index_select`` and ``torch.take``
    (for single entries: ``torch.take(table, flat_index)``) do not."""
    return table.index_select(0, i.reshape(1)).squeeze(0)


# PyTorch's CUDA reduction lays its threads out by the number of rows it
# reduces, and from 16 rows up that layout, and so each row's summation order,
# no longer changes
_MIN_BLOCK_ROWS = 16


def _block_sums(R: torch.Tensor, blocks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Partial sums of R over its 256-row blocks: all of them, or the
    ``blocks`` listed (at least _MIN_BLOCK_ROWS of them, repeats allowed).
    Either way one row reduction of a (k, 256) matrix with k >= 16 or k the
    whole block count, so a block's sum has the same bits whichever way it
    is taken, on the CPU and on the card."""
    R2 = R.reshape(-1, _BLK)
    if blocks is not None:
        R2 = R2.index_select(0, blocks)
    return torch.sum(R2, dim=1)


def _refresh_block_sums(bs: torch.Tensor, R: torch.Tensor, rows: torch.Tensor,
                        live: Optional[torch.Tensor] = None) -> None:
    """Bring the carried block sums ``bs`` up to date, in place, after the
    ``rows`` of R changed: only the blocks of those rows are summed again.
    Fewer blocks than _MIN_BLOCK_ROWS in all are summed whole, as the fresh
    selection sums them. ``live`` (0-d bool on the device): a false one
    keeps ``bs`` as it is."""
    if bs.shape[0] < _MIN_BLOCK_ROWS:
        new = _block_sums(R)
        bs.copy_(new if live is None else torch.where(live, new, bs))
        return
    blk = torch.div(rows, _BLK, rounding_mode="floor")
    if blk.shape[0] < _MIN_BLOCK_ROWS:
        blk = torch.cat([blk, blk[:1].expand(_MIN_BLOCK_ROWS - blk.shape[0])])
    new = _block_sums(R, blk)
    if live is not None:
        new = torch.where(live, new, bs.index_select(0, blk))
    bs.index_copy_(0, blk, new)


def _select_site(R: torch.Tensor, r_sel: torch.Tensor, bs: Optional[torch.Tensor] = None):
    """Site selection over the row sums R. With len(R) a multiple of 256 it is
    two-level: block partial sums (``bs`` where the caller carries them, else
    summed here), cumsum over the blocks, cumsum inside the selected block —
    searchsorted(cumsum(R), r_sel*total, right) up to the reassociated
    partial sums; any other length takes that full-length cumsum itself.
    Returns (site, prev_cum_below_site, total, target), all 0-d device
    tensors."""
    n = R.shape[0]
    if n % _BLK:
        cum = _cumsum(R)
        total = cum[-1]
        target = r_sel * total
        site = torch.searchsorted(cum, target, right=True).clamp(0, n - 1)
        prev = torch.where(site > 0, torch.take(cum, (site - 1).clamp(min=0)), 0.0)
        return site, prev, total, target
    return _select_site_bs(R, _block_sums(R) if bs is None else bs, r_sel)


def _select_site_bs(R: torch.Tensor, bs: torch.Tensor, r_sel: torch.Tensor):
    """Second level of the selection given the block partial sums."""
    nb = bs.shape[0]
    cumb = _cumsum(bs)
    total = cumb[-1]
    target = r_sel * total
    blk = torch.searchsorted(cumb, target, right=True).clamp(0, nb - 1)
    prev_b = torch.where(blk > 0, torch.take(cumb, (blk - 1).clamp(min=0)), 0.0)
    cumr = _cumsum(_row(R.reshape(nb, _BLK), blk))
    off = torch.searchsorted(cumr, target - prev_b, right=True).clamp(0, _BLK - 1)
    site = blk * _BLK + off
    prev = prev_b + torch.where(off > 0, torch.take(cumr, (off - 1).clamp(min=0)), 0.0)
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
    ij = torch.stack([isel, jsel])
    ci, cj = torch.take(code, ij)
    gen = etype == int(EVENT.VACANCY_GENERATION)
    rec = etype == int(EVENT.VACANCY_RECOMBINATION)
    swap = (etype == int(EVENT.VACANCY_DIFFUSION)) | (etype == int(EVENT.ION_DIFFUSION))
    new_ci = torch.where(gen, _CODE_OD_NEG, torch.where(rec, _CODE_D_0, torch.where(swap, cj, ci)))
    new_cj = torch.where(gen, _CODE_V_POS, torch.where(rec, _CODE_O_0, torch.where(swap, ci, cj)))
    return code.scatter(0, ij, torch.stack([new_ci, new_cj]).to(code.dtype))


def _touched_rows(neigh_idx, abs2act, zero_rows, site, jrow):
    """Rows that can hold a pair touching the event's two sites: the two
    sites' rows and their neighbors' rows, (2 + 2*NN,), duplicates included.
    ``zero_rows`` is the static per-row set {r} ∪ abs2act[neigh[r]]; without
    it the same multiset is put together from ``neigh_idx`` (and ``abs2act``
    when the table is row-compacted)."""
    both = torch.stack([site, jrow])
    if zero_rows is not None:
        return zero_rows[both].reshape(-1)
    nbr = neigh_idx[both].reshape(-1).clamp(min=0)
    if abs2act is not None:
        nbr = abs2act[nbr]
    return torch.cat([both, nbr])


def _fire_event(code, P, R, etype, neigh_idx, act_idx, abs2act, zero_rows, r_sel, bs=None,
                live=None):
    """One event of the serial loops from the selection draw ``r_sel``: select
    (site, slot) by rate, execute it on the packed ``code`` vector (a new
    tensor), and zero every pair involving the two changed sites in ``P`` and
    ``R`` (in place). ``bs``: R's carried block sums, selected on and then
    refreshed in place. A table with no rate left (``ok`` false) changes
    nothing, and neither does a step of a device loop whose ``live`` (0-d
    bool) is false. Returns (code, total, ok), ``total`` and ``ok`` 0-d
    tensors."""
    nn = P.shape[1]
    site, prev, total, target = _select_site(R, r_sel, bs)
    rowcum = _cumsum(_row(P, site))
    slot = torch.searchsorted(rowcum, target - prev, right=True).clamp(0, nn - 1)
    isel = site if act_idx is None else torch.take(act_idx, site).clamp(min=0)
    pair = site * nn + slot
    jsel = torch.take(neigh_idx, pair).clamp(min=0)
    ok = total > 0.0
    write = ok if live is None else ok & live

    code = torch.where(write, _execute_event_code(code, isel, jsel, torch.take(etype, pair)),
                       code)

    # zero out every pair involving isel or jsel: the two sites' rows
    # and their neighbors' rows (duplicates write identical values)
    jrow = jsel if abs2act is None else torch.take(abs2act, jsel)
    ar = _touched_rows(neigh_idx, abs2act, zero_rows, site, jrow)
    rows_P = P[ar]
    rows_nbr = neigh_idx[ar]
    kill = (
        (ar == site)[:, None]
        | (ar == jrow)[:, None]
        | (rows_nbr == isel)
        | (rows_nbr == jsel)
    )
    new_rows = torch.where(kill & write, 0.0, rows_P)
    P[ar] = new_rows
    row_sums = torch.sum(new_rows, dim=1)
    R[ar] = row_sums if live is None else torch.where(live, row_sums, R[ar])
    if bs is not None:
        _refresh_block_sums(bs, R, ar, live)
    return code, total, ok


def _waiting_time(e, total, ok, ln_S):
    """Waiting time e / (S * total) of the unit-exponential draw ``e``; inf
    on an empty table. With a rate scale it is formed in log space: S itself
    may be out of range."""
    if ln_S is None:
        return torch.where(ok, e / total, math.inf)
    return torch.where(
        ok,
        torch.exp(torch.log(e) - torch.log(torch.where(ok, total, 1.0)) - ln_S),
        math.inf,
    )


def _pack_code(element, charge):
    """element and charge as one packed int: code = element*4 + charge//2 + 1."""
    return element * 4 + (torch.div(charge, 2, rounding_mode="floor") + 1)


def _unpack_code(code, element_dtype, charge_dtype):
    return (
        torch.div(code, 4, rounding_mode="floor").to(element_dtype),
        (((code % 4) - 1) * 2).to(charge_dtype),
    )


class EventLoopResult(NamedTuple):
    element: torch.Tensor
    charge: torch.Tensor
    P: torch.Tensor           # the rate table, zeroed in place by the loop
    event_time: torch.Tensor  # () final (loop-breaking) waiting time [s]
    n_events: int             # events executed in this chunk
    draws_used: int           # rands consumed
    done: bool                # superstep finished (vs. buffer exhausted)
    event_time_h: float       # event_time as the loop last read it on the host


def run_event_loop_plain(
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
    incremental_select: bool = False,
) -> EventLoopResult:
    """Residence-time loop (execute_kmc_step_mpi, kmc_events.cu:430-528) as
    a host loop with one read per event: the plain version of
    ``run_event_loop``, which the main path runs.

    Runs until the latest single-event waiting time reaches 1/freq, or the
    rand buffer is exhausted (the caller then refills and resumes with
    ``event_time_in`` and the returned P).

    ``incremental_select``: keep the selection's block sums from loop entry
    and, after each event, sum again only the blocks of the rows it touched
    (``akmc_tpu``'s ``incremental_select``). The same events, state and
    times to the bit as the fresh selection (``_block_sums``). Off when the
    table's row count is not a multiple of 256, as in ``akmc_tpu``; a resumed
    loop sums its blocks anew from R."""
    buf_len = rand_buf.shape[0]
    inv_freq = 1.0 / freq
    R = torch.sum(P, dim=1)
    bs = _block_sums(R) if incremental_select and R.shape[0] % _BLK == 0 else None
    code = _pack_code(element, charge)
    if event_time_in is None:
        ev_time = torch.zeros((), dtype=P.dtype, device=P.device)
    else:
        ev_time = event_time_in
    ev_h = float(ev_time)
    cnt = 0
    n_ev = 0
    while ev_h < inv_freq and cnt + 2 <= buf_len:
        code, total, ok = _fire_event(
            code, P, R, etype, neigh_idx, act_idx, abs2act, zero_rows, rand_buf[cnt], bs
        )

        ev_time = _waiting_time(-torch.log(rand_buf[cnt + 1]), total, ok, ln_S)
        ok_h, ev_h = torch.stack([ok.to(P.dtype), ev_time]).tolist()
        # a total-rate-0 iteration executes nothing, consumes no draws and
        # ends the loop through ev_time = inf
        if ok_h:
            cnt += 2
            n_ev += 1
    element, charge = _unpack_code(code, element.dtype, charge.dtype)
    return EventLoopResult(
        element=element, charge=charge, P=P, event_time=ev_time,
        n_events=n_ev, draws_used=cnt, done=ev_h >= inv_freq, event_time_h=ev_h,
    )


# events (serial) or batches (batched) per replay of a device loop on a card:
# see PERF.md §6 for the readings behind them. On the CPU a read of
# the flags costs nothing and a dead step costs a whole step, so k is 1 there
SERIAL_K = 64
BATCHED_K = 32
# events per pass of the serial loop's while node inside a superstep's
# program on a card: a sweep's superstep fires one to a few events, and a
# dead event costs a whole one (PERF.md §6)
SERIAL_NODE_K = 1
# batches per pass of the batched loop's while node inside a production
# superstep's program on a card (PERF.md §6)
BATCHED_NODE_K = 1


def _steps(k: Optional[int], card_k: int, device: torch.device) -> int:
    if k is not None:
        return k
    return card_k if device.type == "cuda" else 1


# replays, steps and live steps of each device loop since the last reset
LOOP_COUNTS = {name: {"replays": 0, "steps": 0, "live_steps": 0}
               for name in ("serial", "native", "batched")}


def reset_loop_counts() -> None:
    for c in LOOP_COUNTS.values():
        c.update(replays=0, steps=0, live_steps=0)


def _count(name: str, replays: int, steps: int, live: int) -> None:
    c = LOOP_COUNTS[name]
    c["replays"] += replays
    c["steps"] += steps
    c["live_steps"] += live


def _set(dst: torch.Tensor, value) -> None:
    """A loop's 0-d input from a number (a fill) or a 0-d tensor (a copy:
    inside a program the value is the program's input, read when it runs)."""
    if isinstance(value, torch.Tensor):
        dst.copy_(value)
    else:
        dst.fill_(value)


def _run_nested(prog, name: str, live_steps: torch.Tensor) -> None:
    """A loop program's steps as a ``device_loop.while_loop`` of k-step
    passes inside a program (the span ``event_loop``); its passes and
    ``live_steps`` are recorded for the program's read, as ``name``'s
    counts."""
    passes = torch.zeros((), dtype=torch.int64, device=prog.live.device)

    def body():
        for i in range(prog.k):
            prog._step(i)
        passes.add_(1)
        prog.live.copy_(prog._live())

    prog.live.copy_(prog._live())
    with profiling.span("event_loop"):
        device_loop.while_loop(prog.live, body)
    device_loop.record((passes, live_steps.clone()), lambda v: _count(
        name, int(v[0]), int(v[0]) * prog.k, int(v[1])))


def _addresses(*tables) -> tuple:
    return tuple(None if t is None else (t.data_ptr(), tuple(t.shape)) for t in tables)


class _SerialProgram:
    """State and k-step body of the serial device loops. mt19937 form
    (``run_event_loop``): two draws per event from the static copy of the
    caller's buffer at a device cursor; ``native`` form
    (``run_event_loop_native``): one (2,) vector per event from static
    buffers that ``Prefill`` fills before each replay, or, ``keyed``, drawn
    inside the step from the threefry key the loop holds (``st``,
    ``ops/threefry.py::draw_step``: split in three, the selection and the
    waiting-time draw from the last two subkeys, the key moved on only by a
    live step). The tables are the
    caller's tensors, read in place; everything the loop writes is owned
    here and starts dead (``ev_time`` inf).

    ``rand_len``: the length of the static draw buffer when it holds several
    windows of ``buf_len`` draws (a program of k supersteps), each loop
    reading its window from ``base`` on. ``run_nested`` runs the loop as a
    while loop inside a program (``ops/device_loop.py``); ``nested``: the
    program is made for that alone, and captures no replays of its own
    unless asked for (``loop``)."""

    def __init__(self, P, etype, code, tables, freq, buf_len, native, has_ln_S,
                 incremental, k, rand_len=None, keyed=False, nested=False):
        dev = P.device
        f64 = dict(dtype=torch.float64, device=dev)
        i64 = dict(dtype=torch.int64, device=dev)
        self.neigh_idx, self.act_idx, self.abs2act, self.zero_rows = tables
        self.inv_freq, self.native, self.k, self.buf_len = 1.0 / freq, native, k, buf_len
        self.code = torch.zeros_like(code)
        self.P = torch.zeros_like(P)
        self.R = torch.zeros(P.shape[0], dtype=P.dtype, device=dev)
        self.bs = (torch.zeros(P.shape[0] // _BLK, dtype=P.dtype, device=dev)
                   if incremental else None)
        self.etype = torch.zeros_like(etype)
        self.ln_S = torch.zeros((), **f64) if has_ln_S else None
        self.ev_time = torch.full((), math.inf, dtype=P.dtype, device=dev)
        self.cnt = torch.zeros((), **i64)        # draws used (mt19937 form)
        self.base = torch.zeros((), **i64)       # where the window starts in ``rand``
        self.limit = torch.zeros((), **i64)      # max_events (native form)
        self.n_ev = torch.zeros((), **i64)
        self.n_it = torch.zeros((), **i64)       # live iterations (events and an empty table)
        self.flags = torch.zeros(5, **f64)
        self.live = torch.zeros((), dtype=torch.bool, device=dev)
        self.prefill = self.st = None
        if native and keyed:
            self.rand = None
            self.st = threefry.key_state(device=dev)
            self.u = [torch.zeros(2, dtype=P.dtype, device=dev)]
        elif native:
            self.rand = None
            self.u = [torch.zeros(2, dtype=P.dtype, device=dev) for _ in range(k)]
            self.prefill = Prefill([(u,) for u in self.u])
        else:
            self.rand = torch.zeros(max(rand_len or buf_len, 2), dtype=P.dtype, device=dev)
        self._loop = None
        if not (nested or device_loop.in_program()):
            self._make_loop()

    def _make_loop(self) -> None:
        """Capture the replays of the host-driven loop. A capture runs the
        body, so it runs with the loop dead (``ev_time`` inf), and a state
        loaded before is left as it was."""
        kept = self.ev_time.clone()
        self.ev_time.fill_(math.inf)
        try:
            self._loop = GraphLoop(self._body, self.k, self.code.device, self.flags, 3,
                                   self.prefill)
        finally:
            self.ev_time.copy_(kept)

    @property
    def loop(self) -> GraphLoop:
        """The replays of the host-driven loop: captured when the program is
        made, or, for one made inside a superstep's program, on first use."""
        if self._loop is None:
            self._make_loop()
        return self._loop

    @property
    def capture_s(self) -> float:
        return 0.0 if self._loop is None else self._loop.capture_s

    def _live(self):
        if self.native:
            return (self.ev_time < self.inv_freq) & (self.n_ev < self.limit)
        return (self.ev_time < self.inv_freq) & (self.cnt + 2 <= self.buf_len)

    def _step(self, i):
        live = self._live()
        if self.native:
            if self.st is not None:
                u = self.u[0]
                threefry.draw_step(self.st, live, u[0:1], u[1:2])
                r_sel, r_time = u
            else:
                r_sel, r_time = self.u[i]
            e_of = lambda r: -torch.log1p(-r)  # noqa: E731
        else:
            c = (self.base + self.cnt).clamp(max=self.rand.shape[0] - 2)
            r_sel, r_time = self.rand.index_select(0, torch.stack([c, c + 1]))
            e_of = lambda r: -torch.log(r)  # noqa: E731
        code, total, ok = _fire_event(
            self.code, self.P, self.R, self.etype, self.neigh_idx, self.act_idx, self.abs2act,
            self.zero_rows, r_sel, self.bs, live=live)
        ev = _waiting_time(e_of(r_time), total, ok, self.ln_S)
        self.code.copy_(code)
        self.ev_time.copy_(torch.where(live, ev, self.ev_time))
        fired = (live & ok).to(torch.int64)
        self.n_ev.add_(fired)
        if not self.native:
            self.cnt.add_(2 * fired)
        self.n_it.add_(live.to(torch.int64))

    def _body(self, n):
        for i in range(n):
            self._step(i)
        f64 = self.flags.dtype
        self.flags.copy_(torch.stack([self._live().to(f64), self.n_ev.to(f64),
                                      self.cnt.to(f64), self.n_it.to(f64),
                                      self.ev_time.to(f64)]))

    def load(self, element, charge, P, etype, ln_S, event_time_in, rand_buf=None,
             max_events=0, key=None):
        self.code.copy_(_pack_code(element, charge))
        if key is not None:
            self.st[threefry.KEY].copy_(key)
        self.P.copy_(P)
        self.etype.copy_(etype)
        self.R.copy_(torch.sum(self.P, dim=1))
        if self.bs is not None:
            self.bs.copy_(_block_sums(self.R))
        if self.ln_S is not None:
            self.ln_S.copy_(torch.as_tensor(ln_S, dtype=torch.float64))
        if event_time_in is None:
            self.ev_time.zero_()
        else:
            self.ev_time.copy_(event_time_in)
        if rand_buf is not None:
            self.rand[: rand_buf.shape[0]].copy_(rand_buf)
        for c in (self.cnt, self.n_ev, self.n_it):
            c.zero_()
        _set(self.limit, max_events)

    def run_nested(self, name: str = "serial") -> None:
        """The loop as a while loop inside a program (``_run_nested``),
        counted as ``name``'s."""
        _run_nested(self, name, self.n_it)

    def run(self, name, draws=None):
        """Replays until the loop is dead: (n_events, draws used, live
        iterations, event_time as read)."""
        (_, n_ev, cnt, n_it, ev_h), replays, steps = self.loop.run(draws)
        _count(name, replays, steps, int(n_it))
        return int(n_ev), int(cnt), int(n_it), ev_h

    def results(self, element, charge, P):
        P.copy_(self.P)
        el, ch = _unpack_code(self.code, element.dtype, charge.dtype)
        return el, ch, self.ev_time.clone()


def _serial_program(graphs, P, etype, element, charge, tables, freq, buf_len, native,
                    ln_S, incremental, k, keyed=False):
    code = _pack_code(element, charge)
    key = ("native" if native else "serial", tuple(P.shape), P.dtype, etype.dtype,
           tuple(code.shape), code.dtype, P.device, freq, buf_len, ln_S is not None,
           incremental, k, keyed, _addresses(*tables))
    return program(graphs, key, lambda: _SerialProgram(
        P, etype, code, tables, freq, buf_len, native, ln_S is not None, incremental, k,
        keyed=keyed))


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
    incremental_select: bool = False,
    k: Optional[int] = None,
    graphs=None,
) -> EventLoopResult:
    """``run_event_loop_plain`` kept on the device: k events (default
    SERIAL_K on a card, 1 on the CPU; the first replay at most
    ``device_loop.FIRST_K``) per replay and one host read of the loop's flags
    and counters per replay. Each step draws at a device
    cursor into the buffer and runs only while ``ev_time < 1/freq`` and two
    draws are left; a dead step writes nothing, so k changes no result.
    The result equals the plain
    loop's to the bit (``draws_used``, ``n_events``, ``done``,
    ``event_time_h`` included). ``graphs``: the caller's ``LoopGraphs``, so
    that a graph is captured once per shape (without one, each call builds
    and captures its own)."""
    k = _steps(k, SERIAL_K, P.device)
    incremental = incremental_select and P.shape[0] % _BLK == 0
    tables = (neigh_idx, act_idx, abs2act, zero_rows)
    prog = _serial_program(graphs, P, etype, element, charge, tables, freq,
                           rand_buf.shape[0], False, ln_S, incremental, k)
    prog.load(element, charge, P, etype, ln_S, event_time_in, rand_buf=rand_buf)
    n_ev, cnt, _, ev_h = prog.run("serial")
    element, charge, ev_time = prog.results(element, charge, P)
    return EventLoopResult(
        element=element, charge=charge, P=P, event_time=ev_time,
        n_events=n_ev, draws_used=cnt, done=ev_h >= 1.0 / freq, event_time_h=ev_h,
    )


# ----------------------------------------------------------------------
# draws: where the production loops get their uniforms. A batch asks its
# source for ``batch(n, clock_dtype, B, dtype, device)`` (u_clk, u_slot), a
# native event for ``event(dtype, device)`` (selection, waiting-time draw).
# ``KeyDraws`` (ops/threefry.py) is akmc_tpu's threefry key, the driver's
# source; the two below are a device generator and a replay of given vectors
# ----------------------------------------------------------------------
class GeneratorDraws:
    """Uniforms in [0, 1) from a ``torch.Generator`` that lives on the
    tensors' device (seeded by the caller; the global generator is never
    touched)."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    @classmethod
    def seeded(cls, seed: int, device) -> "GeneratorDraws":
        g = torch.Generator(device=device)
        g.manual_seed(int(seed))
        return cls(g)

    def uniform(self, shape, dtype, device) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator, dtype=dtype, device=device)

    def batch(self, n, clock_dtype, B, dtype, device):
        """One batch of the batched loop: u_clk (n,), then u_slot (B,)."""
        return self.uniform((n,), clock_dtype, device), self.uniform((B,), dtype, device)

    def event(self, dtype, device):
        """One event of the native loop: one (2,) vector, (selection draw,
        waiting-time draw)."""
        r = self.uniform((2,), dtype, device)
        return r[0], r[1]

    # the device loops draw a replay's uniforms ahead into their own buffers
    # and give back those of dead steps (ops/device_loop.py::Prefill)
    def fill(self, out: torch.Tensor) -> None:
        """``out`` filled with what ``uniform(out.shape, out.dtype,
        out.device)`` would return."""
        torch.rand(out.shape, generator=self.generator, out=out)

    def mark(self):
        return self.generator.get_state()

    def rewind(self, mark) -> None:
        self.generator.set_state(mark)


class ReplayDraws:
    """Hands out, in order, the vectors it was given (arrays or tensors, or an
    iterator that makes them on demand): the batched loop asks for ``u_clk``
    (n,) and then ``u_slot`` (B,) once per batch, the native loop for one
    (2,) vector (selection draw, waiting-time draw) per event. Shape and
    dtype must be what the loop asks for, so a replay that falls out of step
    fails instead of reinterpreting a vector. ``mark``/``rewind`` put back
    every vector taken since the mark, those that failed included."""

    def __init__(self, vectors):
        self._it = iter(vectors)
        self._back = []          # vectors put back by ``rewind``, next first
        self._taken = None       # vectors taken since the last ``mark``, if marked
        self.handed_out = 0

    def uniform(self, shape, dtype, device) -> torch.Tensor:
        if self._back:
            u = self._back.pop()
        else:
            try:
                u = next(self._it)
            except StopIteration:
                raise RuntimeError(
                    f"replay exhausted after {self.handed_out} vectors") from None
        if self._taken is not None:
            self._taken.append(u)
        if not isinstance(u, torch.Tensor):
            u = torch.from_numpy(np.array(u))     # a copy: arrays may be read-only
        if tuple(u.shape) != tuple(shape) or u.dtype != dtype:
            raise ValueError(
                f"replayed vector {self.handed_out} is {tuple(u.shape)} {u.dtype}, "
                f"the loop asked for {tuple(shape)} {dtype}")
        self.handed_out += 1
        return u.to(device)

    batch = GeneratorDraws.batch
    event = GeneratorDraws.event

    def fill(self, out: torch.Tensor) -> None:
        out.copy_(self.uniform(out.shape, out.dtype, out.device))

    def mark(self) -> int:
        self._taken = []
        return self.handed_out

    def rewind(self, mark: int) -> None:
        self._back.extend(reversed(self._taken))
        self._taken = None
        self.handed_out = mark


def _smallest_stable(v: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest entries of a vector in (value, index) order: equal
    values keep their index order, which ``torch.topk`` does not promise."""
    vals, idx = torch.sort(v, stable=True)
    return vals[:k], idx[:k]


def _topk_smallest(tau: torch.Tensor, B: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact B smallest entries of tau (values, indices), ties in the order
    ``lax.top_k`` gives them in akmc_tpu. Two-stage when len(tau) is a
    multiple of 256 above 1024: the B blocks with the smallest minima, then
    the B smallest inside the gathered blocks (ties among those by block
    rank, then by position). Exact: a top-B element's block minimum is <=
    the element, so a block ranked below the B best would imply >= B
    strictly smaller elements. Only the short vectors are sorted."""
    n = tau.shape[0]
    if n % _BLK or n <= 4 * _BLK:
        return _smallest_stable(tau, B)
    blocks = tau.reshape(n // _BLK, _BLK)
    _, bsel = _smallest_stable(torch.min(blocks, dim=1).values, B)
    vals, ci = _smallest_stable(blocks[bsel].reshape(-1), B)
    idx = bsel[torch.div(ci, _BLK, rounding_mode="floor")] * _BLK + ci % _BLK
    return vals, idx


class BatchedLoopResult(NamedTuple):
    element: torch.Tensor
    charge: torch.Tensor
    P: torch.Tensor           # the rate table, zeroed in place by the loop
    event_time: torch.Tensor  # () f64 terminating gap [s]; 0 if never done
    n_events: int
    n_batches: int
    done: bool
    # batches whose accepted prefix was cut by each cause (why amortization
    # stops: a row conflict, or the killed-mass staleness bound)
    n_cut_conflict: int = 0
    n_cut_mass: int = 0
    event_time_h: float = 0.0  # event_time as read on the host with the last batch


def run_event_loop_batched_plain(
    element: torch.Tensor,     # (N,) int32
    charge: torch.Tensor,      # (N,) int32
    P: torch.Tensor,           # (R, NN) rate table — updated IN PLACE
    etype: torch.Tensor,       # (R, NN) int32 event types
    neigh_idx: torch.Tensor,   # (R, NN) int64 absolute neighbor ids, -1 padded
    draws,                     # GeneratorDraws or ReplayDraws
    freq: float,
    batch: int = 64,
    max_batches: int = 1 << 14,
    act_idx: Optional[torch.Tensor] = None,   # (R,) absolute site per row, -1 padded
    abs2act: Optional[torch.Tensor] = None,   # (N,) site -> row (all-zero pad row if none)
    ln_S=None,
    mass_eps: float = 1e-3,
    clock_f32: bool = False,
) -> BatchedLoopResult:
    """Multi-event batches via the exponential-race (next-reaction) form of
    the residence-time algorithm: the loop of crossbar-scale runs, where one
    event per iteration is too slow. Production mode (its own uniforms, not
    reference-stream parity). Everything after the draws follows
    ``akmc_tpu/ops/events.py::run_event_loop_batched`` operation for operation.

      * Per-row clocks tau_i = -ln(u_i)/R_i realize the exponential race:
        (argmin, min-gap) is distributed as (selection ~ rates, waiting time
        ~ Exp(total)), the serial law.
      * The slot within a winning row is drawn from the row's batch-start
        rates. Rates only decrease within a superstep, so selecting on stale
        rates and accepting only live pairs is exact (thinning).
      * Candidates are taken in tau order and the batch is CUT at the first
        candidate whose row lies in an earlier candidate's touched row set:
        before the cut no accepted row's rates were touched. Cut candidates'
        clocks are redrawn next batch (memorylessness).
      * The one inexactness: accepted events zero rate mass elsewhere, so
        later gaps of the SAME batch race against a total that is stale by
        the killed mass still racing (the executed row's own mass is consumed
        by firing and excluded). The batch is cut when that cumulative mass
        exceeds ``mass_eps`` of the total, which bounds the relative
        waiting-time distortion per batch by ``mass_eps``.

    Termination matches the committed loop: the first accepted gap >= 1/freq
    executes its event, returns that gap as event_time and stops. An empty
    table gives event_time = inf, done, no event.

    ``clock_f32`` draws and transforms the clocks in f32 (gaps then carry f32
    rounding); the termination test stays in f64 log space. This is the host
    loop, with one device-to-host read per batch: the plain version of
    ``run_event_loop_batched``, which the main path runs."""
    n, nn = P.shape
    n_sites = element.shape[0]
    dev = P.device
    B = batch
    inv_freq = 1.0 / freq
    clock_dtype = torch.float32 if clock_f32 else P.dtype
    R = torch.sum(P, dim=1)
    # one slot longer than the structure: the last slot takes the writes of
    # rejected candidates (no masked write, so no host-side boolean mask)
    element_x = torch.cat([element, element.new_zeros(1)])
    charge_x = torch.cat([charge, charge.new_zeros(1)])
    lower = torch.tril(torch.ones((B, B), dtype=torch.bool, device=dev), diagonal=-1)
    arange_b = torch.arange(B, device=dev)
    zero_gap = torch.zeros(1, dtype=clock_dtype, device=dev)

    ev_time = torch.zeros((), dtype=torch.float64, device=dev)
    ev_h = 0.0
    n_ev = n_b = n_cc = n_cm = 0
    done = False
    while not done and n_b < max_batches:
        # 1. per-row clocks at batch-start rates (inf on zero-rate rows). With
        # a rate scale, R~ = R/S and tau~ = tau*S; gaps are rescaled by S in
        # log space at the termination test only.
        u, u_slot = draws.batch(n, clock_dtype, B, P.dtype, dev)
        tau = -torch.log(u) / R.to(clock_dtype)
        total = torch.sum(R)
        ok = total > 0.0

        tau_b, rows_b = _topk_smallest(tau, B)

        # 2. slot per candidate from its (untouched, batch-start) row; the
        # count of partial sums below the target, not a searchsorted
        rows_P = P[rows_b]                                   # (B, NN)
        cumr = torch.cumsum(rows_P, dim=1)
        rowtot = cumr[:, -1]
        t_slot = u_slot * rowtot
        slot_b = torch.sum(cumr < t_slot[:, None], dim=1).clamp(0, nn - 1)

        isel_b = rows_b if act_idx is None else act_idx[rows_b].clamp(min=0)
        jsel_b = neigh_idx[rows_b, slot_b].clamp(min=0)
        ety_b = etype[rows_b, slot_b]

        # 3. touched row set per candidate (the serial loop's zero-out rows);
        # an inactive neighbor maps to the all-zero pad row
        jrow_b = jsel_b if abs2act is None else abs2act[jsel_b]
        nbr_rows = torch.cat([neigh_idx[rows_b], neigh_idx[jrow_b]], dim=1).clamp(min=0)
        if abs2act is not None:
            nbr_rows = abs2act[nbr_rows]
        ar_b = torch.cat([torch.stack([rows_b, jrow_b], dim=1), nbr_rows], dim=1)  # (B, 2+2*NN)

        # 4. exact prefix cut: candidate j is conflicted if an earlier
        # candidate i < j touches its row
        touch = (rows_b[None, :, None] == ar_b[:, None, :]).any(dim=2)   # [i, j]
        conflicted = (touch.T & lower).any(dim=1)

        # killed-mass staleness bound: pairs killed by candidate i live in
        # rows untouched by other accepted candidates (else the cut fired),
        # so the per-candidate masses are disjoint and their cumsum is the
        # exact decrease of the total rate
        ar_P = P[ar_b]                                       # (B, 2+2*NN, NN)
        ar_nbr = neigh_idx[ar_b]
        kill_b = (
            (ar_b == rows_b[:, None])[:, :, None]
            | (ar_b == jrow_b[:, None])[:, :, None]
            | (ar_nbr == isel_b[:, None, None])
            | (ar_nbr == jsel_b[:, None, None])
        )
        killed_mass = torch.where(kill_b, ar_P, 0.0).sum(dim=(1, 2))
        # only mass whose clock keeps racing stale distorts later gaps: the
        # executed row's own clock is consumed by firing
        racing_killed = (killed_mass - rowtot).clamp(min=0.0)
        mass_ok = (_cumsum(racing_killed) - racing_killed) <= mass_eps * total

        valid = torch.isfinite(tau_b) & (rowtot > 0.0) & ok
        acceptable = valid & ~conflicted & mass_ok
        acc_prefix = torch.cumprod(acceptable.to(torch.int32), dim=0) == 1

        # which cause cut the prefix, if any
        n_prefix = acc_prefix.sum()
        cut_here = n_prefix < B
        cut_i = n_prefix.clamp(0, B - 1)
        cut_conflict = cut_here & torch.take(conflicted, cut_i)
        cut_mass = cut_here & ~torch.take(conflicted, cut_i) & ~torch.take(mass_ok, cut_i)

        # 5. termination: the first accepted gap >= 1/freq executes, then
        # the loop stops. Gaps stay in the clock's type; with a rate scale
        # the test is in f64 log space whatever that type is.
        gaps = torch.diff(tau_b, prepend=zero_gap)
        if ln_S is None:
            big = gaps >= inv_freq
        else:
            big = (torch.log(gaps.to(torch.float64).clamp(min=1e-300)) - ln_S
                   >= math.log(inv_freq))
        big_acc = big & acc_prefix
        first_big = torch.argmax(big_acc.to(torch.int8))     # first maximum
        has_big = big_acc.any()
        last = torch.where(has_big, first_big, B - 1)
        accept = acc_prefix & (arange_b <= last)
        n_acc = accept.sum()

        # 6. execute the accepted events (their sites are pairwise disjoint:
        # an overlap would have tripped the row-touch cut). A rejected
        # candidate may share a site with an accepted one, so its write goes
        # to the spare slot and can never win.
        ei, ej = element_x[isel_b], element_x[jsel_b]
        qi, qj = charge_x[isel_b], charge_x[jsel_b]
        gen = ety_b == int(EVENT.VACANCY_GENERATION)
        rec = ety_b == int(EVENT.VACANCY_RECOMBINATION)
        swap = (ety_b == int(EVENT.VACANCY_DIFFUSION)) | (ety_b == int(EVENT.ION_DIFFUSION))
        new_ei = torch.where(gen, int(ELEM.OXYGEN_DEFECT),
                             torch.where(rec, int(ELEM.DEFECT), torch.where(swap, ej, ei)))
        new_ej = torch.where(gen, int(ELEM.VACANCY),
                             torch.where(rec, int(ELEM.O), torch.where(swap, ei, ej)))
        new_qi = torch.where(gen, -2, torch.where(rec, 0, torch.where(swap, qj, qi)))
        new_qj = torch.where(gen, 2, torch.where(rec, 0, torch.where(swap, qi, qj)))
        wi = torch.where(accept, isel_b, n_sites)
        wj = torch.where(accept, jsel_b, n_sites)
        element_x[wi] = new_ei.to(element_x.dtype)
        element_x[wj] = new_ej.to(element_x.dtype)
        charge_x[wi] = new_qi.to(charge_x.dtype)
        charge_x[wj] = new_qj.to(charge_x.dtype)

        # 7. zero-out: every gathered row is written back with ALL accepted
        # events applied, so rows gathered twice carry identical values and
        # the order of duplicate writes does not matter. Membership of a row
        # (a neighbor site) in the accepted rows (sites) is one marked table
        # each, in place of a comparison against every candidate.
        row_hit = torch.zeros(n + 1, dtype=torch.bool, device=dev)
        row_hit.index_fill_(0, torch.where(accept, torch.cat([rows_b, jrow_b]).view(2, B), n)
                            .reshape(-1), True)
        site_hit = torch.zeros(n_sites + 1, dtype=torch.bool, device=dev)
        site_hit.index_fill_(0, torch.cat([wi, wj]), True)
        # the spare slots collect the rejected candidates and are never read:
        # rows are < n, and pad neighbors (-1) are masked out (their rate is 0)
        kill_all = row_hit[ar_b][:, :, None] | (site_hit[ar_nbr.clamp(min=0)] & (ar_nbr >= 0))
        new_rows = torch.where(kill_all, 0.0, ar_P)
        ar_flat = ar_b.reshape(-1)
        P[ar_flat] = new_rows.reshape(-1, nn)
        R[ar_flat] = new_rows.sum(dim=2).reshape(-1)

        # event_time: the terminating gap, rescaled by S in log space
        last_gap = torch.take(gaps, last).to(torch.float64)
        if ln_S is None:
            t_out = last_gap
        else:
            t_out = torch.exp(torch.log(last_gap.clamp(min=1e-300)) - ln_S)
        done_now = has_big | ~ok
        ev_time = torch.where(done_now, torch.where(ok, t_out, math.inf), ev_time)

        # the batch's one device-to-host read (the counts are exact in f64)
        done_h, ok_h, n_acc_h, cc_h, cm_h, ev_h = torch.stack(
            [done_now, ok, n_acc, cut_conflict, cut_mass, ev_time]).tolist()
        done = bool(done_h)
        n_b += 1
        if ok_h:
            n_ev += int(n_acc_h)
            n_cc += int(cc_h)
            n_cm += int(cm_h)
    return BatchedLoopResult(
        element=element_x[:n_sites], charge=charge_x[:n_sites], P=P, event_time=ev_time,
        n_events=n_ev, n_batches=n_b, done=done, n_cut_conflict=n_cc, n_cut_mass=n_cm,
        event_time_h=ev_h,
    )


def run_event_loop_native_plain(
    element: torch.Tensor,
    charge: torch.Tensor,
    P: torch.Tensor,           # (R, NN) rate table — updated IN PLACE
    etype: torch.Tensor,
    neigh_idx: torch.Tensor,
    draws,                     # GeneratorDraws or ReplayDraws
    freq: float,
    max_events: int = 1 << 20,
    act_idx: Optional[torch.Tensor] = None,
    abs2act: Optional[torch.Tensor] = None,
    ln_S=None,
    zero_rows: Optional[torch.Tensor] = None,
) -> EventLoopResult:
    """Production-mode serial loop: ``run_event_loop``'s algorithm with two
    uniforms per event from ``draws`` instead of the replicated mt19937
    buffer, and the waiting time as -log1p(-r) / total. The exact
    residence-time law that the batched loop is held against. Never runs out
    of draws; ``draws_used`` reports 2 per event. A host loop with one read
    per event: the plain version of ``run_event_loop_native``."""
    inv_freq = 1.0 / freq
    R = torch.sum(P, dim=1)
    code = _pack_code(element, charge)
    ev_time = torch.zeros((), dtype=P.dtype, device=P.device)
    ev_h = 0.0
    n_ev = 0
    while ev_h < inv_freq and n_ev < max_events:
        r_sel, r_time = draws.event(P.dtype, P.device)
        code, total, ok = _fire_event(
            code, P, R, etype, neigh_idx, act_idx, abs2act, zero_rows, r_sel
        )
        ev_time = _waiting_time(-torch.log1p(-r_time), total, ok, ln_S)
        ok_h, ev_h = torch.stack([ok.to(P.dtype), ev_time]).tolist()
        if ok_h:
            n_ev += 1
    element, charge = _unpack_code(code, element.dtype, charge.dtype)
    return EventLoopResult(
        element=element, charge=charge, P=P, event_time=ev_time,
        n_events=n_ev, draws_used=2 * n_ev, done=ev_h >= inv_freq, event_time_h=ev_h,
    )


def run_event_loop_native(
    element: torch.Tensor,
    charge: torch.Tensor,
    P: torch.Tensor,           # (R, NN) rate table — updated IN PLACE
    etype: torch.Tensor,
    neigh_idx: torch.Tensor,
    draws,                     # GeneratorDraws or ReplayDraws
    freq: float,
    max_events: int = 1 << 20,
    act_idx: Optional[torch.Tensor] = None,
    abs2act: Optional[torch.Tensor] = None,
    ln_S=None,
    zero_rows: Optional[torch.Tensor] = None,
    k: Optional[int] = None,
    graphs=None,
) -> EventLoopResult:
    """``run_event_loop_native_plain`` kept on the device: k events (default
    SERIAL_K on a card, 1 on the CPU; the first replay at most
    ``device_loop.FIRST_K``) per replay, one host read per replay.
    Before each replay the k events' (2,) uniforms are drawn from ``draws`` in the plain loop's
    order; those of dead steps are given back (``Prefill``), so ``draws``
    ends where the plain loop leaves it and the result is the plain loop's
    to the bit. A ``ReplayDraws`` that holds just the vectors the loop needs
    is enough; one that runs out or falls out of step on a live event
    raises as in the plain loop. A ``KeyDraws`` is drawn from inside the
    step instead (``ops/threefry.py::draw_step``), its key copied in and,
    moved on by the live events, back out."""
    k = _steps(k, SERIAL_K, P.device)
    tables = (neigh_idx, act_idx, abs2act, zero_rows)
    keyed = isinstance(draws, KeyDraws)
    prog = _serial_program(graphs, P, etype, element, charge, tables, freq, 0, True,
                           ln_S, False, k, keyed)
    prog.load(element, charge, P, etype, ln_S, None, max_events=max_events,
              key=draws.key if keyed else None)
    n_ev, _, _, ev_h = prog.run("native", None if keyed else draws)
    if keyed:
        draws.key = prog.st[threefry.KEY].clone()
    element, charge, ev_time = prog.results(element, charge, P)
    return EventLoopResult(
        element=element, charge=charge, P=P, event_time=ev_time,
        n_events=n_ev, draws_used=2 * n_ev, done=ev_h >= 1.0 / freq, event_time_h=ev_h,
    )


class _BatchedProgram:
    """State and k-batch body of ``run_event_loop_batched``: every tensor
    the loop writes, the static buffers of each batch's uniforms, and the
    constants of the body, all built before the capture. Starts dead
    (``max_b`` 0). The uniforms are filled before each replay (``Prefill``)
    or, ``keyed``, drawn inside each batch from the threefry key the loop
    holds (``st``, ``ops/threefry.py::draw_step``), which only a live batch
    moves on. ``run_nested`` runs the loop as a while loop inside a
    program (``ops/device_loop.py``)."""

    def __init__(self, element, charge, P, etype, tables, freq, B, clock_dtype, has_ln_S, k,
                 keyed=False, nested=False):
        dev = P.device
        f64 = dict(dtype=torch.float64, device=dev)
        i64 = dict(dtype=torch.int64, device=dev)
        n = P.shape[0]
        self.neigh_idx, self.act_idx, self.abs2act = tables
        self.freq, self.B, self.k, self.n_sites = freq, B, k, element.shape[0]
        self.clock_dtype = clock_dtype
        self.element_x = torch.zeros(self.n_sites + 1, dtype=element.dtype, device=dev)
        self.charge_x = torch.zeros(self.n_sites + 1, dtype=charge.dtype, device=dev)
        self.P = torch.zeros_like(P)
        self.R = torch.zeros(n, dtype=P.dtype, device=dev)
        self.etype = torch.zeros_like(etype)
        self.ln_S = torch.zeros((), **f64) if has_ln_S else None
        self.mass_eps = torch.zeros((), **f64)
        self.max_b = torch.zeros((), **i64)
        self.ev_time = torch.zeros((), **f64)
        self.done = torch.zeros((), dtype=torch.bool, device=dev)
        self.n_ev, self.n_b, self.n_cc, self.n_cm = (torch.zeros((), **i64) for _ in range(4))
        self.flags = torch.zeros(7, **f64)
        self.live = torch.zeros((), dtype=torch.bool, device=dev)
        self.st = threefry.key_state(device=dev) if keyed else None
        nbuf = 1 if keyed else k
        self.u = [torch.zeros(n, dtype=clock_dtype, device=dev) for _ in range(nbuf)]
        self.v = [torch.zeros(B, dtype=P.dtype, device=dev) for _ in range(nbuf)]
        self.lower = torch.tril(torch.ones((B, B), dtype=torch.bool, device=dev), diagonal=-1)
        self.arange_b = torch.arange(B, device=dev)
        self.zero_gap = torch.zeros(1, dtype=clock_dtype, device=dev)
        self._loop = None
        if not (nested or device_loop.in_program()):
            self._make_loop()

    def _make_loop(self) -> None:
        """Capture the replays of the host-driven loop, with the loop dead
        (no batch allowed) and a state loaded before left as it was."""
        kept = self.max_b.clone()
        self.max_b.zero_()
        try:
            self._loop = GraphLoop(self._body, self.k, self.P.device, self.flags, 2,
                                   None if self.st is not None
                                   else Prefill(list(zip(self.u, self.v))))
        finally:
            self.max_b.copy_(kept)

    @property
    def loop(self) -> GraphLoop:
        """The replays of the host-driven loop: captured when the program is
        made, or, for one made inside a superstep's program, on first use."""
        if self._loop is None:
            self._make_loop()
        return self._loop

    @property
    def capture_s(self) -> float:
        return 0.0 if self._loop is None else self._loop.capture_s

    def _live(self):
        return ~self.done & (self.n_b < self.max_b)

    def _step(self, i):
        """One batch of ``run_event_loop_batched_plain``, operation for
        operation, with its writes guarded by ``live``: the race over every
        row (span ``batch.race``), then its B candidates resolved
        (``batch.resolve``)."""
        live = self._live()
        with profiling.span("batch.race"):
            race = self._race(i, live)
        with profiling.span("batch.resolve"):
            self._resolve(live, *race)

    def _race(self, i, live):
        """The batch's draws, every row's clock and the B smallest: (slot
        uniforms, clocks of the B, their rows, the total rate, whether it is
        positive)."""
        R = self.R
        if self.st is not None:
            u, u_slot = self.u[0], self.v[0]
            threefry.draw_step(self.st, live, u, u_slot)
        else:
            u, u_slot = self.u[i], self.v[i]
        tau = -torch.log(u) / R.to(self.clock_dtype)
        total = torch.sum(R)
        ok = total > 0.0
        tau_b, rows_b = _topk_smallest(tau, self.B)
        return u_slot, tau_b, rows_b, total, ok

    def _resolve(self, live, u_slot, tau_b, rows_b, total, ok):
        """The B candidates' slots, the conflict and mass cuts, the writes,
        the rows touched and the counters."""
        P, R, element_x, charge_x = self.P, self.R, self.element_x, self.charge_x
        neigh_idx, act_idx, abs2act = self.neigh_idx, self.act_idx, self.abs2act
        n, nn = P.shape
        B, n_sites, ln_S, dev = self.B, self.n_sites, self.ln_S, P.device
        inv_freq = 1.0 / self.freq

        rows_P = P[rows_b]
        cumr = torch.cumsum(rows_P, dim=1)
        rowtot = cumr[:, -1]
        t_slot = u_slot * rowtot
        slot_b = torch.sum(cumr < t_slot[:, None], dim=1).clamp(0, nn - 1)

        isel_b = rows_b if act_idx is None else act_idx[rows_b].clamp(min=0)
        jsel_b = neigh_idx[rows_b, slot_b].clamp(min=0)
        ety_b = self.etype[rows_b, slot_b]

        jrow_b = jsel_b if abs2act is None else abs2act[jsel_b]
        nbr_rows = torch.cat([neigh_idx[rows_b], neigh_idx[jrow_b]], dim=1).clamp(min=0)
        if abs2act is not None:
            nbr_rows = abs2act[nbr_rows]
        ar_b = torch.cat([torch.stack([rows_b, jrow_b], dim=1), nbr_rows], dim=1)

        touch = (rows_b[None, :, None] == ar_b[:, None, :]).any(dim=2)
        conflicted = (touch.T & self.lower).any(dim=1)

        ar_P = P[ar_b]
        ar_nbr = neigh_idx[ar_b]
        kill_b = (
            (ar_b == rows_b[:, None])[:, :, None]
            | (ar_b == jrow_b[:, None])[:, :, None]
            | (ar_nbr == isel_b[:, None, None])
            | (ar_nbr == jsel_b[:, None, None])
        )
        killed_mass = torch.where(kill_b, ar_P, 0.0).sum(dim=(1, 2))
        racing_killed = (killed_mass - rowtot).clamp(min=0.0)
        mass_ok = (_cumsum(racing_killed) - racing_killed) <= self.mass_eps * total

        valid = torch.isfinite(tau_b) & (rowtot > 0.0) & ok
        acceptable = valid & ~conflicted & mass_ok
        acc_prefix = torch.cumprod(acceptable.to(torch.int32), dim=0) == 1

        n_prefix = acc_prefix.sum()
        cut_here = n_prefix < B
        cut_i = n_prefix.clamp(0, B - 1)
        cut_conflict = cut_here & torch.take(conflicted, cut_i)
        cut_mass = cut_here & ~torch.take(conflicted, cut_i) & ~torch.take(mass_ok, cut_i)

        gaps = torch.diff(tau_b, prepend=self.zero_gap)
        if ln_S is None:
            big = gaps >= inv_freq
        else:
            big = (torch.log(gaps.to(torch.float64).clamp(min=1e-300)) - ln_S
                   >= math.log(inv_freq))
        big_acc = big & acc_prefix
        first_big = torch.argmax(big_acc.to(torch.int8))
        has_big = big_acc.any()
        last = torch.where(has_big, first_big, B - 1)
        accept = acc_prefix & (self.arange_b <= last)
        n_acc = accept.sum()
        write = accept & live

        ei, ej = element_x[isel_b], element_x[jsel_b]
        qi, qj = charge_x[isel_b], charge_x[jsel_b]
        gen = ety_b == int(EVENT.VACANCY_GENERATION)
        rec = ety_b == int(EVENT.VACANCY_RECOMBINATION)
        swap = (ety_b == int(EVENT.VACANCY_DIFFUSION)) | (ety_b == int(EVENT.ION_DIFFUSION))
        new_ei = torch.where(gen, int(ELEM.OXYGEN_DEFECT),
                             torch.where(rec, int(ELEM.DEFECT), torch.where(swap, ej, ei)))
        new_ej = torch.where(gen, int(ELEM.VACANCY),
                             torch.where(rec, int(ELEM.O), torch.where(swap, ei, ej)))
        new_qi = torch.where(gen, -2, torch.where(rec, 0, torch.where(swap, qj, qi)))
        new_qj = torch.where(gen, 2, torch.where(rec, 0, torch.where(swap, qi, qj)))
        wi = torch.where(write, isel_b, n_sites)
        wj = torch.where(write, jsel_b, n_sites)
        element_x[wi] = new_ei.to(element_x.dtype)
        element_x[wj] = new_ej.to(element_x.dtype)
        charge_x[wi] = new_qi.to(charge_x.dtype)
        charge_x[wj] = new_qj.to(charge_x.dtype)

        row_hit = torch.zeros(n + 1, dtype=torch.bool, device=dev)
        row_hit.index_fill_(0, torch.where(write, torch.cat([rows_b, jrow_b]).view(2, B), n)
                            .reshape(-1), True)
        site_hit = torch.zeros(n_sites + 1, dtype=torch.bool, device=dev)
        site_hit.index_fill_(0, torch.cat([wi, wj]), True)
        kill_all = row_hit[ar_b][:, :, None] | (site_hit[ar_nbr.clamp(min=0)] & (ar_nbr >= 0))
        new_rows = torch.where(kill_all, 0.0, ar_P)
        ar_flat = ar_b.reshape(-1)
        P[ar_flat] = new_rows.reshape(-1, nn)
        R[ar_flat] = torch.where(live, new_rows.sum(dim=2).reshape(-1), R[ar_flat])

        last_gap = torch.take(gaps, last).to(torch.float64)
        if ln_S is None:
            t_out = last_gap
        else:
            t_out = torch.exp(torch.log(last_gap.clamp(min=1e-300)) - ln_S)
        ends = live & (has_big | ~ok)
        self.ev_time.copy_(torch.where(ends, torch.where(ok, t_out, math.inf), self.ev_time))
        self.done.copy_(self.done | ends)
        counted = live & ok
        self.n_b.add_(live.to(torch.int64))
        self.n_ev.add_(torch.where(counted, n_acc, 0))
        self.n_cc.add_((counted & cut_conflict).to(torch.int64))
        self.n_cm.add_((counted & cut_mass).to(torch.int64))

    def _body(self, n):
        for i in range(n):
            self._step(i)
        f64 = self.flags.dtype
        self.flags.copy_(torch.stack([
            self._live().to(f64), self.done.to(f64), self.n_b.to(f64), self.n_ev.to(f64),
            self.n_cc.to(f64), self.n_cm.to(f64), self.ev_time]))

    def load(self, element, charge, P, etype, ln_S, mass_eps, max_batches, key=None):
        """The loop's inputs copied in (``mass_eps`` and ``max_batches``
        numbers or 0-d tensors; ``key`` the threefry key of a keyed loop)."""
        self.element_x[: self.n_sites].copy_(element)
        self.charge_x[: self.n_sites].copy_(charge)
        self.element_x[self.n_sites:] = 0
        self.charge_x[self.n_sites:] = 0
        self.P.copy_(P)
        self.etype.copy_(etype)
        self.R.copy_(torch.sum(self.P, dim=1))
        if self.ln_S is not None:
            self.ln_S.copy_(torch.as_tensor(ln_S, dtype=torch.float64))
        _set(self.mass_eps, mass_eps)
        _set(self.max_b, max_batches)
        if key is not None:
            self.st[threefry.KEY].copy_(key)
        self.ev_time.zero_()
        self.done.zero_()
        for c in (self.n_ev, self.n_b, self.n_cc, self.n_cm):
            c.zero_()

    def run_nested(self) -> None:
        """The loop as a while loop inside a program (``_run_nested``)."""
        _run_nested(self, "batched", self.n_b)

    def run(self, draws):
        """Replays until the loop is dead: (done, batches, events, conflict
        cuts, mass cuts, event_time as read)."""
        (_, done, n_b, n_ev, n_cc, n_cm, ev_h), replays, steps = self.loop.run(draws)
        _count("batched", replays, steps, int(n_b))
        return bool(done), int(n_b), int(n_ev), int(n_cc), int(n_cm), ev_h


def _batched_program(graphs, element, charge, P, etype, tables, freq, batch, clock_f32, ln_S,
                     k, keyed):
    clock_dtype = torch.float32 if clock_f32 else P.dtype
    key = ("batched", tuple(P.shape), P.dtype, etype.dtype, element.shape[0], element.dtype,
           charge.dtype, P.device, freq, batch, clock_dtype, ln_S is not None, k, keyed,
           _addresses(*tables))
    return program(graphs, key, lambda: _BatchedProgram(
        element, charge, P, etype, tables, freq, batch, clock_dtype, ln_S is not None, k,
        keyed=keyed))


def run_event_loop_batched(
    element: torch.Tensor,     # (N,) int32
    charge: torch.Tensor,      # (N,) int32
    P: torch.Tensor,           # (R, NN) rate table — updated IN PLACE
    etype: torch.Tensor,       # (R, NN) int32 event types
    neigh_idx: torch.Tensor,   # (R, NN) int64 absolute neighbor ids, -1 padded
    draws,                     # GeneratorDraws or ReplayDraws
    freq: float,
    batch: int = 64,
    max_batches: int = 1 << 14,
    act_idx: Optional[torch.Tensor] = None,
    abs2act: Optional[torch.Tensor] = None,
    ln_S=None,
    mass_eps: float = 1e-3,
    clock_f32: bool = False,
    k: Optional[int] = None,
    graphs=None,
) -> BatchedLoopResult:
    """``run_event_loop_batched_plain`` kept on the device: k batches
    (default BATCHED_K on a card, 1 on the CPU; the first replay at most
    ``device_loop.FIRST_K``) per replay and one host read of the loop's
    packed flags and counters per replay. A batch runs only while the loop
    is not done and fewer than ``max_batches`` batches ran; a dead batch writes
    nothing and counts nothing, so k changes no result. Before each replay
    the k batches' uniforms, ``u_clk`` (n,) then ``u_slot`` (B,) per batch,
    are drawn from ``draws`` in the plain loop's order, and those of dead
    batches are given back (``Prefill``): ``draws`` ends where the plain loop
    leaves it, and the result equals the plain loop's to the bit. A
    ``ReplayDraws`` that holds just the vectors the loop needs is enough; one
    that runs out or falls out of step on a live batch raises as in the
    plain loop. A ``KeyDraws`` is drawn from inside each batch instead
    (``ops/threefry.py::draw_step``, as ``akmc_tpu`` draws from its key),
    its key copied in and, moved on by the live batches, back out.
    ``graphs``: the caller's ``LoopGraphs``."""
    k = _steps(k, BATCHED_K, P.device)
    prog = _batched_program(graphs, element, charge, P, etype, (neigh_idx, act_idx, abs2act),
                            freq, batch, clock_f32, ln_S, k, isinstance(draws, KeyDraws))
    keyed = prog.st is not None
    prog.load(element, charge, P, etype, ln_S, mass_eps, max_batches,
              key=draws.key if keyed else None)
    done, n_b, n_ev, n_cc, n_cm, ev_h = prog.run(None if keyed else draws)
    if keyed:
        draws.key = prog.st[threefry.KEY].clone()
    P.copy_(prog.P)
    n_sites = element.shape[0]
    return BatchedLoopResult(
        element=prog.element_x[:n_sites].clone(), charge=prog.charge_x[:n_sites].clone(),
        P=P, event_time=prog.ev_time.clone(), n_events=n_ev, n_batches=n_b, done=done,
        n_cut_conflict=n_cc, n_cut_mass=n_cm, event_time_h=ev_h,
    )
