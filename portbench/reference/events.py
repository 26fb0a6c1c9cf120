"""The rate table and the two event loops of a superstep, replayed.

Rate table (kmc_events.cu:130-229 upstream). Rows are the event-capable
sites (elements DEFECT, O, V, Od, a class that events never leave) in
ascending site order, padded with zero rows to a multiple of 256 with at
least one pad row; a row's columns are its event-capable neighbors in
ascending order. For a row site i and neighbor j, with phi = V_i - V_j (the
summed potential), charges q_i, q_j, cs = q_i - q_j and the screened
self-term s2 = 2 erfc(d / (sigma sqrt 2)) k e / d:

    generation     (i DEFECT, j O):   EA = E_gen   - 2 phi
    recombination  (i Od,     j V):   EA = E_rec   - cs (phi + cs/2 s2)
    V diffusion    (i V,      j O):   EA = E_Vdiff - cs (phi + [q_i != 0] q_i/2 s2)
    ion diffusion  (i Od,     j DEFECT): EA = E_Odiff - cs (phi - [q_i != 0] s2)

with the zero-field energies of the neighbor's layer. Rates are
freq / (exp(EA / kT) + 1e-200); with the shifted exponent they are
exp(z_min - z), z = EA / kT, and ln_S = ln(freq) - z_min rescales times.

Every event changes both of its sites (generation: i -> Od(-2), j -> V(+2);
recombination: i -> DEFECT(0), j -> O(0); diffusions swap element and
charge) and then every pair that touches either site leaves the table: the
rates are not rebuilt within a superstep.

The serial loop (kmc_events.cu:430-528) draws a selection uniform u1 and a
time uniform u2 per event: the event is the pair where the running sum of
rates in row-major order first exceeds u1 * total; it fires; its waiting
time is -ln(u2) / total; the loop stops after the first event whose waiting
time reaches 1 / freq, and that time is the superstep's.

The batched loop is the exponential race with B candidates a batch, each
batch drawing from the key's split in three (the key goes on, row clocks
from the second, slot draws from the third):

1. each row's clock tau = -ln(u) / R_row; the B smallest, in order, are the
   candidates; a candidate's slot is the first whose running row sum is not
   below u_slot * row total;
2. a candidate is cut when its row lies in the touched rows of an earlier
   candidate (its two sites' rows and their neighbors' rows), or when the
   summed killed mass of the earlier candidates, less each one's own row
   total, exceeds mass_eps of the table's total; candidates are accepted up
   to the first cut or invalid one (no finite clock, an empty row);
3. gaps are the differences of the accepted clocks; the first accepted gap
   that reaches 1 / freq (in log space with the rate scale) is the last
   event and the superstep's time; else all accepted events fire and the
   next batch follows.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import streams
from portbench.reference.fields import E_CHARGE
from portbench.reference.lattice import ACTIVE, ELEM

KB_EV = 8.617333262e-5
GEN, REC, VDIFF, ODIFF, NULL_EVENT = 0, 1, 2, 3, 4


class Table:
    """The static row layout of the rate table of one structure."""

    def __init__(self, element, pos, nbr, layer, sigma, k):
        dev = element.device
        n = element.shape[0]
        active = torch.zeros(n, dtype=torch.bool, device=dev)
        for e in ACTIVE:
            active |= element == e
        self.act = torch.nonzero(active).flatten()
        n_act = self.act.shape[0]
        self.rows = -(-(n_act + 1) // 256) * 256
        self.pad_row = self.rows - 1
        self.row_of = torch.full((n,), self.pad_row, dtype=torch.int64, device=dev)
        self.row_of[self.act] = torch.arange(n_act, device=dev)
        nb = nbr[self.act]
        keep = (nb >= 0) & active[nb.clamp(min=0)]
        width = max(8, int(keep.sum(dim=1).max()))
        if nb.shape[1] < width:
            pad = torch.full((n_act, width - nb.shape[1]), -1, dtype=nb.dtype, device=dev)
            nb = torch.cat([nb, pad], dim=1)
            keep = torch.cat([keep, pad >= 0], dim=1)
        order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)[:, :width]
        cols = torch.where(torch.gather(keep, 1, order), torch.gather(nb, 1, order), -1)
        self.nbr = torch.full((self.rows, width), -1, dtype=torch.int64, device=dev)
        self.nbr[:n_act] = cols
        self.site = torch.full((self.rows,), -1, dtype=torch.int64, device=dev)
        self.site[:n_act] = self.act
        j = self.nbr.clamp(min=0)
        ok = self.nbr >= 0
        d = torch.sqrt(((pos[self.site.clamp(min=0)][:, None, :] - pos[j]) ** 2).sum(dim=2)) * 1e-10
        d = torch.where(ok, d, 1.0)
        self.s2 = torch.where(ok, 2.0 * torch.special.erfc(d / (sigma * math.sqrt(2.0)))
                              * k * E_CHARGE / d, 0.0)
        self.layer = torch.where(ok, layer[j], 0)

    def rates(self, element, charge, pot, T, energies, freq, normalize, dtype=torch.float64):
        """(P, event types, ln_S) with P in ``dtype``."""
        valid = self.nbr >= 0
        i = self.site.clamp(min=0)
        j = self.nbr.clamp(min=0)
        ei, ej = element[i][:, None], element[j]
        qi = charge[i][:, None].to(dtype)
        qj = charge[j].to(dtype)
        phi = pot[i].to(dtype)[:, None] - pot[j].to(dtype)
        s2 = self.s2.to(dtype)
        gen = (ei == ELEM["DEFECT"]) & (ej == ELEM["O"])
        rec = (ei == ELEM["OXYGEN_DEFECT"]) & (ej == ELEM["VACANCY"])
        vdiff = (ei == ELEM["VACANCY"]) & (ej == ELEM["O"])
        odiff = (ei == ELEM["OXYGEN_DEFECT"]) & (ej == ELEM["DEFECT"])
        E = {name: torch.tensor(v, dtype=dtype, device=pot.device)[self.layer]
             for name, v in energies.items()}
        cs = qi - qj
        zero = torch.zeros((), dtype=dtype, device=pot.device)
        EA = torch.where(gen, E["gen"] - 2.0 * phi,
             torch.where(rec, E["rec"] - cs * (phi + cs / 2.0 * s2),
             torch.where(vdiff, E["vdiff"] - cs * (phi + torch.where(qi != 0, qi / 2.0 * s2, zero)),
                         E["odiff"] - cs * (phi - torch.where(qi != 0, s2, zero)))))
        any_event = (gen | rec | vdiff | odiff) & valid
        kT = KB_EV * float(T)
        ln_S = None
        if normalize:
            z = EA / kT
            z_min = torch.min(torch.where(any_event, z, math.inf))
            z_min = torch.where(torch.isfinite(z_min), z_min, 0.0)
            P = torch.where(any_event, torch.exp(z_min - z), zero)
            ln_S = math.log(freq) - float(z_min)
        else:
            P = torch.where(any_event, freq / (torch.exp(EA / kT) + 1e-200), zero)
        etype = torch.where(gen, GEN, torch.where(rec, REC, torch.where(
            vdiff, VDIFF, torch.where(odiff, ODIFF, NULL_EVENT))))
        etype = torch.where(any_event, etype, NULL_EVENT)
        return P, etype, ln_S

    def touched_rows(self, sites):
        """Rows that hold a pair touching any of ``sites``: the sites' rows
        and their neighbors' rows."""
        r = self.row_of[sites]
        return torch.unique(torch.cat([r, self.row_of[self.nbr[r].clamp(min=0)].flatten()]))

    def kill(self, P, R, sites):
        """Every pair touching ``sites`` leaves the table (in place)."""
        rows = self.touched_rows(sites)
        hit = torch.zeros(self.row_of.shape[0], dtype=torch.bool, device=P.device)
        hit[sites] = True
        row_site_hit = hit[self.site[rows].clamp(min=0)] & (self.site[rows] >= 0)
        nb = self.nbr[rows]
        pair_hit = hit[nb.clamp(min=0)] & (nb >= 0)
        new = torch.where(row_site_hit[:, None] | pair_hit, 0.0, P[rows])
        P[rows] = new
        R[rows] = new.sum(dim=1)


def _fire(element, charge, i, j, etype):
    """Apply events (i, j, type) to element and charge in place."""
    ei, ej, qi, qj = element[i].clone(), element[j].clone(), charge[i].clone(), charge[j].clone()
    gen, rec = etype == GEN, etype == REC
    swap = (etype == VDIFF) | (etype == ODIFF)
    element[i] = torch.where(gen, ELEM["OXYGEN_DEFECT"], torch.where(rec, ELEM["DEFECT"],
                             torch.where(swap, ej, ei))).to(element.dtype)
    element[j] = torch.where(gen, ELEM["VACANCY"], torch.where(rec, ELEM["O"],
                             torch.where(swap, ei, ej))).to(element.dtype)
    charge[i] = torch.where(gen, -2, torch.where(rec, 0, torch.where(swap, qj, qi))).to(charge.dtype)
    charge[j] = torch.where(gen, 2, torch.where(rec, 0, torch.where(swap, qi, qj))).to(charge.dtype)


def serial(table, element, charge, P, etype, ln_S, freq, uniforms):
    """The serial loop on the uniforms ``uniforms`` (a 1-D f64 array drawn
    from the superstep's start in the stream): (element, charge, events,
    event time)."""
    element, charge = element.clone(), charge.clone()
    P = P.clone()
    R = P.sum(dim=1)
    inv_freq = 1.0 / freq
    n_ev, t, c = 0, 0.0, 0
    dt = P.dtype
    while t < inv_freq:
        cum = torch.cumsum(R, dim=0)
        total = cum[-1]
        if not float(total) > 0.0:
            return element, charge, n_ev, math.inf
        target = torch.tensor(float(uniforms[c]), dtype=dt, device=P.device) * total
        row = min(int(torch.searchsorted(cum, target.reshape(1), right=True)), R.shape[0] - 1)
        prev = cum[row - 1] if row > 0 else torch.zeros((), dtype=dt, device=P.device)
        rowcum = torch.cumsum(P[row], dim=0)
        slot = min(int(torch.searchsorted(rowcum, (target - prev).reshape(1), right=True)),
                   P.shape[1] - 1)
        total = float(total)
        i = table.site[row].clamp(min=0).reshape(1)
        j = table.nbr[row, slot].clamp(min=0).reshape(1)
        _fire(element, charge, i, j, etype[row, slot].reshape(1))
        table.kill(P, R, torch.cat([i, j]))
        e = -math.log(float(uniforms[c + 1]))
        t = math.exp(math.log(e) - math.log(total) - ln_S) if ln_S is not None else e / total
        c += 2
        n_ev += 1
    return element, charge, n_ev, t


def batched(table, element, charge, P, etype, ln_S, freq, sub_key, batch, mass_eps,
            clock_dtype=torch.float64, max_batches: int = 1 << 14):
    """The batched loop on the superstep's subkey: (element, charge, events,
    batches, event time)."""
    dev = P.device
    element, charge = element.clone(), charge.clone()
    P = P.clone()
    R = P.sum(dim=1)
    B = batch
    n_rows, width = P.shape
    log_inv_freq = math.log(1.0 / freq)
    idx = torch.arange(B, device=dev)
    n_ev = n_b = 0
    key = sub_key
    while n_b < max_batches:
        sub = streams.split(key, 3)
        key = sub[0]
        u = streams.uniform(sub[1], n_rows, clock_dtype)
        u_slot = streams.uniform(sub[2], B, P.dtype)
        tau = -torch.log(u) / R.to(clock_dtype)
        total = R.sum()
        ok = bool(total > 0.0)
        tau_b, rows_b = (t[:B] for t in torch.sort(tau, stable=True))
        rows_P = P[rows_b]
        cumr = torch.cumsum(rows_P, dim=1)
        rowtot = cumr[:, -1]
        slot = (cumr < (u_slot * rowtot)[:, None]).sum(dim=1).clamp(0, width - 1)
        isel = table.site[rows_b].clamp(min=0)
        jsel = table.nbr[rows_b, slot].clamp(min=0)
        ety = etype[rows_b, slot]
        jrow = table.row_of[jsel]
        ar = torch.cat([rows_b[:, None], jrow[:, None],
                        table.row_of[table.nbr[rows_b].clamp(min=0)],
                        table.row_of[table.nbr[jrow].clamp(min=0)]], dim=1)
        touch = (ar[:, None, :] == rows_b[None, :, None]).any(dim=2)        # [i, j]
        conflicted = (touch & (idx[:, None] < idx[None, :])).any(dim=0)
        ar_nbr = table.nbr[ar]
        killing = ((ar == rows_b[:, None]) | (ar == jrow[:, None]))[:, :, None] \
            | (ar_nbr == isel[:, None, None]) | (ar_nbr == jsel[:, None, None])
        killed = torch.where(killing, P[ar], 0.0).sum(dim=(1, 2))
        racing = (killed - rowtot).clamp(min=0.0)
        mass_ok = (torch.cumsum(racing, dim=0) - racing) <= mass_eps * total
        valid = torch.isfinite(tau_b) & (rowtot > 0.0) & ok
        accepted = torch.cumprod((valid & ~conflicted & mass_ok).to(torch.int64), dim=0) == 1
        gaps = torch.diff(tau_b, prepend=torch.zeros(1, dtype=clock_dtype, device=dev))
        if ln_S is None:
            big = gaps >= 1.0 / freq
        else:
            big = torch.log(gaps.to(torch.float64).clamp(min=1e-300)) - ln_S >= log_inv_freq
        big_acc = big & accepted
        has_big = bool(big_acc.any())
        last = int(torch.nonzero(big_acc)[0]) if has_big else B - 1
        accept = accepted & (idx <= last)
        n_b += 1
        if not ok:
            return element, charge, n_ev, n_b, math.inf
        a = torch.nonzero(accept).flatten()
        _fire(element, charge, isel[a], jsel[a], ety[a])
        table.kill(P, R, torch.cat([isel[a], jsel[a]]))
        n_ev += a.shape[0]
        if has_big:
            gap = max(float(gaps[last]), 1e-300)
            t = math.exp(math.log(gap) - ln_S) if ln_S is not None else gap
            return element, charge, n_ev, n_b, t
    return element, charge, n_ev, n_b, 0.0
