"""The transmission ("T") system of the current, in blocks.

The same physics as ``current.py`` (whose docstring states the upstream
equations: the neighbor conductances, the WKB tunnel transmissions, the rail
ties, the Jacobi CG and its stop rule, I_macro and the atom power), with the
pair coupling never formed as one (n_atom, n_atom) matrix. At the upstream's
T-system scale (about 10^5 atoms) that matrix alone takes 8 n_atom^2 bytes,
more than one card holds. Here the coupling is

* the neighbor part as a gather: the conductances on the atom adjacency,
  (n_atom, NN), zero off the list;
* the tunnel part as three dense blocks on the live lists: W_tt (vacancies x
  vacancies), W_cc (window contacts x window contacts) and W_ct (window
  contacts x vacancies), each built in row blocks of at most
  ``BLOCK_ELEMENTS`` pairs by ``current.Current._tunnel``, the dense form's
  expression entry for entry;
* the diagonal as the row sums of those parts.

The CG's operator, I_macro and the atom power run on the same blocks; the
atom power sums each row over its parts, in row blocks.

Departures from the upstream's ``create_X`` (current_solver_gpu.cu:2175-2316)
and its distributed solve (``update_power_gpu_sparse_dist``, :1430-1855),
beyond those ``current.py`` notes:

* no (n_atom + 2)^2 matrix X is assembled; its product is the gather, the
  block products and the rail terms;
* the upstream splits the T system into a sparse part and one dense tunnel
  subblock over the tunnel rows, ordered and distributed over ranks; here the
  tunnel rows are the vacancy and contact lists, in atom order, on one device;
* the contact-trap energy integral of a row block runs to that block's own
  largest window: a step past a pair's window adds an exact zero;
* a row's sums (the diagonal, the product, the atom power) add its parts in
  another order than a dense row would: the results agree with
  ``current.py`` to rounding, not bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.current import G0, Current
from portbench.reference.lattice import ELEM

BLOCK_ELEMENTS = 1 << 24     # pairs of one row block of a tunnel block or of the atom power


class Coupling(NamedTuple):
    """The pair couplings c_ij of one state, in blocks."""

    G: torch.Tensor          # (n_atom, NN) neighbor conductances, 0 off the list
    vac: torch.Tensor        # (nv,) atom indices of the vacancies
    con: torch.Tensor        # (nc,) atom indices of the window contacts
    W_tt: torch.Tensor       # (nv, nv)
    W_cc: torch.Tensor       # (nc, nc)
    W_ct: torch.Tensor       # (nc, nv)
    rowsum: torch.Tensor     # (n_atom,) sum_j c_ij


def block_rows(cols: int) -> int:
    """Rows of a block of at most ``BLOCK_ELEMENTS`` pairs with ``cols`` columns."""
    return max(1, BLOCK_ELEMENTS // max(1, cols))


class Transmission(Current):
    """``Current``'s static atom layout, with the coupling in blocks."""

    def _blocked_tunnel(self, a, b, cb, integrate, dtype):
        """``_tunnel(a, b)`` built in row blocks of at most ``BLOCK_ELEMENTS`` pairs."""
        out = torch.zeros(a.shape[0], b.shape[0], dtype=dtype, device=cb.device)
        step = block_rows(b.shape[0])
        for s in range(0, a.shape[0], step):
            out[s:s + step] = self._tunnel(a[s:s + step], b, cb, integrate, dtype)
        return out

    def coupling(self, element, charge, cb, dtype=torch.float64) -> Coupling:
        """The couplings of (element, charge) on the CB edge ``cb`` [J] in ``dtype``."""
        dev = cb.device
        ae, aq = element[self.atom], charge[self.atom]
        cvac = (ae == ELEM["VACANCY"]) & (aq == 0)
        cb_a = cb[self.atom]
        real = self.nbr >= 0
        j = self.nbr.clamp(min=0)
        hi = (self.metal[:, None] & self.metal[j]) | (cvac[:, None] & cvac[j])
        G = torch.where(hi, torch.tensor(self.high, dtype=dtype, device=dev),
                        torch.tensor(self.low, dtype=dtype, device=dev))
        G = torch.where(real, G, torch.zeros((), dtype=dtype, device=dev))
        vac = torch.nonzero(ae == ELEM["VACANCY"]).flatten()
        con = self.contact
        W_tt = self._blocked_tunnel(vac, vac, cb_a, False, dtype)
        W_cc = self._blocked_tunnel(con, con, cb_a, False, dtype)
        W_ct = self._blocked_tunnel(con, vac, cb_a, True, dtype)
        rowsum = G.sum(dim=1)
        rowsum = rowsum.index_add(0, vac, W_tt.sum(dim=1) + W_ct.sum(dim=0))
        rowsum = rowsum.index_add(0, con, W_cc.sum(dim=1) + W_ct.sum(dim=1))
        return Coupling(G, vac, con, W_tt, W_cc, W_ct, rowsum)

    def matvec(self, C: Coupling, v: torch.Tensor) -> torch.Tensor:
        """sum_j c_ij v_j for every atom i."""
        y = (C.G * v[self.nbr.clamp(min=0)]).sum(dim=1)
        v_v, v_c = v[C.vac], v[C.con]
        y = y.index_add(0, C.vac, C.W_tt @ v_v + C.W_ct.T @ v_c)
        return y.index_add(0, C.con, C.W_cc @ v_c + C.W_ct @ v_v)

    def _system(self, C: Coupling, Vd, dtype):
        """``Current._system`` on the blocks."""
        n, dev = self.n, C.G.device
        inj, ext = self.inj.to(dtype), self.ext.to(dtype)
        diag = C.rowsum.to(dtype) + self.high * (inj + ext)
        d0 = self.loop + self.high * float(self.ext.sum())
        d1 = self.loop + self.high * float(self.inj.sum())
        ng = n - 1

        def X(v):
            va = torch.cat([v[2:], torch.zeros(1, dtype=dtype, device=dev)])
            ya = diag * va - self.matvec(C, va) - self.high * inj * v[1] - self.high * ext * v[0]
            y0 = d0 * v[0] - self.loop * v[1] - self.high * (ext * va).sum()
            y1 = d1 * v[1] - self.loop * v[0] - self.high * (inj * va).sum()
            return torch.cat([torch.stack([y0, y1]), ya[:ng]])

        b = torch.zeros(ng + 2, dtype=dtype, device=dev)
        b[0], b[1] = -self.loop * Vd, self.loop * Vd
        inv_d = 1.0 / torch.cat([torch.tensor([d0, d1], dtype=dtype, device=dev), diag[:ng]])
        return X, b, inv_d

    def outputs(self, C: Coupling, Vd, m, dtype=torch.float64):
        """(I_macro [A], atom power (n_atom,) [W]) of the unscaled solution
        ``m``, computed in ``dtype``: ``Current.outputs`` on the blocks."""
        m = m.to(dtype) * G0
        m_at = m[2:]
        I_macro = float((torch.where(self.ext, -self.high * (m[0] - m_at), 0.0)).sum())

        def forward(c, m_i, m_j):
            """Each row's sum over its pairs of the forward-current power."""
            diff = m_j[None, :] - m_i[:, None] if m_j.dim() == 1 else m_j - m_i[:, None]
            ical = c.to(dtype) * diff
            fwd = ical < 0 if Vd >= 0 else ical > 0
            return (torch.where(fwd, -ical, 0.0) * diff).sum(dim=1)

        def in_rows(c, m_i, m_j):
            step = block_rows(c.shape[1])
            return torch.cat([forward(c[s:s + step], m_i[s:s + step], m_j)
                              for s in range(0, c.shape[0], step)]) if c.shape[0] else \
                torch.zeros(0, dtype=dtype, device=m.device)

        power = forward(C.G, m_at, m_at[self.nbr.clamp(min=0)])
        m_v, m_c = m_at[C.vac], m_at[C.con]
        power = power.index_add(0, C.vac, in_rows(C.W_tt, m_v, m_v)
                                + in_rows(C.W_ct.T, m_v, m_c))
        power = power.index_add(0, C.con, in_rows(C.W_cc, m_c, m_c)
                                + in_rows(C.W_ct, m_c, m_v))
        return I_macro, torch.where(self.metal, 0.0, -power).to(torch.float64)
