"""The conduction-band edge and the current and dissipated power.

CB edge (potential_solver_gpu.cu:574-772 upstream): the Laplace system of
the K network's shape over the interface sites, an edge conducting
100000 * G_coeff when either site is metal and low_G otherwise, contacts at
+Vd/2 (left) and -Vd/2 (right); CG on the symmetrically scaled system until
||D^-1/2 (A x - b)|| <= 1e-14; the profile in J (x e), the contacts at their
voltages.

Current (current_solver_gpu.cu:2175-2573 upstream): nodes extraction (0),
injection (1) and the atoms (every site but interstitials), the last atom
grounded. Atom pairs closer than nn_dist conduct high = 1e5 G_coeff when
both are metal or both neutral vacancies, else low_G. Non-neighbor pairs
with |dE| > 0.01 eV of CB edge tunnel (vacancy-vacancy, vacancy-contact,
contact-contact; contacts are the metal atoms outside the outer
num_layers_contact - 1 slices of each contact) with the WKB transmission
exp(prefac d/|dE| (E1^1.5 - E2^1.5)), E1 = e V0, E2 = E1 - |dE| (the E2
term dropped where E2 <= 0), prefac = -(2/3) sqrt(2 m_e) / hbar; a
contact-vacancy pair sums it over E1 = e V0 + s * 0.01 eV for s * 0.01 eV
< |dE|. The first atoms of the left contact slice tie to node 1 and the
last of the right one to node 0 with high; nodes 0 and 1 tie with
loop = 1e7 G_coeff; b = (-loop Vd, loop Vd, 0, ...). The diagonal is the
row sum. Jacobi CG stops at r.z / b.b <= (1e-16 n_atom s)^2 with s the
caller's scale. The solution m, scaled by G0 = 7.7224e-10: I_macro = G0 sum over extraction atoms of -high (m_0 - m_a)
and an atom's power is -sum_j c_ij (m_j - m_i)^2 over the pairs whose
current flows forward (c_ij the pair's coupling), zero on metals.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.lattice import ELEM

EV_TO_J = 1.60217663e-19
H_BAR = 1.054571817e-34
M_0 = 9.11e-31
G0 = 2 * 3.8612e-5 * 1e-5


def cb_residual(cb_edge, element0, nbr, metal, L, Vd, G_coeff) -> float:
    """||D^-1/2 (A x - b)|| / 1e-14 of a CB edge profile [J] (inf if a
    contact site does not hold its voltage)."""
    n = element0.shape[0]
    left = torch.full((L,), Vd / 2.0 * EV_TO_J, dtype=torch.float64, device=cb_edge.device)
    if not (torch.equal(cb_edge[:L], left) and torch.equal(cb_edge[n - L:], -left)):
        return math.inf
    rows = nbr[L:n - L]
    j = rows.clamp(min=0)
    real = rows >= 0
    f64 = dict(dtype=torch.float64, device=cb_edge.device)
    hi = metal[L:n - L, None] | metal[j]
    G = torch.where(real, torch.where(hi, torch.tensor(1e5 * G_coeff, **f64),
                                      torch.tensor(1e-8 * G_coeff, **f64)), torch.zeros((), **f64))
    lft, rgt = real & (j < L), real & (j >= n - L)
    inner = real & ~lft & ~rgt
    diag = G.sum(dim=1)
    b = torch.where(lft, G, 0.0).sum(dim=1) * (Vd / 2.0) - torch.where(rgt, G, 0.0).sum(dim=1) * (Vd / 2.0)
    x = cb_edge.to(torch.float64) / EV_TO_J
    Ax = diag * x[L:n - L] - (torch.where(inner, G, 0.0) * x[j]).sum(dim=1)
    return float(torch.linalg.vector_norm((Ax - b) / torch.sqrt(diag))) / 1e-14


def cb_solve(element0, nbr, metal, L, Vd, G_coeff, dtype=torch.float64,
             max_iterations: int = 100000):
    """The CB edge profile [J] by CG on the symmetrically scaled Laplace
    system in ``dtype``, from a zero start."""
    n = element0.shape[0]
    dev = nbr.device
    rows = nbr[L:n - L]
    j = rows.clamp(min=0)
    real = rows >= 0
    hi = metal[L:n - L, None] | metal[j]
    high = torch.tensor(1e5 * G_coeff, dtype=dtype, device=dev)
    low = torch.tensor(1e-8 * G_coeff, dtype=dtype, device=dev)
    G = torch.where(real, torch.where(hi, high, low), torch.zeros((), dtype=dtype, device=dev))
    lft, rgt = real & (j < L), real & (j >= n - L)
    inner = real & ~lft & ~rgt
    diag = G.sum(dim=1)
    b = (torch.where(lft, G, 0.0).sum(dim=1) - torch.where(rgt, G, 0.0).sum(dim=1)) * (Vd / 2.0)
    G_in = torch.where(inner, G, 0.0)
    col = torch.where(inner, j - L, 0)
    s = 1.0 / torch.sqrt(diag)

    def As(y):
        x = s * y
        return s * (diag * x - (G_in * x[col]).sum(dim=1))

    y = torch.zeros_like(b)
    r = As(y) - s * b
    p = -r
    t = (r * r).sum()
    k = 0
    while k < max_iterations and float(t) > 1e-28:
        Ap = As(p)
        a = t / (p * Ap).sum()
        y = y + a * p
        r = r + a * Ap
        t_new = (r * r).sum()
        p = (t_new / t) * p - r
        t = t_new
        k += 1
    full = torch.zeros(n, dtype=torch.float64, device=dev)
    full[L:n - L] = (y * s).to(torch.float64)
    full[:L], full[n - L:] = Vd / 2.0, -Vd / 2.0
    return full * EV_TO_J


class Current:
    """The static atom layout of one structure."""

    def __init__(self, element0, pos, nbr, metal, L, physics):
        dev = pos.device
        not_atom = (element0 == ELEM["DEFECT"]) | (element0 == ELEM["OXYGEN_DEFECT"]) \
            | (element0 == ELEM["NULL"])
        self.atom = torch.nonzero(~not_atom).flatten()
        n = self.atom.shape[0]
        self.n = n
        self.pos = pos[self.atom]
        self.metal = metal[self.atom]
        atom_of = torch.full((element0.shape[0],), -1, dtype=torch.int64, device=dev)
        atom_of[self.atom] = torch.arange(n, device=dev)
        an = atom_of[nbr[self.atom].clamp(min=0)]
        self.nbr = torch.where((nbr[self.atom] >= 0) & (an >= 0), an, -1)
        n_sites = element0.shape[0]
        n_inj = int((~not_atom[:L]).sum())
        n_ext = int((~not_atom[n_sites - L:]).sum())
        ai = torch.arange(n, device=dev)
        nlc = int(physics["num_layers_contact"])
        self.contact = torch.nonzero(self.metal & (ai > (nlc - 1) * n_inj)
                                     & (ai < n - (nlc - 1) * n_ext)).flatten()
        self.inj, self.ext = ai < n_inj, ai > n - n_ext
        g = float(physics["G_coeff"])
        self.high, self.low, self.loop = 1e5 * g, 1e-8 * g, 1e7 * g
        self.m_e = float(physics["m_r"]) * M_0
        self.V0 = float(physics["V0"])
        self.nn_dist = float(physics["nn_dist"])

    def _tunnel(self, a, b, cb, integrate, dtype):
        """Transmission between atom lists a and b (rows, cols) in ``dtype``."""
        pa, pb = self.pos[a].to(dtype), self.pos[b].to(dtype)
        d2 = (pa[:, None, 0] - pb[None, :, 0]) ** 2
        for k in (1, 2):
            d2 = d2 + (pa[:, None, k] - pb[None, :, k]) ** 2
        d_ang = torch.sqrt(d2)
        d_m = 1e-10 * d_ang
        dE = torch.abs(cb[a].to(dtype)[:, None] - cb[b].to(dtype)[None, :])
        ok = (a[:, None] != b[None, :]) & ~(d_ang < self.nn_dist) & (dE > EV_TO_J * 0.01)
        dE = torch.where(ok, dE, torch.ones_like(dE))
        d_m = torch.where(ok, d_m, torch.ones_like(d_m))
        prefac = -(math.sqrt(2.0 * self.m_e) / H_BAR) * (2.0 / 3.0)
        q = prefac * (d_m / dE)

        def term(E1):
            E2 = E1 - dE
            trap = q * (E1 ** 1.5 - torch.where(E2 > 0, E2, torch.zeros_like(E2)) ** 1.5)
            return torch.exp(torch.where(E2 > 0, trap, q * E1 ** 1.5))

        E0 = EV_TO_J * self.V0
        if not integrate:
            T = term(torch.tensor(E0, dtype=dtype, device=dE.device))
        else:
            T = torch.zeros_like(dE)
            step = EV_TO_J * 0.01
            n_steps = min(2048, int(math.ceil(float(dE[ok].max()) / step)) + 1) if ok.any() else 0
            for s in range(n_steps):
                iv = torch.tensor(s * step, dtype=dtype, device=dE.device)
                T = T + torch.where(iv < dE, term(E0 + iv), torch.zeros_like(dE))
        return torch.where(ok, T, torch.zeros_like(T))

    def coupling(self, element, charge, cb, dtype=torch.float64):
        """(n_atom, n_atom) pair couplings c_ij: neighbor conductances plus
        tunnel transmissions."""
        ae, aq = element[self.atom], charge[self.atom]
        cvac = (ae == ELEM["VACANCY"]) & (aq == 0)
        cb_a = cb[self.atom]
        C = torch.zeros(self.n, self.n, dtype=dtype, device=cb.device)
        rows = torch.arange(self.n, device=cb.device)[:, None].expand_as(self.nbr)
        real = self.nbr >= 0
        j = self.nbr.clamp(min=0)
        hi = (self.metal[:, None] & self.metal[j]) | (cvac[:, None] & cvac[j])
        G = torch.where(hi, torch.tensor(self.high, dtype=dtype, device=cb.device),
                        torch.tensor(self.low, dtype=dtype, device=cb.device))
        C[rows[real], j[real]] = G[real]
        vac = torch.nonzero(ae == ELEM["VACANCY"]).flatten()
        con = self.contact
        W_tt = self._tunnel(vac, vac, cb_a, False, dtype)
        W_cc = self._tunnel(con, con, cb_a, False, dtype)
        W_ct = self._tunnel(con, vac, cb_a, True, dtype)
        C[vac[:, None], vac[None, :]] += W_tt
        C[con[:, None], con[None, :]] += W_cc
        C[con[:, None], vac[None, :]] += W_ct
        C[vac[:, None], con[None, :]] += W_ct.T
        return C

    def _system(self, C, Vd, dtype):
        """(X as a function, b, inverse diagonal) over the unknowns [node 0,
        node 1, atoms but the grounded last one]."""
        n, dev = self.n, C.device
        inj, ext = self.inj.to(dtype), self.ext.to(dtype)
        diag = C.sum(dim=1) + self.high * (inj + ext)
        d0 = self.loop + self.high * float(self.ext.sum())
        d1 = self.loop + self.high * float(self.inj.sum())
        ng = n - 1

        def X(v):
            va = torch.cat([v[2:], torch.zeros(1, dtype=dtype, device=dev)])
            ya = diag * va - C @ va - self.high * inj * v[1] - self.high * ext * v[0]
            y0 = d0 * v[0] - self.loop * v[1] - self.high * (ext * va).sum()
            y1 = d1 * v[1] - self.loop * v[0] - self.high * (inj * va).sum()
            return torch.cat([torch.stack([y0, y1]), ya[:ng]])

        b = torch.zeros(ng + 2, dtype=dtype, device=dev)
        b[0], b[1] = -self.loop * Vd, self.loop * Vd
        inv_d = 1.0 / torch.cat([torch.tensor([d0, d1], dtype=dtype, device=dev), diag[:ng]])
        return X, b, inv_d

    def residual_ratio(self, C, Vd, m, rtol_scale) -> float:
        """sqrt(r.z / b.b) of the unscaled solution ``m`` (n_atom + 2) over
        the stop tolerance, in f64 (inf if the grounded atom is not 0)."""
        if float(m[-1]) != 0.0:
            return math.inf
        X, b, inv_d = self._system(C, Vd, torch.float64)
        r = b - X(m[:-1].to(torch.float64))
        return math.sqrt(float((r * r * inv_d).sum() / (b * b).sum())) / (
            1e-16 * self.n * float(rtol_scale))

    def solve(self, C, Vd, m_prev, rtol_scale, dtype=torch.float64, max_iterations=10000):
        """The unscaled solution (n_atom + 2) by Jacobi CG in ``dtype`` from
        ``m_prev``, under the stop rule."""
        X, b, inv_d = self._system(C, Vd, dtype)
        rtol = 1e-16 * self.n * float(rtol_scale)
        x = m_prev[:-1].to(dtype)
        r = b - X(x)
        z = r * inv_d
        p = z
        rz = (r * z).sum()
        bb = (b * b).sum()
        k = 1
        while k <= max_iterations and float(rz / bb) > rtol * rtol:
            Ap = X(p)
            a = rz / (p * Ap).sum()
            x = x + a * p
            r = r - a * Ap
            z = r * inv_d
            rz_new = (r * z).sum()
            p = z + (rz_new / rz) * p
            rz = rz_new
            k += 1
        return torch.cat([x, torch.zeros(1, dtype=dtype, device=x.device)])

    def outputs(self, C, Vd, m, dtype=torch.float64):
        """(I_macro [A], atom power (n_atom,) [W]) of the unscaled solution
        ``m``, computed in ``dtype``."""
        n = self.n
        m = m.to(dtype) * G0
        m_at = m[2:]
        I_macro = float((torch.where(self.ext, -self.high * (m[0] - m_at), 0.0)).sum())
        power = torch.zeros(n, dtype=dtype, device=m.device)
        for s in range(0, n, 4096):
            diff = m_at[None, :] - m_at[s:s + 4096, None]          # m_j - m_i
            ical = C[s:s + 4096].to(dtype) * diff
            fwd = ical < 0 if Vd >= 0 else ical > 0
            power[s:s + 4096] = (torch.where(fwd, -ical, 0.0) * diff).sum(dim=1)
        return I_macro, torch.where(self.metal, 0.0, -power).to(torch.float64)
