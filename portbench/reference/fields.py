"""Site charges, the boundary potential and the pairwise potential.

Charges (potential_solver_gpu.cu:12-63 upstream): a vacancy is +2, or 0
when it has a metallic neighbor or two or more vacancy neighbors; an oxygen
interstitial is -2, or 0 next to a metal; every other site keeps its charge.

The boundary (K) system is the Kirchhoff network over the interface sites,
every site but the first and the last ``L`` (the contacts). An edge (i, j)
between neighbors conducts G_ij = high_G when both sites are metal or both
are neutral vacancies, else low_G. Row i: diag_i = sum over all its
neighbors of G_ij, off-diagonal -G_ij for interface neighbors, and the
right-hand side sums G_ij * (-Vd/2) over left-contact neighbors and
G_ij * (+Vd/2) over right-contact ones. Jacobi-preconditioned CG stops when
r.z / b.b <= (1e-14 * n_interface)^2, the upstream rule.

The pairwise potential of site i is the sum over charged sites q != i with
d2 < cutoff^2 of q_q * erfc(d / (sigma sqrt 2)) * k * e / d, d in meters.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.lattice import ELEM

E_CHARGE = 1.60217663e-19


def charges(element, charge, nbr, metal):
    """The charge rules on (N,) elements over the (N, M) neighbor lists."""
    j = nbr.clamp(min=0)
    real = nbr >= 0
    vac_nbrs = (real & (element[j] == ELEM["VACANCY"])).sum(dim=1)
    any_metal = (real & metal[j]).any(dim=1)
    v_q = torch.where(any_metal | (vac_nbrs >= 2), 0, 2)
    od_q = torch.where(any_metal, 0, -2)
    out = torch.where(element == ELEM["VACANCY"], v_q,
                      torch.where(element == ELEM["OXYGEN_DEFECT"], od_q, charge.to(torch.int64)))
    return out.to(charge.dtype)


class KSystem:
    """The K system of one (element, charge) state at bias ``Vd``, in f64."""

    def __init__(self, element, charge, nbr, metal, L, Vd, high_G, low_G):
        n = element.shape[0]
        self.n, self.L = n, L
        rows = nbr[L:n - L]
        j = rows.clamp(min=0)
        real = rows >= 0
        cvac = (element == ELEM["VACANCY"]) & (charge == 0)
        hi = (metal[L:n - L, None] & metal[j]) | (cvac[L:n - L, None] & cvac[j])
        f64 = dict(dtype=torch.float64, device=element.device)
        G = torch.where(real, torch.where(hi, torch.tensor(high_G, **f64),
                                          torch.tensor(low_G, **f64)), torch.zeros((), **f64))
        left, right = real & (j < L), real & (j >= n - L)
        self.diag = G.sum(dim=1)
        self.rhs = (torch.where(left, G, 0.0).sum(dim=1) * (-Vd / 2.0)
                    + torch.where(right, G, 0.0).sum(dim=1) * (Vd / 2.0))
        inner = real & ~left & ~right
        self.off = torch.where(inner, G, 0.0)
        self.col = torch.where(inner, j - L, 0)
        self.inv_diag = torch.where(self.diag > 0, 1.0 / torch.where(self.diag > 0, self.diag, 1.0),
                                    1.0)
        self.rtol = 1e-14 * (n - 2 * L)

    def matvec(self, x, dtype=torch.float64):
        off = self.off.to(dtype)
        return self.diag.to(dtype) * x - (off * x[self.col]).sum(dim=1)

    def residual_ratio(self, potential_boundary) -> float:
        """sqrt(r.z / b.b) / rtol of a full-length boundary potential, taken
        in f64: 1 where the upstream stop rule is just met."""
        x = potential_boundary[self.L:self.n - self.L].to(torch.float64)
        r = self.rhs - self.matvec(x)
        rz = torch.dot(r, r * self.inv_diag)
        return math.sqrt(float(rz / torch.dot(self.rhs, self.rhs))) / self.rtol

    def solve(self, x0_full, dtype=torch.float64, max_iterations: int = 10000):
        """Jacobi CG in ``dtype`` from the full-length start ``x0_full``:
        (full-length solution, iterations)."""
        b = self.rhs.to(dtype)
        inv_d = self.inv_diag.to(dtype)
        x = x0_full[self.L:self.n - self.L].to(dtype)
        tol2 = self.rtol ** 2
        bb = torch.dot(b, b)
        r = b - self.matvec(x, dtype)
        z = r * inv_d
        p = z
        rz = torch.dot(r, z)
        k = 1
        while k <= max_iterations and float(rz / bb) > tol2:
            Ap = self.matvec(p, dtype)
            a = rz / torch.dot(p, Ap)
            x = x + a * p
            r = r - a * Ap
            z = r * inv_d
            rz_new = torch.dot(r, z)
            p = z + (rz_new / rz) * p
            rz = rz_new
            k += 1
        full = torch.zeros(self.n, dtype=torch.float64, device=x.device)
        full[self.L:self.n - self.L] = x.to(torch.float64)
        return full, k


def pairwise(sites, pos, charge, cutoff, sigma, k, dtype=torch.float64, block: int = 256):
    """Pairwise potential [V] at ``sites`` in ``dtype`` (coordinates, plane
    and sums alike); returned in f64."""
    q_idx = torch.nonzero(charge != 0).flatten()
    q_pos = pos[q_idx].to(dtype)
    q_val = charge[q_idx].to(dtype)
    cut2 = torch.tensor(cutoff * cutoff, dtype=torch.float64).to(dtype)
    inv_sig = torch.tensor(1.0 / (sigma * math.sqrt(2.0)), dtype=dtype)
    kq = torch.tensor(k * E_CHARGE, dtype=dtype)
    ang = torch.tensor(1e-10, dtype=dtype)
    inv_sig, kq, ang = (t.to(pos.device) for t in (inv_sig, kq, ang))
    out = []
    for s in range(0, sites.shape[0], block):
        i = sites[s:s + block]
        p_i = pos[i].to(dtype)
        d2 = (p_i[:, None, 0] - q_pos[None, :, 0]) ** 2
        for a in (1, 2):
            d2 = d2 + (p_i[:, None, a] - q_pos[None, :, a]) ** 2
        ok = (d2 < cut2) & (i[:, None] != q_idx[None])
        d = ang * torch.sqrt(torch.where(ok, d2, torch.ones_like(d2)))
        v = q_val[None] * torch.special.erfc(d * inv_sig) * kq / d
        out.append(torch.where(ok, v, torch.zeros_like(v)).sum(dim=1).to(torch.float64))
    return torch.cat(out)
