"""Lattice / structure handling: element coding, xyz I/O, neighbor lists.

Host-side numpy, shared by every device: positions never change during a
simulation, so the lists are built once (reference: kmc_main.cpp:197-207).

Reference behavior reproduced exactly (same rules as ``akmc_tpu.lattice``):
  * element coding (utils.cpp:7-53),
  * xyz format (utils.cpp:72-98; snapshots Device.cpp:214-232),
  * the neighbor table: for each site, ascending indices j != i with the
    NON-PBC Euclidean distance < nn_dist, -1 padded
    (neighbor_lists_gpu.cu:55-78).

With ``pbc = 1`` the K sparsity wraps y/z (``build_k_adjacency``,
iterative_solvers_gpu.cu:96-124) while the event and pairwise tables never do
(kmc_events.cu:154-155): the asymmetry is the reference's and is kept.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum
from typing import Optional, Sequence, Tuple

import numpy as np
from scipy.spatial import cKDTree


class ELEM(IntEnum):
    """Site element coding (reference: utils.h:37-44)."""

    DEFECT = 0          # "d"  - lattice interstitial site
    OXYGEN_DEFECT = 1   # "Od" - oxygen interstitial defect
    VACANCY = 2         # "V"  - lattice vacancy
    O = 3
    Hf = 4
    Ni = 5
    Ti = 6
    Pt = 7
    N = 8
    NULL_ELEMENT = 9


ELEMENT_NAMES = {
    ELEM.DEFECT: "d",
    ELEM.OXYGEN_DEFECT: "Od",
    ELEM.VACANCY: "V",
    ELEM.O: "O",
    ELEM.Hf: "Hf",
    ELEM.Ni: "Ni",
    ELEM.Ti: "Ti",
    ELEM.Pt: "Pt",
    ELEM.N: "N",
}
NAME_TO_ELEMENT = {v: k for k, v in ELEMENT_NAMES.items()}


class EVENT(IntEnum):
    """Event type coding (reference: utils.h:53-60)."""

    VACANCY_GENERATION = 0
    VACANCY_RECOMBINATION = 1
    VACANCY_DIFFUSION = 2
    ION_DIFFUSION = 3
    NULL_EVENT = 4


def read_xyz(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Read an xyz file -> (element codes, x, y, z). Reference: utils.cpp:72-98."""
    with open(path) as f:
        n = int(f.readline().split()[0])
        f.readline()  # comment line
        elems = np.empty(n, dtype=np.int32)
        xyz = np.empty((n, 3), dtype=np.float64)
        for i in range(n):
            parts = f.readline().split()
            elems[i] = int(NAME_TO_ELEMENT[parts[0]])
            xyz[i] = [float(v) for v in parts[1:4]]
    return elems, xyz[:, 0].copy(), xyz[:, 1].copy(), xyz[:, 2].copy()


def write_xyz_snapshot(path, element, x, y, z, potential, power) -> None:
    """Write a snapshot in the reference format (Device.cpp:214-232):
    ``element x y z potential power`` with a site-count header."""
    n = len(element)
    with open(path, "w") as f:
        f.write(f"{n}\n\n")
        f.writelines(
            f"{ELEMENT_NAMES[ELEM(int(element[i]))]}   {_fmt(x[i])}   {_fmt(y[i])}"
            f"   {_fmt(z[i])}   {_fmt(potential[i])}   {_fmt(power[i])}\n"
            for i in range(n)
        )


def _fmt(v: float) -> str:
    # reference streams doubles with default precision (6 significant digits)
    return f"{float(v):.6g}"


def center_coords(x, y, z, dims=(True, True, True)):
    """Shift the minimum coordinate to 0 in the selected dims
    (reference: center_coords, utils.h:121)."""
    return tuple(a - a.min() if do else a for a, do in zip((x, y, z), dims))


def translate_cell(x, y, z, lattice: Sequence[float], shifts: Sequence[float]):
    """Translate coordinates across the periodic cell by fractional shifts
    (reference: translate_cell, utils.cpp:267-299; used when `shift = 1`)."""
    dims = [s != 0.0 for s in shifts]
    x, y, z = center_coords(x, y, z, dims)
    out = [
        np.where(a < frac * dim, a + dim, a) if do else a
        for a, dim, frac, do in zip((x, y, z), lattice, shifts, dims)
    ]
    return center_coords(*out, dims)


def site_dist(
    p1: np.ndarray, p2: np.ndarray, lattice: Sequence[float], pbc: bool
) -> np.ndarray:
    """Distance between position rows, PBC in y/z only (utils.cpp:100-174).

    p1: (..., 3), p2: (..., 3) broadcastable.
    """
    d = p1 - p2
    if pbc:
        dy = d[..., 1] / lattice[1]
        dy = (dy - np.round(dy)) * lattice[1]
        dz = d[..., 2] / lattice[2]
        dz = (dz - np.round(dz)) * lattice[2]
        return np.sqrt(d[..., 0] ** 2 + dy**2 + dz**2)
    return np.sqrt((d**2).sum(-1))


def _dist2(p1: np.ndarray, p2: np.ndarray, lattice: Sequence[float], pbc: bool) -> np.ndarray:
    """Squared distance of position rows, PBC in y/z only, as
    ``akmc_tpu/lattice_jax.py::_block_dist2`` forms it."""
    d = p1 - p2
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    if pbc:
        dy = dy / lattice[1]
        dy = (dy - np.round(dy)) * lattice[1]
        dz = dz / lattice[2]
        dz = (dz - np.round(dz)) * lattice[2]
    return dx * dx + dy * dy + dz * dz


def _candidate_pairs(pos, radius, lattice, pbc) -> np.ndarray:
    """(M, 2) index pairs i < j that can lie within ``radius``: a superset
    from a k-d tree, periodic in y/z when ``pbc``."""
    if not pbc:
        return cKDTree(pos).query_pairs(radius, output_type="ndarray")
    # the periodic tree wants every coordinate in [0, box): wrap y and z,
    # and give the open x axis a box no pair can reach across
    w = np.array(pos, dtype=np.float64)
    w[:, 0] -= w[:, 0].min()
    box = np.array([2.0 * w[:, 0].max() + 4.0 * radius + 1.0, lattice[1], lattice[2]])
    w[:, 1:] = np.mod(w[:, 1:], box[1:])
    w[w >= box] = 0.0
    return cKDTree(w, boxsize=box).query_pairs(radius, output_type="ndarray")


def build_neighbor_list(
    pos: np.ndarray,
    nn_dist: float,
    max_num_neighbors: int,
    lattice: Optional[Sequence[float]] = None,
    pbc: bool = False,
    strict: bool = True,
    squared: bool = False,
) -> np.ndarray:
    """Padded neighbor table: for each site i, ascending indices j != i with
    dist(i, j) < nn_dist, -1 padded to ``max_num_neighbors``. The reference's
    neighbor kernel uses the non-PBC distance: pass ``pbc=False`` for parity
    (populate_neighbor_list, neighbor_lists_gpu.cu:55-78).

    Candidate pairs come from a k-d tree searched slightly beyond nn_dist;
    each is then kept by the reference's own distance expression
    (``site_dist``, evaluated in the same order), so the table equals the
    exhaustive blocked scan of ``akmc_tpu.lattice`` entry for entry at a
    fraction of its host time.

    ``strict=True`` raises if any site exceeds ``max_num_neighbors`` (the
    reference silently truncates — pass strict=False to reproduce that).

    ``squared=True`` keeps a pair by its squared distance against nn_dist^2
    instead (dx*dx + dy*dy + dz*dz, PBC terms as ``site_dist`` forms them):
    the rule of ``akmc_tpu/lattice_jax.py::_block_dist2``, which builds
    akmc_tpu's atom table for the current solver. The two rules can part
    only on a pair within a rounding of the cutoff.
    """
    n = pos.shape[0]
    lat = lattice if lattice is not None else (0.0, 1.0, 1.0)
    pairs = _candidate_pairs(pos, nn_dist * (1.0 + 1e-9), lat, pbc)
    a, b = pairs[:, 0].astype(np.int64), pairs[:, 1].astype(np.int64)
    # the expression is even in p_i - p_j (np.round is odd), so one test
    # decides both directions
    if squared:
        keep = _dist2(pos[a], pos[b], lat, pbc) < nn_dist * nn_dist
    else:
        keep = site_dist(pos[a], pos[b], lat, pbc) < nn_dist
    a, b = a[keep], b[keep]
    rows = np.concatenate([a, b])
    cols = np.concatenate([b, a])
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    counts = np.bincount(rows, minlength=n)
    if strict and n and counts.max() > max_num_neighbors:
        i = int(np.argmax(counts))
        raise ValueError(
            f"site {i} has {counts[i]} neighbors > max_num_neighbors="
            f"{max_num_neighbors}; raise the cap (reference would silently "
            f"truncate, Device.cpp:59)"
        )
    slot = np.arange(len(rows)) - (np.cumsum(counts) - counts)[rows]
    sel = slot < max_num_neighbors
    out = np.full((n, max_num_neighbors), -1, dtype=np.int32)
    out[rows[sel], slot[sel]] = cols[sel]
    return out


def build_k_adjacency(
    pos: np.ndarray,
    nn_dist: float,
    max_num_neighbors: int,
    lattice: Sequence[float],
    pbc: bool,
) -> np.ndarray:
    """Neighbor table for the K matrix sparsity, PBC-aware distance
    (calc_nnz_per_row, iterative_solvers_gpu.cu:96-124). Ascending j order =
    ascending CSR column order, so matrix-free row sums reproduce the
    reference's CSR accumulation order. Identical to build_neighbor_list when
    pbc=False."""
    return build_neighbor_list(pos, nn_dist, max_num_neighbors, lattice, pbc)


@dataclass
class Lattice:
    """Static geometry + connectivity of a device (immutable during a run)."""

    element0: np.ndarray            # (N,) initial element codes (int32)
    x: np.ndarray                   # (N,) f64 Angstrom
    y: np.ndarray
    z: np.ndarray
    lattice: np.ndarray             # (3,) cell dims [Angstrom]
    pbc: bool
    nn_dist: float
    neigh_idx: np.ndarray           # (N, NN) neighbor table (non-PBC dist)
    k_neigh_idx: np.ndarray         # (N, NN) PBC-aware table for the K sparsity
    site_layer: np.ndarray          # (N,) layer id per site
    # grid-native descriptor (n_yz, nx_total, a) for structures on the
    # two-sublattice slot enumeration (models/crossbar.py)
    grid: Optional[Tuple[int, int, float]] = None

    @property
    def N(self) -> int:
        return int(self.element0.shape[0])

    @property
    def max_num_neighbors(self) -> int:
        return int(self.neigh_idx.shape[1])


def assign_layers(x: np.ndarray, layers) -> np.ndarray:
    """Per-site layer id by x binning; the LAST matching layer wins
    (KMCProcess.cpp:33-50). Raises if a site is outside every layer."""
    lid = np.full(x.shape[0], 1000, dtype=np.int32)
    for j, lay in enumerate(layers):
        lid[(lay.start_x <= x) & (x <= lay.end_x)] = j
    if (lid == 1000).any():
        bad = int(np.nonzero(lid == 1000)[0][0])
        raise ValueError(f"Site #{bad} at x={x[bad]} is not inside the device!")
    return lid


def build_lattice(
    element: np.ndarray,
    x: np.ndarray,
    y: np.ndarray,
    z: np.ndarray,
    params,
    precomputed_lists: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    grid: Optional[Tuple[int, int, float]] = None,
) -> Lattice:
    """Construct connectivity. ``precomputed_lists``: (neigh_idx,
    k_neigh_idx) from a structure-aware generator (the grid-native crossbar
    builds them analytically — models/crossbar.py::grid_neighbor_list)."""
    if precomputed_lists is not None:
        neigh_idx, k_neigh_idx = precomputed_lists
    else:
        pos = np.stack([x, y, z], axis=1)
        neigh_idx = build_neighbor_list(pos, params.nn_dist, params.max_num_neighbors)
        if params.pbc:
            k_neigh_idx = build_k_adjacency(
                pos, params.nn_dist, params.max_num_neighbors,
                np.asarray(params.lattice, dtype=np.float64), True,
            )
        else:
            k_neigh_idx = neigh_idx      # open boundaries: same table
    return Lattice(
        element0=element.astype(np.int32),
        x=np.asarray(x, np.float64),
        y=np.asarray(y, np.float64),
        z=np.asarray(z, np.float64),
        lattice=np.asarray(params.lattice, dtype=np.float64),
        pbc=bool(params.pbc),
        nn_dist=float(params.nn_dist),
        neigh_idx=neigh_idx,
        k_neigh_idx=k_neigh_idx,
        site_layer=assign_layers(x, params.layers),
        grid=grid,
    )


def metal_mask(element: np.ndarray, metals: Sequence[str]) -> np.ndarray:
    """Boolean mask of metallic sites given metal element names
    (is_in_array_gpu usage, gpu_solvers.h:268-278)."""
    codes = np.array([int(NAME_TO_ELEMENT[m]) for m in metals], dtype=element.dtype)
    return np.isin(element, codes)
