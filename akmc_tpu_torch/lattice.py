"""Lattice / structure handling: element coding, xyz I/O, neighbor lists.

Host-side numpy, shared by every device: positions never change during a
simulation, so the lists are built once (reference: kmc_main.cpp:197-207).
``build_lattice`` builds them with the k-d tree here, or on a CUDA device with
the blocked scan of ``lattice_device.py``.

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

import functools
import hashlib
import os
from dataclasses import dataclass
from enum import IntEnum
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
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


# element code -> name; "" where a code has no name (NULL_ELEMENT)
_NAME_TABLE = np.array([ELEMENT_NAMES.get(e, "") for e in ELEM], dtype=object)


class SnapshotWriter:
    """Snapshots of one structure in the reference format (Device.cpp:214-232):
    a site-count header, then ``element x y z potential power`` per site,
    every number as C++'s default stream prints a double (6 significant
    digits, ``{:.6g}``). Positions never change during a run, so their
    columns are formatted once, here; a snapshot formats the rest in one
    pass. Byte for byte what ``akmc_tpu/lattice.py::write_xyz_snapshot``
    writes."""

    def __init__(self, x, y, z):
        cols = [map("{:.6g}".format, np.asarray(a, np.float64).tolist()) for a in (x, y, z)]
        self._xyz = list(map("{}   {}   {}".format, *cols))

    def write(self, path, element, potential, power) -> None:
        codes = np.asarray(element)
        if len(codes) != len(self._xyz):
            raise ValueError(f"{len(codes)} elements for a structure of {len(self._xyz)} sites")
        if codes.size and (codes.min() < 0 or codes.max() >= len(_NAME_TABLE)):
            raise ValueError(f"element codes outside 0..{len(_NAME_TABLE) - 1}")
        names = _NAME_TABLE[codes]
        if codes.size and not names.all():
            raise KeyError(f"no element name for code {int(codes[names == ''][0])}")
        rows = map("{}   {}   {:.6g}   {:.6g}\n".format, names.tolist(), self._xyz,
                   np.asarray(potential, np.float64).tolist(),
                   np.asarray(power, np.float64).tolist())
        with open(path, "w") as f:
            f.write(f"{len(codes)}\n\n")
            f.write("".join(rows))


def write_xyz_snapshot(path, element, x, y, z, potential, power) -> None:
    """Write one snapshot in the reference format (``SnapshotWriter``)."""
    SnapshotWriter(x, y, z).write(path, element, potential, power)


def sort_by_x(element, x, y, z):
    """Stable sort of sites by x (reference: sort_by_x, utils.cpp:176+)."""
    order = np.argsort(x, kind="stable")
    return element[order], x[order], y[order], z[order]


def sort_by_xyz(element, x, y, z):
    """Lexicographic (x, then y, then z) sort (reference: sort_by_xyz)."""
    order = np.lexsort((z, y, x))
    return element[order], x[order], y[order], z[order]


def count_contact_sites(element: np.ndarray, num_atoms_contact: int, side: str) -> int:
    """Number of leading (``side="left"``) or trailing site-array entries
    spanning ``num_atoms_contact`` non-defect atoms (reference:
    get_num_in_contacts, heat_solver.cpp:4-36)."""
    atoms = np.asarray(element) != int(ELEM.DEFECT)
    if side != "left":
        atoms = atoms[::-1]
    found = np.cumsum(atoms)
    hit = np.nonzero(atoms & (found >= num_atoms_contact))[0]
    return int(hit[0]) + 1 if len(hit) else len(atoms)


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


# elements a pairwise-Coulomb source can carry a charge on
_POSSIBLY_CHARGED = (ELEM.OXYGEN_DEFECT, ELEM.O, ELEM.VACANCY, ELEM.DEFECT)


def build_cutoff_list(
    pos: np.ndarray, element: np.ndarray, cutoff_radius: float,
) -> Tuple[np.ndarray, int]:
    """Padded cutoff-candidate table of the pairwise Coulomb sum: for each site
    i, ascending indices j != i with the non-PBC distance < ``cutoff_radius``
    and element[j] possibly charged (neighbor_lists_gpu.cu:107-136). Returns
    (cutoff_idx (N, N_cutoff) int32 -1 padded, N_cutoff), N_cutoff the largest
    row count (compute_cutoff_list, neighbor_lists_gpu.cu:340-342). Candidate
    pairs from a k-d tree, kept by ``site_dist`` as ``build_neighbor_list``
    keeps them: entry for entry the table of akmc_tpu's blocked scan."""
    n = pos.shape[0]
    poss = np.isin(element, np.array(_POSSIBLY_CHARGED, dtype=np.asarray(element).dtype))
    pairs = _candidate_pairs(pos, cutoff_radius * (1.0 + 1e-9), (0.0, 1.0, 1.0), False)
    a, b = pairs[:, 0].astype(np.int64), pairs[:, 1].astype(np.int64)
    keep = site_dist(pos[a], pos[b], (0.0, 1.0, 1.0), False) < cutoff_radius
    a, b = a[keep], b[keep]
    rows = np.concatenate([a, b])
    cols = np.concatenate([b, a])
    sel = poss[cols]
    rows, cols = rows[sel], cols[sel]
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    counts = np.bincount(rows, minlength=n)
    maxc = int(counts.max()) if n else 0
    slot = np.arange(len(rows)) - (np.cumsum(counts) - counts)[rows]
    out = np.full((n, maxc), -1, dtype=np.int32)
    out[rows, slot] = cols
    return out, maxc


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
    # (N, N_cutoff) pairwise candidates (``build_cutoff_list``): parity
    # tooling only, (N, 0) unless read from a list cache that holds them
    cutoff_idx: Optional[np.ndarray] = None

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


def _cache_path(cache_dir: str, pos: np.ndarray, element: np.ndarray, params) -> str:
    """``<cache_dir>/lists_<16 hex>.npz``: the sha1 over the positions, the
    elements and the list parameters that akmc_tpu/lattice.py keys its cache
    with, so that the two packages read each other's files."""
    h = hashlib.sha1()
    h.update(pos.tobytes())
    h.update(element.tobytes())
    h.update(
        f"{params.nn_dist}:{params.max_num_neighbors}:{params.cutoff_radius}:{params.pbc}".encode()
    )
    return os.path.join(cache_dir, f"lists_{h.hexdigest()[:16]}.npz")


def build_lattice(
    element: np.ndarray,
    x: np.ndarray,
    y: np.ndarray,
    z: np.ndarray,
    params,
    cache_dir: Optional[str] = None,
    need_cutoff_table: bool = False,
    precomputed_lists: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    grid: Optional[Tuple[int, int, float]] = None,
    device=None,
) -> Lattice:
    """Construct connectivity. ``precomputed_lists``: (neigh_idx,
    k_neigh_idx) from a structure-aware generator (the grid-native crossbar
    builds them analytically — models/crossbar.py::grid_neighbor_list).

    The builder follows ``device``: on a CUDA device the blocked scan of
    ``lattice_device.py`` builds the lists (akmc_tpu's ``lattice_jax``
    builders), elsewhere (``None``: the host) the k-d tree builders here.
    Both keep a pair by ``site_dist < cutoff``, so the lists, and the cache
    file, are the same whichever built them. A failure on the card raises;
    nothing falls back to the host. ``need_cutoff_table``: akmc_tpu's
    argument, for parity tooling (no program path asks for it): build the
    full ``cutoff_idx``, else an (N, 0) one.

    ``cache_dir``: keep the lists (``neigh_idx``, ``k_neigh_idx``,
    ``cutoff_idx``) in an npz file keyed by the structure, read it when it
    exists and write it when it does not, in akmc_tpu's names and layout. No
    cache with precomputed lists, as in akmc_tpu (regenerating them is
    faster than loading them). The pairwise paths need no cutoff table, so
    a file written here holds an (N, 0) one, as akmc_tpu's driver writes it;
    one read from a file keeps what the file holds (``build_cutoff_list``
    builds the full table)."""
    pos = np.stack([x, y, z], axis=1)
    cache_path = None
    if cache_dir and precomputed_lists is None:
        cache_path = _cache_path(cache_dir, pos, element, params)
    if cache_path and os.path.exists(cache_path):
        with np.load(cache_path) as data:
            neigh_idx = data["neigh_idx"]
            k_neigh_idx = data["k_neigh_idx"]
            cutoff_idx = data["cutoff_idx"]
    else:
        on_card = device is not None and torch.device(device).type == "cuda"
        if on_card:
            from akmc_tpu_torch import lattice_device

            build_nn = functools.partial(lattice_device.build_neighbor_list_device, device=device)
            build_cut = functools.partial(lattice_device.build_cutoff_list_device, device=device)
        else:
            build_nn, build_cut = build_neighbor_list, build_cutoff_list
        if precomputed_lists is not None:
            neigh_idx, k_neigh_idx = precomputed_lists
        else:
            neigh_idx = build_nn(pos, params.nn_dist, params.max_num_neighbors)
            if params.pbc:
                k_neigh_idx = build_nn(
                    pos, params.nn_dist, params.max_num_neighbors,
                    np.asarray(params.lattice, dtype=np.float64), True,
                )
            else:
                k_neigh_idx = neigh_idx      # open boundaries: same table
        if need_cutoff_table:
            cutoff_idx, _ = build_cut(pos, element, params.cutoff_radius)
        else:
            cutoff_idx = np.zeros((len(x), 0), np.int32)
        if cache_path:
            os.makedirs(cache_dir, exist_ok=True)
            tmp = f"{cache_path}.{os.getpid()}.tmp.npz"
            np.savez_compressed(tmp, neigh_idx=neigh_idx, k_neigh_idx=k_neigh_idx,
                                cutoff_idx=cutoff_idx)
            os.replace(tmp, cache_path)     # a concurrent reader never sees a partial file
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
        cutoff_idx=cutoff_idx,
    )


def metal_mask(element: np.ndarray, metals: Sequence[str]) -> np.ndarray:
    """Boolean mask of metallic sites given metal element names
    (is_in_array_gpu usage, gpu_solvers.h:268-278)."""
    codes = np.array([int(NAME_TO_ELEMENT[m]) for m in metals], dtype=element.dtype)
    return np.isin(element, codes)
