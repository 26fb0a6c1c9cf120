"""Structure generators — the host-side generators of
``akmc_tpu/models/crossbar.py``.

* ``tile_device`` tiles any device cell periodically in y/z;
  ``synthetic_stack`` builds a disordered TiN | HfO2 | Ti | TiN stack with
  prescribed slice counts (its defaults are the 5 nm device's).
* Grid-native crossbar structures (the same stack on a two-sublattice slot
  enumeration) with their analytic neighbor list and DIA K operator. The
  reference's crossbar decks ship without their structure files, so the
  driver's ``--synthesize-crossbar N_YZ`` builds a stand-in stack from the
  deck's parameters (``synthesize_deck_structure``).
* ``sort_crossbar`` orders a crossbar's sites into word lines, oxide and bit
  lines.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from akmc_tpu_torch.lattice import ELEM


def toy_device(nx=10, ny=4, nz=4, a=2.0, contact_layers=2, seed=0, vacancy_fraction=0.2):
    """A tiny VCM-like device for law checks and tests: simple-cubic lattice
    along x, metal contact planes at both ends, oxide with a few interstitial
    defect sites between, ``vacancy_fraction`` of the oxygen turned into
    vacancies (stream ``ReferenceRNG(7)``). (KMCParameters, Lattice)."""
    from akmc_tpu_torch.config import KMCParameters, Layer
    from akmc_tpu_torch.lattice import build_lattice
    from akmc_tpu_torch.rng import ReferenceRNG
    from akmc_tpu_torch.state import make_substoichiometric

    rng = np.random.RandomState(seed)
    ix, iy, iz = (g.ravel() for g in np.meshgrid(range(nx), range(ny), range(nz), indexing="ij"))
    x, y, z = ix * a, iy * a, iz * a
    e = np.where((ix < contact_layers) | (ix >= nx - contact_layers),
                 int(ELEM.Ti), int(ELEM.O)).astype(np.int32)
    n_def = max(2, (nx - 2 * contact_layers) * ny * nz // 8)
    picked = rng.choice(np.nonzero(e == int(ELEM.O))[0], n_def, replace=False)
    x = np.concatenate([x, x[picked] + a / 2])
    y = np.concatenate([y, y[picked] + a / 2])
    z = np.concatenate([z, z[picked] + a / 2])
    e = np.concatenate([e, np.full(n_def, int(ELEM.DEFECT), np.int32)])
    order = np.lexsort((z, y, x))
    x, y, z, e = x[order], y[order], z[order], e[order]
    x0, x1, cL = x.min(), x.max(), contact_layers * a
    layers = [
        Layer("contact", 0.0, 0.0, 0.0, 0.76, x0 - 1, x0 + cL - a / 2),
        Layer("oxide", 1.5, 0.1, 1.09, 0.76, x0 + cL - a / 2, x1 - cL + a / 2),
        Layer("contact", 1.73, 0.0, 0.0, 2.8, x1 - cL + a / 2, x1 + 1),
    ]
    p = KMCParameters(
        lattice=[x1 - x0 + a, ny * a, nz * a], nn_dist=a * 1.2, freq=10e13, sigma=3.5e-10,
        epsilon=23.0, metals=["Ti", "N"], num_atoms_first_layer=int((x <= x0 + 1e-9).sum()),
        num_layers_contact=contact_layers, background_temp=300.0, layers=layers,
        max_num_neighbors=20, cutoff_radius=3 * a + 0.1, solve_potential=True,
        perturb_structure=True,
    )
    if vacancy_fraction:
        e = make_substoichiometric(e, vacancy_fraction, ReferenceRNG(7))
    return p, build_lattice(e, x, y, z, p)


def tile_device(
    element: np.ndarray,
    x: np.ndarray,
    y: np.ndarray,
    z: np.ndarray,
    unit_lattice: Tuple[float, float, float],
    ny: int,
    nz: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Tile a unit device ny x nz times along y/z.

    Returns (element, x, y, z, lattice), sites in lexicographic (x, y, z)
    order.
    """
    ey, ez = unit_lattice[1], unit_lattice[2]
    shifts = [(iy * ey, iz * ez) for iy in range(ny) for iz in range(nz)]
    e_out = np.concatenate([element] * len(shifts))
    x_out = np.concatenate([x] * len(shifts))
    y_out = np.concatenate([y + sy for sy, _ in shifts])
    z_out = np.concatenate([z + sz for _, sz in shifts])
    order = np.lexsort((z_out, y_out, x_out))
    lattice = np.array([unit_lattice[0], ny * ey, nz * ez])
    return e_out[order], x_out[order], y_out[order], z_out[order], lattice


def synthetic_stack(
    n_yz: int = 24,
    a: float = 2.131255,
    contact_slices: int = 10,
    oxide_slices: int = 20,
    ti_slices: int = 8,
    vacancy_defect_fraction: float = 0.3,
    seed: int = 0,
):
    """Generate a TiN | HfO2 | Ti | TiN stack on a simple lattice.

    x-slice layout (matching the 5 nm device's element profile):
      contact_slices of alternating Ti/N  |  oxide_slices of Hf+O (+ DEFECT
      interstitial sites at cell centers, a random subset per slice)  |
      ti_slices of Ti  |  contact_slices of alternating Ti/N.

    Returns (element, x, y, z, lattice, params_patch) where params_patch
    holds num_atoms_first_layer / num_layers_contact / lattice consistent
    with the structure. One ``RandomState(seed).choice`` per oxide slice, in
    slice order, as ``akmc_tpu`` draws them.
    """
    rng = np.random.RandomState(seed)
    nx_total = 2 * contact_slices + oxide_slices + ti_slices
    iy, iz = (g.ravel() for g in np.meshgrid(np.arange(n_yz), np.arange(n_yz), indexing="ij"))
    elems, xs, ys, zs = [], [], [], []

    def add_slice(e, ix, jy, jz, off=0.0):
        elems.append(np.broadcast_to(np.asarray(e, np.int32), jy.shape))
        xs.append(np.full(jy.shape, ix * a + off))
        ys.append(jy * a + off)
        zs.append(jz * a + off)

    def checker(odd, even, s):
        return np.where((iy + iz + s) % 2, int(odd), int(even))

    x_cursor = 0
    for s in range(contact_slices):                      # left contact
        add_slice(checker(ELEM.Ti, ELEM.N, s), x_cursor, iy, iz)
        x_cursor += 1
    n_def = int(vacancy_defect_fraction * n_yz * n_yz)
    for s in range(oxide_slices):                        # Hf + O rocksalt
        add_slice(checker(ELEM.Hf, ELEM.O, s), x_cursor, iy, iz)
        # interstitial DEFECT sites at cell centers (sparse random subset)
        picks = rng.choice(n_yz * n_yz, n_def, replace=False)
        add_slice(int(ELEM.DEFECT), x_cursor, picks // n_yz, picks % n_yz, off=a / 2)
        x_cursor += 1
    for s in range(ti_slices):                           # Ti scavenging layer
        add_slice(int(ELEM.Ti), x_cursor, iy, iz)
        x_cursor += 1
    for s in range(contact_slices):                      # right contact
        add_slice(checker(ELEM.Ti, ELEM.N, s), x_cursor, iy, iz)
        x_cursor += 1

    e, x, y, z = (np.concatenate(v) for v in (elems, xs, ys, zs))
    order = np.lexsort((z, y, x))
    e, x, y, z = e[order].astype(np.int32), x[order], y[order], z[order]

    lattice = np.array([nx_total * a, n_yz * a, n_yz * a])
    params_patch = dict(
        lattice=list(lattice),
        num_atoms_first_layer=n_yz * n_yz,
        num_layers_contact=contact_slices,
        num_atoms_contact=contact_slices * n_yz * n_yz,
        metals=["Ti", "N"],
    )
    return e, x, y, z, lattice, params_patch


def grid_stack(
    n_yz: int = 24,
    a: float = 2.131255,
    contact_slices: int = 10,
    oxide_slices: int = 20,
    ti_slices: int = 8,
    defect_fraction: float = 0.3,
    seed: int = 0,
):
    """Grid-NATIVE TiN | HfO2 | Ti | TiN stack: every site lives on a fixed
    two-sublattice slot enumeration, so the K adjacency's index offsets form
    a SMALL static set and the potential solve runs on the gather-free DIA
    operator (solvers/dia.py) at any scale.

    Slot layout:  index(ix, s, iy, iz) = ((ix*2 + s)*n_yz + iy)*n_yz + iz
    with sublattice s=0 the cubic grid (position ix,iy,iz * a) and s=1 the
    cell-center slot (+a/2 on each axis). Center slots host interstitial
    DEFECT sites in the oxide (a random ``defect_fraction`` subset); all
    other center slots are NULL_ELEMENT placeholders that carry no edges, no
    charge and no events — they only preserve the regular enumeration.
    Contacts are positional like the reference's ([0, L) and [N-R, N) with
    L = R = 2*n_yz^2 including the slice's null centers).

    Open boundaries only (the 40 nm crossbar deck runs pbc=0).

    Returns (element, x, y, z, lattice, params_patch).
    """
    rng = np.random.RandomState(seed)
    nx_total = 2 * contact_slices + oxide_slices + ti_slices
    slice_n = 2 * n_yz * n_yz
    n = nx_total * slice_n

    iy, iz = np.meshgrid(np.arange(n_yz), np.arange(n_yz), indexing="ij")
    iy = iy.ravel()
    iz = iz.ravel()

    element = np.full(n, int(ELEM.NULL_ELEMENT), np.int32)
    x = np.empty(n)
    y = np.empty(n)
    z = np.empty(n)
    ox_lo, ox_hi = contact_slices, contact_slices + oxide_slices

    for ix in range(nx_total):
        base = ix * slice_n
        g = base + iy * n_yz + iz                 # s=0 grid slots
        c = base + n_yz * n_yz + iy * n_yz + iz   # s=1 center slots
        x[g] = ix * a
        y[g] = iy * a
        z[g] = iz * a
        x[c] = ix * a + a / 2
        y[c] = iy * a + a / 2
        z[c] = iz * a + a / 2
        if ix < ox_lo or ix >= ox_hi + ti_slices:          # TiN contacts
            element[g] = np.where((iy + iz + ix) % 2, int(ELEM.Ti), int(ELEM.N))
        elif ix >= ox_hi:                                   # Ti scavenging
            element[g] = int(ELEM.Ti)
        else:                                               # HfO2 oxide
            element[g] = np.where((iy + iz + ix) % 2, int(ELEM.Hf), int(ELEM.O))
            n_def = int(defect_fraction * n_yz * n_yz)
            picks = rng.choice(n_yz * n_yz, n_def, replace=False)
            element[c[picks]] = int(ELEM.DEFECT)

    lattice = np.array([nx_total * a, n_yz * a, n_yz * a])
    params_patch = dict(
        lattice=list(lattice),
        num_atoms_first_layer=slice_n,
        num_layers_contact=contact_slices,
        num_atoms_contact=contact_slices * slice_n,
        metals=["Ti", "N"],
        pbc=False,
    )
    return element, x, y, z, lattice, params_patch


def mask_null_slots(lat):
    """Remove every adjacency entry that touches a NULL_ELEMENT slot (the
    placeholders exist only to keep the slot enumeration regular; they carry
    no physics). In-place on the Lattice's index tables; remaining entries
    are left-compacted, -1 padded."""
    null = lat.element0 == int(ELEM.NULL_ELEMENT)

    def filt(tbl):
        drop = null[:, None] | (null[np.clip(tbl, 0, None)] & (tbl >= 0))
        if not drop.any():
            return tbl      # already null-free (analytic builder) — the
            #                 per-row repack costs ~25 s/table at 4.5M slots
        out = np.where(drop, -1, tbl)
        # left-compact each row (stable): valid entries first
        key = out < 0
        order = np.argsort(key, axis=1, kind="stable")
        return np.take_along_axis(out, order, axis=1)

    lat.neigh_idx[:] = filt(lat.neigh_idx)
    if lat.k_neigh_idx is not lat.neigh_idx:
        lat.k_neigh_idx[:] = filt(lat.k_neigh_idx)
    return lat


def crossbar_layers(contact_slices: int, oxide_slices: int, ti_slices: int,
                    a: float = 2.131255):
    """Layer table for a grid_stack structure: the TiN/HfO2/Ti/TiN energy
    parameterization (structure_input.h:10-50) with x-ranges matched to the
    generated slice layout (layer binning is last-match-wins by x,
    KMCProcess.cpp:33-50)."""
    from akmc_tpu_torch.config import Layer

    x0 = 0.0
    x1 = (2 * contact_slices + oxide_slices + ti_slices - 1) * a
    cL = contact_slices * a
    ox_end = (contact_slices + oxide_slices) * a
    return [
        Layer("contact", 0.0, 0.0, 0.0, 0.76, x0 - 1, cL - a / 4),
        Layer("oxide", 3.93, 0.0, 1.09, 0.76, cL - a / 4, ox_end - a / 4),
        Layer("interface", 1.66, 0.0, 1.09, 0.76, ox_end - a / 4,
              ox_end + ti_slices * a - a / 4),
        # end past x1 + a/2: the last slice's (null) center slots sit there
        Layer("contact", 1.73, 0.0, 0.0, 2.8, ox_end + ti_slices * a - a / 4,
              x1 + a),
    ]


def synthesize_deck_structure(p, n_yz: int, a: float = 2.131255,
                              ti_slices: int = 8):
    """Stand-in structure for a crossbar DECK whose xyz files are stripped
    from the reference snapshot (.MISSING_LARGE_BLOBS lists both 40 nm
    crossbar files). Builds a grid-native stack whose x-extent matches the
    deck's lattice[0] and whose contact depth matches num_layers_contact;
    the y/z cross-section is set by ``n_yz`` (the deck's full 409.6 A
    cross-section corresponds to n_yz=192).

    Returns (p_patched, element, x, y, z): ``p_patched`` is a copy of the
    deck parameters with the structure-derived fields (lattice,
    contact counts, metals, layer table) replaced; every physics/run
    parameter (V_switch, t_switch, seeds, flags, freq, sigma, ...) is kept
    from the deck. Substoichiometry is NOT applied here — the driver's
    standard pristine path does that with the deck's seed."""
    import dataclasses

    contact_slices = int(p.num_layers_contact) or 10
    total_slices = max(
        2 * contact_slices + ti_slices + 2,
        int(round(p.lattice[0] / a)) if p.lattice else 50,
    )
    oxide_slices = total_slices - 2 * contact_slices - ti_slices

    e, x, y, z, lattice, patch = grid_stack(
        n_yz=n_yz, a=a, contact_slices=contact_slices,
        oxide_slices=oxide_slices, ti_slices=ti_slices,
        defect_fraction=0.1, seed=int(p.rnd_seed),
    )
    p_patched = dataclasses.replace(
        p,
        lattice=patch["lattice"],
        num_atoms_first_layer=patch["num_atoms_first_layer"],
        num_layers_contact=patch["num_layers_contact"],
        num_atoms_contact=patch["num_atoms_contact"],
        metals=patch["metals"],
        layers=crossbar_layers(contact_slices, oxide_slices, ti_slices, a),
    )
    return p_patched, e, x, y, z


def _grid_offset_classes(n_yz: int, a: float, nn_dist: float):
    """Static in-cutoff offset classes of the two-sublattice grid stack,
    per source sublattice, sorted ascending by linear-index delta.
    Entries: (delta, djx, djy, djz)."""
    r2 = nn_dist * nn_dist
    m = int(np.ceil(nn_dist / a)) + 1
    classes = {0: [], 1: []}
    for ss in (0, 1):
        for tt in (0, 1):
            h = (tt - ss) * 0.5
            for djx in range(-m, m + 1):
                for djy in range(-m, m + 1):
                    for djz in range(-m, m + 1):
                        if ss == tt and djx == djy == djz == 0:
                            continue
                        dx = (djx + h) * a
                        dy = (djy + h) * a
                        dz = (djz + h) * a
                        if dx * dx + dy * dy + dz * dz < r2:
                            delta = (
                                (djx * 2 + (tt - ss)) * n_yz + djy
                            ) * n_yz + djz
                            classes[ss].append((delta, djx, djy, djz))
    for ss in (0, 1):
        classes[ss].sort()
    return classes


def grid_neighbor_list(
    n_yz: int,
    nx_total: int,
    a: float,
    nn_dist: float,
    max_nn: int,
    null_mask: np.ndarray = None,
) -> np.ndarray:
    """Analytic neighbor list for the grid-native two-sublattice stack:
    the slot enumeration index(ix, s, iy, iz) = ((ix*2+s)*n_yz + iy)*n_yz
    + iz makes every in-cutoff neighbor a STATIC linear-index offset, so
    the list is index arithmetic + boundary masks — no spatial search.
    Produces the identical (n, max_nn) table (same neighbors, same
    ascending-index order, -1 padded) as the native C++ cell-list builder
    at ~20x less host time at the 2.37M-site scale (the cell list was the
    234 s init bottleneck, BENCH_init_r03). Reference analogue: the
    nearest-neighbor scans in neighbor_lists_gpu.cu:24-93 — part of the
    ~20 min/node crossbar initialization (README.md:11) this path
    replaces for grid-native structures. Equality is pinned by
    tests/test_crossbar.py::test_grid_neighbor_list_matches_cell_list.

    Open boundaries (the crossbar decks run pbc=0)."""
    n = nx_total * 2 * n_yz * n_yz
    idx = np.arange(n, dtype=np.int64)
    iz = idx % n_yz
    iy = (idx // n_yz) % n_yz
    sx = idx // (n_yz * n_yz)
    s = (sx % 2).astype(np.int32)
    ix = (sx // 2).astype(np.int64)

    classes = _grid_offset_classes(n_yz, a, nn_dist)
    K = max(len(classes[0]), len(classes[1]))

    # null_mask: exclude NULL placeholder slots up front (same rule as
    # mask_null_slots) — the downstream per-row repacking then has nothing
    # to do (it measured ~50 s of hidden argsort at 4.5M slots)
    ok_i = None if null_mask is None else ~null_mask
    jmat = np.full((n, K), -1, np.int32)
    # per-axis range masks are shared across classes (few distinct dj per
    # axis), and each class writes one full column via np.where — a
    # boolean-mask assignment would run a hidden nonzero + scatter per
    # class (measured slower at 4.5M slots)
    ax_cache = {}

    def _ax(base, dj, hi, tag):
        key = (tag, dj)
        if key not in ax_cache:
            ax_cache[key] = (base + dj >= 0) & (base + dj < hi)
        return ax_cache[key]

    jidx = idx.astype(np.int32)
    for ss in (0, 1):
        rows = s == ss
        for k, (delta, djx, djy, djz) in enumerate(classes[ss]):
            ok = (
                rows
                & _ax(ix, djx, nx_total, "x")
                & _ax(iy, djy, n_yz, "y")
                & _ax(iz, djz, n_yz, "z")
            )
            if ok_i is not None:
                ok = ok & ok_i
                jcl = np.where(ok, idx + delta, 0)
                ok = ok & ok_i[jcl]
            np.copyto(
                jmat[:, k], jidx + np.int32(delta), where=ok, casting="no"
            )

    # pack valid entries left (stable: preserves ascending-delta order).
    # Measured at 4.5M slots: this per-row stable argsort beats a
    # cumsum-position flat scatter (80 vs 132 s — the (N*K,) nonzero +
    # fancy double-index gathers lose on this host's ~2 GB/s memory)
    order = np.argsort(jmat < 0, axis=1, kind="stable")
    packed = np.take_along_axis(jmat, order, axis=1)
    found = int((packed >= 0).sum(axis=1).max())
    if found > max_nn:
        raise ValueError(
            f"grid neighbor list needs {found} slots > max_num_neighbors={max_nn}"
        )
    out = np.full((n, max_nn), -1, np.int32)
    out[:, : min(K, max_nn)] = packed[:, : min(K, max_nn)]
    return out


def grid_dia_k(
    n_yz: int,
    nx_total: int,
    a: float,
    nn_dist: float,
    is_metal: np.ndarray,
    num_atoms_first_layer: int,
    high_G: float,
    low_G: float,
    pos: np.ndarray,
    null_mask: np.ndarray = None,
):
    """Analytic DIA K operator for the grid-native stack — BIT-IDENTICAL
    to solvers.dia.build_dia_k on the same structure (equality-pinned by
    tests/test_crossbar.py::test_grid_dia_matches_generic): the int8 codes
    are integers, the edge values are the two constants {low_G, high_G},
    and the degree/boundary sums accumulate per offset class in the same
    ascending-delta order the generic builder's bincount follows (the
    packed neighbor table is ascending-j). Replaces the (N, KNN) edge-list
    scan — the 57 s DIA build at the 4.5M-slot crossbar (reference
    analogue: initialize_sparsity_K's per-rank nnz counting + CSR
    assembly, iterative_solvers_gpu.cu:262-488).

    ``null_mask``: NULL placeholder slots (mask_null_slots removes every
    edge touching one from the index tables; the analytic enumeration must
    exclude them the same way).

    Open boundaries (pbc=0) like the rest of the grid-native path."""
    from akmc_tpu_torch.solvers.dia import make_dia

    n = nx_total * 2 * n_yz * n_yz
    idx = np.arange(n, dtype=np.int64)
    iz = idx % n_yz
    iy = (idx // n_yz) % n_yz
    sx = idx // (n_yz * n_yz)
    s = (sx % 2).astype(np.int32)
    ix = (sx // 2).astype(np.int64)

    classes = _grid_offset_classes(n_yz, a, nn_dist)
    merged = sorted(
        (delta, ss, djx, djy, djz)
        for ss in (0, 1)
        for (delta, djx, djy, djz) in classes[ss]
    )

    # validity masks (reuse per-axis range tests across classes)
    _ax_cache = {}
    _ax_base = {"x": (ix, nx_total), "y": (iy, n_yz), "z": (iz, n_yz)}

    def axis_ok(axis, dj):
        key = (axis, dj)
        if key not in _ax_cache:
            base, hi = _ax_base[axis]
            _ax_cache[key] = (base + dj >= 0) & (base + dj < hi)
        return _ax_cache[key]

    ok_i = np.ones(n, bool) if null_mask is None else ~null_mask
    entries = []          # (delta, v) with at least one valid row
    for delta, ss, djx, djy, djz in merged:
        v = (
            (s == ss)
            & ok_i
            & axis_ok("x", djx)
            & axis_ok("y", djy)
            & axis_ok("z", djz)
        )
        if null_mask is not None:
            j = np.where(v, idx + delta, 0)
            v = v & ~null_mask[j]
        if v.any():
            entries.append((delta, v))

    uniq = sorted({delta for delta, _ in entries})
    off_index = {o: d for d, o in enumerate(uniq)}
    diags = np.zeros((len(uniq), n), np.int8)
    deg = np.zeros(n)
    lsum = np.zeros(n)
    rsum = np.zeros(n)
    active = np.zeros(n, bool)
    L = R = num_atoms_first_layer
    for delta, v in entries:
        j = np.where(v, idx + delta, 0)
        mm = v & is_metal & is_metal[j]
        d = off_index[delta]
        diags[d][v] += np.int8(1)
        diags[d][mm] += np.int8(1)
        val = np.where(mm, high_G, np.where(v, low_G, 0.0))
        deg += val
        lsum += np.where(j < L, val, 0.0)
        rsum += np.where(j >= n - R, val, 0.0)
        active |= v

    return make_dia(diags, deg, lsum, rsum, pos, active, uniq, low_G, high_G)


def build_grid_crossbar(
    n_yz: int = 24,
    contact_slices: int = 10,
    oxide_slices: int = 20,
    ti_slices: int = 8,
    defect_fraction: float = 0.3,
    vacancy_concentration: float = 0.05,
    seed: int = 0,
    a: float = 2.131255,
    freq: float = 10e13,
):
    """grid_stack -> substoichiometry -> Lattice with null links masked ->
    (KMCParameters, Lattice). The one-call crossbar construction used by the
    scale benchmarks and the crossbar runner."""
    from akmc_tpu_torch.config import KMCParameters
    from akmc_tpu_torch.lattice import build_lattice
    from akmc_tpu_torch.rng import ReferenceRNG
    from akmc_tpu_torch.state import make_substoichiometric

    e, x, y, z, lattice, patch = grid_stack(
        n_yz=n_yz, a=a, contact_slices=contact_slices,
        oxide_slices=oxide_slices, ti_slices=ti_slices,
        defect_fraction=defect_fraction, seed=seed,
    )
    if vacancy_concentration:
        e = make_substoichiometric(e, vacancy_concentration, ReferenceRNG(seed + 1))

    layers = crossbar_layers(contact_slices, oxide_slices, ti_slices, a)
    p = KMCParameters(
        lattice=list(lattice),
        nn_dist=3.5,
        freq=freq,
        sigma=3.5e-10,
        epsilon=23.0,
        metals=patch["metals"],
        num_atoms_first_layer=patch["num_atoms_first_layer"],
        num_layers_contact=patch["num_layers_contact"],
        num_atoms_contact=patch["num_atoms_contact"],
        layers=layers,
        max_num_neighbors=52,
        cutoff_radius=20.0,
        solve_potential=True,
        perturb_structure=True,
        initial_vacancy_concentration=vacancy_concentration,
    )
    nx_total = 2 * contact_slices + oxide_slices + ti_slices
    nl = grid_neighbor_list(
        n_yz, nx_total, a, p.nn_dist, p.max_num_neighbors,
        null_mask=e == int(ELEM.NULL_ELEMENT),
    )
    # open boundaries (pbc=0): the K adjacency equals the neighbor list
    lat = build_lattice(
        e, x, y, z, p, precomputed_lists=(nl, nl), grid=(n_yz, nx_total, a),
    )
    mask_null_slots(lat)
    return p, lat


def sort_crossbar(
    element: np.ndarray,
    x: np.ndarray,
    y: np.ndarray,
    z: np.ndarray,
    split_y: float,
    split_z: float,
) -> Tuple[np.ndarray, ...]:
    """Reorder crossbar sites so that the boundary-condition contacts sit at
    the beginning and the end, grouped into word and bit lines (the
    reference's postprocessing/sort_crossbar.py:49-115).

    The left contact is every leading Ti/N site up to the first oxide (Hf/O)
    site, the right contact the same count of trailing Ti/N sites; the left
    contact splits into two word lines by z < split_z, the right into two
    bit lines by y < split_y. Returns (element, x, y, z) ordered word line
    1, word line 2, oxide, bit line 1, bit line 2 (the reference script
    stops after bit line 1; the whole structure is written here)."""
    is_metal = np.isin(element, [int(ELEM.Ti), int(ELEM.N)])
    is_oxide = np.isin(element, [int(ELEM.Hf), int(ELEM.O)])
    n = len(element)
    first_oxide = int(np.argmax(is_oxide)) if is_oxide.any() else n
    left = np.arange(first_oxide)[is_metal[:first_oxide]]
    num_contact = len(left)
    # trailing Ti/N sites, scanning backwards until an oxide site or the count
    right = []
    for i in range(n - 1, -1, -1):
        if is_oxide[i] or len(right) == num_contact:
            break
        if is_metal[i]:
            right.append(i)
    right = np.array(right[::-1], dtype=np.int64)
    middle = np.setdiff1d(np.arange(n), np.concatenate([left, right]))

    word1 = left[z[left] < split_z]
    word2 = left[z[left] >= split_z]
    bit1 = right[y[right] < split_y]
    bit2 = right[y[right] >= split_y]
    order = np.concatenate([word1, word2, middle, bit1, bit2])
    return element[order], x[order], y[order], z[order]
