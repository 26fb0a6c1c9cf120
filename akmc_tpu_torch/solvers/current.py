"""Current / dissipated-power solver (transmission-matrix linear system), as
``akmc_tpu/solvers/current.py`` defines it.

Reference: the dense ``update_power_gpu`` path (current_solver_gpu.cu:2382-2573,
create_X 2175-2316) and its sparse + tunnel split (update_power_gpu_sparse_dist,
1430-1855).

System: nodes [0] = extraction, [1] = injection, [2 .. N_atom+2) = atoms
(non-defect sites; the set is static, since events only exchange elements
within the {V, O} / {Od, d} classes). The last atom is grounded. Terms:

  * neighbor conductances (dist < nn_dist): -high_G for metal-metal or
    neutral-vacancy pairs, else -low_G;
  * WKB tunneling between non-neighbor tunnel-eligible pairs (vacancy <->
    vacancy, vacancy <-> tunnel-window contact metal, metal <-> metal) with
    |dE_CB| > tol:
      trap/trap and contact/contact: T = exp(prefac * d/|dE| * (E1^1.5 - E2^1.5))
                                     (E2 < 0: the E2 term drops, triangular barrier)
      contact->trap: the same expression summed over the occupied contact
                     energies E1 = V0*q + s*dE_step for s*dE_step < |dE|;
  * injection/extraction rails: -high_G from node 1 to the first
    num_source_inj atoms and from node 0 to the last num_ground_ext - 1
    atoms (the reference's strict ``i > N - num_ground_ext`` is kept);
  * -loop_G between nodes 0 and 1; rhs = (-loop_G*Vd, +loop_G*Vd, 0, ...).

No (N_atom+2)^2 matrix is formed: the CG operator is the atom diagonal, the
neighbor part (the static int8 atom band of ``build_power_band``, or a gather
over the atom adjacency), the dense tunnel blocks W_tt / W_ct / W_cc on the
compacted vacancy and contact lists, and the rail terms. The CG is the device
loop of ``solvers/cg.py::jacobi_cg`` with the multiply + sum dot (k
iterations per CUDA-graph replay, one host read per replay). Its scatters
(``_scatter_add``) add at most one non-zero value per index: the compacted
vacancy and contact lists hold each atom once and their pads add exact zeros,
so the device's atomics give the same sum in any order.

The contact-trap block W_ct is, on a card in f64, one launch of the kernel
``csrc/wkb_ct.cu`` (``wkb_contact_trap_kernel``): each pair's terms summed in
a register over the pair's own energy window. Its plain twin
(``wkb_block_plain``), on the CPU and under ``wkb_f32``, runs a chunk's shared energy loop to the chunk's bound
(the largest eligible pair window): every term past a pair's own window is
an exact masked zero. The steps are computed a plane of several energies at
a time and added in ascending order one step at a time, as akmc_tpu's loop
adds them (Kahan-compensated under ``wkb_f32``). Both give the same bits.

Post-solve (scaled by G0): I_macro over the extraction rail; the per-atom
dissipated power P_i = sum_j ineg_ij (m_j - m_i) with ineg the forward-current
matrix (set_ineg, 2353-2379); site power = -alpha * P_i on non-metal atoms.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, fields
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from akmc_tpu_torch.config import EV_TO_J, H_BAR
from akmc_tpu_torch.lattice import ELEM, build_neighbor_list, metal_mask
from akmc_tpu_torch.ops import cuda_build, device_loop
from akmc_tpu_torch.ops.compact import compact_mask
from akmc_tpu_torch.solvers.cg import Operator, addresses, f64_vdot, jacobi_cg, jacobi_cg_plain

F64 = torch.float64


@dataclass
class CurrentTables:
    """Static atom-level tables (the atom set never changes)."""

    atom_ind: torch.Tensor        # (N_atom,) int64 site index of each atom
    atom_pos: torch.Tensor        # (N_atom, 3) f64 [Angstrom]
    atom_neigh_idx: torch.Tensor  # (N_atom, NNa) int64 atom-index adjacency, -1 pad
    atom_is_metal: torch.Tensor   # (N_atom,) bool
    metal_p: torch.Tensor         # (N_atom,) bool: metal in the tunnel window
    contact_idx: torch.Tensor     # (NCp,) int64 atom indices of metal_p contacts,
    #                               -1 padded to a 256-multiple (pad rows of the
    #                               W_cc / W_ct blocks are exact zeros)
    inj_tie: torch.Tensor         # (N_atom,) bool: tied to the injection node
    ext_tie: torch.Tensor         # (N_atom,) bool: tied to the extraction node
    n_inj: int
    n_ext: int

    def to(self, device) -> "CurrentTables":
        return CurrentTables(**{
            f.name: getattr(self, f.name).to(device)
            if isinstance(getattr(self, f.name), torch.Tensor) else getattr(self, f.name)
            for f in fields(self)
        })


def build_current_tables(
    element0: np.ndarray,
    pos: np.ndarray,                # (N, 3)
    lattice: np.ndarray,
    pbc: bool,
    nn_dist: float,
    metals: list,
    num_source_inj: int,
    num_ground_ext: int,
    num_layers_contact: int,
    max_num_neighbors: int = 52,
) -> CurrentTables:
    """Host-side construction (tensors on the CPU).

    The atom adjacency keeps a pair when its squared distance, as
    ``akmc_tpu/lattice_jax.py::_block_dist2`` computes it, lies below
    nn_dist^2: the table of akmc_tpu's ``build_neighbor_list_device``, entry
    for entry (``lattice.py::build_neighbor_list(squared=True)``)."""
    # NULL placeholder slots (grid-native crossbars) are not atoms
    is_atom = (
        (element0 != int(ELEM.DEFECT))
        & (element0 != int(ELEM.OXYGEN_DEFECT))
        & (element0 != int(ELEM.NULL_ELEMENT))
    )
    atom_ind = np.nonzero(is_atom)[0]
    n_atom = len(atom_ind)
    apos = np.asarray(pos[atom_ind], np.float64)
    a_nbr = build_neighbor_list(apos, nn_dist, max_num_neighbors, lattice, pbc,
                                strict=True, squared=True)

    am = metal_mask(element0[atom_ind], metals)
    ai = np.arange(n_atom)
    # tunnel-window contacts exclude the outer num_layers_contact-1 slices
    # (create_X metal1p/metal2p, current_solver_gpu.cu:2206-2213)
    metal_p = (
        am
        & (ai > (num_layers_contact - 1) * num_source_inj)
        & (ai < n_atom - (num_layers_contact - 1) * num_ground_ext)
    )
    inj_tie = ai < num_source_inj
    # reference quirk kept: strict '>', so num_ground_ext-1 atoms
    # (create_X, current_solver_gpu.cu:2306)
    ext_tie = ai > (n_atom - num_ground_ext)

    cidx = np.nonzero(metal_p)[0]
    ncp = max(256, -(-len(cidx) // 256) * 256)
    cidx = np.concatenate([cidx, np.full(ncp - len(cidx), -1)])

    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)

    return CurrentTables(
        atom_ind=t(atom_ind, torch.int64),
        atom_pos=t(apos, F64),
        atom_neigh_idx=t(a_nbr, torch.int64),
        atom_is_metal=t(am),
        metal_p=t(metal_p),
        contact_idx=t(cidx, torch.int64),
        inj_tie=t(inj_tie),
        ext_tie=t(ext_tie),
        n_inj=int(inj_tie.sum()),
        n_ext=int(ext_tie.sum()),
    )


# ---------------------------------------------------------------------------
# WKB tunneling coefficients
# ---------------------------------------------------------------------------

def _prefac(m_e: float) -> float:
    return -(np.sqrt(2.0 * m_e) / H_BAR) * (2.0 / 3.0)


def _wkb_single(dist_m, dE_abs, m_e, V0, f32: bool = False):
    """Single-barrier transmission (trap/trap and contact/contact), create_X
    else-branch (current_solver_gpu.cu:2258-2272). ``f32``: the plane in f32
    with the cancellation-free form of (E1^1.5 - E2^1.5)/dE; the result stays
    f32 (the W blocks are stored f32 under the ``wkb_f32`` lever)."""
    prefac = _prefac(m_e)
    if f32:
        dist_m, dE_abs = dist_m.float(), dE_abs.float()
        prefac = float(np.float32(prefac))
        E1_np = np.float32(EV_TO_J * V0)
    else:
        E1_np = np.float64(EV_TO_J * V0)
    E1 = torch.full((), float(E1_np), dtype=dist_m.dtype, device=dist_m.device)
    E2 = E1 - dE_abs
    if f32:
        # a^1.5 - b^1.5 = (a - b)(a + sqrt(ab) + b)/(sqrt(a) + sqrt(b)) with
        # a - b = dE exactly: the division cancels, no near-equal subtraction
        E2p = torch.clamp(E2, min=0.0)
        expo_trap = prefac * dist_m * (
            (E1 + torch.sqrt(E1 * E2p) + E2p) / (torch.sqrt(E1) + torch.sqrt(E2p))
        )
    else:
        expo_trap = prefac * (dist_m / dE_abs) * (
            float(E1_np**1.5) - torch.where(E2 > 0, E2, 0.0) ** 1.5
        )
    expo_tri = prefac * (dist_m / dE_abs) * float(E1_np**1.5)
    # select-then-exp: one exp per pair
    return torch.exp(torch.where(E2 > 0, expo_trap, expo_tri))


# elements of one (steps, rows, cols) plane of the energy integral, and the
# most steps of one pass of its loop (each pass adds them one at a time)
_PLANE_ELEMENTS = 1 << 24
WKB_PASS_STEPS = 4


def _wkb_contact_trap(dist_m, dE_abs, m_e, V0, n_steps, mask=None, f32: bool = False):
    """Energy-integrated transmission for contact<->trap pairs (create_X
    contact_to_trap branch, current_solver_gpu.cu:2229-2256): the sum over
    s = 0 .. n_steps-1 of the single-barrier term at E1 = q*V0 + s*dE_step,
    masked to s*dE_step < |dE| (the reference's per-pair energy window).

    ``n_steps``: an int, or a 0-d device tensor (``_ct_loop_bound``), the
    shared bound akmc_tpu's ``fori_loop`` runs to. ``mask`` (bool,
    optional): pairs whose integral is never read; their exponents are kept
    in range and their result is 0. The steps run as a loop of passes, each
    evaluating ``WKB_PASS_STEPS`` steps (fewer where the plane would pass
    ``_PLANE_ELEMENTS``) as one (steps, rows, cols) plane and adding them in
    ascending s, one step at a time
    (Kahan-compensated under ``f32``). A step at or past the bound leaves
    the sums as they were: in f64 it adds an exact zero, under ``f32`` it is
    skipped, since a zero term would still fold the compensation into the
    sum. Inside a program (``device_loop.in_program``)
    the passes are a ``device_loop.while_loop`` to the device bound; outside
    one the bound is read once and the passes run on the host."""
    from akmc_tpu_torch.ops import device_loop

    prefac = _prefac(m_e)
    dE_step = EV_TO_J * 0.01
    if mask is not None:
        dE_abs = torch.where(mask, dE_abs, 1.0)
        dist_m = torch.where(mask, dist_m, 1.0)
    if f32:
        prefac = float(np.float32(prefac))
        dist_m, dE_abs = dist_m.float(), dE_abs.float()

    # loop-invariant per-pair factors (the association order of the inline forms)
    q_tri = prefac * (dist_m / dE_abs)
    q_trap = (prefac * dist_m) if f32 else q_tri
    acc = torch.zeros_like(dist_m)
    comp = torch.zeros_like(dist_m)
    dev = dist_m.device
    per = min(WKB_PASS_STEPS, max(1, _PLANE_ELEMENTS // max(1, dist_m.numel())))
    bshape = (-1,) + (1,) * dist_m.dim()
    steps = torch.arange(per, dtype=torch.int64, device=dev)
    s0 = torch.zeros((), dtype=torch.int64, device=dev)
    bound = torch.as_tensor(n_steps, dtype=torch.int64, device=dev)

    def one_pass():
        s = s0 + steps
        iv = s.to(F64) * dE_step
        E1 = EV_TO_J * V0 + iv
        if f32:
            # akmc_tpu compares the f64 step energy rounded to f32
            E1, iv = E1.float(), iv.float()
        E1, iv = E1.reshape(bshape), iv.reshape(bshape)
        E2 = E1 - dE_abs
        if f32:
            E2p = torch.clamp(E2, min=0.0)
            expo_trap = q_trap * (
                (E1 + torch.sqrt(E1 * E2p) + E2p) / (torch.sqrt(E1) + torch.sqrt(E2p))
            )
        else:
            expo_trap = q_trap * (E1**1.5 - torch.where(E2 > 0, E2, 0.0) ** 1.5)
        expo_tri = q_tri * E1**1.5
        term = torch.exp(torch.where(E2 > 0, expo_trap, expo_tri))
        on = s < bound
        if not f32:
            # a step past the bound adds an exact zero to a sum >= +0
            term = torch.where((iv < dE_abs) & on.reshape(bshape), term, 0.0)
            for k in range(per):
                acc.add_(term[k])
        else:
            term = torch.where(iv < dE_abs, term, 0.0)
            for k in range(per):
                # Kahan: comp carries the low-order residue
                y = term[k] - comp
                t = acc + y
                torch.where(on[k], (t - acc) - y, comp, out=comp)
                torch.where(on[k], t, acc, out=acc)
        s0.add_(per)

    if device_loop.in_program():
        live = s0 < bound

        def body():
            one_pass()
            live.copy_(s0 < bound)
        device_loop.while_loop(live, body)
    else:
        for _ in range(-(-int(bound) // per)):
            one_pass()
    return acc if mask is None else torch.where(mask, acc, 0.0)


def _ct_loop_bound(dE_abs, ok, ne_max: int) -> torch.Tensor:
    """The energy loop's step count for one block as a 0-d int64 device
    tensor: the largest window among its eligible pairs, ceil(max |dE| /
    dE_step) + 1, capped at ``ne_max``."""
    dE_step = EV_TO_J * 0.01
    max_dE = torch.max(torch.where(ok, dE_abs, 0.0))
    # akmc_tpu's compiled division by the constant dE_step is a multiplication
    # by its reciprocal
    n = torch.ceil(max_dE * (1.0 / dE_step)).to(torch.int64) + 1
    return torch.clamp(n, max=int(ne_max))


class _WkbCtArgs(ctypes.Structure):
    """``struct WkbCtArgs`` of ``csrc/wkb_ct.cu``."""

    _fields_ = [
        *((name, ctypes.c_void_p) for name in (
            "pos_a", "pos_b", "cb_a", "cb_b", "mask_a", "mask_b", "idx_a", "idx_b", "lattice",
            "out", "bounds")),
        *((name, ctypes.c_longlong) for name in ("R", "C", "chunk", "ne_max")),
        *((name, ctypes.c_double) for name in (
            "nn_dist", "tol", "prefac", "E0", "dE_step", "inv_step", "ang")),
        ("pbc", ctypes.c_int),
    ]


def _wkb_ct_library() -> ctypes.CDLL:
    """``csrc/wkb_ct.cu``, built and typed on first use."""
    lib = cuda_build.load("wkb_ct")
    if lib.wkb_ct_launch.argtypes is None:
        lib.wkb_ct_launch.argtypes = [ctypes.POINTER(_WkbCtArgs), ctypes.c_void_p]
        lib.wkb_ct_counts_read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
        lib.wkb_ct_counts_reset.argtypes = []
        for fn in (lib.wkb_ct_launch, lib.wkb_ct_counts_read, lib.wkb_ct_counts_reset):
            fn.restype = ctypes.c_int
    return lib


def _ct_on_card(pos: torch.Tensor, f32: bool) -> bool:
    """Whether the integrated block is the kernel's: CUDA tensors and f64
    blocks. Under ``wkb_f32`` the plain loop stays: its Kahan sum folds even
    a zero term into the compensation, so it cannot stop at a pair's window."""
    return pos.is_cuda and not f32


def wkb_contact_trap_kernel(w: WkbInputs, a: Sites, b: Sites,
                            chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The integrated block of rows ``a`` and columns ``b`` (``wkb_block``;
    its twin ``wkb_block_plain``) in one launch of ``csrc/wkb_ct.cu``: (the f64 block, the (ceil(cols /
    chunk),) int64 energy-loop bounds of its chunks of ``chunk`` columns),
    bit-equal to the plain build's block and ``_ct_loop_bound``s. Each
    launch adds its terms and issued lane-steps to the device's counters
    (``wkb_ct_counts``)."""
    from akmc_tpu_torch.ops.dia_matvec import current_raw_stream, require_tensor

    dev = a.pos.device
    rows, cols = a.pos.shape[0], b.pos.shape[0]
    for side, sites, n in (("rows", a, rows), ("cols", b, cols)):
        for name, t, dtype, shape in (("pos", sites.pos, F64, (n, 3)), ("cb", sites.cb, F64, (n,)),
                                      ("mask", sites.mask, torch.bool, (n,)),
                                      ("idx", sites.idx, torch.int64, (n,))):
            require_tensor(f"{side}.{name}", t, dtype, shape, dev)
    require_tensor("lattice", w.lattice, F64, (3,), dev)
    out = torch.empty((rows, cols), dtype=F64, device=dev)
    bounds = torch.full((max(1, -(-cols // chunk)),), min(1, int(w.ne_max)), dtype=torch.int64,
                        device=dev)
    dE_step = EV_TO_J * 0.01
    args = _WkbCtArgs(
        *(t.data_ptr() for t in (a.pos, b.pos, a.cb, b.cb, a.mask, b.mask, a.idx, b.idx,
                                 w.lattice, out, bounds)),
        rows, cols, chunk, int(w.ne_max), w.nn_dist, w.tol, _prefac(w.m_e), EV_TO_J * w.V0,
        dE_step, 1.0 / dE_step, 1e-10, int(w.pbc),
    )
    device_loop.bind(*a, *b, w.lattice, out, bounds)
    with torch.cuda.device(dev):
        err = _wkb_ct_library().wkb_ct_launch(ctypes.byref(args),
                                              current_raw_stream(dev.index))
    if err != 0:
        raise RuntimeError(f"wkb_ct kernel launch failed: CUDA error {err}")
    device_loop.count_launch(wkb_contact_trap_kernel)
    return out, bounds


wkb_contact_trap_kernel.launches = 0   # kernel launches (in a graph: launches as replayed)


def wkb_ct_counts(device) -> Tuple[int, int]:
    """(terms evaluated, lane-steps issued) by ``wkb_contact_trap_kernel`` on
    ``device`` since ``reset_wkb_ct_counts``: their ratio is the share of
    the issued lanes that did a term. Waits for the device."""
    vals = (ctypes.c_ulonglong * 2)()
    with torch.cuda.device(device):
        err = _wkb_ct_library().wkb_ct_counts_read(vals)
    if err != 0:
        raise RuntimeError(f"wkb_ct counters: CUDA error {err}")
    return int(vals[0]), int(vals[1])


def reset_wkb_ct_counts(device) -> None:
    with torch.cuda.device(device):
        err = _wkb_ct_library().wkb_ct_counts_reset()
    if err != 0:
        raise RuntimeError(f"wkb_ct counters: CUDA error {err}")


# ---------------------------------------------------------------------------
# per-superstep assembly (compact pieces, no big matrix)
# ---------------------------------------------------------------------------

# W-block build chunk size (rows, or the trap columns of the integrated
# block); module-level so tests can shrink it
_WKB_ROW_BLOCK = 1024


class PowerSystem(NamedTuple):
    """Per-superstep operator pieces of the transmission system."""

    G_nbr: torch.Tensor          # (N_atom, NNa) neighbor conductances (masked 0)
    vac_idx: torch.Tensor        # (VMAX,) compacted vacancy atom idx, -1 pad
    W_tt: torch.Tensor           # (VMAX, VMAX) trap-trap tunnel coefficients
    W_ct: torch.Tensor           # (NC, VMAX) contact-trap (integrated)
    W_cc: torch.Tensor           # (NC, NC) contact-contact
    diag: torch.Tensor           # (N_atom,) atom diagonal
    diag0: float                 # extraction-node diagonal
    diag1: float                 # injection-node diagonal


class PowerShard(NamedTuple):
    """A rank's share of the power system under a mesh
    (``VCMModel._shard_power_system``): every rank's rows of the compacted
    vacancy list (``vac``), of the contact list (``con``), of the atoms
    (``atom``) and, with the power band, of its blocks (``band``). The rank
    builds and holds those rows of W_tt, of W_cc and W_ct and of G_nbr;
    products with them are gathered (``Mesh.gather_rows``), and the
    transposed product W_ct^T v_c is added over ranks in rank order
    (``Mesh.sum_partials``)."""

    mesh: object
    vac: list
    con: list
    atom: list
    band: Optional[list] = None
    band_rows: Optional[list] = None   # each rank's solver-frame rows of its band blocks


def _mine(shard, name: str, n: int) -> slice:
    """This rank's rows of list ``name`` (all ``n`` rows on one device)."""
    if shard is None:
        return slice(0, n)
    a, b = getattr(shard, name)[shard.mesh.rank]
    return slice(a, b)


def _whole(shard, name: str, t: torch.Tensor) -> torch.Tensor:
    """The rows of ``t`` gathered whole (one device: ``t``)."""
    return t if shard is None else shard.mesh.gather_rows(t, getattr(shard, name))


def _over_ranks(shard, t: torch.Tensor) -> torch.Tensor:
    """Per-rank partial sums ``t`` added in rank order (one device: ``t``)."""
    return t if shard is None else shard.mesh.sum_partials(t)


def _gathered(shard, pieces) -> list:
    """Every piece whole, in one all-gather (``Mesh.gather_flat``): a piece
    (t, name) is this rank's rows of list ``name`` of ``shard``; (t, None) is
    this rank's partial sum, added over the ranks in rank order. One device:
    the tensors as they are."""
    if shard is None:
        return [t for t, _ in pieces]
    mesh = shard.mesh
    flat = [(t, getattr(shard, name) if name else
             [(r * t.shape[0], (r + 1) * t.shape[0]) for r in range(mesh.size)], t.device)
            for t, name in pieces]
    out = []
    for (_, name), whole in zip(pieces, mesh.gather_flat(flat)):
        if name is None:
            parts = whole.reshape(mesh.size, -1)
            whole = parts[0]
            for part in parts[1:]:
                whole = whole + part
        out.append(whole)
    return out


class WkbStats(NamedTuple):
    """What one build of the W blocks did: the energy-loop step count of each
    integrated block (the shared bound akmc_tpu's loop runs to), as 0-d
    int64 device tensors."""

    ct_bounds: Tuple[torch.Tensor, ...]


def _pair_dist_m(pos_a, pos_b, lattice, pbc):
    """(meters, Angstrom) pair distances as (rows, cols) planes, PBC in y/z."""
    dx = pos_a[:, 0][:, None] - pos_b[None, :, 0]
    dy = pos_a[:, 1][:, None] - pos_b[None, :, 1]
    dz = pos_a[:, 2][:, None] - pos_b[None, :, 2]
    if pbc:
        dy = dy / lattice[1]
        dy = (dy - torch.round(dy)) * lattice[1]
        dz = dz / lattice[2]
        dz = (dz - torch.round(dz)) * lattice[2]
    d2 = dx * dx + dy * dy + dz * dz
    d = torch.sqrt(d2)
    return 1e-10 * d, d


def _scatter_add(out: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``out`` with ``vals`` added at ``idx``; -1 pad indices add nothing
    (akmc_tpu adds their exact zeros at index -1)."""
    ok = idx >= 0
    return out.index_add(0, idx.clamp(min=0), torch.where(ok, vals, 0.0))


class WkbInputs(NamedTuple):
    """What a build of a W block reads besides its rows and columns."""

    lattice: torch.Tensor
    pbc: bool
    nn_dist: float
    tol: float
    m_e: float
    V0: float
    ne_max: int
    f32: bool            # the ``wkb_f32`` lever


class Sites(NamedTuple):
    """A W block's rows or columns: positions [Angstrom], CB edges [J], masks
    (pads and non-vacancies False) and atom indices."""

    pos: torch.Tensor
    cb: torch.Tensor
    mask: torch.Tensor
    idx: torch.Tensor

    def rows(self, s: slice) -> "Sites":
        return Sites(*(t[s] for t in self))


def tunnel_sites(ct: CurrentTables, atom_element: torch.Tensor, atom_cb_edge: torch.Tensor,
                 vmax: int) -> Tuple[Sites, Sites]:
    """(vacancies, contacts): the W blocks' rows and columns, the compacted
    vacancy list (-1 padded to ``vmax``) and the window contacts. Pad slots
    sit on atom 0 and are masked, so their rows and columns are exact zeros."""
    vac_idx, vv = compact_mask(atom_element == int(ELEM.VACANCY), vmax)
    vi, ci = vac_idx.clamp(min=0), ct.contact_idx.clamp(min=0)
    return (Sites(ct.atom_pos[vi], atom_cb_edge[vi], vv, vac_idx),
            Sites(ct.atom_pos[ci], atom_cb_edge[ci], ct.contact_idx >= 0, ct.contact_idx))


def _wkb_block_direct(w: WkbInputs, a: Sites, b: Sites, integrate: bool,
                      bounds: list) -> torch.Tensor:
    dist_m, dist_ang = _pair_dist_m(a.pos, b.pos, w.lattice, w.pbc)
    dE = torch.abs(a.cb[:, None] - b.cb[None, :])
    neighbor = dist_ang < w.nn_dist
    same = a.idx[:, None] == b.idx[None, :]
    ok = a.mask[:, None] & b.mask[None, :] & ~same & ~neighbor & (dE > w.tol)
    dE_safe = torch.where(ok, dE, 1.0)
    if integrate:
        n_steps = _ct_loop_bound(dE, ok, w.ne_max)
        bounds.append(n_steps)
        T = _wkb_contact_trap(dist_m, dE_safe, w.m_e, w.V0, n_steps, mask=ok, f32=w.f32)
    else:
        T = _wkb_single(dist_m, dE_safe, w.m_e, w.V0, f32=w.f32)
    return torch.where(ok, T, 0.0)


def wkb_block_plain(w: WkbInputs, a: Sites, b: Sites, integrate: bool,
                    bounds: list) -> torch.Tensor:
    """The W block of rows ``a`` and columns ``b`` built from planes
    (``integrate``: the contact-trap energy integral; each of its energy-loop
    bounds appended to ``bounds``): the direct build up to 4 B^2 pairs; past
    it, chunks of B trap columns (integrated: each chunk's energy loop runs
    to its own pairs' bound, as akmc_tpu's column-chunked build does) or B
    rows. Every entry equals the direct form's. The CPU's build, the
    ``wkb_f32`` lever's, and the twin of ``wkb_contact_trap_kernel``."""
    rows, cols = a.pos.shape[0], b.pos.shape[0]
    B = _WKB_ROW_BLOCK
    if rows * cols <= 4 * B * B:
        return _wkb_block_direct(w, a, b, integrate, bounds)
    if integrate:
        return torch.cat([_wkb_block_direct(w, a, b.rows(slice(s, s + B)), True, bounds)
                          for s in range(0, cols, B)], dim=1)
    return torch.cat([_wkb_block_direct(w, a.rows(slice(s, s + B)), b, False, bounds)
                      for s in range(0, rows, B)], dim=0)


def wkb_block(w: WkbInputs, a: Sites, b: Sites, integrate: bool, bounds: list) -> torch.Tensor:
    """The W block of rows ``a`` and columns ``b``, equal to
    ``wkb_block_plain``'s bit for bit. On a card in f64 the integrated block
    is one launch of ``wkb_contact_trap_kernel`` over all its columns, which
    gives the bound of each of the plain build's chunks too."""
    if integrate and _ct_on_card(a.pos, w.f32):
        cols, B = b.pos.shape[0], _WKB_ROW_BLOCK
        direct = a.pos.shape[0] * cols <= 4 * B * B
        T, chunk_bounds = wkb_contact_trap_kernel(w, a, b, max(1, cols) if direct else B)
        bounds.extend(chunk_bounds.unbind(0))
        return T
    return wkb_block_plain(w, a, b, integrate, bounds)


def build_power_system(
    ct: CurrentTables,
    atom_element: torch.Tensor,     # (N_atom,) gathered site elements
    atom_charge: torch.Tensor,
    atom_cb_edge: torch.Tensor,     # (N_atom,) [J]
    lattice: torch.Tensor,
    pbc: bool,
    nn_dist: float,
    high_G: float,
    low_G: float,
    loop_G: float,
    tol: float,
    m_e: float,
    V0: float,
    vmax: int,
    ne_max: int,
    wkb_f32: bool = False,
    shard: Optional[PowerShard] = None,
) -> Tuple[PowerSystem, WkbStats]:
    """The W blocks, G_nbr and the diagonal of the power system. ``shard``:
    this rank's rows of W_tt, W_cc, W_ct and G_nbr only (``PowerShard``);
    the diagonal is whole on every rank."""
    sa = _mine(shard, "atom", ct.atom_neigh_idx.shape[0])
    nbr = ct.atom_neigh_idx[sa]
    valid = nbr >= 0
    j = nbr.clamp(min=0)
    dev = atom_element.device

    metal_i = ct.atom_is_metal
    cvac = (atom_element == int(ELEM.VACANCY)) & (atom_charge == 0)
    pair_high = (metal_i[sa, None] & metal_i[j]) | (cvac[sa, None] & cvac[j])
    hi = torch.full((), high_G, dtype=F64, device=dev)
    G_nbr = torch.where(valid, torch.where(pair_high, hi, low_G), 0.0)

    vac, con = tunnel_sites(ct, atom_element, atom_cb_edge, vmax)
    vac_idx, cidx = vac.idx, con.idx
    # this rank's rows of each block (all rows on one device): every entry
    # is the whole block's, whichever rows a build holds
    sv, sc = _mine(shard, "vac", vac_idx.shape[0]), _mine(shard, "con", cidx.shape[0])
    w = WkbInputs(lattice, pbc, nn_dist, tol, m_e, V0, ne_max, wkb_f32)
    bounds = []
    W_tt = wkb_block(w, vac.rows(sv), vac, False, bounds)
    W_cc = wkb_block(w, con.rows(sc), con, False, bounds)
    W_ct = wkb_block(w, con.rows(sc), vac, True, bounds)

    # diagonal: all row sums positive (write_to_diag, iterative_solvers_gpu.cu:39-47);
    # the tunnel row sums accumulate in f64 when the blocks are stored f32
    diag = _whole(shard, "atom", torch.sum(G_nbr, dim=1))
    diag = diag + high_G * ct.inj_tie.to(F64) + high_G * ct.ext_tie.to(F64)
    diag = _scatter_add(diag, vac_idx, _whole(shard, "vac", torch.sum(W_tt, dim=1, dtype=F64))
                        + _over_ranks(shard, torch.sum(W_ct, dim=0, dtype=F64)))
    diag = _scatter_add(diag, cidx, _whole(shard, "con", torch.sum(W_cc, dim=1, dtype=F64)
                                           + torch.sum(W_ct, dim=1, dtype=F64)))

    ps = PowerSystem(
        G_nbr=G_nbr, vac_idx=vac_idx, W_tt=W_tt, W_ct=W_ct, W_cc=W_cc, diag=diag,
        diag0=loop_G + high_G * ct.n_ext, diag1=loop_G + high_G * ct.n_inj,
    )
    return ps, WkbStats(ct_bounds=tuple(bounds))


def _tunnel_matvec(W_tt, W_ct, W_cc, y, va, vi, vv, cidx, shard=None, first=None):
    """y plus the tunnel blocks' part, -(W_tt v_v + W_ct^T v_c) on the
    vacancy slots and -(W_cc v_c + W_ct v_v) on the contacts. The blocks are
    f64 here (f32 blocks are widened once per solve, the products akmc_tpu's
    f32 * f64 promotion forms); each product is one matrix-vector call.

    ``shard``: the blocks are this rank's rows (``PowerShard``) and the
    products are gathered in one all-gather, together with ``first`` (a
    ``_gathered`` piece) when given; then ``y`` is a function that takes the
    whole ``first`` and returns the vector the tunnel part is added to."""
    v_v = torch.where(vv, va[vi], 0.0)
    v_c = va[cidx.clamp(min=0)]
    sc = _mine(shard, "con", cidx.shape[0])
    pieces = [(torch.mv(W_tt, v_v), "vac"), (torch.mv(W_ct.T, v_c[sc]), None),
              (-torch.mv(W_cc, v_c) - torch.mv(W_ct, v_v), "con")]
    if first is not None:
        head, tt, ctT, y_c = _gathered(shard, [first] + pieces)
        y = y(head)
    else:
        tt, ctT, y_c = _gathered(shard, pieces)
    y_v = -tt - ctT                                  # per vacancy slot
    y = _scatter_add(y, torch.where(vv, vi, -1), y_v)
    return _scatter_add(y, cidx, y_c)                # per contact


def _X_atoms_matvec(ct: CurrentTables, ps: PowerSystem, va: torch.Tensor,
                    blocks=None, shard=None) -> torch.Tensor:
    """Off-diagonal atom-atom part: (-G_nbr - W_tunnel) @ va, over all atoms.
    ``blocks``: (W_tt, W_ct, W_cc) in f64 (default: the system's, widened)."""
    nbr = ct.atom_neigh_idx[_mine(shard, "atom", ct.atom_neigh_idx.shape[0])]
    g = -torch.sum(ps.G_nbr * va[nbr.clamp(min=0)], dim=1)
    if blocks is None:
        blocks = (ps.W_tt.to(F64), ps.W_ct.to(F64), ps.W_cc.to(F64))
    vi = ps.vac_idx.clamp(min=0)
    return _tunnel_matvec(*blocks, lambda y: y, va, vi, ps.vac_idx >= 0, ct.contact_idx, shard,
                          first=(g, "atom"))


def build_power_band(
    ct: CurrentTables,
    atom_element0: np.ndarray,
    high_G: float,
    low_G: float,
    max_band_bytes: float = 2e9,
):
    """Static int8 band over the atom adjacency for ``solve_power``'s
    neighbor part (code 1 = low_G, code 2 = metal-metal high_G; the dynamic
    conductive-vacancy edges fold into W_tt once per solve, ``_cvac_fold``).
    Returns (BandedK, BandMeta) on the CPU, or None (the gather operator)
    when the atom bandwidth is too wide for a band."""
    from akmc_tpu_torch.solvers.banded import build_banded_k

    return build_banded_k(
        ct.atom_pos.cpu().numpy(),
        ct.atom_neigh_idx.cpu().numpy(),
        ct.atom_is_metal.cpu().numpy(),
        np.asarray(atom_element0),
        0, high_G, low_G,
        max_band_bytes=max_band_bytes,
    )


def _cvac_fold(pos_v, cvac_v, vac_idx, lattice, pbc, nn_dist, dtype, dG, rows=slice(None)):
    """dG * (neighbor & cvac_i & cvac_j) over the compacted vacancy list: the
    dynamic part of ``build_power_system``'s ``pair_high`` rule, which the
    static band codes cannot carry. Built in chunks of ``_WKB_ROW_BLOCK``
    rows; ``rows``: only those rows of the list (a rank's share)."""
    def block(chunk_pos, chunk_cvac, chunk_idx):
        _, dist_ang = _pair_dist_m(chunk_pos, pos_v, lattice, pbc)
        same = chunk_idx[:, None] == vac_idx[None, :]
        adj = (dist_ang < nn_dist) & ~same & chunk_cvac[:, None] & cvac_v[None, :]
        return torch.where(adj, torch.full((), dG, dtype=dtype, device=pos_v.device),
                           torch.zeros((), dtype=dtype, device=pos_v.device))

    pos_r, cvac_r, idx_r = pos_v[rows], cvac_v[rows], vac_idx[rows]
    B = _WKB_ROW_BLOCK
    if pos_r.shape[0] == 0:
        return torch.zeros((0, pos_v.shape[0]), dtype=dtype, device=pos_v.device)
    return torch.cat([block(pos_r[s:s + B], cvac_r[s:s + B], idx_r[s:s + B])
                      for s in range(0, pos_r.shape[0], B)], dim=0)


def _power_band_op(v, diag_p, W_tt, W_ct, W_cc, vi_p, vv, cidx_p, gmask, inj_p, ext_p,
                   inj_pm, ext_pm, *, bk, meta, high_G, loop_G, diag0, diag1, block0, shard):
    """X v in the band's solver frame. v: (N_atom + 2,) = [ext, inj, atoms
    (solver frame; the grounded slot pinned by an identity row)]."""
    from akmc_tpu_torch.solvers.banded import band_matvec

    va = torch.where(gmask, v[2:], 0.0)
    y = _tunnel_matvec(W_tt, W_ct, W_cc, lambda bm: diag_p * va - bm, va, vi_p, vv,
                       cidx_p, shard, first=(band_matvec(bk, meta, va, block0), "band_rows"))
    y = y - high_G * inj_p * v[1] - high_G * ext_p * v[0]
    y0 = diag0 * v[0] - loop_G * v[1] - high_G * torch.sum(torch.where(ext_pm, va, 0.0))
    y1 = diag1 * v[1] - loop_G * v[0] - high_G * torch.sum(torch.where(inj_pm, va, 0.0))
    y = torch.where(gmask, y, v[2:])
    return torch.cat([torch.stack([y0, y1]), y])


def _power_gather_op(v, diag, G_nbr, vac_idx, W_tt, W_ct, W_cc, inj, ext, *, ct, high_G,
                     loop_G, diag0, diag1, shard):
    """X v over the atom adjacency. v: (N_atom + 1,) = [ext, inj,
    atoms[:-1]] (the grounded atom dropped)."""
    ps = PowerSystem(G_nbr=G_nbr, vac_idx=vac_idx, W_tt=W_tt, W_ct=W_ct, W_cc=W_cc, diag=diag,
                     diag0=diag0, diag1=diag1)
    va = torch.cat([v[2:], torch.zeros(1, dtype=v.dtype, device=v.device)])
    y_at = diag * va + _X_atoms_matvec(ct, ps, va, (W_tt, W_ct, W_cc), shard)
    y_at = y_at - high_G * inj * v[1] - high_G * ext * v[0]
    y0 = diag0 * v[0] - loop_G * v[1] - high_G * torch.sum(torch.where(ct.ext_tie, va, 0.0))
    y1 = diag1 * v[1] - loop_G * v[0] - high_G * torch.sum(torch.where(ct.inj_tie, va, 0.0))
    return torch.cat([torch.stack([y0, y1]), y_at[:-1]])


def _rails_rhs(Vd: torch.Tensor, loop_G: float) -> torch.Tensor:
    """(-loop_G Vd, loop_G Vd): the right-hand side on the two rail nodes."""
    return torch.stack([-loop_G * Vd, loop_G * Vd])


def _power_cg(A, b, x0, inv_diag, rtol, max_iterations, shard, graphs):
    """The power CG with the multiply + sum dot: the device loop, or under
    ``shard`` the host loop."""
    if shard is None:
        return jacobi_cg(A, b, x0, inv_diag, rtol, max_iterations, dot_fn=f64_vdot,
                         graphs=graphs)
    return jacobi_cg_plain(A, b, x0, inv_diag, rtol, max_iterations, dot_fn=f64_vdot)


def solve_power(
    ct: CurrentTables,
    ps: PowerSystem,
    Vd,                              # [V] a float or a 0-d f64 device tensor
    high_G: float,
    loop_G: float,
    G0: float,
    alpha: float,
    m_prev: torch.Tensor,            # (N_atom+2,) warm start (unscaled units)
    atom_element: torch.Tensor,
    rtol_coeff: float = 1e-16,
    max_iterations: int = 10000,
    band=None,                       # (BandedK) static atom band (build_power_band);
    band_meta=None,                  #   None = the gather operator
    cvac=None,                       # (N_atom,) conductive-vacancy mask
    nn_dist: float = 0.0,
    lattice=None,
    pbc: bool = False,
    rtol_scale=1.0,                  # multiplier on the relative tolerance (float or 0-d
    #                                  tensor): the low-bias I-V points are a sub-nA
    #                                  cancellation of large virtual potentials, so
    #                                  callers tighten the solve there
    shard: Optional[PowerShard] = None,   # the system and the band are this rank's rows
    graphs=None,                     # the caller's LoopGraphs for the CG's device loop
    grounded: Optional[int] = None,  # the grounded atom's slot in the band's frame
    #                                  (static: ``VCMModel.power_band`` keeps it); None
    #                                  reads it from the band
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Solve X m = b; returns (I_macro [A] (0-d), atom_power (N_atom,) [W],
    m (N_atom+2) unscaled, CG iterations).

    Unknowns: nodes [0, 1] and the atoms, the last atom grounded. With
    ``band`` the CG runs in the band's solver frame (the neighbor part is the
    band product, the cvac-cvac edges are folded into W_tt, the grounded
    atom's row is an identity row whose residual stays exactly 0); without
    it the neighbor part is a gather over the atom adjacency and the grounded
    atom is dropped from the unknowns.

    On one device the CG is the device loop of ``solvers/cg.py``. Under
    ``shard`` the CG vectors stay whole on every rank and every rank
    computes the same iterates: each product with a sharded block is the
    rank's rows, gathered (``PowerShard``); the CG is the host loop there
    (gloo collectives cannot be captured into a graph).

    ``Vd`` and ``rtol_scale`` enter as 0-d device tensors (a float is made
    one), so that one captured program serves every bias and tolerance; the
    direction of the forward current is a device select on ``Vd >= 0``.
    With a ``grounded`` slot given, nothing is read back to the host."""
    n_atom = ct.atom_ind.shape[0]
    dev = m_prev.device
    inj = ct.inj_tie.to(F64)
    ext = ct.ext_tie.to(F64)
    vi = ps.vac_idx.clamp(min=0)
    vv = ps.vac_idx >= 0
    Vd = torch.as_tensor(Vd, dtype=F64, device=dev)
    rtol = rtol_coeff * n_atom * torch.as_tensor(rtol_scale, dtype=F64, device=dev)
    d01 = torch.stack([torch.full((), ps.diag0, dtype=F64, device=dev),
                       torch.full((), ps.diag1, dtype=F64, device=dev)])

    if band is not None:
        bk, meta = band, band_meta
        perm, invp = bk.perm, bk.inv_perm
        dGv = meta.val_both - meta.val_low
        diag_p = ps.diag[perm]
        inj_p, ext_p = inj[perm], ext[perm]
        inj_pm, ext_pm = ct.inj_tie[perm], ct.ext_tie[perm]
        g_p = int(invp[n_atom - 1]) if grounded is None else grounded
        gmask = torch.arange(n_atom, device=dev) != g_p
        vi_p = invp[vi]
        cidx_p = torch.where(ct.contact_idx >= 0, invp[ct.contact_idx.clamp(min=0)], -1)

        sv = _mine(shard, "vac", vi.shape[0])
        cvac_v = torch.where(vv, cvac[vi], False)
        W_tt = (ps.W_tt + _cvac_fold(
            ct.atom_pos[vi], cvac_v, ps.vac_idx,
            lattice, pbc, nn_dist, ps.W_tt.dtype, dGv, rows=sv,
        )).to(F64)
        W_ct, W_cc = ps.W_ct.to(F64), ps.W_cc.to(F64)
        block0 = 0 if shard is None else shard.band[shard.mesh.rank][0]

        A = Operator(
            "power_band",
            functools.partial(_power_band_op, bk=bk, meta=meta, high_G=high_G, loop_G=loop_G,
                              diag0=ps.diag0, diag1=ps.diag1, block0=block0, shard=shard),
            (diag_p, W_tt, W_ct, W_cc, vi_p, vv, cidx_p, gmask, inj_p, ext_p, inj_pm, ext_pm),
            (addresses(bk.values(meta), perm), meta, high_G, loop_G, ps.diag0, ps.diag1,
             block0),
        )

        b = torch.cat([_rails_rhs(Vd, loop_G), torch.zeros(n_atom, dtype=F64, device=dev)])
        inv_diag = torch.cat([1.0 / d01, torch.where(gmask, 1.0 / torch.where(gmask, diag_p, 1.0), 1.0)])
        x0 = torch.cat([m_prev[:2], torch.where(gmask, m_prev[2:][perm], 0.0)])
        res = _power_cg(A, b, x0, inv_diag, rtol, max_iterations, shard, graphs)
        m = torch.cat([res.x[:2], res.x[2:][invp]])
    else:
        blocks = (ps.W_tt.to(F64), ps.W_ct.to(F64), ps.W_cc.to(F64))

        A = Operator(
            "power_gather",
            functools.partial(_power_gather_op, ct=ct, high_G=high_G, loop_G=loop_G,
                              diag0=ps.diag0, diag1=ps.diag1, shard=shard),
            (ps.diag, ps.G_nbr, ps.vac_idx, *blocks, inj, ext),
            (addresses(ct.atom_neigh_idx, ct.contact_idx, ct.ext_tie, ct.inj_tie), high_G,
             loop_G, ps.diag0, ps.diag1),
        )

        b = torch.cat([_rails_rhs(Vd, loop_G), torch.zeros(n_atom - 1, dtype=F64, device=dev)])
        inv_diag = 1.0 / torch.cat([d01, ps.diag[:-1]])
        x0 = m_prev[: n_atom + 1]
        res = _power_cg(A, b, x0, inv_diag, rtol, max_iterations, shard, graphs)
        m = torch.cat([res.x, torch.zeros(1, dtype=res.x.dtype, device=dev)])   # grounded atom
    m_scaled = m * G0

    # I_macro: extraction-rail sum (get_imacro, current_solver_gpu.cu:2493-2507)
    m_at = m_scaled[2:]
    I_macro = torch.sum(torch.where(ct.ext_tie, (-high_G) * (m_scaled[0] - m_at), 0.0))

    # forward-current power: pdisp_i = sum_j ineg_ij (m_j - m_i)
    # (set_ineg + row_reduce + write_to_diag + gemv, 2520-2559)
    # (sign(Vd) >= 0 is Vd >= 0, for -0.0 and NaN too)
    forward_neg = Vd >= 0

    def ineg_contrib(x_off, mi, mj):
        ical = -x_off * (mi - mj)      # X_ij = -coef
        fwd = torch.where(forward_neg, ical < 0, ical > 0)
        return torch.where(fwd, -ical, 0.0)

    sa = _mine(shard, "atom", n_atom)
    sv = _mine(shard, "vac", vi.shape[0])
    sc = _mine(shard, "con", ct.contact_idx.shape[0])
    nbr = ct.atom_neigh_idx[sa]
    jm = m_at[nbr.clamp(min=0)]
    ineg_n = ineg_contrib(ps.G_nbr, m_at[sa, None], jm)
    pdisp = _whole(shard, "atom", torch.sum(ineg_n * (jm - m_at[sa, None]), dim=1))

    m_v = torch.where(vv, m_at[vi], 0.0)
    m_c = m_at[ct.contact_idx.clamp(min=0)]
    in_tt = ineg_contrib(ps.W_tt, m_v[sv, None], m_v[None, :])
    in_cc = ineg_contrib(ps.W_cc, m_c[sc, None], m_c[None, :])
    in_ct = ineg_contrib(ps.W_ct, m_c[sc, None], m_v[None, :])
    in_tc = ineg_contrib(ps.W_ct.T, m_v[:, None], m_c[None, sc])
    p_v = _whole(shard, "vac", torch.sum(in_tt * (m_v[None, :] - m_v[sv, None]), dim=1)) + (
        _over_ranks(shard, torch.sum(in_tc * (m_c[None, sc] - m_v[:, None]), dim=1))
    )
    p_c = _whole(shard, "con", torch.sum(in_cc * (m_c[None, :] - m_c[sc, None]), dim=1)
                 + torch.sum(in_ct * (m_v[None, :] - m_c[sc, None]), dim=1))
    pdisp = _scatter_add(pdisp, torch.where(vv, vi, -1), p_v)
    pdisp = _scatter_add(pdisp, ct.contact_idx, p_c)

    atom_power = torch.where(ct.atom_is_metal, 0.0, -alpha * pdisp)
    return I_macro, atom_power, m, res.iterations


# ---------------------------------------------------------------------------
# dense form (small systems and tests): the whole (N_atom+2)^2 matrix
# ---------------------------------------------------------------------------

def assemble_dense_X(
    ct: CurrentTables,
    atom_element: torch.Tensor,
    atom_charge: torch.Tensor,
    atom_cb_edge: torch.Tensor,
    lattice: torch.Tensor,
    pbc: bool,
    nn_dist: float,
    high_G: float,
    low_G: float,
    loop_G: float,
    tol: float,
    m_e: float,
    V0: float,
    ne_max: int = 2048,
) -> torch.Tensor:
    """The full (N_atom+2)^2 transmission matrix, as create_X builds it. For
    tests and small devices only."""
    n = atom_element.shape[0]
    dev = atom_element.device
    dist_m, dist_ang = _pair_dist_m(ct.atom_pos, ct.atom_pos, lattice, pbc)
    ii = torch.arange(n, device=dev)
    same = ii[:, None] == ii[None, :]
    neighbor = (dist_ang < nn_dist) & ~same

    metal = ct.atom_is_metal
    cvac = (atom_element == int(ELEM.VACANCY)) & (atom_charge == 0)
    pair_high = (metal[:, None] & metal[None, :]) | (cvac[:, None] & cvac[None, :])
    hi = torch.tensor(-high_G, dtype=F64, device=dev)
    Xnn = torch.where(neighbor, torch.where(pair_high, hi, -low_G), 0.0)

    vac = atom_element == int(ELEM.VACANCY)
    mp = ct.metal_p
    tt = vac[:, None] & vac[None, :]
    cc = mp[:, None] & mp[None, :]
    ctp = (vac[:, None] & mp[None, :]) | (mp[:, None] & vac[None, :])
    dE = torch.abs(atom_cb_edge[:, None] - atom_cb_edge[None, :])
    elig = (tt | cc | ctp) & (dE > tol) & ~same & ~neighbor
    dE_safe = torch.where(elig, dE, 1.0)
    T_single = _wkb_single(dist_m, dE_safe, m_e, V0)
    T_int = _wkb_contact_trap(dist_m, dE_safe, m_e, V0, ne_max)
    Xt = torch.where(elig, torch.where(ctp, -T_int, -T_single), 0.0)

    X = torch.zeros((n + 2, n + 2), dtype=F64, device=dev)
    X[2:, 2:] = Xnn + Xt
    inj = -high_G * ct.inj_tie.to(F64)
    ext = -high_G * ct.ext_tie.to(F64)
    X[1, 2:] += inj
    X[2:, 1] += inj
    X[0, 2:] += ext
    X[2:, 0] += ext
    X[0, 1] = -loop_G
    X[1, 0] = -loop_G
    return X + torch.diag(-torch.sum(X, dim=1))

