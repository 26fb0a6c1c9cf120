"""Matrix inspection and validation tooling, the counterpart of
``akmc_tpu/postprocessing/matrices.py``.

Reference equivalents: dump_csr_matrix_txt (iterative_solvers_gpu.cu:538),
check_sparse_dense_match (509-537), and the offline Python checks
(test_matrices.py, check_matrix_match.py).

Exports the assembled K system of a live model state as a scipy sparse
matrix and checks the diag = -(row sums) invariant.
"""

from __future__ import annotations

import numpy as np
import torch


def assemble_k_coo(model, element, charge, Vd: float):
    """The interface K system of ``model`` (the port's ``VCMModel``) on
    (element, charge) as (scipy COO matrix, rhs): the explicit form of the
    matrix-free operator (solvers/poisson.py)."""
    import scipy.sparse as sp

    from akmc_tpu_torch.solvers.poisson import edge_conductance

    p = model.params
    lat = model.lat
    n = lat.N
    L = R = p.num_atoms_first_layer
    n_int = n - L - R

    t = model.tables
    dev = t.k_neigh_idx.device
    G = edge_conductance(
        torch.as_tensor(element, dtype=torch.int32, device=dev),
        torch.as_tensor(charge, dtype=torch.int32, device=dev),
        t.k_neigh_idx, t.metal_edge, p.high_G, p.low_G,
    ).cpu().numpy()
    nbr = lat.k_neigh_idx
    valid = nbr >= 0
    j = np.clip(nbr, 0, None)
    in_int = valid & (j >= L) & (j < n - R)
    in_left = valid & (j < L)
    in_right = valid & (j >= n - R)

    rows_i, cols_s = np.nonzero(in_int[L : n - R])
    data = -G[L : n - R][rows_i, cols_s]
    cols = j[L : n - R][rows_i, cols_s] - L
    diag = np.where(valid, G, 0.0).sum(1)[L : n - R]

    A = sp.coo_matrix(
        (
            np.concatenate([data, diag]),
            (
                np.concatenate([rows_i, np.arange(n_int)]),
                np.concatenate([cols, np.arange(n_int)]),
            ),
        ),
        shape=(n_int, n_int),
    )
    lsum = np.where(in_left, G, 0.0).sum(1)[L : n - R]
    rsum = np.where(in_right, G, 0.0).sum(1)[L : n - R]
    rhs = lsum * (-Vd / 2) + rsum * (Vd / 2)
    return A, rhs


def check_row_sum_invariant(A, lsum_plus_rsum: np.ndarray, atol=1e-10) -> bool:
    """K-matrix invariant (reference: test_matrices.py:36-50): each interface
    row's diagonal equals -(off-diagonal row sum) + contact terms."""
    rowsum = np.asarray(A.sum(axis=1)).ravel()
    return bool(np.allclose(rowsum, lsum_plus_rsum, atol=atol))


def dump_matrix_txt(A, path: str) -> None:
    """CSR text dump in the reference's format (row_ptr / col / val lines)."""
    csr = A.tocsr()
    with open(path, "w") as f:
        f.write(f"{csr.shape[0]} {csr.nnz}\n")
        f.write(" ".join(map(str, csr.indptr)) + "\n")
        f.write(" ".join(map(str, csr.indices)) + "\n")
        f.write(" ".join(f"{v:.17g}" for v in csr.data) + "\n")


def spy_plot(A, out_png: str, markersize: float = 0.1) -> str:
    """The sparsity pattern of the scipy matrix ``A`` as a PNG, titled with
    its nnz. Needs matplotlib (Agg backend, imported here): a host-side tool."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 6))
    ax.spy(A.tocsr(), markersize=markersize)
    ax.set_title(f"nnz = {A.nnz}")
    fig.tight_layout()
    fig.savefig(out_png, dpi=150)
    plt.close(fig)
    return out_png
