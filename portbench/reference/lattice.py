"""Neighbor lists and layer ids from the raw structure.

A neighbor of site i is a site j != i at a non-periodic distance
sqrt(d2) < r, with d2 the sum of the squared coordinate differences; lists
hold neighbor indices in ascending order, padded with -1. Sites of the
excluded set (the grid stand-in's placeholder slots) are no one's neighbor
and have none. The search bins sites into cubic cells of edge r and scans
the 27 cells around each site's own, in blocks of sites on the device.
"""

from __future__ import annotations

import torch

ELEM = dict(DEFECT=0, OXYGEN_DEFECT=1, VACANCY=2, O=3, Hf=4, Ni=5, Ti=6, Pt=7, N=8, NULL=9)
ACTIVE = (ELEM["DEFECT"], ELEM["O"], ELEM["VACANCY"], ELEM["OXYGEN_DEFECT"])


def neighbors(pos: torch.Tensor, r: float, excluded: torch.Tensor, block: int = 32768):
    """(N, M) int64 ascending neighbor ids (-1 pad) of every site."""
    dev = pos.device
    n = pos.shape[0]
    lo = pos.min(dim=0).values
    cell = torch.floor((pos - lo) / r).to(torch.int64)
    dims = cell.max(dim=0).values + 1
    cid = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
    cid = torch.where(excluded, -1, cid)
    order = torch.argsort(cid)
    sorted_cid = cid[order]
    n_cells = int(dims.prod())
    cells = torch.arange(n_cells, device=dev)
    start = torch.searchsorted(sorted_cid, cells)
    count = torch.searchsorted(sorted_cid, cells, right=True) - start
    width = int(count.max())
    offs = torch.tensor([(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1)],
                        device=dev)
    slot = torch.arange(width, device=dev)
    r2 = r * r
    rows = []
    for s in range(0, n, block):
        i = torch.arange(s, min(n, s + block), device=dev)
        nc = cell[i][:, None, :] + offs[None]                        # (b, 27, 3)
        inside = ((nc >= 0) & (nc < dims)).all(dim=2)
        ncid = (nc[..., 0] * dims[1] + nc[..., 1]) * dims[2] + nc[..., 2]
        ncid = torch.where(inside, ncid, 0)
        st, ct = start[ncid], torch.where(inside, count[ncid], 0)
        k = (st[..., None] + slot).clamp(max=n - 1)                  # (b, 27, width)
        ok = slot < ct[..., None]
        j = order[k].reshape(len(i), -1)
        ok = ok.reshape(len(i), -1) & (j != i[:, None]) & ~excluded[i][:, None]
        d2 = ((pos[i][:, None, :] - pos[j]) ** 2).sum(dim=2)
        ok &= torch.sqrt(d2) < r
        j = torch.where(ok, j, n)
        j = torch.sort(j, dim=1).values
        rows.append(j)
    m = max(1, max(int((row < n).sum(dim=1).max()) for row in rows))
    out = torch.cat([row[:, :m] for row in rows])
    return torch.where(out < n, out, -1)


def layer_ids(x: torch.Tensor, layers) -> torch.Tensor:
    """Layer of each site by its x coordinate: the last layer whose
    [start_x, end_x] holds it."""
    lid = torch.full(x.shape, -1, dtype=torch.int64, device=x.device)
    for j, lay in enumerate(layers):
        lid = torch.where((lay["start_x"] <= x) & (x <= lay["end_x"]), j, lid)
    if (lid < 0).any():
        raise ValueError("a site lies outside every layer")
    return lid
