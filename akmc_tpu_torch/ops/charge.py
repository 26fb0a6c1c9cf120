"""Site-charge assignment from local neighborhood rules.

Reference: the ``update_charge`` kernel (potential_solver_gpu.cu:12-63):
  * VACANCY sites get +2, demoted to 0 if they have >= 2 vacancy neighbors
    or any metallic neighbor;
  * OXYGEN_DEFECT sites get -2, demoted to 0 if they have any metallic
    neighbor;
  * all other sites keep their current charge (events manage it).

The metal-neighbor predicate is static (metallic sites never transform), so
``any_metal_nbr`` is precomputed once.
"""

from __future__ import annotations

import torch

from akmc_tpu_torch.lattice import ELEM
from akmc_tpu_torch.ops.compact import compact_mask


def update_charge_compact(
    element: torch.Tensor,        # (N,) int32
    charge: torch.Tensor,         # (N,) int32 current charges
    neigh_idx: torch.Tensor,      # (N, NN) int64, -1 padded
    any_metal_nbr: torch.Tensor,  # (N,) bool, static
    vmax: int,
) -> torch.Tensor:
    """Vacancy-neighbor counts via the compacted (<= vmax) vacancy list and
    the symmetric adjacency: a scatter-add over <= vmax*NN positions."""
    is_v = element == int(ELEM.VACANCY)
    vidx, vv = compact_mask(is_v, vmax)
    rows = neigh_idx[vidx.clamp(min=0)]                  # (VMAX, NN)
    ok = (rows >= 0) & vv[:, None]
    vac_nbrs = torch.zeros(element.shape[0], dtype=torch.int32, device=element.device)
    vac_nbrs.index_add_(0, rows.clamp(min=0).flatten(), ok.flatten().to(torch.int32))
    return _apply_rules(element, charge, any_metal_nbr, vac_nbrs)


def _apply_rules(element, charge, any_metal_nbr, vac_nbrs):
    is_v = element == int(ELEM.VACANCY)
    is_od = element == int(ELEM.OXYGEN_DEFECT)
    zero = torch.zeros_like(charge)
    v_charge = torch.where(any_metal_nbr | (vac_nbrs >= 2), zero, zero + 2)
    od_charge = torch.where(any_metal_nbr, zero, zero - 2)
    return torch.where(is_v, v_charge, torch.where(is_od, od_charge, charge))
