"""Utility namespace (reference: src/utils.{h,cpp}), the names of
``akmc_tpu/utils/__init__.py``.

Element coding, xyz I/O, distances and structure manipulation live in
``akmc_tpu_torch.lattice``, the reference random streams in
``akmc_tpu_torch.rng``; they are re-exported here.
"""

from akmc_tpu_torch.lattice import (
    ELEM,
    ELEMENT_NAMES,
    EVENT,
    NAME_TO_ELEMENT,
    center_coords,
    count_contact_sites,
    read_xyz,
    site_dist,
    sort_by_x,
    sort_by_xyz,
    translate_cell,
    write_xyz_snapshot,
)
from akmc_tpu_torch.rng import MT19937, BufferedStream, ReferenceRNG

__all__ = [
    "ELEM", "ELEMENT_NAMES", "EVENT", "NAME_TO_ELEMENT",
    "center_coords", "count_contact_sites", "read_xyz", "site_dist",
    "sort_by_x", "sort_by_xyz", "translate_cell", "write_xyz_snapshot",
    "MT19937", "BufferedStream", "ReferenceRNG",
]
