"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs a CUDA device (a hand-written kernel has no CPU mode)
and skips without one. The file imports no JAX, so it also runs on a machine
that has only the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from akmc_tpu_torch.lattice import ELEM, metal_mask
from akmc_tpu_torch.models.crossbar import build_grid_crossbar
from akmc_tpu_torch.ops import dia_matvec as mv
from akmc_tpu_torch.solvers.dia import build_dia_k

OFFSET_SETS = [
    [-136, -129, -128, -127, -64, -9, -1, 1, 9, 64, 127, 128, 129, 136],
    [-5000, -4999, -3, -1, 1, 3, 4999, 5000],
    [-2, -1, 1, 2],
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the DIA kernel has no CPU mode")
    return torch.device("cuda")


def _cases():
    p, lat = build_grid_crossbar(n_yz=6, contact_slices=2, oxide_slices=6, ti_slices=2,
                                 defect_fraction=0.3, vacancy_concentration=0.1, seed=3)
    dia, meta = build_dia_k(np.stack([lat.x, lat.y, lat.z], 1), lat.k_neigh_idx,
                            metal_mask(lat.element0, p.metals), p.num_atoms_first_layer,
                            p.high_G, p.low_G)
    assert (lat.element0 == int(ELEM.NULL_ELEMENT)).any()
    yield "crossbar", dia.diags, dia.offsets, meta.val_low, meta.val_high
    rng = np.random.RandomState(0)
    for offs in OFFSET_SETS:
        c = np.where(rng.rand(len(offs), 4000) < 0.6, rng.randint(1, 3, (len(offs), 4000)), 0)
        yield str(offs[0]), torch.tensor(c, dtype=torch.int8), torch.tensor(offs), 1e-8, 1.0


@pytest.mark.cuda
def test_dia_kernel_matches_twin(card):
    rng = np.random.default_rng(1)
    for name, diags, offsets, lo, hi in _cases():
        n = diags.shape[1]
        x = torch.tensor(rng.standard_normal(n) * np.exp(rng.standard_normal(n)))
        xv = torch.tensor(rng.standard_normal(n) * (rng.random(n) < 0.3))
        y0, v0 = mv.dia_combined_matvec(diags, offsets, lo, hi, x, xv)
        before = mv.dia_combined_matvec.launches
        y1, v1 = mv.dia_combined_matvec(diags.to(card), offsets.to(card), lo, hi,
                                        x.to(card), xv.to(card))
        torch.cuda.synchronize()
        assert mv.dia_combined_matvec.launches == before + 1
        # same terms, same order, same roundings: equal bit for bit
        assert torch.equal(y1.cpu(), y0), name
        assert torch.equal(v1.cpu(), v0), name


@pytest.mark.cuda
def test_dia_kernel_refuses_what_it_does_not_take(card):
    _, diags, offsets, lo, hi = next(_cases())
    n = diags.shape[1]
    d, o = diags.to(card), offsets.to(card)
    x = torch.zeros(n, dtype=torch.float64, device=card)
    for bad in (x.float(), x[:-1], torch.zeros(2 * n, dtype=torch.float64, device=card)[::2]):
        with pytest.raises(ValueError):
            mv.dia_combined_matvec(d, o, lo, hi, bad, x)
    with pytest.raises(ValueError):
        mv.dia_combined_matvec(d.cpu(), o, lo, hi, x, x)
