"""The port's distributed-CG harness (``akmc_tpu_torch/solvers/cg_harness.py``)
against ``akmc_tpu/solvers/cg_harness.py``: the five cases of
``tests/test_cg_harness.py`` with the same numpy systems through both
packages (``akmc_tpu`` on its 8-device virtual CPU mesh, the port on four gloo
ranks), and the generators array for array."""

import numpy as np
import pytest
import torch

from akmc_tpu.solvers import cg_harness as jh
from akmc_tpu_torch.solvers import cg_harness as th

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def k_class():
    return {"jax": jh.run(n=4096, devices=1, contrast=1e8),
            "one": th.run(n=4096, devices=1, contrast=1e8, device="cpu"),
            "four": th.run(n=4096, devices=4, contrast=1e8, device="cpu")}


@pytest.fixture(scope="module")
def t_class():
    return {"jax": jh.run_split(n=4096, n_sub=592, devices=1),
            "one": th.run_split(n=4096, n_sub=592, devices=1, device="cpu"),
            "four": th.run_split(n=4096, n_sub=592, devices=4, device="cpu")}


def test_generators_are_akmc_tpus():
    for a, b in zip(th.make_system(3000, contrast=1e6, seed=4),
                    jh.make_system(3000, contrast=1e6, seed=4)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(th.make_system_split(2000, 290), jh.make_system_split(2000, 290)):
        np.testing.assert_array_equal(a, b)


def test_cg_harness_single_device(k_class):
    res = k_class["one"]
    assert res["rel_l2_error"] < 1e-8
    assert 0 < res["iterations"] < 20000
    assert res["iterations"] == pytest.approx(k_class["jax"]["iterations"], abs=2)


def test_cg_harness_4_ranks_match_single(k_class):
    r1, r4 = k_class["one"], k_class["four"]
    assert r4["devices"] == 4 and r4["rel_l2_error"] < 1e-8
    assert r4["iterations"] == pytest.approx(r1["iterations"], abs=2)
    assert r4["rel_l2_error"] == pytest.approx(k_class["jax"]["rel_l2_error"], rel=1e-3)


def test_split_system_structure():
    """The T-class subblock's invariants (main_test.cpp:46-52): symmetric,
    ~43% dense, zero diagonal, positive weights."""
    _, _, sub_idx, W_off, sub_rowsum = th.make_system_split(2000, 290)
    assert np.array_equal(W_off, W_off.T)
    assert np.all(np.diag(W_off) == 0.0)
    assert 0.35 < np.count_nonzero(W_off) / W_off.size < 0.50
    assert np.allclose(sub_rowsum, W_off.sum(1))
    assert np.all(np.diff(sub_idx) > 0)


def test_cg_harness_t_class_single_device(t_class):
    res = t_class["one"]
    assert res["rel_l2_error"] < 1e-8
    assert 0 < res["iterations"] < 20000
    assert res["iterations"] == pytest.approx(t_class["jax"]["iterations"], abs=2)


def test_cg_harness_t_class_4_ranks_match_single(t_class):
    r1, r4 = t_class["one"], t_class["four"]
    assert r4["rel_l2_error"] < 1e-8
    assert r4["iterations"] == pytest.approx(r1["iterations"], abs=2)
    # 592 = 4 * 148: each rank holds a quarter of the dense subblock
    assert r4["W_bytes_rank"] * 4 == r1["W_bytes_rank"]
    assert r4["rel_l2_error"] == pytest.approx(t_class["jax"]["rel_l2_error"], rel=1e-3)
