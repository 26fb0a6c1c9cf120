"""The port's threefry stream (``akmc_tpu_torch/ops/threefry.py``) against
``jax.random`` as ``akmc_tpu`` uses it, bit for bit: ``PRNGKey``, ``split``
and ``uniform`` in f64 and f32; ``draw_step``'s twin against the same
schedule; ``KeyDraws`` as the event loops' source.

JAX is imported by a fixture, not by the module, so that the card's machine
(which has no JAX) can run the ``cuda`` case here: the kernel
``csrc/threefry.cu`` bit-equal to the twin.
"""

import os

import numpy as np
import pytest
import torch

from akmc_tpu_torch.config import KMCParameters
from akmc_tpu_torch.ops import threefry

DECK = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "decks", "iv_sweep_5nm.txt")
SHAPES = [(), (1,), (7,), (1000,), (4096 + 3,)]


@pytest.fixture(scope="module")
def jrandom():
    os.environ.setdefault("JAX_ENABLE_X64", "1")
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    return jax


def _words(key) -> list:
    return np.asarray(key).astype(np.int64).reshape(-1).tolist()


@pytest.mark.parametrize("seed", [0, 1, "deck", 2**32 + 12345])
def test_prng_key_matches_jax(jrandom, seed):
    if seed == "deck":
        seed = KMCParameters.from_file(DECK).rnd_seed_kmc
    assert threefry.prng_key(seed).tolist() == _words(jrandom.random.PRNGKey(seed))


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("seed", [0, 7, 2**33 + 5])
def test_split_matches_jax(jrandom, seed, n):
    key = jrandom.random.PRNGKey(seed)
    got = threefry.split(threefry.prng_key(seed), n)
    want = np.asarray(jrandom.random.split(key, n)).astype(np.int64)
    assert got.shape == (n, 2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_uniform_matches_jax_bit_for_bit(jrandom, shape, dtype):
    jnp = jrandom.numpy
    for seed in (0, 42, 2**32 + 1):
        key = jrandom.random.PRNGKey(seed)
        want = np.asarray(jrandom.random.uniform(key, shape, dtype=getattr(jnp, dtype)))
        got = threefry.uniform(threefry.prng_key(seed), shape, getattr(torch, dtype))
        assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy().reshape(-1).view(np.uint8),
                                      want.reshape(-1).view(np.uint8))
        assert (got >= 0).all() and (got < 1).all()


def test_key_draws_follow_akmc_tpus_schedule(jrandom):
    """``KeyDraws``: a superstep's split, then batches and events as
    ``akmc_tpu``'s loops draw them, equal to ``jax.random`` on the same key."""
    jax, jnp = jrandom, jrandom.numpy
    draws = threefry.KeyDraws.seeded(99, "cpu")
    key = jax.random.PRNGKey(99)
    key, sub = jax.random.split(key)
    loop = draws.split()
    assert draws.key.tolist() == _words(key) and loop.key.tolist() == _words(sub)
    for clock in (torch.float64, torch.float32):
        sub, k_clk, k_slot = jax.random.split(sub, 3)
        u, v = loop.batch(300, clock, 16, torch.float64, "cpu")
        jclock = jnp.float32 if clock == torch.float32 else jnp.float64
        np.testing.assert_array_equal(u.numpy(), np.asarray(
            jax.random.uniform(k_clk, (300,), dtype=jclock)))
        np.testing.assert_array_equal(v.numpy(), np.asarray(
            jax.random.uniform(k_slot, (16,), dtype=jnp.float64)))
    sub, k_sel, k_time = jax.random.split(sub, 3)
    r_sel, r_time = loop.event(torch.float64, "cpu")
    assert float(r_sel) == float(jax.random.uniform(k_sel, dtype=jnp.float64))
    assert float(r_time) == float(jax.random.uniform(k_time, dtype=jnp.float64))
    assert loop.key.tolist() == _words(sub)


@pytest.mark.parametrize("clock", [torch.float64, torch.float32])
def test_draw_step_twin_follows_the_schedule(clock):
    """``draw_step`` (the twin on the CPU): a live step is one batch of
    ``KeyDraws`` with the subkeys kept; a dead step changes nothing."""
    key = threefry.prng_key(5)
    st = threefry.key_state(key)
    u = torch.zeros(257, dtype=clock)
    v = torch.zeros(64, dtype=torch.float64)
    ref = threefry.KeyDraws(key.clone())
    for live in (True, False, True):
        before = (st.clone(), u.clone(), v.clone())
        threefry.draw_step(st, torch.tensor(live), u, v)
        if not live:
            for a, b in zip(before, (st, u, v)):
                assert torch.equal(a, b)
            continue
        sub = threefry.split(ref.key, 3)
        ru, rv = ref.batch(257, clock, 64, torch.float64, "cpu")
        assert torch.equal(u, ru) and torch.equal(v, rv)
        assert st[threefry.SUBKEYS].tolist() == sub.reshape(-1).tolist()
        assert st[threefry.KEY].tolist() == ref.key.tolist()
    # the superstep's split: no draws, the key moved on, sub in state[4:6]
    k0 = st[threefry.KEY].clone()
    threefry.draw_step(st)
    want = threefry.split(k0, 2)
    assert st[threefry.KEY].tolist() == want[0].tolist()
    assert st[4:6].tolist() == want[1].tolist()
    assert int(st[threefry.COUNTER]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("n,B,clock", [(610_304, 64, torch.float64), (409_600, 64, torch.float32),
                                       (1, 1, torch.float64), (0, 0, torch.float64),
                                       (100, 300, torch.float64)])
def test_threefry_kernel_equals_twin(n, B, clock):
    """``csrc/threefry.cu`` against its twin from the same key state: every
    bit of the draws, the subkeys and the key, over live and dead steps, and
    the block count back at 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the threefry kernel has no CPU mode")
    card = torch.device("cuda", torch.cuda.current_device())
    st_c = threefry.key_state(threefry.prng_key(2**40 + 3, card))
    st_h = st_c.cpu()
    u_c, v_c = torch.zeros(n, dtype=clock, device=card), torch.zeros(B, dtype=torch.float64,
                                                                    device=card)
    u_h, v_h = u_c.cpu(), v_c.cpu()
    for live in (True, True, False, True):
        threefry.draw_step(st_c, torch.tensor(live, device=card), u_c, v_c)
        threefry.draw_step_plain(st_h, torch.tensor(live), u_h, v_h)
        torch.cuda.synchronize()
        assert torch.equal(st_c.cpu(), st_h)
        assert torch.equal(u_c.cpu().view(torch.uint8), u_h.view(torch.uint8))
        assert torch.equal(v_c.cpu().view(torch.uint8), v_h.view(torch.uint8))
    threefry.draw_step(st_c)
    threefry.draw_step_plain(st_h, None, None, None)
    assert torch.equal(st_c.cpu(), st_h)
