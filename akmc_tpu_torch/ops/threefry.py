"""``akmc_tpu``'s random stream: JAX's threefry-2x32, as ``jax.random`` uses it.

``akmc_tpu`` draws every production superstep from a threefry key: the driver
makes it as ``jax.random.PRNGKey(p.rnd_seed_kmc)``, each superstep splits it
once (``key, sub = jax.random.split(key)``, ``akmc_tpu/models/vcm.py:1050``,
``:1173``) and each batch or event splits again (``key, k_a, k_b =
jax.random.split(key, 3)``, ``akmc_tpu/ops/events.py:589``, ``:834``) and
draws ``jax.random.uniform`` from the two subkeys. This module is its
counterpart, bit for bit (JAX 0.9, ``jax_threefry_partitionable`` on):

* a key is two 32-bit words, ``prng_key(s) = (s >> 32, s & 0xFFFFFFFF)``;
* ``split(key, n)`` is the block function on the counters ``(0, i)``, i < n;
* the bits of n values come from the counters ``(i >> 32, i & 0xFFFFFFFF)``:
  words ``(b0, b1)``, 64-bit ``(b0 << 32) | b1``, 32-bit ``b0 ^ b1``;
* a uniform in [0, 1) is the float whose mantissa is the top bits: f64
  ``((bits >> 12) | 0x3FF0000000000000) - 1.0``, f32 ``((bits >> 9) |
  0x3F800000) - 1.0``.

The plain twin (``block``, ``split``, ``uniform``) computes on int64 tensors
holding 32-bit words, on any device. ``draw_step`` is one step of a loop that
draws from a key held on the device: the kernel ``csrc/threefry.cu`` on a
card, the twin on the CPU. It reads the key where it stands when it runs (so
a CUDA graph that replays it draws anew each time), splits it in three,
draws the step's uniforms from the second and third subkeys and moves the
key on to the first, all only when the step is live. ``KeyDraws`` is the
draws source of the event loops that holds such a key.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from akmc_tpu_torch.ops import cuda_build, device_loop

M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KERNEL = "threefry"

# the layout of a loop's key state (int64): the key, the three subkeys of its
# last live step, and the kernel's count of blocks that have read the key
KEY, SUBKEYS, COUNTER, STATE_LEN = slice(0, 2), slice(2, 8), 8, 9


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def block(k0, k1, x0: torch.Tensor, x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """threefry2x32 of the key words (k0, k1) on the counter words (x0, x1):
    int64 tensors (or ints for the key) of 32-bit words, mod 2^32."""
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: (2,) int64 of 32-bit words."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & M32, seed & M32], dtype=torch.int64, device=device)


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(key, n)``: (n, 2) int64."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    b0, b1 = block(key[0], key[1], torch.zeros_like(i), i)
    return torch.stack([b0, b1], dim=1)


def _uniform_flat(key: torch.Tensor, n: int, dtype) -> torch.Tensor:
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    b0, b1 = block(key[0], key[1], i >> 32, i & M32)
    if dtype == torch.float64:
        bits = (b0 << 20) | (b1 >> 12) | 0x3FF0000000000000
        return bits.view(torch.float64) - 1.0
    if dtype == torch.float32:
        bits = ((b0 ^ b1) >> 9) | 0x3F800000
        return bits.to(torch.int32).view(torch.float32) - 1.0
    raise ValueError(f"uniform draws f64 or f32, not {dtype}")


def uniform(key: torch.Tensor, shape: Sequence[int] = (), dtype=torch.float64) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype)`` in [0, 1), f64 or f32."""
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= int(s)
    return _uniform_flat(key, n, dtype).reshape(shape)


# ----------------------------------------------------------------------
# one step of a loop that draws on the device
# ----------------------------------------------------------------------
def key_state(key: Optional[torch.Tensor] = None, device=None) -> torch.Tensor:
    """A loop's key state ((STATE_LEN,) int64, the kernel's counter 0),
    holding ``key`` if given."""
    dev = key.device if key is not None else device
    st = torch.zeros(STATE_LEN, dtype=torch.int64, device=dev)
    if key is not None:
        st[KEY].copy_(key)
    return st


def draw_step_plain(state: torch.Tensor, live: Optional[torch.Tensor],
                    u: Optional[torch.Tensor], v: Optional[torch.Tensor]) -> None:
    """The twin of ``draw_step``: (key', k_a, k_b) = split(key, 3); ``u``
    from k_a, ``v`` from k_b (each in its own type); the three subkeys into
    the state and the key moved on to key', everything kept as it was where
    ``live`` (0-d bool) is false."""
    sub = split(state[KEY], 3)
    new = [(state[SUBKEYS], sub.reshape(-1)), (state[KEY], sub[0])]
    if u is not None and u.numel():
        new.append((u, uniform(sub[1], u.shape, u.dtype)))
    if v is not None and v.numel():
        new.append((v, uniform(sub[2], v.shape, v.dtype)))
    for dst, val in new:
        dst.copy_(val if live is None else torch.where(live, val, dst))


def _launcher():
    """The library's C entry point, built and typed on first use."""
    fn = cuda_build.load(_KERNEL).threefry_step_launch
    if fn.argtypes is None:
        v = ctypes.c_void_p
        fn.argtypes = [v, v, v, ctypes.c_int, ctypes.c_longlong, v, ctypes.c_longlong, v]
        fn.restype = ctypes.c_int
    return fn


def _check(name: str, t: torch.Tensor, dtypes, dev) -> None:
    if t.device != dev or t.dtype not in dtypes or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D {' or '.join(map(str, dtypes))} "
                         f"tensor on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def draw_step(state: torch.Tensor, live: Optional[torch.Tensor] = None,
              u: Optional[torch.Tensor] = None, v: Optional[torch.Tensor] = None) -> None:
    """One step's draws from the key held in ``state`` (``key_state``):
    ``u`` (n,) f64 or f32 from the step's second subkey, ``v`` (B,) f64 from
    its third, the subkeys kept in the state and the key moved on, only where
    ``live`` (a 0-d bool device flag; None: always) is true. With neither
    ``u`` nor ``v`` it is ``key, sub = split(key)``: the subkey ``sub`` is
    then ``state[4:6]``. On a card the kernel ``csrc/threefry.cu`` (one launch,
    which reads the key and the flag on the device: nothing is read back);
    on the CPU the twin ``draw_step_plain``."""
    dev = state.device
    if dev.type == "cpu":
        draw_step_plain(state, live, u, v)
        return
    from akmc_tpu_torch.ops.dia_matvec import current_raw_stream

    _check("state", state, (torch.int64,), dev)
    if state.numel() != STATE_LEN:
        raise ValueError(f"state must hold {STATE_LEN} words, got {state.numel()}")
    if live is not None and (live.device != dev or live.dtype != torch.bool or live.dim()):
        raise ValueError("live must be a 0-d bool tensor on the state's device")
    n = b = 0
    u_f32 = 0
    if u is not None and u.numel():
        _check("u", u, (torch.float64, torch.float32), dev)
        n, u_f32 = u.numel(), int(u.dtype == torch.float32)
    if v is not None and v.numel():
        _check("v", v, (torch.float64,), dev)
        b = v.numel()
    device_loop.bind(state, live, u if n else None, v if b else None)
    args = (state.data_ptr(), None if live is None else live.data_ptr(),
            u.data_ptr() if n else None, u_f32, n, v.data_ptr() if b else None, b,
            current_raw_stream(dev.index))
    if torch.cuda.current_device() == dev.index:
        err = _launcher()(*args)
    else:
        with torch.cuda.device(dev):
            err = _launcher()(*args)
    if err != 0:
        raise RuntimeError(f"threefry kernel launch failed: CUDA error {err}")
    device_loop.count_launch(draw_step)


draw_step.launches = 0     # kernel launches (in a graph: launches as replayed)


class KeyDraws:
    """A draws source that is ``akmc_tpu``'s threefry key, held on the
    device as a (2,) int64 tensor of 32-bit words. The plain loops draw from
    it as ``akmc_tpu``'s loops do (a batch or an event splits the key in
    three and draws from the last two subkeys); the device loops copy the key
    into their own state, draw inside their step (``draw_step``) and copy it
    back. Nothing is read back to the host."""

    def __init__(self, key: torch.Tensor):
        if key.dtype != torch.int64 or tuple(key.shape) != (2,):
            raise ValueError(f"a key is (2,) int64, got {key.dtype} {tuple(key.shape)}")
        self.key = key

    @classmethod
    def seeded(cls, seed: int, device) -> "KeyDraws":
        """``jax.random.PRNGKey(seed)`` on ``device``."""
        return cls(prng_key(seed, torch.device(device) if isinstance(device, str) else device))

    def split(self) -> "KeyDraws":
        """``key, sub = jax.random.split(key)``: this source moves on to
        ``key``; the returned one holds ``sub``."""
        sub = split(self.key, 2)
        self.key = sub[0].clone()
        return KeyDraws(sub[1].clone())

    def batch(self, n: int, clock_dtype, B: int, dtype,
              device) -> Tuple[torch.Tensor, torch.Tensor]:
        """One batch of the batched loop: ``key, k_clk, k_slot = split(key,
        3)``, u_clk (n,) in the clock's type from k_clk, u_slot (B,) from
        k_slot."""
        sub = split(self.key, 3)
        self.key = sub[0].clone()
        return uniform(sub[1], (n,), clock_dtype), uniform(sub[2], (B,), dtype)

    def event(self, dtype, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """One event of the native loop: ``key, k_sel, k_time = split(key,
        3)``, the selection draw from k_sel and the waiting-time draw from
        k_time (0-d each)."""
        sub = split(self.key, 3)
        self.key = sub[0].clone()
        return uniform(sub[1], (), dtype), uniform(sub[2], (), dtype)
