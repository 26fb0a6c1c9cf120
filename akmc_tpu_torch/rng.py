"""Random-number generation.

Two streams exist in the reference (random_num.h:1-26):
  * the Device stream (seed ``rnd_seed``) used only by makeSubstoichiometric,
  * the KMC stream (seed ``rnd_seed_kmc=1``) whose draws select events and
    advance the clock (kmc_events.cu:469, 515).

Both are ``std::mt19937`` + ``std::uniform_real_distribution<double>(0,1)``.
``ReferenceRNG`` reproduces that stream bit-exactly (libstdc++ semantics:
generate_canonical with 53 bits => two 32-bit draws combined as
``(x0 + x1*2^32) / 2^64``), so golden trajectories from the reference can be
matched. The KMC selection draws are *replicated scalars* in the reference
(identical seeded generator on every rank, kmc_events.cu:469); here they are
precomputed on host into a buffer that the event loop consumes
(``ops/events.py::run_event_loop``), which advances the stream by exactly the
number of draws it used.
"""

from __future__ import annotations

import numpy as np

_N = 624
_M = 397
_MATRIX_A = 0x9908B0DF
_UPPER_MASK = 0x80000000
_LOWER_MASK = 0x7FFFFFFF


class MT19937:
    """Minimal std::mt19937 (32-bit Mersenne twister, standard seeding)."""

    def __init__(self, seed: int):
        self.mt = np.empty(_N, dtype=np.uint64)
        self.mt[0] = seed & 0xFFFFFFFF
        for i in range(1, _N):
            prev = int(self.mt[i - 1])
            self.mt[i] = (1812433253 * (prev ^ (prev >> 30)) + i) & 0xFFFFFFFF
        self.mti = _N

    def _twist(self) -> None:
        # Vectorized in three phases to honor the in-place update order of the
        # canonical twist (indices >= N-M read already-updated entries).
        mt = self.mt

        def f(cur, nxt):
            y = (cur & np.uint64(_UPPER_MASK)) | (nxt & np.uint64(_LOWER_MASK))
            mag = np.where((y & np.uint64(1)).astype(bool), np.uint64(_MATRIX_A), np.uint64(0))
            return (y >> np.uint64(1)) ^ mag

        mt[: _N - _M] = mt[_M:_N] ^ f(mt[: _N - _M], mt[1 : _N - _M + 1])
        # i in [N-M, N-1) reads mt[i+M-N], which may itself be written within
        # this phase — process in dependency-safe chunks of length N-M.
        s = _N - _M
        while s < _N - 1:
            e = min(s + (_N - _M), _N - 1)
            mt[s:e] = mt[s - (_N - _M) : e - (_N - _M)] ^ f(mt[s:e], mt[s + 1 : e + 1])
            s = e
        mt[_N - 1] = mt[_M - 1] ^ f(mt[_N - 1 : _N], mt[0:1])[0]
        self.mt = mt & np.uint64(0xFFFFFFFF)
        self.mti = 0

    @classmethod
    def from_state(cls, mt: np.ndarray, mti: int) -> "MT19937":
        """A generator at a saved position: the 624 state words and the index
        of the next one to temper."""
        self = cls.__new__(cls)
        self.mt = np.array(mt, dtype=np.uint64)
        self.mti = int(mti)
        return self

    def next_uint32(self, count: int) -> np.ndarray:
        """Return `count` tempered 32-bit outputs."""
        out = np.empty(count, dtype=np.uint64)
        filled = 0
        while filled < count:
            if self.mti >= _N:
                self._twist()
            take = min(_N - self.mti, count - filled)
            y = self.mt[self.mti : self.mti + take].copy()
            y ^= y >> np.uint64(11)
            y ^= (y << np.uint64(7)) & np.uint64(0x9D2C5680)
            y ^= (y << np.uint64(15)) & np.uint64(0xEFC60000)
            y ^= y >> np.uint64(18)
            out[filled : filled + take] = y
            self.mti += take
            filled += take
        return out


class ReferenceRNG:
    """std::mt19937 + libstdc++ uniform_real_distribution<double>(0,1).

    Each double consumes two 32-bit outputs x0, x1 and returns
    (x0 + x1*2^64... precisely (x0 + x1*2^32) / 2^64 (generate_canonical
    with b=53 bits, k=2 rounds).
    """

    def __init__(self, seed: int):
        self._mt = MT19937(seed)

    def uniform(self, count: int = 1) -> np.ndarray:
        bits = self._mt.next_uint32(2 * count)
        x0 = bits[0::2].astype(np.float64)
        x1 = bits[1::2].astype(np.float64)
        return (x0 + x1 * 4294967296.0) / 18446744073709551616.0

    def one(self) -> float:
        return float(self.uniform(1)[0])


class BufferedStream:
    """Peek/advance view over a uniform stream.

    The event loop receives a buffer of pre-generated draws but
    may consume fewer (the loop terminates data-dependently). ``peek``
    returns a lookahead window without consuming; ``advance`` commits the
    number of draws the event loop actually used, keeping the host stream
    position exactly in sync with the reference's draw-per-event accounting.
    """

    def __init__(self, rng: ReferenceRNG):
        self._rng = rng
        self._buf = np.empty(0, dtype=np.float64)

    def get_state(self):
        """What a checkpoint must hold to resume the stream bit for bit: the
        twister's state words, its position, and the draws already generated
        but not yet consumed."""
        mt = self._rng._mt
        return mt.mt.copy(), int(mt.mti), self._buf.copy()

    @classmethod
    def from_state(cls, mt: np.ndarray, mti: int, buf: np.ndarray) -> "BufferedStream":
        rng = ReferenceRNG.__new__(ReferenceRNG)
        rng._mt = MT19937.from_state(mt, mti)
        stream = cls(rng)
        stream._buf = np.array(buf, dtype=np.float64)
        return stream

    def peek(self, n: int) -> np.ndarray:
        if len(self._buf) < n:
            extra = self._rng.uniform(n - len(self._buf))
            self._buf = np.concatenate([self._buf, extra])
        return self._buf[:n]

    def advance(self, k: int) -> None:
        assert k <= len(self._buf)
        self._buf = self._buf[k:]
