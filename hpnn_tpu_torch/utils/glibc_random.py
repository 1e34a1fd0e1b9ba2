"""Bit-exact reimplementation of glibc's ``random()`` / ``srandom()``.

The reference framework (ovhpa/hpnn) derives two things from glibc's default
TYPE_3 additive-feedback generator:

* the training/testing sample shuffle order
  (``src/libhpnn.c:1218-1229``), and
* the initial weight values, uniform in +-1/sqrt(M)
  (``src/ann.c:653-707``: ``w = 2*(random()/RAND_MAX - 0.5)/sqrt(M)``).

To reproduce its training trajectories bit-for-bit we need the exact same
stream of 31-bit integers.  glibc's default generator (TYPE_3, 31-word state,
degree r=31, separation s=3) is:

    seeding (srandom):
        r[0] = seed (seed 0 is mapped to 1 by glibc)
        r[i] = (16807 * r[i-1]) mod 2147483647          for i in 1..30
               (computed via Schrage's method on int32, negative results
                corrected by adding 2^31-1)
    then the state is "spun" 310 times (10 * degree), discarding outputs.

    output:
        r[i] = (r[i-31] + r[i-3]) mod 2^32   (uint32 wraparound)
        return r[i] >> 1                      (a 31-bit value)

``RAND_MAX`` is 2**31 - 1.

This is a well-known public algorithm (documented in glibc's stdlib/random_r.c
and many independent write-ups); the implementation below is from the spec and
is verified against the host libc in tests/test_glibc_random.py.
"""

from __future__ import annotations

import numpy as np

RAND_MAX = 2147483647  # 2**31 - 1

_DEG = 31  # degree of the default TYPE_3 trinomial x**31 + x**3 + 1
_SEP = 3   # separation
_M32 = 0xFFFFFFFF


class GlibcRandom:
    """Stream-compatible clone of glibc ``srandom(seed)`` + ``random()``."""

    __slots__ = ("_state", "_f", "_r")

    def __init__(self, seed: int):
        self.srandom(seed)

    def srandom(self, seed: int) -> None:
        seed = int(seed) & _M32
        if seed == 0:
            seed = 1
        # int32 view of the seed word, as glibc stores it
        word = seed - (1 << 32) if seed >= (1 << 31) else seed
        state = [0] * _DEG
        state[0] = word & _M32
        # Schrage's method for 16807 * x mod (2^31 - 1) in 32-bit arithmetic.
        for i in range(1, _DEG):
            hi, lo = divmod(word, 127773)
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 2147483647
            state[i] = word & _M32
        self._state = state
        self._f = _SEP   # front pointer index
        self._r = 0      # rear pointer index
        for _ in range(_DEG * 10):
            self.random()

    def random(self) -> int:
        """Return the next 31-bit pseudo-random value (0 .. RAND_MAX)."""
        st = self._state
        f, r = self._f, self._r
        val = st[f] = (st[f] + st[r]) & _M32
        self._f = f + 1 if f + 1 < _DEG else 0
        self._r = r + 1 if r + 1 < _DEG else 0
        return val >> 1

    # -- state capture (checkpoint/resume) ---------------------------------

    def get_state(self) -> list[int]:
        """The full generator state as 33 ints: the 31 state words then
        the front/rear pointers.  Restoring it with :meth:`set_state`
        continues the output stream bit-exactly -- the checkpoint
        subsystem persists this so a resumed training run draws the SAME
        shuffle orders the uninterrupted run would have."""
        return [*self._state, self._f, self._r]

    def set_state(self, state) -> None:
        vals = [int(v) for v in state]
        if len(vals) != _DEG + 2:
            raise ValueError(
                f"glibc RNG state must be {_DEG + 2} ints, got {len(vals)}")
        self._state = [v & _M32 for v in vals[:_DEG]]
        self._f = vals[_DEG] % _DEG
        self._r = vals[_DEG + 1] % _DEG

    @classmethod
    def from_state(cls, state) -> "GlibcRandom":
        rng = cls.__new__(cls)
        rng.set_state(state)
        return rng

    # -- bulk helpers ------------------------------------------------------

    def randoms(self, n: int) -> np.ndarray:
        """Return the next ``n`` values as an int64 ndarray."""
        n = int(n)
        out = np.empty(n, dtype=np.int64)
        st = self._state
        f, r = self._f, self._r
        for i in range(n):
            val = st[f] = (st[f] + st[r]) & _M32
            f = f + 1 if f + 1 < _DEG else 0
            r = r + 1 if r + 1 < _DEG else 0
            out[i] = val >> 1
        self._f, self._r = f, r
        return out

    def uniform_array(self, n: int) -> np.ndarray:
        """``random()/RAND_MAX`` for ``n`` draws, as float64 (ann.c:674-677)."""
        return self.randoms(n).astype(np.float64) / RAND_MAX


def shuffled_indices(seed_or_rng, n: int) -> list[int]:
    """Reproduce the reference's shuffle-without-replacement order.

    The reference draws ``idx = (UINT)((DOUBLE)random() * n / RAND_MAX)`` and
    re-draws while slot ``idx`` was already consumed
    (``src/libhpnn.c:1221-1229``).  Note ``random()`` can
    return RAND_MAX itself, in which case idx == n; the C code would index out
    of bounds there, we re-draw instead (documented deviation; probability
    2**-31 per draw).
    """
    rng = seed_or_rng if isinstance(seed_or_rng, GlibcRandom) else GlibcRandom(seed_or_rng)
    taken = [False] * n
    order: list[int] = []
    for _ in range(n):
        idx = int(rng.random() * n / RAND_MAX)
        while idx >= n or taken[idx]:
            idx = int(rng.random() * n / RAND_MAX)
        taken[idx] = True
        order.append(idx)
    return order
