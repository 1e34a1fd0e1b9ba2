"""glibc's ``srandom``/``random`` (TYPE_3, the default generator) and the
reference trainer's shuffle, frozen here so that the plain reference works
each epoch's sample order out again from the conf's ``[seed]``.

The generator: ``r[0] = seed`` (0 read as 1), ``r[i] = 16807 r[i-1] mod
(2^31 - 1)`` for i < 31 by Schrage's method on int32, 310 outputs
discarded, then ``r[i] = r[i-31] + r[i-3] mod 2^32`` and ``random()``
returns ``r[i] >> 1``.  The shuffle (hpnn's ``libhpnn.c:1218-1229``) draws
``idx = (unsigned)(random() * n / RAND_MAX)`` and draws again while the
slot is taken; ``idx == n`` (``random()`` returned RAND_MAX) is drawn
again too.  One ``srandom`` a run: every epoch's shuffle continues the
same stream.
"""

from __future__ import annotations

RAND_MAX = 2147483647
_DEG, _SEP, _M32 = 31, 3, 0xFFFFFFFF


class Random:
    """The stream of ``srandom(seed)`` then ``random()`` calls."""

    def __init__(self, seed: int):
        word = int(seed) & _M32 or 1
        if word >= 1 << 31:
            word -= 1 << 32
        state = [word & _M32]
        for _ in range(1, _DEG):
            hi, lo = divmod(word, 127773)
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 2147483647
            state.append(word & _M32)
        self.state, self.f, self.r = state, _SEP, 0
        for _ in range(10 * _DEG):
            self.random()

    def random(self) -> int:
        st, f, r = self.state, self.f, self.r
        val = st[f] = (st[f] + st[r]) & _M32
        self.f = f + 1 if f + 1 < _DEG else 0
        self.r = r + 1 if r + 1 < _DEG else 0
        return val >> 1


def shuffle(rng: Random, n: int) -> list[int]:
    """One epoch's order: listing indices in the order they are trained."""
    taken = bytearray(n)
    order = []
    st, f, r = rng.state, rng.f, rng.r
    for _ in range(n):
        while True:
            val = st[f] = (st[f] + st[r]) & _M32
            f = f + 1 if f + 1 < _DEG else 0
            r = r + 1 if r + 1 < _DEG else 0
            idx = int((val >> 1) * n / RAND_MAX)
            if idx < n and not taken[idx]:
                break
        taken[idx] = 1
        order.append(idx)
    rng.f, rng.r = f, r
    return order
