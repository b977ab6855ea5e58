"""glibc ``rand()`` replica (TYPE_3 additive-feedback generator).

The reference's only nondeterminism is ``srand``/``rand`` from glibc
(kmedoidclusterer.cpp:67,780).  Replicating the generator bit-for-bit (the
same trick utils/cxxsort.py plays for libstdc++ sort tie order) makes the
k-medoids clusterer byte-comparable against a pinned-seed oracle build.

Algorithm (glibc stdlib/random_r.c, TYPE_3, degree 31, separation 3):
  r[0]   = seed (0 mapped to 1)
  r[i]   = 16807 * r[i-1] mod 2147483647   for i in 1..30  (Schrage form,
           matching glibc's signed-word evaluation)
  r[31..33] = r[0..2]
  r[i]   = (r[i-31] + r[i-3]) mod 2^32     for i >= 34
  output k >= 0  =  r[34 + 310 + k] >> 1   (first 310 values discarded)

Verified bit-equal against the host glibc by tests/test_kmedoid_oracle.py.
"""

from __future__ import annotations


class GlibcRandom:
    """Bit-exact glibc rand(); supports re-seeding like srand()."""

    def __init__(self, seed: int = 1) -> None:
        self.srand(seed)

    def srand(self, seed: int) -> None:
        seed &= 0xFFFFFFFF
        if seed == 0:
            seed = 1
        r = [seed]
        for _ in range(30):
            hi, lo = divmod(r[-1], 127773)
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 2147483647
            r.append(word)
        r.extend(r[0:3])
        # keep a sliding window of the last 31 values; discard 310 outputs
        self._w = r[3:34]  # window holding r[i-31..i-1]
        for _ in range(310):
            self._step()

    def _step(self) -> int:
        w = self._w
        v = (w[0] + w[28]) & 0xFFFFFFFF
        del w[0]
        w.append(v)
        return v

    def rand(self) -> int:
        """Next rand() value in [0, 2^31)."""
        return self._step() >> 1
