"""Input recipes shared by the generators: the length lists a
configuration fixes, and fitting a planted homolog to its slot."""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np

AA = "ARNDCQEGHILKMFPSTWYV"


def lengths(cfg: dict) -> np.ndarray:
    """The configuration's template lengths: log-normal quantiles at (i +
    0.5) / n, rounded and clipped, in ascending order.  The list is the
    same for every seed; a seed only permutes it over the slots."""
    spec, n = cfg["lengths"], cfg["n_templates"]
    inv = NormalDist().inv_cdf
    return np.array([min(spec["max"], max(spec["min"], int(round(
        spec["median"] * math.exp(spec["sigma"] * inv((i + 0.5) / n))))))
        for i in range(n)], dtype=np.int64)


def core(n: int) -> tuple[int, int]:
    """The part of an n-residue query its homologs descend from."""
    return n // 12, n - n // 16


def fit(rng: np.random.Generator, rows: np.ndarray, n: int, fill):
    """``rows`` cut to a window of n at a random offset, or flanked by
    ``fill(k)`` rows split at random to reach n."""
    if len(rows) >= n:
        lo = int(rng.integers(0, len(rows) - n + 1))
        return rows[lo:lo + n]
    pad = n - len(rows)
    left = int(rng.integers(0, pad + 1))
    return np.concatenate([fill(left), rows, fill(pad - left)])
