"""Math helpers mirroring hmath.h semantics (dot products, z-normalization,
Pearson correlation) as vectorized numpy, float32 throughout."""

from __future__ import annotations

import numpy as np


def seq_sum_f32(v: np.ndarray, axis: int = -1) -> np.ndarray:
    """Strictly sequential float32 summation along ``axis`` — matches the
    reference's valarray::sum() / += accumulation order bit-for-bit (numpy's
    own sum is pairwise/unrolled and rounds differently).

    Short axes (profile dims, K ~ 20) accumulate with an unrolled
    in-place loop — same sequential rounding as cumsum's last element
    without materializing the full cumulative array (the cumsum path was
    ~60% of build_costs)."""
    v = np.asarray(v, dtype=np.float32)
    n = v.shape[axis]
    if n == 0:
        return np.zeros(np.delete(v.shape, axis), dtype=np.float32)
    if n <= 64:
        mv = np.moveaxis(v, axis, 0)
        acc = mv[0].astype(np.float32, copy=True)
        for i in range(1, n):
            acc += mv[i]
        return acc
    return np.cumsum(v, axis=axis, dtype=np.float32).take(-1, axis=axis)


def seq_matmul_f32(A: np.ndarray, B: np.ndarray, chunk: int = 128) -> np.ndarray:
    """(N,K) x (M,K) -> (N,M) with sequential-in-K float32 accumulation:
    out accumulates the k-th outer-product term in order, which is the
    reference's += rounding sequence exactly."""
    A = np.asarray(A, dtype=np.float32)
    B = np.asarray(B, dtype=np.float32)
    k = A.shape[1]
    out = (A[:, 0:1] * B[None, :, 0]).astype(np.float32)
    for i in range(1, k):
        out += A[:, i:i + 1] * B[None, :, i]
    return out


def norm_elements_vec(v: np.ndarray) -> np.ndarray:
    """Z-normalize a vector (hmath.h norm_elements): (v - mean) / std with
    var = E[v^2] - E[v]^2, sums accumulated in reference order."""
    v = v.astype(np.float32)
    n = np.float32(v.size)
    avg = np.float32(seq_sum_f32(v) / n)
    sumsq = np.float32(seq_sum_f32(v * v))
    var = np.float32(sumsq / n - avg * avg)
    std = np.float32(np.sqrt(var))
    return ((v - avg) / std).astype(np.float32)


def norm_elements_region(m: np.ndarray, i0: int, i1: int, j0: int, j1: int) -> np.ndarray:
    """Z-normalize the [i0:i1, j0:j1) region of a matrix in place-like fashion
    (hmath.h norm_elements(matrix) overload). Returns a new array."""
    if i0 >= i1 or j0 >= j1:
        i0, j0, i1, j1 = 0, 0, m.shape[0], m.shape[1]
    out = m.astype(np.float32).copy()
    region = out[i0:i1, j0:j1]
    out[i0:i1, j0:j1] = norm_elements_vec(region.ravel()).reshape(region.shape)
    return out


def shift_elements_region(m: np.ndarray, i0: int, i1: int, j0: int, j1: int,
                          shift: float) -> np.ndarray:
    """Add ``shift`` to the region (hmath.h shift_elements)."""
    if i0 >= i1 or j0 >= j1:
        i0, j0, i1, j1 = 0, 0, m.shape[0], m.shape[1]
    out = m.astype(np.float32).copy()
    out[i0:i1, j0:j1] = out[i0:i1, j0:j1] + np.float32(shift)
    return out


def pearson_rows(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pearson correlation between every row of ``a`` (N,K) and every row of
    ``b`` (M,K) -> (N,M), mirroring hmath.h pearson_corr (z-normalize each
    K-vector, dot, divide by K) with reference accumulation order."""
    a = a.astype(np.float32)
    b = b.astype(np.float32)
    k = a.shape[1]

    def znorm(rows):
        avg = (seq_sum_f32(rows, axis=1) / np.float32(k))[:, None]
        sumsq = seq_sum_f32(rows * rows, axis=1)[:, None]
        var = sumsq / np.float32(k) - avg * avg
        std = np.sqrt(var).astype(np.float32)
        with np.errstate(divide="ignore", invalid="ignore"):
            return ((rows - avg) / std).astype(np.float32)

    za = znorm(a)
    zb = znorm(b)
    dots = seq_matmul_f32(za, zb)
    return (dots / np.float32(k)).astype(np.float32)
