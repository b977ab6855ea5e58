"""The published peaks of the card and the work a kernel needs.

Frozen with the benchmark so that a change to the program cannot move the
yardstick.  Peaks are NVIDIA's data sheet for the H100 SXM (80 GB HBM3) at
its full 700 W: 3.35 TB/s of HBM, 132 SMs of 128 float32 lanes at the
1,980 MHz boost clock, one operation per lane per clock.  The card's own
clock reading is not used.

A kernel's roofline share is its least time, the larger of its bytes over
the memory rate and its operations over the float32 rate, over the device
time it took.  Bytes count each input read once and each output written
once; operations count what the inputs need (real residues, not padding).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
SMS = 132
F32_LANES = 128
SM_CLOCK_HZ = 1.98e9
F32_OPS_PER_S = SMS * F32_LANES * SM_CLOCK_HZ

# K1 (local affine Smith-Waterman scores): per needed cell, the three
# recurrences' adds, subtracts and maxes and the running max
K1_OPS_PER_CELL = 11


def least_s(nbytes: float, ops: float) -> float:
    """The least time the card could take for ``nbytes`` of HBM traffic and
    ``ops`` float32 operations."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def k1_work(q: int, residues: int, n_templates: int,
            alphabet: int) -> tuple[float, float]:
    """K1's bytes and operations for one query of ``q`` residues against
    ``n_templates`` templates holding ``residues`` real residues: the
    templates' int32 codes, the query's, the table and the gap pair read
    once, one float32 score written per template; 11 operations per cell
    of query x real template residues."""
    nbytes = 4.0 * (residues + q + alphabet * alphabet + 2 + n_templates)
    return nbytes, float(K1_OPS_PER_CELL) * q * residues


def k3_work(shapes) -> tuple[float, float]:
    """K3's bytes and operations on its vector form for buckets of (n, q2,
    t2) (sizes with the two sentinel rows): S and the four cost vectors
    read once, one score written; a subtract and a max per gap candidate
    (both kinds, the triangles the recurrence scans), six operations per
    interior cell."""
    nbytes = ops = 0.0
    for n, q2, t2 in shapes:
        ia, ib = q2 - 3, t2 - 3
        nbytes += 4 * n * (q2 * t2 + 4 * t2 + 1)
        ops += n * ia * ib * (ia + ib - 2) + 6 * n * ia * ib
    return nbytes, ops
