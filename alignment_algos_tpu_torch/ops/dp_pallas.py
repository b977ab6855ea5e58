"""Exact general-gap DP with the full H matrix (counterpart of
``alignment_algos_tpu/ops/dp_pallas.py``).

The TPU package has a second Pallas kernel for this, one H row per grid
step; here K3 (:func:`.dp_scores.dp_general`) computes the same function
and its full-H mode returns H.  The cost tables are built on the host
exactly as the JAX package builds them (:func:`_host_tables`, a numpy
copy), so the H matrices are bit-identical to ``dp_ref`` / ``dp_engine``.
There is no ``supported()`` gate and no ``MAX_VMEM_SIDE``: K3's table form
takes t2 up to 19,200 (its rows in shared memory).
"""

from __future__ import annotations

import numpy as np
import torch

from . import dp_ref
from .dp_ref import NULL, DPResult
from .dp_scores import dp_general

__all__ = ["forward_h_batched", "forward_h_reference", "forward_result",
           "forward_scores_batch"]


def _host_tables(c, q0: int, q1: int, t0: int, t1: int):
    """Exact host-precomputed cost tables (reference float32
    mul-then-add), a copy of the JAX package's numpy helper.  Cm and
    insc_m are indexed by gap distance m."""
    q2 = c.q_size
    m = np.arange(q2, dtype=np.int64)
    Cm = (c.A[None, :] + c.B[None, :]
          * (m[:, None] - c.ins_dist_offset).astype(np.float32)
          ).astype(np.float32)
    if c.C is not None:
        Cm = (Cm + c.C[None, :].astype(np.float32)).astype(np.float32)
    Cm[m < 2] = 0.0

    ii = np.arange(q2, dtype=np.int64)
    ins0 = c.ins_cost_of_dist(ii - q0, t0 + 1)
    if c.ins_zero_head_q and q0 == 0:
        ins0 = np.zeros_like(ins0)
    # closing-cell insertion costs in distance form: insc_m[m] =
    # insertion(q1-m, q1, t1-1, t1)
    insc_m = c.ins_cost_of_dist(m, t1)
    if c.ins_zero_tail_q and q1 == q2 - 1:
        insc_m = np.zeros_like(insc_m)
    dclose = np.ascontiguousarray(c.D[:, t1])
    return Cm, ins0, insc_m, dclose


def _bucket_shape(costs: list) -> tuple[int, int]:
    """(q2, t2) of a non-empty batch of same-shape cost models."""
    if not costs:
        raise ValueError("empty batch of cost models")
    shape = (costs[0].q_size, costs[0].t_size)
    if any((c.q_size, c.t_size) != shape for c in costs):
        raise ValueError("cost models of several shapes: bucket by shape "
                         "first")
    return shape


def forward_h_reference(costs: list, local: bool = False) -> np.ndarray:
    """The shared numpy engine, ``dp_ref.build_forward``, over the whole
    matrix of each pair: (n, q2, t2) H.  The route for shapes K3 does not
    take (q2 < 3 or t2 < 3), and the independent oracle K3 is held
    against."""
    return np.stack([dp_ref.build_forward(c, 0, c.q_size - 1, 0,
                                          c.t_size - 1, local=local).H
                     for c in costs])


def forward_h_batched(costs: list, local: bool = False, *,
                      device: torch.device) -> np.ndarray:
    """Full forward H matrices (n, q2, t2) for a batch of same-shape cost
    models, bit-identical to ``dp_ref``: K3 in full-H mode on CUDA, its
    plain version on the CPU."""
    q2, t2 = _bucket_shape(costs)
    if q2 < 3 or t2 < 3:
        return forward_h_reference(costs, local=local)
    tabs = [_host_tables(c, 0, q2 - 1, 0, t2 - 1) for c in costs]
    arrays = (np.stack([c.S for c in costs]), np.stack([c.D for c in costs]),
              np.stack([t[0] for t in tabs]), np.stack([t[1] for t in tabs]),
              np.stack([t[2] for t in tabs]), np.stack([t[3] for t in tabs]))
    tensors = [torch.from_numpy(np.ascontiguousarray(a, np.float32))
               .to(device) for a in arrays]
    return dp_general(*tensors, local=local, full_h=True).cpu().numpy()


def forward_scores_batch(costs: list, local: bool = False, *,
                         device: torch.device) -> np.ndarray:
    """Optimal global scores H[q1, t1] for a batch of same-shape pairs."""
    H = forward_h_batched(costs, local=local, device=device)
    return H[:, -1, -1].copy()


def forward_result(c, local: bool = False, *,
                   device: torch.device) -> DPResult:
    """DPResult with the exact H matrix (traceback pointers left NULL, as
    the JAX package leaves them)."""
    H = forward_h_batched([c], local=local, device=device)[0]
    res = DPResult(c.q_size, c.t_size)
    res.H = H
    res.PQ[:] = NULL
    res.PT[:] = NULL
    return res
