"""Evaluator interface for the DP engine.

The reference dispatches scoring through a CRTP ``Evaluator`` with five hooks
(similarity / deletion / insertion / pre_calculate / post_process,
evaluator.h:20-97) called per candidate cell inside the O(Q*T*(Q+T)) DP loop.
The TPU-native design instead asks each evaluator to *materialize* its cost
model once as dense arrays (a similarity matrix, a template-pair deletion
table, and per-column affine insertion coefficients); the DP kernels then
consume only arrays.  This covers every reference evaluator exactly:

* deletion costs never depend on query positions (aasubalib.h:27-51,
  hmap_eval.h:63-88, gn2_eval.h:99-130, gnoalib.h:91-143) -> a (T+2,T+2)
  table D[k, j] suffices;
* insertion costs are affine in the query gap length with coefficients that
  depend only on the flanking template pair (aasubalib.h:53-77,
  hmap_eval.h:90-117, gn2_eval.h:132-158) -> per-column A[j], B[j] with
  cost(q1,q2,j) = A[j] + B[j]*(q2-q1-2), plus head/tail-overhang zero flags.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.params import AlignT

# modes in which gap costs touching the sequence ends are zeroed
_DEL_FREE_OVERHANG_MODES = (AlignT.LOCAL, AlignT.SEMI_LOCAL, AlignT.LOCAL_GLOBAL)
_INS_FREE_OVERHANG_MODES = (AlignT.LOCAL, AlignT.SEMI_LOCAL, AlignT.GLOBAL_LOCAL)


@dataclass
class DPCosts:
    """Materialized cost model for one (query, template, evaluator) triple.

    S:  (Q+2, T+2) float32 similarity matrix, borders zeroed, post-processed.
    D:  (T+2, T+2) float32 deletion cost for a template gap with endpoints
        (k, j); zero where j-k < 2; head/tail overhang rules applied at
        k == 0 and j == T+1.
    A, B: (T+2,) float32 insertion coefficients for the template pair
        (j-1, j), indexed by j; cost = A[j] + B[j]*(dist-2) for dist >= 2.
    ins_zero_head_q / ins_zero_tail_q: insertion cost is zero when the gap
        starts at the query Head / ends at the query Tail (overhang modes).
    """

    S: np.ndarray
    D: np.ndarray
    A: np.ndarray
    B: np.ndarray
    ins_zero_head_q: bool
    ins_zero_tail_q: bool
    # generalized insertion form: (A[j] + B[j]*(dist - ins_dist_offset)) + C[j]
    # (gn2 adds a per-column contact term after the affine part,
    # gn2_eval.h:139; gnoali scales by (dist-1), gnoalib.h:168)
    C: np.ndarray | None = None
    ins_dist_offset: int = 2
    # when D equals affine_deletion_table(min-outer(del_gi_vec),
    # min-outer(del_ge_vec), del_align), these let device kernels rebuild
    # D from the two (T+2,) vectors instead of shipping the (T+2, T+2)
    # table (ops/dp_scores)
    del_gi_vec: np.ndarray | None = None
    del_ge_vec: np.ndarray | None = None
    del_align: AlignT | None = None

    @property
    def q_size(self) -> int:
        return self.S.shape[0]

    @property
    def t_size(self) -> int:
        return self.S.shape[1]

    def ins_cost_of_dist(self, dist, j):
        """Vectorized insertion cost for integer gap spans ``dist`` at
        column j, in the evaluator's float32 op order."""
        dist = np.asarray(dist, dtype=np.int64)
        cost = (np.float32(self.A[j]) + np.float32(self.B[j])
                * (dist - self.ins_dist_offset).astype(np.float32)).astype(np.float32)
        if self.C is not None:
            cost = (cost + np.float32(self.C[j])).astype(np.float32)
        return np.where(dist < 2, np.float32(0.0), cost)

    # --- scalar cost hooks (bit-compatible with the DP arrays; used by the
    # --- traceback enumerators which re-price individual gaps) -------------
    def deletion(self, q1: int, q2: int, t1: int, t2: int) -> float:
        return float(self.D[t1, t2])

    def insertion(self, q1: int, q2: int, t1: int, t2: int) -> float:
        dist = q2 - q1
        if dist < 2:
            return 0.0
        if self.ins_zero_head_q and q1 == 0:
            return 0.0
        if self.ins_zero_tail_q and q2 == self.q_size - 1:
            return 0.0
        return float(self.ins_cost_of_dist(np.array([dist]), t2)[0])


def affine_deletion_table(gi: np.ndarray, ge: np.ndarray,
                          align_type: AlignT) -> np.ndarray:
    """Build D[k, j] for affine template gaps with per-pair coefficients
    gi[k,j], ge[k,j] (already reduced, e.g. elementwise-min of endpoint
    values): cost = gi + ge*(j-k-2) for j-k >= 2 else 0, with overhang modes
    zeroing k == 0 and j == T+1 entries."""
    t2 = gi.shape[0]
    k = np.arange(t2, dtype=np.int64)[:, None]
    j = np.arange(t2, dtype=np.int64)[None, :]
    dist = (j - k).astype(np.float32)
    cost = (gi + ge * (dist - np.float32(2.0))).astype(np.float32)
    cost = np.where(j - k < 2, np.float32(0.0), cost)
    if align_type in _DEL_FREE_OVERHANG_MODES:
        cost[0, :] = 0.0
        cost[:, t2 - 1] = 0.0
    return cost.astype(np.float32)


def ins_zero_flags(align_type: AlignT) -> tuple[bool, bool]:
    z = align_type in _INS_FREE_OVERHANG_MODES
    return z, z
