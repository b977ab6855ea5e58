"""Substitution-matrix evaluator (aasubalib.h): BLOSUM similarity with
classic affine gaps and the five overhang modes."""

from __future__ import annotations

import numpy as np

from ..seq.sequence import AASequence
from ..utils.params import AliParams, AlignT
from .base import DPCosts, affine_deletion_table, ins_zero_flags
from .submatrix import SubstitutionMatrix


class AASubstitutionEval:
    def __init__(self, params: AliParams, sub_matrix: SubstitutionMatrix) -> None:
        self.params = params
        self.sub_matrix = sub_matrix

    def build_costs(self, query: AASequence, templ: AASequence) -> DPCosts:
        qs = query.get_string()
        ts = templ.get_string()
        q2, t2 = len(qs), len(ts)
        alphabet, table = self.sub_matrix.score_table()
        index = {c: i for i, c in enumerate(alphabet)}

        # similarity: table lookup; head/tail (and the zeroed borders of the
        # SimilarityMatrix, simmatrix.h:50-73) score 0
        qi = np.array([index.get(c, -1) for c in qs], dtype=np.int64)
        ti = np.array([index.get(c, -1) for c in ts], dtype=np.int64)
        S = np.zeros((q2, t2), dtype=np.float32)
        valid = (qi[:, None] >= 0) & (ti[None, :] >= 0)
        S[valid] = table[qi[:, None].clip(0), ti[None, :].clip(0)][valid]
        S[0, :] = 0.0
        S[-1, :] = 0.0
        S[:, 0] = 0.0
        S[:, -1] = 0.0

        gi = np.full((t2, t2), np.float32(self.params.gap_init_penalty))
        ge = np.full((t2, t2), np.float32(self.params.gap_extn_penalty))
        at = AlignT(self.params.align_type)
        D = affine_deletion_table(gi, ge, at)
        A = np.full(t2, np.float32(self.params.gap_init_penalty))
        B = np.full(t2, np.float32(self.params.gap_extn_penalty))
        zh, zt = ins_zero_flags(at)
        return DPCosts(S=S, D=D, A=A, B=B,
                       ins_zero_head_q=zh, ins_zero_tail_q=zt,
                       del_gi_vec=A.copy(), del_ge_vec=B.copy(),
                       del_align=at)
