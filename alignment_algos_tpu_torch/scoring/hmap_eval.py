"""HMAP profile-profile evaluator (hmap_eval.{h,cpp}).

similarity = dot(aa_profile_q, aa_profile_t)
             * exp(alpha * pearson(sse_q, sse_t) * conf_q * conf_t)
Position-specific affine gaps set by pre_calculate on the template:
gap_init/extn scaled by exp(beta * (1 - 1.25 * p_coil)); gap cost uses the
min of the two flanking residues' values.  post_process z-normalizes the
whole similarity region then subtracts zero_shift (hmap_eval.cpp:47-51).

The TPU formulation: the similarity matrix is one (Q,20)x(20,T) matmul plus
one (Q,3)x(3,T) z-scored matmul for the Pearson term.
"""

from __future__ import annotations

import numpy as np

from ..seq.hmap import HMAPSequence
from ..utils.hmath import (norm_elements_region, pearson_rows,
                           seq_matmul_f32, shift_elements_region)
from ..utils.params import AlignT, HMAPaliParams
from .base import DPCosts, affine_deletion_table, ins_zero_flags
from ..native import expf


class HMAPaliEval:
    def __init__(self, params: HMAPaliParams) -> None:
        self.params = params

    def _gap_vectors(self, templ: HMAPSequence) -> tuple[np.ndarray, np.ndarray]:
        """pre_calculate (hmap_eval.cpp:38-45): per-position gap penalties on
        the template, including the sentinel rows (whose p_coil is 0)."""
        p = self.params
        arg = (np.float32(p.beta) *
               (np.float32(1.0) - np.float32(1.25) *
                templ.sse_values[:, 2].astype(np.float32))).astype(np.float32)
        pi = expf(arg)  # libm expf, as resolved by the reference's exp(float)
        gi = (np.float32(p.gap_init_penalty) * pi).astype(np.float32)
        ge = (np.float32(p.gap_extn_penalty) * pi).astype(np.float32)
        return gi, ge

    def build_costs(self, query: HMAPSequence, templ: HMAPSequence) -> DPCosts:
        p = self.params
        q2 = query.size()
        t2 = templ.size()

        # similarity (hmap_eval.h:47-61)
        ip = seq_matmul_f32(query.aa_profile, templ.aa_profile)
        pc = pearson_rows(query.sse_values, templ.sse_values)
        # float-chain ((alpha*pc)*conf_q)*conf_t then libm expf then a float
        # multiply, exactly as hmap_eval.h:56-60 compiles
        arg = (np.float32(p.alpha) * pc).astype(np.float32)
        arg = (arg * query.sse_confid[:, None].astype(np.float32)).astype(np.float32)
        arg = (arg * templ.sse_confid[None, :].astype(np.float32)).astype(np.float32)
        S = (ip * expf(arg)).astype(np.float32)
        S = np.nan_to_num(S, nan=0.0, posinf=0.0, neginf=0.0)
        S[0, :] = 0.0
        S[-1, :] = 0.0
        S[:, 0] = 0.0
        S[:, -1] = 0.0

        # post_process: z-normalize then shift the [1:-1, 1:-1) region
        # (hmap_eval.cpp:47-51 normalizes [1, rows-1) x [1, cols-1))
        if p.normalize_mtx:
            S = norm_elements_region(S, 1, q2 - 1, 1, t2 - 1)
        S = shift_elements_region(S, 1, q2 - 1, 1, t2 - 1, -p.zero_shift)
        S[0, :] = 0.0
        S[-1, :] = 0.0
        S[:, 0] = 0.0
        S[:, -1] = 0.0

        gi_vec, ge_vec = self._gap_vectors(templ)
        gi_pair = np.minimum(gi_vec[:, None], gi_vec[None, :]).astype(np.float32)
        ge_pair = np.minimum(ge_vec[:, None], ge_vec[None, :]).astype(np.float32)
        at = AlignT(p.align_type)
        D = affine_deletion_table(gi_pair, ge_pair, at)

        # insertion pair (j-1, j), indexed by j; A[0] unused
        A = np.minimum(gi_vec, np.roll(gi_vec, 1)).astype(np.float32)
        B = np.minimum(ge_vec, np.roll(ge_vec, 1)).astype(np.float32)
        zh, zt = ins_zero_flags(at)
        return DPCosts(S=S, D=D, A=A, B=B,
                       ins_zero_head_q=zh, ins_zero_tail_q=zt,
                       del_gi_vec=gi_vec.astype(np.float32),
                       del_ge_vec=ge_vec.astype(np.float32), del_align=at)
