"""GN2 evaluator (gn2_eval.{h,cpp}) — the flagship structure-aware score.

similarity = gn2_shift + aa_w*log_aa + ss_w*log_ss + cn_w*log_cn + hp_w*log_hp
  log_aa from the normalized profile dot product, log_ss from the 36-entry
  lods table indexed by t.lods_type*12 + q.lods_type, log_cn from the
  template's weighted contact number, log_hp from hydropathy agreement.

deletion: blocked (8100) unless the flanking-Cbeta distance < 18 A, else
affine with SSE-dependent gi/ge plus exp(dist - dd_constr) and a broken-
H-bond term, precomputed into triangular tables (gn2_eval.cpp:135-158).

insertion: affine with coilness-blended gi/ge plus a contact-number term
per template position (gn2_eval.cpp:116-133).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..native import expf, logf
from ..seq.hmap import HMAPSequence
from ..structure.smap import SMAPSequence
from ..utils.hmath import seq_matmul_f32
from ..utils.params import AlignT, HMAPaliParams, ParamStore
from .base import DPCosts, ins_zero_flags

F32 = np.float32


def _default_ss_lods() -> np.ndarray:
    """gn2_eval.cpp:52-108."""
    return np.array([
        0.08, 0.22, 0.43, -1.05, -1.20, -1.57, -0.30, -0.50, -0.55, 0, 0, 0,
        -0.56, -0.79, -1.70, 0.32, 0.44, 0.60, -0.13, -0.22, -0.49, 0, 0, 0,
        -0.04, -0.18, -0.59, 0.10, 0.01, -0.33, 0.14, 0.18, 0.28, 0, 0, 0,
    ], dtype=np.float32)


@dataclass
class Gn2Params(HMAPaliParams):
    gap_init_coil: float = 1.2
    gap_extn_coil: float = 0.08
    gap_init_ss: float = 100.0
    gap_extn_ss: float = 1.0
    aa_weight: float = 1.0
    ss_weight: float = 2.2
    cn_weight: float = 3.4
    hp_weight: float = 1.2
    hb_weight: float = 0.13
    ic_weight: float = 0.09
    dd_constr: float = 8.0
    gn2_shift: float = 1.2
    ss_dependent_gp: bool = True
    ss_lods: np.ndarray = field(default_factory=_default_ss_lods)

    def read(self, p: ParamStore) -> None:  # type: ignore[override]
        for key, attr in (("GI_COIL", "gap_init_coil"),
                          ("GE_COIL", "gap_extn_coil"),
                          ("GI_SS", "gap_init_ss"), ("GE_SS", "gap_extn_ss"),
                          ("AA_WEIGHT", "aa_weight"), ("SS_WEIGHT", "ss_weight"),
                          ("CN_WEIGHT", "cn_weight"), ("HP_WEIGHT", "hp_weight"),
                          ("HB_WEIGHT", "hb_weight"), ("IC_WEIGHT", "ic_weight"),
                          ("GN2_SHIFT", "gn2_shift"),
                          ("DEL_DIST_CONSTR", "dd_constr")):
            if p.find(key):
                setattr(self, attr, p.get_float(key))
        if p.find("SS_DEPENDENT_GP"):
            self.ss_dependent_gp = p.get_bool("SS_DEPENDENT_GP")
        HMAPaliParams.read(self, p)


class Gn2Eval:
    def __init__(self, params: Gn2Params) -> None:
        self.params = params

    # ------------------------------------------------------------------
    def _similarity(self, query: HMAPSequence, templ: SMAPSequence) -> np.ndarray:
        p = self.params
        # normalized profile dot product (hmath.h norm_dot_product)
        ip = seq_matmul_f32(query.aa_profile, templ.aa_profile)
        qsq = np.cumsum(query.aa_profile * query.aa_profile, axis=1,
                        dtype=np.float32)[:, -1]
        tsq = np.cumsum(templ.aa_profile * templ.aa_profile, axis=1,
                        dtype=np.float32)[:, -1]
        from ..native import sqrtf
        norm = (sqrtf(qsq)[:, None] * sqrtf(tsq)[None, :]).astype(np.float32)
        with np.errstate(divide="ignore", invalid="ignore"):
            ipn = (ip / norm).astype(np.float32)
        ipn = np.nan_to_num(ipn, nan=0.0, posinf=0.0, neginf=0.0)

        log_aa = (F32(0.543) / (F32(2.85) - expf(ipn)) - F32(0.738)).astype(np.float32)

        lods_idx = (templ.lods_type[None, :] * 12
                    + query.lods_type[:, None]).astype(np.int64)
        log_ss = p.ss_lods[lods_idx].astype(np.float32)

        wcn = templ.weighted_contact_number.astype(np.float32)
        log_cn = (F32(2.0) * wcn - F32(0.9)).astype(np.float32)[None, :]

        dq = query.hydropathy.astype(np.float32)[:, None]
        dt = templ.hydropathy.astype(np.float32)[None, :]
        inner = expf(-np.abs(dq - dt))
        coef = (F32(0.75) + F32(0.3) * np.abs(dt - F32(0.22))).astype(np.float32)
        log_hp = (expf((inner * coef).astype(np.float32)) - F32(1.8)).astype(np.float32)

        sim = (F32(p.gn2_shift)
               + F32(p.aa_weight) * log_aa).astype(np.float32)
        sim = (sim + F32(p.ss_weight) * log_ss).astype(np.float32)
        sim = (sim + F32(p.cn_weight) * log_cn).astype(np.float32)
        sim = (sim + F32(p.hp_weight) * log_hp).astype(np.float32)
        return sim

    # ------------------------------------------------------------------
    def build_costs(self, query: HMAPSequence, templ: SMAPSequence) -> DPCosts:
        p = self.params
        q2 = query.size()
        t2 = templ.size()
        n = templ.seq_length
        at = AlignT(p.align_type)

        S = self._similarity(query, templ)
        S[0, :] = 0.0
        S[-1, :] = 0.0
        S[:, 0] = 0.0
        S[:, -1] = 0.0
        # post_process is empty for gn2 (raw log-odds)

        # --- insertion vectors (pre_calculate, gn2_eval.cpp:116-133) ------
        p_coil = templ.sse_values[:, 2].astype(np.float32)
        i_idx = np.arange(n + 1)
        v_coil = np.maximum(p_coil[i_idx], p_coil[i_idx + 1]).astype(np.float32)
        v_gi = (v_coil * F32(p.gap_init_coil)
                + (F32(1.0) - v_coil) * F32(p.gap_init_ss)).astype(np.float32)
        v_ge = (v_coil * F32(p.gap_extn_coil)
                + (F32(1.0) - v_coil) * F32(p.gap_extn_ss)).astype(np.float32)
        wcn = templ.weighted_contact_number.astype(np.float32)
        cn = (wcn[i_idx] + wcn[i_idx + 1]).astype(np.float32)
        v_cn = (F32(p.ic_weight) * (F32(1.693) - logf(cn))).astype(np.float32)

        # engine indexing: insertion at pair (j-1, j) uses index j-1
        A = np.zeros(t2, dtype=np.float32)
        B = np.zeros(t2, dtype=np.float32)
        C = np.zeros(t2, dtype=np.float32)
        A[1:] = v_gi
        B[1:] = v_ge
        C[1:] = v_cn

        # --- deletion table (pre_calculate vv tables + gn2_eval.h:99-130) -
        D = np.zeros((t2, t2), dtype=np.float32)
        isse = templ.isse
        for i in range(2, n + 2):
            j_arr = np.arange(i - 1)
            same_sse = (isse[i] == isse[j_arr]) & (isse[i] > -1)
            v_allow = np.where(same_sse, F32(0.0), F32(1.0)).astype(np.float32)
            vv_gi = (v_allow * F32(p.gap_init_coil)
                     + (F32(1.0) - v_allow) * F32(p.gap_init_ss)).astype(np.float32)
            vv_ge = (v_allow * F32(p.gap_extn_coil)
                     + (F32(1.0) - v_allow) * F32(p.gap_extn_ss)).astype(np.float32)
            dist_row = templ.distance[i - 2, : i - 1].astype(np.float32)
            vv_cd = expf((dist_row - F32(p.dd_constr)).astype(np.float32))
            broken = np.zeros(i - 1, dtype=np.float32)
            if i - 2 < n:
                bh = templ.brokenhb[i - 2]
                m = min(i - 1, bh.shape[0])
                broken[:m] = bh[:m].astype(np.float32)
            vv_cd = (vv_cd + v_allow * F32(p.hb_weight) * broken).astype(np.float32)

            di = (i - j_arr).astype(np.float32)
            gp = ((vv_gi + vv_ge * (di - F32(2.0))).astype(np.float32)
                  + vv_cd).astype(np.float32)
            gp = np.where(dist_row < F32(18.0), gp, F32(8100.0)).astype(np.float32)
            D[j_arr, i] = gp

        if at in (AlignT.LOCAL, AlignT.SEMI_LOCAL, AlignT.LOCAL_GLOBAL):
            D[0, :] = 0.0
            D[:, t2 - 1] = 0.0
        zh, zt = ins_zero_flags(at)
        return DPCosts(S=S, D=D, A=A, B=B, ins_zero_head_q=zh,
                       ins_zero_tail_q=zt, C=C, ins_dist_offset=2)
