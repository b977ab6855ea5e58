"""GNOALI evaluator (gnoalib.{h,cpp}): the older structure-aware score.

deletion: broken-H-bond quadratic term + distance/angle exponentials with
SSE-aware branching (gnoalib.h:91-143); insertion: solvent-accessibility
exponential scaled by (dist-1) plus an SSE-type opening offset
(gnoalib.h:145-180); similarity: HMAP profile form with z-norm post-process.

Note: the reference's gnoali tool does not compile as shipped (gnoalib.h:16
includes the renamed hmapalib.h), so there is no binary oracle; this
implementation follows the source semantics.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..native import expf
from ..seq.hmap import HMAPSequence
from ..structure.pdb import HELIX_TYPE
from ..structure.smap import SMAPSequence
from ..utils.hmath import norm_elements_region, shift_elements_region
from ..utils.params import AlignT, HMAPaliParams, ParamStore
from .base import DPCosts, ins_zero_flags
from .hmap_eval import HMAPaliEval

F32 = np.float32


@dataclass
class GnoaliParams(HMAPaliParams):
    di_par1: float = -4.0   # dist_0
    di_par2: float = 10.0   # dist_off
    di_par3: float = 4.0    # dist_scale
    hb_par1: float = 0.0    # hb_0
    hb_par2: float = 0.0    # hb_off
    hb_par3: float = 1.0    # hb_scale
    ac_par1: float = -50.0  # acc_0
    ac_par2: float = 5.0    # acc_off
    ac_par3: float = -50.0  # acc_scale
    igo_alpha: float = 20.0  # helix insertion opening
    igo_beta: float = 10.0   # strand insertion opening

    def read(self, p: ParamStore) -> None:  # type: ignore[override]
        for key, attr in (("DI_PAR1", "di_par1"), ("DI_PAR2", "di_par2"),
                          ("DI_PAR3", "di_par3"), ("HB_PAR1", "hb_par1"),
                          ("HB_PAR2", "hb_par2"), ("HB_PAR3", "hb_par3"),
                          ("AC_PAR1", "ac_par1"), ("AC_PAR2", "ac_par2"),
                          ("AC_PAR3", "ac_par3"), ("INS_GO_HELIX", "igo_alpha"),
                          ("INS_GO_STRAND", "igo_beta")):
            if p.find(key):
                setattr(self, attr, p.get_float(key))
        HMAPaliParams.read(self, p)


class GnoaliEval:
    def __init__(self, params: GnoaliParams) -> None:
        self.params = params

    def build_costs(self, query: HMAPSequence, templ: SMAPSequence) -> DPCosts:
        p = self.params
        q2 = query.size()
        t2 = templ.size()
        n = templ.seq_length
        at = AlignT(p.align_type)

        # similarity: identical form to the HMAP evaluator minus the
        # gap pre_calculate (gnoalib.h:77-90), with z-norm + shift
        hm = HMAPaliEval(p)
        ip_costs = hm.build_costs(query, templ)
        S = ip_costs.S  # already normalized+shifted identically

        # --- deletion table ------------------------------------------------
        D = np.zeros((t2, t2), dtype=np.float32)
        isse = templ.isse
        sse_type = templ.sse_type
        for i in range(2, n + 2):
            j_arr = np.arange(i - 1)
            di = (i - j_arr).astype(np.float32)
            broken = np.zeros(i - 1, dtype=np.float32)
            if i - 2 < n:
                bh = templ.brokenhb[i - 2]
                m = min(i - 1, bh.shape[0])
                broken[:m] = bh[:m].astype(np.float32)
            br = (broken / (di - F32(1.0))).astype(np.float32)
            b0 = (br + F32(p.hb_par1)).astype(np.float32)
            bp = (b0 * b0 / F32(p.hb_par3)).astype(np.float32)

            rd1 = templ.distance[i - 2, : i - 1].astype(np.float32)
            rd2_raw = templ.distance2[i - 2, : i - 1].astype(np.float32)
            rd2 = (np.maximum(rd2_raw - F32(7.0), F32(0.0))
                   - np.maximum(rd1 - F32(7.0), F32(0.0))).astype(np.float32)
            sd = np.abs(isse[i] - isse[j_arr])
            far = sd > 1
            ang = templ.angle[i - 2, : i - 1].astype(np.float32)
            ra = np.where(far, (expf(ang) * F32(2.0)).astype(np.float32),
                          F32(0.735759)).astype(np.float32)
            rd = np.where(far, F32(0.0),
                          expf((F32(2.0) * rd2 / F32(p.di_par3)).astype(np.float32)))
            gp = (expf(((rd1 + F32(p.di_par1)) / F32(p.di_par3)).astype(np.float32))
                  * ra + rd).astype(np.float32)
            ro = np.where((isse[j_arr] >= 0) & (isse[j_arr] == isse[i]),
                          F32(p.di_par2), F32(0.0)).astype(np.float32)
            total = ((F32(p.hb_par2) + bp) + (ro + gp)).astype(np.float32)
            D[j_arr, i] = total

        if at in (AlignT.LOCAL, AlignT.SEMI_LOCAL, AlignT.LOCAL_GLOBAL):
            D[0, :] = 0.0
            D[:, t2 - 1] = 0.0

        # --- insertion: A[j] = sse opening offset, B[j] = accessibility
        # exponential for pair (j-1, j), cost = A + B*(dist-1) ------------
        acc = templ.accessibility.astype(np.float64)
        A = np.zeros(t2, dtype=np.float32)
        B = np.zeros(t2, dtype=np.float32)
        for j in range(1, t2):
            t1p, t2p = j - 1, j
            a1, a2 = acc[t1p], acc[t2p]
            ga = F32(np.float32(np.exp((F32(p.ac_par1) + (a1 + a2) / 2.0)
                                       / F32(p.ac_par3))))
            ao = F32(0.0)
            if isse[t1p] >= 0 and isse[t1p] == isse[t2p]:
                ao = F32(p.igo_alpha) if sse_type[t1p] == HELIX_TYPE else F32(p.igo_beta)
            A[j] = ao
            B[j] = ga
        zh, zt = ins_zero_flags(at)
        return DPCosts(S=S, D=D, A=A, B=B, ins_zero_head_q=zh,
                       ins_zero_tail_q=zt, C=None, ins_dist_offset=1)
