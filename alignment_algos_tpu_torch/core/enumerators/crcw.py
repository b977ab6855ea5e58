"""Controlled-redundancy constrained branched traceback (crcw.h) — the
production enumerator for gn2.

At each branch point: collect all Waterman-passing candidate operations,
sort by score (truncate at sort_limit), walk each candidate's optimal
subpath through the current flag region, greedily reject candidates whose
subpath overlaps an already-accepted candidate's subpath by more than
max_overlap (within the same ending region), cap accepted ops at the branch
limit, extend alignments with the subpaths, and recurse per accepted op
(crcw.h:206-550).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

from ...utils.params import NOaliParams
from ..alignment import Alignment

F32 = np.float32

from .nativedelegate import try_native


@dataclass
class OpData:
    limit: int
    q0: int
    t0: int
    k0: int
    score: float = 0.0
    new_r: float = 0.0
    index: int = 0


class CRConstrainedNearOptimal:
    def __init__(self, params: NOaliParams, subopt) -> None:
        self.params = params
        self.subopt = subopt
        self.warn_user = True
        self.count_redundant = 0
        self.count_subpaths = 0

    def estimate_size(self) -> int:
        return self.params.number_suboptimal

    def enumerate(self, dpm, as_) -> None:
        if try_native("crcw", self, dpm, as_, self.subopt):
            return
        q_last = dpm.get_query_size() - 1
        t_last = dpm.get_template_size() - 1
        self.warn_user = True
        self._H = dpm.res.H
        self._PQ = dpm.res.PQ
        self._PT = dpm.res.PT
        self._S = dpm.costs.S
        self._del = dpm.costs.deletion
        self._ins = dpm.costs.insertion

        # region ids per template index (crcw.h init_mem:177-182)
        state = 0
        self._regions = np.zeros(t_last, dtype=np.int64)
        for i in range(self.subopt.size() - 1):
            if self.subopt[i + 1] != self.subopt[i]:
                state += 1
            self._regions[i] = state

        a = Alignment()
        a.uid = 1
        as_.append(a)
        init = len(as_) - 1

        opt = F32(self._H[q_last, t_last])
        self.threshold = F32(F32(F32(1.0) - F32(self.params.delta_ratio)) * opt)
        self.threshold = min(self.threshold, F32(opt - F32(0.1)))
        self.count_redundant = 0
        self.count_subpaths = 0

        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, 8 * (q_last + t_last) + 1000))
        try:
            self._branch(as_, OpData(self.params.k_limit, q_last, t_last, init))
        finally:
            sys.setrecursionlimit(old)

        print(f"Removed {self.count_redundant} subpaths with more than "
              f"{self.params.max_overlap * 100:g}% overlap. Started with "
              f"{self.count_subpaths}.", file=sys.stderr)
        print(f"Number of alignments before sorting: {len(as_)}.",
              file=sys.stderr)
        as_.sort_set(self.params.number_suboptimal)

    # ------------------------------------------------------------------
    def _branch(self, as_, op: OpData) -> None:
        k_limit, q0, t0, k0 = op.limit, op.q0, op.t0, op.k0
        if k_limit < 2:
            self._force_opt_path(as_, op)
            return
        if len(as_) > self.params.user_limit:
            if self.warn_user:
                self.warn_user = False
                print(f"Number of alignments exceeding user limits "
                      f"({self.params.user_limit})", file=sys.stderr)
            self._force_opt_path(as_, op)
            return

        curr = as_[k0]
        all_op: list[OpData] = []
        r = F32(F32(curr.score) + self._S[q0, t0])

        f = self._H[q0 - 1, t0 - 1]
        s = f + r
        if s > self.threshold:
            all_op.append(OpData(k_limit, q0 - 1, t0 - 1, k0, float(s), float(r)))
        for i in range(t0 - 2, 0, -1):
            f = self._H[q0 - 1, i]
            g = F32(self._del(q0 - 1, q0, i, t0))
            s = f + r - g
            if s > self.threshold:
                all_op.append(OpData(k_limit, q0 - 1, i, k0, float(s),
                                     float(F32(r - g))))
        for j in range(q0 - 2, 0, -1):
            f = self._H[j, t0 - 1]
            g = F32(self._ins(j, q0, t0 - 1, t0))
            s = f + r - g
            if s > self.threshold:
                all_op.append(OpData(k_limit, j, t0 - 1, k0, float(s),
                                     float(F32(r - g))))

        if not all_op:
            self._force_opt_path(as_, op)
            return

        from ...utils.cxxsort import cxx_partial_sort, cxx_sort
        less = lambda a, b: a.score > b.score
        if len(all_op) > self.params.sort_limit:
            cxx_partial_sort(all_op, self.params.sort_limit, less)
            del all_op[self.params.sort_limit:]
        else:
            cxx_sort(all_op, less)

        all_op = self._filter_and_extend(as_, q0, t0, all_op)
        for it in all_op:
            if it.k0 > -1:
                self._branch(as_, it)

    # ------------------------------------------------------------------
    def _filter_and_extend(self, as_, q0: int, t0: int,
                           v_op: list[OpData]) -> list[OpData]:
        end_alignment = 2
        n = len(v_op)
        self.count_subpaths += n
        regions = self._regions

        # walk each candidate's optimal subpath through its flag region
        alignments = np.full((n, t0), -1, dtype=np.int64)  # [op][t-1] = q
        p_rq = np.zeros(n, dtype=np.int64)
        p_rt = np.zeros(n, dtype=np.int64)
        l_sp = np.zeros(n, dtype=np.int64)
        state = np.zeros(n, dtype=np.int64)
        rs = np.zeros(n, dtype=np.float32)

        for i, opi in enumerate(v_op):
            opi.index = i
            q, t = opi.q0, opi.t0
            l_sp[i] = 1
            state[i] = regions[t - 1]
            rs[i] = F32(opi.new_r)
            while q > 0 and t > 0 and regions[t - 1] == state[i]:
                alignments[i][t - 1] = q
                l_sp[i] += 1
                pq = int(self._PQ[q, t])
                pt = int(self._PT[q, t])
                if q - pq == 1:
                    g = self._del(pq, q, pt, t)
                else:
                    g = self._ins(pq, q, pt, t)
                rs[i] = F32(F32(rs[i] + self._S[q, t]) - F32(g))
                q, t = pq, pt
            p_rq[i] = q
            p_rt[i] = t
            state[i] = regions[t - 1]

        # greedy redundancy filter (crcw.h:424-461)
        filt = np.zeros(n, dtype=bool)
        filt[0] = True
        count = 0
        accepted = 1
        lim = v_op[-1].limit
        for i in range(1, n):
            if accepted >= lim:
                break
            filt[i] = True
            for j in range(i):
                if filt[i] and filt[j] and state[i] == state[j]:
                    overlap = 0.0
                    overlap_max = self.params.max_overlap * float(l_sp[j])
                    if p_rq[i] == p_rq[j] and p_rt[i] == p_rt[j]:
                        overlap += 1
                    for k in range(t0 - 1, int(p_rt[i]) - 1, -1):
                        if (alignments[i][k] > -1 and alignments[j][k] > -1
                                and alignments[i][k] == alignments[j][k]):
                            overlap += 1
                            if overlap > overlap_max:
                                filt[i] = False
                                count += 1
                                break
                    if not filt[i]:
                        continue
            if filt[i]:
                accepted += 1
        self.count_redundant += count

        # keep accepted ops (cap at lim)
        kept = []
        accepted = 0
        for i in range(n):
            if accepted >= lim:
                break
            if filt[i]:
                kept.append(v_op[i])
                accepted += 1
        v_op = kept
        for i in range(1, len(v_op)):
            v_op[i].limit = max(2, lim // 2)

        # extend alignments with the subpaths
        k = v_op[0].k0
        curr = as_[k].copy()
        for opi in v_op:
            q0_i = opi.index
            if k == len(as_):
                c = curr.copy()
                c.uid = k
                as_.append(c)
            as_[k].prepend(q0, t0)
            for j in range(t0 - 1, int(p_rt[q0_i]), -1):
                ali_q0 = int(alignments[q0_i][j - 1])
                if ali_q0 > -1:
                    as_[k].prepend(ali_q0, j)
            as_[k].score = float(rs[q0_i])

            opi.q0 = int(p_rq[q0_i])
            opi.t0 = int(p_rt[q0_i])
            opi.k0 = k
            if p_rq[q0_i] <= end_alignment or p_rt[q0_i] <= end_alignment:
                self._force_opt_path(as_, opi)
                opi.k0 = -1
            k = len(as_)
        return v_op

    def _force_opt_path(self, as_, op: OpData) -> None:
        q0, t0, k0 = op.q0, op.t0, op.k0
        a = as_[k0]
        while t0 > 0 and q0 > 0:
            a.prepend(q0, t0)
            a.score = F32(F32(a.score) + self._S[q0, t0])
            pq = int(self._PQ[q0, t0])
            pt = int(self._PT[q0, t0])
            if q0 - pq == 1:
                g = self._del(pq, q0, pt, t0)
            else:
                g = self._ins(pq, q0, pt, t0)
            a.score = F32(F32(a.score) - F32(g))
            q0, t0 = pq, pt
        a.prepend(0, 0)
