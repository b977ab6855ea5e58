"""K-sorted constrained branched traceback (kscw.h).

cw plus a per-branch-point beam: candidate operations are collected, sorted
by forward+reverse score, truncated to k_limit; children get limit/2 except
the best which keeps the full limit (kscw.h:201-276).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

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
    thresh: float
    score: float = 0.0
    new_r: float = 0.0


class KSConstrainedNearOptimal:
    def __init__(self, params: NOaliParams, subopt) -> None:
        self.params = params
        self.subopt = subopt
        self.warn_user = True

    def estimate_size(self) -> int:
        return self.params.number_suboptimal

    def enumerate(self, dpm, as_) -> None:
        if try_native("kscw", self, dpm, as_, self.subopt):
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

        a = Alignment()
        a.uid = 1
        as_.append(a)
        k_last = len(as_) - 1
        opt = F32(self._H[q_last, t_last])
        threshold = F32(F32(F32(1.0) - F32(self.params.delta_ratio)) * opt)
        threshold = min(threshold, F32(opt - F32(0.1)))

        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, 8 * (q_last + t_last) + 1000))
        try:
            self._branch(as_, OpData(self.params.k_limit, q_last, t_last,
                                     k_last, threshold))
        finally:
            sys.setrecursionlimit(old)
        print(f"Ali#={len(as_)}", file=sys.stderr)
        as_.sort_set(self.params.number_suboptimal)

    def _branch(self, as_, op: OpData) -> None:
        k_limit, q0, t0, k0 = op.limit, op.q0, op.t0, op.k0
        threshold = op.thresh
        if q0 == 1 or t0 == 1:
            as_[k0].prepend(q0, t0)
            as_[k0].prepend(0, 0)
            as_[k0].score = F32(F32(as_[k0].score) + self._H[q0, t0])
            return

        curr = as_[k0].copy()
        if len(as_) > self.params.user_limit:
            if self.warn_user:
                self.warn_user = False
                print(f"Number of alignments exceeding user limits "
                      f"({self.params.user_limit})", file=sys.stderr)
            self._opt_path(as_, op, True)
            return

        k_sort: list[OpData] = []
        r = F32(F32(curr.score) + self._S[q0, t0])

        f = self._H[q0 - 1, t0 - 1]
        s = f + r
        if s > threshold:
            k_sort.append(OpData(k_limit // 2, q0 - 1, t0 - 1, k0, threshold,
                                 float(s), float(r)))
        for i in range(t0 - 2, 0, -1):
            f = self._H[q0 - 1, i]
            g = F32(self._del(q0 - 1, q0, i, t0))
            s = f + r - g
            if s > threshold:
                k_sort.append(OpData(k_limit // 2, q0 - 1, i, k0, threshold,
                                     float(s), float(F32(r - g))))
        for j in range(q0 - 2, 0, -1):
            f = self._H[j, t0 - 1]
            g = F32(self._ins(j, q0, t0 - 1, t0))
            s = f + r - g
            if s > threshold:
                k_sort.append(OpData(k_limit // 2, j, t0 - 1, k0, threshold,
                                     float(s), float(F32(r - g))))

        if not k_sort:
            self._opt_path(as_, OpData(1, q0, t0, k0, threshold), True)
            return

        from ...utils.cxxsort import cxx_partial_sort, cxx_sort
        less = lambda a, b: a.score > b.score
        if len(k_sort) > k_limit:
            cxx_partial_sort(k_sort, k_limit, less)
            del k_sort[k_limit:]
        else:
            cxx_sort(k_sort, less)
        k_sort[0].limit *= 2  # best op keeps the full limit

        k = k0
        for it in k_sort:
            it.k0 = k
            if len(as_) == k:
                c = curr.copy()
                c.uid = k
                as_.append(c)
            as_[k].prepend(q0, t0)
            as_[k].score = F32(it.new_r)
            self._opt_path(as_, it)
            k = len(as_)

    def _opt_path(self, as_, op: OpData, force_opt: bool = False) -> None:
        k_limit, q0, t0, k0 = op.limit, op.q0, op.t0, op.k0
        if k_limit <= 1:
            force_opt = True
        if q0 == 1 or t0 == 1:
            as_[k0].prepend(q0, t0)
            as_[k0].prepend(0, 0)
            as_[k0].score = F32(F32(as_[k0].score) + self._H[q0, t0])
            return

        a = as_[k0]
        pq = pt = -1
        flag = not self.subopt[t0]
        while t0 > 1 and q0 > 1:
            if not force_opt and self.subopt[t0] == flag:
                break
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

        self._branch(as_, OpData(k_limit, pq, pt, k0, op.thresh))
