"""Constrained Waterman-style branched traceback (cw.h).

Branching is only allowed where the SuboptFlags region state changes; every
predecessor whose forward+reverse score passes the Waterman threshold spawns
a branch.  Candidate order, in-place extension of the first branch, and the
user-limit forced-optimal fallback follow cw.h:94-284 exactly, so the
enumerated set (and its truncation behavior at the limits) matches the
reference.

Host-side by design: the recursion is output-sensitive and irregular; the
heavy inputs (the DP score matrix, similarity matrix, gap tables) are
device-computed arrays fetched once.
"""

from __future__ import annotations

import sys

import numpy as np

from ...utils.params import NOaliParams
from ..alignment import Alignment

F32 = np.float32

from .nativedelegate import try_native


class ConstrainedNearOptimal:
    def __init__(self, params: NOaliParams, subopt) -> None:
        self.params = params
        self.subopt = subopt
        self.warn_user = True
        self.user_limit = 1000000  # cw.h:76

    def estimate_size(self) -> int:
        return self.params.number_suboptimal

    def enumerate(self, dpm, as_) -> None:
        if try_native("cw", self, dpm, as_, self.subopt):
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
        a.uid = 0
        as_.append(a)
        k_last = len(as_) - 1

        opt = F32(self._H[q_last, t_last])
        threshold = F32(F32(F32(1.0) - F32(self.params.delta_ratio)) * opt)
        threshold = min(threshold, F32(opt - F32(0.1)))

        old_limit = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old_limit, 8 * (q_last + t_last) + 1000))
        try:
            self._branch(as_, q_last, t_last, k_last, threshold, False)
        finally:
            sys.setrecursionlimit(old_limit)
        as_.sort_set(self.params.number_suboptimal)

    # ------------------------------------------------------------------
    def _branch(self, as_, q0: int, t0: int, k0: int, threshold, force_opt: bool):
        if q0 == 1 or t0 == 1:
            as_[k0].prepend(q0, t0)
            as_[k0].prepend(0, 0)
            as_[k0].score = F32(F32(as_[k0].score) + self._H[q0, t0])
            return

        if force_opt:
            self._opt_path(as_, q0, t0, k0, threshold, True)
            return

        k = k0
        curr = as_[k0].copy()

        if len(as_) > self.user_limit:
            if self.warn_user:
                self.warn_user = False
                print(f"Number of alignments exceeding user limits "
                      f"({self.user_limit})", file=sys.stderr)
            self._opt_path(as_, q0, t0, k0, threshold, True)
            return

        r = F32(F32(curr.score) + self._S[q0, t0])

        # match candidate
        f = self._H[q0 - 1, t0 - 1]
        if f + r > threshold:
            if len(as_) == k:
                as_.append(curr.copy())
            as_[k].prepend(q0, t0)
            as_[k].score = r
            self._opt_path(as_, q0 - 1, t0 - 1, k, threshold, force_opt)
            k = len(as_)

        # deletion candidates, descending template predecessor
        for i in range(t0 - 2, 0, -1):
            f = self._H[q0 - 1, i]
            g = F32(self._del(q0 - 1, q0, i, t0))
            if f + r - g > threshold:
                if len(as_) == k:
                    as_.append(curr.copy())
                as_[k].prepend(q0, t0)
                as_[k].score = F32(r - g)
                self._opt_path(as_, q0 - 1, i, k, threshold, force_opt)
                k = len(as_)

        # insertion candidates, descending query predecessor
        for j in range(q0 - 2, 0, -1):
            f = self._H[j, t0 - 1]
            g = F32(self._ins(j, q0, t0 - 1, t0))
            if f + r - g > threshold:
                if len(as_) == k:
                    as_.append(curr.copy())
                as_[k].prepend(q0, t0)
                as_[k].score = F32(r - g)
                self._opt_path(as_, j, t0 - 1, k, threshold, force_opt)
                k = len(as_)

        if k == k0:
            # all candidates fell below threshold: finish along the optimal path
            self._opt_path(as_, q0, t0, k0, threshold, True)

    def _opt_path(self, as_, q0: int, t0: int, k0: int, threshold, force_opt: bool):
        if q0 == 1 or t0 == 1:
            as_[k0].prepend(q0, t0)
            as_[k0].prepend(0, 0)
            as_[k0].score = F32(F32(as_[k0].score) + self._H[q0, t0])
            return

        a = as_[k0]
        pq = pt = -1
        flag = not self.subopt[t0]  # branch on flag-state change (cw.h:245)
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

        self._branch(as_, pq, pt, k0, threshold, force_opt)
