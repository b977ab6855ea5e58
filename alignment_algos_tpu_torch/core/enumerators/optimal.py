"""Optimal-alignment tracebacks (optimal.h, optimal_rev.h, optimal_subali.h)."""

from __future__ import annotations

import numpy as np

from ...utils.params import AlignT
from ..alignment import Alignment


class Optimal:
    """Standard traceback from the tail cell (optimal.h:47-124)."""

    def __init__(self, align_type: AlignT = AlignT.GLOBAL) -> None:
        self.islocal = AlignT(align_type) == AlignT.LOCAL

    def estimate_size(self) -> int:
        return 1

    def enumerate(self, dpm, as_) -> None:
        if self.islocal:
            self._enumerate_local(dpm, as_)
            return
        a = Alignment()
        q = dpm.get_query_size() - 1
        t = dpm.get_template_size() - 1
        a.score = dpm.score(q, t)
        a.append(q, t)
        while q > 0:
            q, t = dpm.prev(q, t)
            a.prepend(q, t)
        if q != 0 or t != 0:
            raise ValueError("Illegal alignment start pair")
        as_.append(a)

    def _enumerate_local(self, dpm, as_) -> None:
        a = Alignment()
        q = dpm.get_query_size() - 1
        t = dpm.get_template_size() - 1
        a.append(q, t)
        q, t, score = self._find_max(dpm)
        a.score = score
        a.prepend(q, t)
        while q > 0:
            pq, pt = dpm.prev(q, t)
            if dpm.score(pq, pt) <= 0.0:
                q, t = pq, pt
                break
            q, t = pq, pt
            a.prepend(q, t)
        if q != 0 and t != 0:
            a.prepend(0, 0)
        as_.append(a)

    @staticmethod
    def _find_max(dpm) -> tuple[int, int, float]:
        """Full scan over all but the last row/col, initialized at the
        (size-2, size-2) cell which wins ties (optimal.h:107-124)."""
        H = dpm.res.H[: dpm.get_query_size() - 1, : dpm.get_template_size() - 1]
        q0, t0 = H.shape[0] - 1, H.shape[1] - 1
        init = float(H[q0, t0])
        m = float(H.max())
        if m > init:
            flat = int(np.argmax(H))
            q, t = divmod(flat, H.shape[1])
            return q, t, m
        return q0, t0, init


class OptimalRev:
    """Traceback of a reverse-built matrix from (0,0) forward (optimal_rev.h)."""

    def __init__(self, align_type: AlignT = AlignT.GLOBAL) -> None:
        self.islocal = AlignT(align_type) == AlignT.LOCAL

    def estimate_size(self) -> int:
        return 1

    def enumerate(self, dpm, as_) -> None:
        if self.islocal:
            self._enumerate_local(dpm, as_)
            return
        a = Alignment()
        q_last = dpm.get_query_size() - 1
        t_last = dpm.get_template_size() - 1
        q = t = 0
        a.score = dpm.score(q, t)
        a.append(q, t)
        while q < q_last:
            q, t = dpm.prev(q, t)
            a.append(q, t)
        if q != q_last or t != t_last:
            raise ValueError("Illegal alignment start pair")
        as_.append(a)

    def _enumerate_local(self, dpm, as_) -> None:
        a = Alignment()
        q_last = dpm.get_query_size() - 1
        t_last = dpm.get_template_size() - 1
        a.append(0, 0)
        q, t, score = self._find_max(dpm)
        a.score = score
        a.append(q, t)
        while q < q_last:
            pq, pt = dpm.prev(q, t)
            if dpm.score(pq, pt) <= 0.0:
                q, t = pq, pt
                break
            q, t = pq, pt
            a.append(q, t)
        if q != q_last and t != t_last:
            a.append(q_last, t_last)
        as_.append(a)

    @staticmethod
    def _find_max(dpm) -> tuple[int, int, float]:
        """optimal_rev.h find_max scans i,j in [1, size) descending; with
        first-maximum-in-scan-order tie-breaking."""
        H = dpm.res.H[1:, 1:][::-1, ::-1]
        flat = int(np.argmax(H))
        qi, ti = divmod(flat, H.shape[1])
        q = dpm.get_query_size() - 1 - qi
        t = dpm.get_template_size() - 1 - ti
        best = float(H[qi, ti])
        if dpm.score(0, 0) >= best:
            return 0, 0, float(dpm.score(0, 0))
        return q, t, best


class OptimalSubali:
    """Traceback between two anchor cells of a sub-built matrix
    (optimal_subali.h:59-83)."""

    def __init__(self, q1_end: int, t1_end: int, q2_beg: int, t2_beg: int) -> None:
        self.q1_end = q1_end
        self.t1_end = t1_end
        self.q2_beg = q2_beg
        self.t2_beg = t2_beg

    def estimate_size(self) -> int:
        return 1

    def enumerate(self, dpm, as_) -> None:
        a = Alignment()
        q, t = self.q2_beg, self.t2_beg
        a.score = dpm.score(q, t)
        a.append(q, t)
        while q > self.q1_end:
            q, t = dpm.prev(q, t)
            a.prepend(q, t)
        if q != self.q1_end or t != self.t1_end:
            raise ValueError("Illegal alignment start pair")
        as_.append(a)
