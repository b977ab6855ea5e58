"""Alignment containers (alignment.h).

An alignment is an ordered list of (query_idx, template_idx) matched pairs
(1-based with the (0,0) head pair and (Q+1,T+1) tail pair included), plus
score / identity / significance / SSE_CO / coverage metadata.
"""

from __future__ import annotations

from collections import deque

import numpy as np


class Alignment:
    """AlignedPairList (alignment.h:49-113)."""

    __slots__ = ("pairs", "score", "identity", "significance", "SSE_CO",
                 "coverage", "uid")

    def __init__(self, pairs=None) -> None:
        self.pairs: deque[tuple[int, int]] = deque(pairs or [])
        self.score = 0.0
        self.identity = 0.0
        self.significance = 9999.0
        self.SSE_CO = 0.0
        self.coverage = 0.0
        self.uid = -1

    def copy(self) -> "Alignment":
        a = Alignment(self.pairs)
        a.score = self.score
        a.identity = self.identity
        a.significance = self.significance
        a.SSE_CO = self.SSE_CO
        a.coverage = self.coverage
        a.uid = self.uid
        return a

    # --- basic ops --------------------------------------------------------
    def append(self, i: int, j: int) -> None:
        self.pairs.append((i, j))

    def prepend(self, i: int, j: int) -> None:
        self.pairs.appendleft((i, j))

    def __len__(self) -> int:
        return len(self.pairs)

    def __iter__(self):
        return iter(self.pairs)

    def front(self) -> tuple[int, int]:
        return self.pairs[0]

    def back(self) -> tuple[int, int]:
        return self.pairs[-1]

    def get_first_query_idx(self) -> int:
        return self.pairs[0][0]

    def get_last_query_idx(self) -> int:
        return self.pairs[-1][0]

    def get_first_template_idx(self) -> int:
        return self.pairs[0][1]

    def get_last_template_idx(self) -> int:
        return self.pairs[-1][1]

    def remove_first_pair(self) -> None:
        self.pairs.popleft()

    def remove_last_pair(self) -> None:
        self.pairs.pop()

    def remove_ends(self) -> None:
        self.pairs.popleft()
        self.pairs.pop()

    def combine(self, a: "Alignment") -> None:
        """splice + score sum (alignment.h:474-479); ``a`` is emptied."""
        self.pairs.extend(a.pairs)
        a.pairs.clear()
        self.score += a.score

    def frag_follows(self, a: "Alignment") -> bool:
        return self.get_last_query_idx() + 1 < a.get_first_query_idx()

    # --- construction from gapped strings ---------------------------------
    def read_from(self, query: str, templ: str) -> None:
        """Parse a 2-row gapped alignment (alignment.h:115-156)."""
        self.score = 0.0
        self.identity = 0.0
        self.significance = 9999.0
        self.uid = -1
        self.pairs.clear()
        if len(query) != len(templ):
            raise ValueError("readFrom error: query and templ not equal length")
        seq1 = seq2 = -1
        aligned = 0.0
        ident = 0.0
        for qc, tc in zip(query, templ):
            if qc != "-":
                seq1 += 1
            if tc != "-":
                seq2 += 1
            if qc != "-" and tc != "-":
                self.append(seq1, seq2)
                if qc not in "^$" and tc not in "^$":
                    aligned += 1.0
                    if qc == tc:
                        ident += 1.0
        self.identity = (ident / aligned * 100.0) if aligned else float("nan")

    # --- rendering --------------------------------------------------------
    def get_templ_string(self, templ_str: str) -> str:
        """Gapped template rendering incl. zigzag handling (alignment.h:210-271)."""
        pairs = list(self.pairs)
        res = [templ_str[pairs[0][1]]]
        prev = pairs[0]
        for cur in pairs[1:]:
            if cur[1] == prev[1] + 1:
                res.append("-" * (cur[0] - prev[0] - 1))
            else:
                res.append(templ_str[prev[1] + 1 : cur[1]])
                if cur[0] > prev[0] + 1:  # zigzag
                    res.append("-" * (cur[0] - prev[0] - 1))
            res.append(templ_str[cur[1]])
            prev = cur
        return "".join(res)

    def get_query_string(self, query_str: str) -> str:
        """Gapped query rendering (alignment.h:274-337)."""
        pairs = list(self.pairs)
        res = [query_str[pairs[0][0]]]
        prev = pairs[0]
        for cur in pairs[1:]:
            if cur[0] == prev[0] + 1:
                res.append("-" * (cur[1] - prev[1] - 1))
            else:
                res.append(query_str[prev[0] + 1 : cur[0]])
                if cur[1] > prev[1] + 1:  # zigzag
                    res.append("-" * (cur[1] - prev[1] - 1))
            res.append(query_str[cur[0]])
            prev = cur
        return "".join(res)

    # --- metrics ----------------------------------------------------------
    def calc_identity(self, query: str, templ: str) -> None:
        """alignment.h:855-865 — counts equal chars over pairs (head/tail
        match and are compensated by the -2)."""
        total = min(len(query), len(templ)) - 2
        bulk = len(self.pairs) > 64 and query.isascii() and templ.isascii()
        if bulk:
            # bulk path: one byte-compare over gathered pair positions
            p = np.asarray(self.pairs, dtype=np.int64)
            qb = np.frombuffer(query.encode("ascii"), np.uint8)
            tb = np.frombuffer(templ.encode("ascii"), np.uint8)
            same = int((qb[p[:, 0]] == tb[p[:, 1]]).sum()) - 2
        else:
            same = -2
            for qi, ti in self.pairs:
                if query[qi] == templ[ti]:
                    same += 1
        self.identity = float(same) / float(total) * 100.0 if total else 0.0

    def calc_significance(self, sig) -> None:
        self.significance = sig.significance(self.score)

    def get_simple_shift(self, apl: "Alignment", core) -> tuple[float, int]:
        """Mean |template shift| over core-flagged aligned query positions
        (alignment.h:400-436). Returns (shift, aligned_len)."""
        if self.get_last_query_idx() != core.size() - 1:
            raise ValueError("Core file length does not match alignment")
        al = ts = 0
        other = list(apl.pairs)
        oi = 0
        for q, t in self.pairs:
            while oi < len(other) and other[oi][0] < q:
                oi += 1
            if oi >= len(other):
                break
            if other[oi][0] == q and core[q]:
                ts += abs(other[oi][1] - t)
                al += 1
        if not al:
            raise ValueError("No residues aligned")
        return float(ts) / float(al), al

    def get_q_all(self, native: "Alignment", core):
        """Agreement metrics vs a native alignment (alignment.h:340-397).
        Returns (n_agree, q_mod, q_dev, q_comb)."""
        if self.get_last_query_idx() != core.size() - 1:
            raise ValueError("Core file length does not match alignment")
        n_agree = -2  # account for head and tail
        cur = list(self.pairs)
        nat = list(native.pairs)
        ci = ni = 0
        while ci < len(cur) and ni < len(nat):
            if nat[ni][0] < cur[ci][0]:
                ni += 1
                continue
            if cur[ci][0] < nat[ni][0]:
                ci += 1
                continue
            if core[cur[ci][0]] and nat[ni][1] == cur[ci][1]:
                n_agree += 1
            ni += 1
            ci += 1
        seen = np.zeros(core.size(), dtype=bool)
        d_mod = -2
        for q, _ in cur:
            if core[q]:
                d_mod += 1
                seen[q] = True
        d_dev = -2
        for q, _ in nat:
            if core[q]:
                d_dev += 1
                seen[q] = True
        d_comb = int(seen.sum()) - 2
        return (n_agree,
                float(n_agree) / float(d_mod) if d_mod else float("nan"),
                float(n_agree) / float(d_dev) if d_dev else float("nan"),
                float(n_agree) / float(d_comb) if d_comb else float("nan"))

    def get_area_diff(self, other: "Alignment") -> float:
        """Exact area between the two alignment paths via merged segment
        sweep + trapezoid differences (alignment.h:525-641), float32."""
        F = np.float32
        p1 = list(self.pairs)
        p2 = list(other.pairs)
        i1 = i2 = 1
        prev1, prev2 = p1[0], p2[0]
        area = F(0.0)
        base = F(self.pairs[-1][0])  # back().query_idx()
        while i1 < len(p1) or i2 < len(p2):
            c1 = p1[min(i1, len(p1) - 1)]
            c2 = p2[min(i2, len(p2) - 1)]
            if c1[1] <= c2[1]:
                main_is_former = True
                former, former_prev = c1, prev1
                latter, latter_prev = c2, prev2
                prev1 = c1
                i1 += 1
            else:
                main_is_former = False
                former, former_prev = c2, prev2
                latter, latter_prev = c1, prev1
                prev2 = c2
                i2 += 1
            xa1, ya1 = F(former_prev[1]), F(former_prev[0])
            xa2, ya2 = F(former[1]), F(former[0])
            xb1, yb1 = F(latter_prev[1]), F(latter_prev[0])
            xb2, yb2 = F(latter[1]), F(latter[0])
            seg = _compare_segments(xa1, ya1, xa2, ya2, xb1, yb1, xb2, yb2)
            exists, has_area, xp, yp, a1s, a2s, b1s, b2s = seg
            if has_area:
                def trap(x1, y1, x2, y2):
                    return F(F(F(F(base - y1) + F(base - y2)) / F(2.0))
                             * F(x2 - x1))
                if not exists:
                    area = F(area + abs(F(trap(a1s[0], a1s[1], a2s[0], a2s[1])
                                           - trap(b1s[0], b1s[1], b2s[0], b2s[1]))))
                else:
                    area = F(area + abs(F(trap(a1s[0], a1s[1], xp, yp)
                                           - trap(b1s[0], b1s[1], xp, yp))))
                    area = F(area + abs(F(trap(xp, yp, a2s[0], a2s[1])
                                           - trap(xp, yp, b2s[0], b2s[1]))))
            if xa2 == xb2:
                if main_is_former:
                    prev2 = p2[min(i2, len(p2) - 1)]
                    i2 += 1
                else:
                    prev1 = p1[min(i1, len(p1) - 1)]
                    i1 += 1
        return float(area)

    def export_path(self) -> np.ndarray:
        """(K,2) int array of (q,t) pairs."""
        return np.array(list(self.pairs), dtype=np.int64).reshape(-1, 2)

    def fix_zigzag(self) -> None:
        """Re-diagonalize zigzag regions by perpendicular-distance walk
        (alignment.h:782-844)."""
        pairs = list(self.pairs)
        out = []
        prev = pairs[0]
        out.append(prev)
        for cur in pairs[1:]:
            if cur[1] - prev[1] > 1 and cur[0] - prev[0] > 1:
                q_beg, t_beg = prev
                q_end, t_end = cur
                q_new, t_new = q_beg, t_beg
                while (q_end - q_new) > 1 and (t_end - t_new) > 1:
                    q_new += 1
                    t_new += 1
                    while (_perp_dist(q_end - q_beg, t_end - t_beg,
                                      (q_new + 1) - q_beg, t_new - t_beg)
                           < _perp_dist(q_end - q_beg, t_end - t_beg,
                                        q_new - q_beg, t_new - t_beg)):
                        q_new += 1
                    while (_perp_dist(q_end - q_beg, t_end - t_beg,
                                      q_new - q_beg, (t_new + 1) - t_beg)
                           < _perp_dist(q_end - q_beg, t_end - t_beg,
                                        q_new - q_beg, t_new - t_beg)):
                        t_new += 1
                    out.append((q_new, t_new))
            out.append(cur)
            prev = cur
        self.pairs = deque(out)

    def __lt__(self, other: "Alignment") -> bool:
        return self.score > other.score  # descending score order


def _compare_segments(xa1, ya1, xa2, ya2, xb1, yb1, xb2, yb2):
    """alignment.h:643-768: returns (exists, has_area, xp, yp, a1, a2, b1, b2)
    where a1/a2/b1/b2 are the clipped segment endpoints as (x, y)."""
    F = np.float32
    same_p1 = (xa1 == xb1) and (ya1 == yb1)
    same_p2 = (xa2 == xb2) and (ya2 == yb2)
    if same_p1 and same_p2:
        return (True, False, F(0), F(0), (xa1, ya1), (xa2, ya2),
                (xb1, yb1), (xb2, yb2))
    x_min = xa1 if xa1 > xb1 else xb1
    x_max = xa2 if xa2 < xb2 else xb2
    with np.errstate(divide="ignore", invalid="ignore"):
        m_a = F((ya2 - ya1) / (xa2 - xa1))
        m_b = F((yb2 - yb1) / (xb2 - xb1))
        int_a = F(ya1 - m_a * xa1)
        int_b = F(yb1 - m_b * xb1)

    def clip():
        return ((x_min, F(m_a * x_min + int_a)), (x_max, F(m_a * x_max + int_a)),
                (x_min, F(m_b * x_min + int_b)), (x_max, F(m_b * x_max + int_b)))

    if same_p1 and not same_p2:
        a1, a2, b1, b2 = ((xa1, ya1), (x_max, F(m_a * x_max + int_a)),
                          (xb1, yb1), (x_max, F(m_b * x_max + int_b)))
        return (True, m_a != m_b, xa1, ya1, a1, a2, b1, b2)
    if not same_p1 and same_p2:
        a1, a2, b1, b2 = ((x_min, F(m_a * x_min + int_a)), (xa2, ya2),
                          (x_min, F(m_b * x_min + int_b)), (xb2, yb2))
        return (True, m_a != m_b, xa2, ya2, a1, a2, b1, b2)
    if m_a == m_b:
        a1, a2, b1, b2 = clip()
        if int_a == int_b:
            return (True, False, F(0), F(0), a1, a2, b1, b2)
        return (False, True, F(0), F(0), a1, a2, b1, b2)
    xp = F((int_a - int_b) / (m_b - m_a))
    a1, a2, b1, b2 = clip()
    if x_min <= xp <= x_max:
        yp = F(int_a + m_a * xp)
        return (True, True, xp, yp, a1, a2, b1, b2)
    return (False, True, xp, F(0), a1, a2, b1, b2)


def _perp_dist(x1p: int, y1p: int, xp: int, yp: int) -> float:
    """alignment.h:833-844."""
    dist_a_sq = float(x1p * x1p + y1p * y1p)
    dist_b_sq = float(xp * xp + yp * yp)
    num = float(x1p * xp + y1p * yp)
    cos_sq = (num * num) / (dist_a_sq * dist_b_sq)
    sin_sq = 1.0 - cos_sq
    return float(np.sqrt(max(dist_b_sq * sin_sq, 0.0)))


class AlignmentSet(list):
    """vector<AlignedPairList> bound to a DP matrix (alignment.h:876-959)."""

    def __init__(self, dpm=None, enumerator=None) -> None:
        super().__init__()
        self.dpm = dpm
        self.enumerator = enumerator
        if dpm is not None and enumerator is not None:
            enumerator.enumerate(dpm, self)
            self.assign_identity()

    def get_query_sequence(self):
        return self.dpm.query_seq

    def get_template_sequence(self):
        return self.dpm.templ_seq

    def sort_set(self, max_n: int) -> None:
        """Descending-score sort; truncate to top max_n (alignment.h:922-932),
        with libstdc++ std::sort/std::partial_sort tie ordering."""
        from ..utils.cxxsort import cxx_partial_sort, cxx_sort
        less = lambda a, b: a.score > b.score
        items = list(self)
        if max_n >= len(items):
            cxx_sort(items, less)
            self[:] = items
        elif max_n > 0:
            cxx_partial_sort(items, max_n, less)
            self[:] = items[:max_n]

    def assign_identity(self) -> None:
        if self.dpm is None:
            return
        qs = self.dpm.query_seq.get_string()
        ts = self.dpm.templ_seq.get_string()
        for a in self:
            a.calc_identity(qs, ts)

    def assign_significance(self, sig) -> None:
        for a in self:
            a.calc_significance(sig)
