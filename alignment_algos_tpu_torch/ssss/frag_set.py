"""Fragment columns and the full fragment set (sse_frag_set.{h,cpp},
frag_set.{h,cpp})."""

from __future__ import annotations

import numpy as np

from .ali_frag import AliFrag
from .defs import HELIX, STRAND

F32 = np.float32


class SSEFragSet:
    """One column = all fragments for one template SSE, sorted by score
    descending (with the reference's stable-sort-then-reverse tie order)."""

    def __init__(self, sse_id: int, t0: int, t1: int, qt_lo: int, qt_hi: int,
                 q_len: int, t_len: int, ss_type: int,
                 frags: list[AliFrag], min_cov_res: int) -> None:
        self.Frags = list(frags)
        self.sse_id = sse_id
        self.t0 = t0
        self.t1 = t1
        self.sse_len = t1 - t0 + 1
        self.qt_shift_lo = qt_lo
        self.qt_shift_hi = qt_hi
        self.query_len = q_len
        self.templ_len = t_len
        self.ss_type = ss_type
        self.min_aligned_residues = min_cov_res
        for i, f in enumerate(self.Frags):
            f.sse_id = sse_id
            f.frag_id = i
            f.make_available()

    def get_frag(self, f: int) -> AliFrag:
        return self.Frags[f]

    def get_active_frags(self) -> list[AliFrag]:
        return [f for f in self.Frags if f.is_active()]

    def get_available_frags(self) -> list[AliFrag]:
        return [f for f in self.Frags if f.is_available()]

    def get_num_active_frags(self) -> int:
        return len(self.get_active_frags())

    def an_available_frag_exists(self) -> bool:
        return any(f.is_available() for f in self.Frags)

    def get_highest_available_frag_zscore(self) -> float:
        avail = self.get_available_frags()
        return avail[0].zs()  # Frags sorted best-first

    def set_frag_zscores(self) -> None:
        """Column mean/stdev z-scores (sse_frag_set.cpp:259-314), float32."""
        n = F32(len(self.Frags))
        s = F32(0.0)
        for f in self.Frags:
            s = F32(s + F32(f.ss()))
        average = F32(s / n)
        s = F32(0.0)
        for f in self.Frags:
            d = F32(F32(f.ss()) - average)
            s = F32(s + F32(d * d))
        stdev = F32(np.sqrt(F32(F32(1.0) / n) * s))
        for f in self.Frags:
            f.z_score = float(F32(F32(F32(f.ss()) - average) / stdev))

    def activate_top_available_frag(self) -> None:
        for f in self.Frags:
            if f.is_available():
                self.activate_frag(f.frag_id)
                return
        raise RuntimeError("Could not find an available frag.")

    def activate_frag(self, frag_id: int) -> None:
        """Activate + mark qt-neighbors redundant (width 2 for helix, 0 for
        strand; sse_frag_set.cpp:317-335)."""
        if self.ss_type == HELIX:
            width = 2
        elif self.ss_type == STRAND:
            width = 0
        else:
            raise ValueError(f"Invalid SSE type in SSE {self.sse_id}")
        center_qt = self.get_frag(frag_id).qt()
        neighbors = [f.frag_id for f in self.Frags
                     if f.is_available()
                     and 0 != abs(f.qt() - center_qt) <= width]
        self.Frags[frag_id].make_active()
        for nid in neighbors:
            self.Frags[nid].make_redundant()

    # gap finding/filling in qt-space (sse_frag_set.cpp:57-144)
    def get_ordered_frags(self) -> list[AliFrag]:
        return sorted(self.get_active_frags(), key=lambda f: f.qt())

    def find_biggest_gap(self):
        ordered = self.get_ordered_frags()
        max_gap = -1
        beg = end = 0
        for i in range(1, len(ordered)):
            cur = ordered[i].qt() - ordered[i - 1].qt() - 1
            if cur > max_gap:
                max_gap = cur
                beg = ordered[i - 1].qt() + 1
                end = ordered[i].qt() - 1
        if ordered and ordered[0].qt() - self.qt_shift_lo > max_gap:
            max_gap = ordered[0].qt() - self.qt_shift_lo
            beg = self.qt_shift_lo
            end = ordered[0].qt() - 1
        if ordered and self.qt_shift_hi - ordered[-1].qt() > max_gap:
            max_gap = self.qt_shift_hi - ordered[-1].qt()
            beg = ordered[-1].qt() + 1
            end = self.qt_shift_hi
        return max_gap, beg, end

    def fill_gap(self, gap_beg: int, gap_end: int) -> None:
        if gap_end - gap_beg + 1 > 5:
            top = gap_end - int((gap_end - gap_beg) / 3.0)
            bot = gap_beg + int((gap_end - gap_beg) / 3.0)
        else:
            top, bot = gap_end, gap_beg
        for f in self.get_available_frags():
            if bot <= f.qt() <= top:
                f.make_active()
                return
        raise RuntimeError(
            f"never found a fragment in the range: sse_id {self.sse_id} - "
            f"{gap_beg} to {gap_end}")

    def find_shift_neighbors(self, qt_target: float, num: int) -> list[AliFrag]:
        """sse_frag_set.cpp:377-416 — the reference's literal O(n^2) swap
        sort is unstable; replicate it verbatim so equal-|qt-target| ties
        order identically."""
        tgt = np.float32(qt_target)
        res = self.get_active_frags()
        for i in range(len(res) - 1):
            for j in range(i + 1, len(res)):
                if (abs(np.float32(res[j].qt()) - tgt)
                        < abs(np.float32(res[i].qt()) - tgt)):
                    res[i], res[j] = res[j], res[i]
        return res[:num]

    # ---- tracking-mode reporting helpers --------------------------------
    def print_sse_info(self, templ_seq: str) -> str:
        """sse_frag_set.cpp print_sse_info(string, ostream)."""
        if self.ss_type == HELIX:
            type_s = "Helix"
        elif self.ss_type == STRAND:
            type_s = "Strand"
        else:
            type_s = "Undefined"
        return (f"SSE id: {self.sse_id}\nType: {type_s}\n"
                f"T: {self.t0} - {self.t1}\n"
                f"QT: {self.qt_shift_lo} - {self.qt_shift_hi}\n"
                f"Seq: {templ_seq[self.t0 : self.t1 + 1]}\n")

    def get_all_frags_qt_sorted(self) -> list[AliFrag]:
        """sse_frag_set.cpp:169-196 (swap sort by qt ascending)."""
        res = list(self.Frags)
        for i in range(len(res) - 1):
            for j in range(i + 1, len(res)):
                if res[j].qt() < res[i].qt():
                    res[i], res[j] = res[j], res[i]
        return res

    def get_frag_status(self, frag: AliFrag) -> int:
        return frag.status  # sse_frag_set.cpp:414-416


class FragSet:
    """All columns plus the virtual N-/C-terminal caps (frag_set.{h,cpp})."""

    def __init__(self) -> None:
        self.Frag_Columns: list[SSEFragSet] = []
        self.num_sses = 0

    def clear_all(self) -> None:
        self.Frag_Columns = []

    def add_column(self, col: SSEFragSet) -> None:
        self.Frag_Columns.append(col)

    def get_col(self, i: int) -> SSEFragSet:
        return self.Frag_Columns[i]

    def activate_terminal_caps(self) -> None:
        self.Frag_Columns[0].Frags[0].make_active()
        self.Frag_Columns[-1].Frags[0].make_active()
        self.num_sses = len(self.Frag_Columns) - 2

    def initialize_all_zscores(self) -> None:
        for col in self.Frag_Columns[1:-1]:
            col.set_frag_zscores()

    def seed_all_columns(self) -> None:
        for i in range(1, self.num_sses + 1):
            self.Frag_Columns[i].activate_top_available_frag()

    def num_frags_in_sse(self, sse: int) -> int:
        return self.Frag_Columns[sse].get_num_active_frags()

    def get_frag(self, f_or_sse, frag_idx: int | None = None) -> AliFrag:
        if frag_idx is None:
            return self.Frag_Columns[f_or_sse.sse_idx].get_frag(f_or_sse.frag_idx)
        return self.Frag_Columns[f_or_sse].get_frag(frag_idx)

    def count_frag_children(self) -> None:
        """Reverse-topological per-frag alignment counts (frag_set.cpp:101-117).
        Note the reference iterates j over the *active count* but indexes
        Frags[j] directly; replicated."""
        for i in range(self.num_sses, -1, -1):
            for j in range(self.num_frags_in_sse(i)):
                curr = self.get_frag(i, j)
                total = 0
                for k in range(curr.num_next()):
                    nxt = self.get_frag(curr.get_next(k).next_frag)
                    total += 1 + nxt.num_children
                curr.num_children = total

    def activate_next_best_available_frag(self) -> float:
        max_z = -9999.0
        max_sse = -1
        for i in range(1, self.num_sses + 1):
            if not self.Frag_Columns[i].an_available_frag_exists():
                continue
            z = self.Frag_Columns[i].get_highest_available_frag_zscore()
            if max_z < z:
                max_z = z
                max_sse = self.Frag_Columns[i].sse_id
        if max_sse == -1:
            raise RuntimeError("Could not find a highest-scoring available frag.")
        self.Frag_Columns[max_sse].activate_top_available_frag()
        return max_z

    def an_available_frag_exists(self) -> bool:
        return any(self.Frag_Columns[i].an_available_frag_exists()
                   for i in range(1, self.num_sses + 1))

    def frags_in_order(self, a, b, c=None, d=None) -> bool:
        if c is not None:
            t_prev_end, q_prev_end, t_next_beg, q_next_beg = a, b, c, d
            return (q_next_beg > q_prev_end + 1) and (t_next_beg > t_prev_end + 1)
        af1, af2 = a, b
        return (af1.core_t1() + 1 < af2.core_t0()
                and af1.core_q1() + 1 < af2.core_q0())

    def export_all_frags(self) -> list[AliFrag]:
        res = []
        for i in range(1, self.num_sses + 1):
            res.extend(self.Frag_Columns[i].get_active_frags())
            res.extend(self.Frag_Columns[i].get_available_frags())
        return res

    def active_minus(self, other: "FragSet") -> list[AliFrag]:
        """operator-: frags active here but not in ``other``."""
        res = []
        for i in range(1, self.num_sses + 1):
            for f in self.Frag_Columns[i].get_active_frags():
                if not other.get_frag(f.get_id()).is_active():
                    res.append(f)
        return res

    def snapshot_statuses(self) -> list[list[int]]:
        return [[f.status for f in col.Frags] for col in self.Frag_Columns]
