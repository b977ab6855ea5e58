"""Fragment factory + connection builder (frag_matrix.{h,cpp})."""

from __future__ import annotations

import sys

import numpy as np

from .ali_frag import AliFrag
from .defs import FragID
from .frag_set import FragSet, SSEFragSet

F32 = np.float32


def find_min_ali_len(sse_len: int) -> int:
    """frag_matrix.cpp:195-205."""
    if sse_len <= 4:
        return sse_len
    if sse_len <= 6:
        return 5
    if sse_len <= 8:
        return 6
    if sse_len <= 10:
        return 7
    if sse_len <= 14:
        return 9
    if sse_len <= 20:
        return 11
    if sse_len <= 30:
        return 15
    return 20


class FragMatrix:
    def __init__(self, min_cov_res: int, fs: FragSet, str_data,
                 max_frag_shift: int, ali_mode: int, compare_to_native=None):
        self.Main_FS = fs
        self.Str = str_data
        self.templ_seq = str_data.templ_seq
        self.query_seq = str_data.query_seq
        self.templ_len = str_data.templ_len
        self.query_len = str_data.query_len
        self.num_sses = str_data.num_templ_sses
        self.max_in_betw_shift = max_frag_shift
        self.ali_mode = ali_mode
        self.Compare_to_Native = compare_to_native
        self.min_aligned_residues = min_cov_res
        # validity and extension info depend only on immutable fragment
        # geometry (cores, qt shifts) and the static sims/cb_dists/TSR
        # arrays, so they are memoized across the per-activation full
        # reconnection sweeps (the reference recomputes them every time,
        # frag_matrix.cpp:464-513 — same results, O(F^2) fewer rescans)
        self._valid_cache: dict = {}
        self._conn_info_cache: dict = {}

    # ------------------------------------------------------------------
    def create_all_fragments(self, fs: FragSet) -> None:
        """Per SSE, per feasible qt_shift: slide a min_ali_len window over
        the SSE, keep the max-scoring placement as the fragment core
        (frag_matrix.cpp:245-373)."""
        fs.clear_all()
        sims = self.Str.sims  # [query][templ] float32

        # N-terminal cap column
        fs.add_column(SSEFragSet(0, 0, 0, -1, -1, self.query_len,
                                 self.templ_len, -1,
                                 [AliFrag.full(0, 0, 0, 0.0, True, False)],
                                 self.min_aligned_residues))

        for sse_id in range(1, self.num_sses + 1):
            sse = self.Str.sses[sse_id - 1]
            t0, t1 = sse.beg_id, sse.end_id
            sse_len = t1 - t0 + 1
            min_ali_len = find_min_ali_len(sse_len)

            q0_lo = max(min_ali_len - sse_len + 1,
                        t0 + self.min_aligned_residues - (self.templ_len - 2))
            q0_hi = min((self.query_len - 2) - min_ali_len + 1,
                        t0 - self.min_aligned_residues + (self.query_len - 2))
            qt_lo = q0_lo - t0
            qt_hi = q0_hi - t0

            frags: list[AliFrag] = []
            for q0 in range(q0_lo, q0_hi + 1):
                qt = q0 - t0
                if (qt > (self.query_len - 2) - self.min_aligned_residues or
                        qt < self.min_aligned_residues - (self.templ_len - 2)):
                    continue
                max_score = F32(-1000.0)
                max_i = -1
                for i in range(sse_len - min_ali_len + 1):
                    if q0 + i < 1 or q0 + i + min_ali_len - 1 > self.query_len - 2:
                        continue
                    score = F32(0.0)
                    for j in range(min_ali_len):
                        score = F32(score + sims[q0 + i + j, t0 + i + j])
                    if score > max_score:
                        max_score = score
                        max_i = i
                if max_score == F32(-1000.0):
                    continue
                frags.append(AliFrag(
                    max(1, t0 + qt) - qt,
                    min(self.query_len - 2, t1 + qt) - qt,
                    t0 + max_i, t0 + max_i + min_ali_len - 1, qt,
                    float(max_score), False, False))

            # stable sort ascending by score, then reverse (list::sort +
            # reverse; ties end up in reverse insertion order)
            frags = sorted(frags, key=lambda f: f.score)[::-1]
            fs.add_column(SSEFragSet(sse_id, t0, t1, qt_lo, qt_hi,
                                     self.query_len, self.templ_len,
                                     sse.ss_type, frags,
                                     self.min_aligned_residues))

        # C-terminal cap column
        fs.add_column(SSEFragSet(
            self.num_sses + 1, self.templ_len - 1, self.templ_len - 1, -1, -1,
            self.query_len, self.templ_len, -1,
            [AliFrag.full(self.templ_len - 1, self.templ_len - 1,
                          (self.query_len - 1) - (self.templ_len - 1),
                          0.0, False, True)],
            self.min_aligned_residues))
        fs.activate_terminal_caps()

    # ------------------------------------------------------------------
    def loop_spans_gap(self, t1_prev, q1_prev, t0_next, q0_next) -> bool:
        return (self.Str.cb_dists[t1_prev, t0_next]
                < F32(q0_next - q1_prev) * F32(3.3))

    def connection_is_valid(self, fs: FragSet, af1: AliFrag, af2: AliFrag) -> bool:
        key = (af1.sse_id, af1.frag_id, af2.sse_id, af2.frag_id)
        hit = self._valid_cache.get(key)
        if hit is not None:
            return hit
        out = self._connection_is_valid(fs, af1, af2)
        self._valid_cache[key] = out
        return out

    def _connection_is_valid(self, fs: FragSet, af1: AliFrag, af2: AliFrag) -> bool:
        t1_prev, q1_prev = af1.core_t1(), af1.core_q1()
        t0_next, q0_next = af2.core_t0(), af2.core_q0()
        if not fs.frags_in_order(t1_prev, q1_prev, t0_next, q0_next):
            return False
        if not (self.Str.tsr_to_n[t1_prev] + self.Str.tsr_to_c[t0_next]
                > self.min_aligned_residues):
            return False
        return self.loop_spans_gap(t1_prev, q1_prev, t0_next, q0_next)

    def get_connection_info(self, fs: FragSet, prev_id: FragID, next_id: FragID):
        """Optionally extend connected fragments toward each other from
        their cores to the SSE ends, keeping the max-similarity extension
        (frag_matrix.cpp:50-137).  Memoized — pure in frag geometry."""
        key = (prev_id.sse_idx, prev_id.frag_idx,
               next_id.sse_idx, next_id.frag_idx)
        hit = self._conn_info_cache.get(key)
        if hit is not None:
            return hit
        out = self._get_connection_info(fs, prev_id, next_id)
        self._conn_info_cache[key] = out
        return out

    def _get_connection_info(self, fs: FragSet, prev_id: FragID, next_id: FragID):
        prev_frag = fs.get_frag(prev_id)
        next_frag = fs.get_frag(next_id)
        if self.ali_mode == 0:
            return prev_frag.core_t1(), next_frag.core_t0(), 0.0

        sims = self.Str.sims
        max_prev_end = -1
        max_next_beg = -1
        max_score = F32(-1000.0)
        for t_prev in range(prev_frag.core_t1(), prev_frag.sse_t1() + 1):
            for t_next in range(next_frag.core_t0(), next_frag.sse_t0() - 1, -1):
                if (prev_frag.frag_is_N_terminal or next_frag.frag_is_C_terminal
                        or (fs.frags_in_order(t_prev, prev_frag.q(t_prev),
                                              t_next, next_frag.q(t_next))
                            and self.loop_spans_gap(
                                t_prev, prev_frag.q(t_prev),
                                t_next, next_frag.q(t_next)))):
                    curr = F32(0.0)
                    for tt in range(prev_frag.core_t1() + 1, t_prev + 1):
                        curr = F32(curr + sims[prev_frag.q(tt), tt])
                    for tt in range(next_frag.core_t0() - 1, t_next - 1, -1):
                        curr = F32(curr + sims[next_frag.q(tt), tt])
                    if curr > max_score:
                        max_score = curr
                        max_prev_end = t_prev
                        max_next_beg = t_next
        return max_prev_end, max_next_beg, float(max_score)

    def find_fragment_connections(self, fs: FragSet) -> None:
        """All-pairs connection building (frag_matrix.cpp:376-421); note the
        reference iterates the first num_active indices of each column."""
        for i in range(1, self.num_sses + 1):
            for j in range(fs.num_frags_in_sse(i)):
                frag = fs.get_frag(i, j)
                frag.clear_next()
                for m in range(i + 1, self.num_sses + 1):
                    for n in range(fs.num_frags_in_sse(m)):
                        if self.connection_is_valid(fs, frag, fs.get_frag(m, n)):
                            pe, nb, cs = self.get_connection_info(
                                fs, frag.get_id(), fs.get_frag(m, n).get_id())
                            frag.make_connection(fs.get_frag(m, n).get_id(),
                                                 pe, nb, cs)
                # every frag connects to the C-terminal cap
                pe, nb, cs = self.get_connection_info(
                    fs, frag.get_id(),
                    fs.get_frag(self.num_sses + 1, 0).get_id())
                frag.make_connection(
                    fs.get_frag(self.num_sses + 1, 0).get_id(), pe, nb, cs)

    def it_is_valid_starting_frag(self, fs: FragSet, f: FragID,
                                  t_next_beg: int) -> bool:
        af = fs.get_frag(f)
        if af.frag_is_C_terminal:
            return False
        return (af.core_q0() < (self.query_len - 2) - self.min_aligned_residues
                and af.core_t0() < (self.templ_len - 2) - self.min_aligned_residues
                and self.Str.tsr_to_c[t_next_beg] > self.min_aligned_residues)

    def find_N_terminal_connections(self, fs: FragSet) -> None:
        num_children = 0
        ncap = fs.get_frag(0, 0)
        ncap.clear_next()
        for m in range(1, self.num_sses + 1):
            for n in range(fs.num_frags_in_sse(m)):
                curr = fs.get_frag(m, n).get_id()
                pe, nb, cs = self.get_connection_info(fs, ncap.get_id(), curr)
                if self.it_is_valid_starting_frag(fs, curr, nb):
                    ncap.make_connection(curr, pe, nb, cs)
                    num_children += fs.get_frag(m, n).num_children
        ncap.num_children = num_children

    def get_number_of_alis_to_search(self, fs: FragSet) -> int:
        self.find_N_terminal_connections(fs)
        return fs.get_frag(0, 0).num_children

    def fill_frag_set_by_zscore(self, fs: FragSet) -> float:
        z = fs.activate_next_best_available_frag()
        self.find_fragment_connections(fs)
        fs.count_frag_children()
        return z

    def activate_next_fragment(self, max_search: int, fs: FragSet):
        """Returns (continued, z) — one budgeted activation step
        (frag_matrix.cpp:464-513)."""
        num = self.get_number_of_alis_to_search(fs)
        if num >= max_search:
            return False, 0.0
        print(f"Search space: {num}\t", end="", file=sys.stderr)
        if fs.an_available_frag_exists():
            z = self.fill_frag_set_by_zscore(fs)
        else:
            print(file=sys.stderr)
            return False, 0.0
        print(f"New frag z-score: {z:g}", file=sys.stderr)
        return True, z

    # ---- tracking-mode reporting (frag_matrix.cpp:778-869) ---------------
    def report_frag_quality(self, fs: FragSet, out=None) -> None:
        """Per-SSE fragment quality vs the native alignment (stderr
        tables; no-op outside tracking mode, like the reference)."""
        import sys
        if self.Compare_to_Native is None:
            return
        out = out or sys.stderr
        for i in range(1, self.num_sses + 1):
            out.write("------SSE INFO----------\n")
            col = fs.get_col(i)
            out.write(col.print_sse_info(self.templ_seq))
            t_beg, t_end = col.t0, col.t1
            if self.sse_is_native(t_beg, t_end):
                out.write("NATIVE\n")
                local = self.Compare_to_Native.get_local_qt_shift(t_beg,
                                                                  t_end)
                out.write(f"Native shift: {_g(local)}\n")
                out.write(f"# Active frags:{col.get_num_active_frags()}\n")
                out.write("Top 5 (or less) closest frags:\n")
                out.write("QT-shift (distance to native): \n")
                for f in col.find_shift_neighbors(local, 5):
                    d = np.float32(abs(np.float32(f.qt())
                                       - np.float32(local)))
                    out.write(f"{f.qt()}({_g(d)})\t")
                out.write("\n")
            else:
                out.write("Not native.\n")
            out.write("\n")
            out.write("------SSE INFO----------\n")

    def report_full_sse_frag_set_info(self, fs: FragSet, out=None) -> None:
        """frag_matrix.cpp:823-869."""
        import sys
        if self.Compare_to_Native is None:
            return
        out = out or sys.stderr
        for i in range(1, self.num_sses + 1):
            out.write("------SSE FRAG SET----------\n")
            col = fs.get_col(i)
            out.write(col.print_sse_info(self.templ_seq))
            t_beg, t_end = col.t0, col.t1
            if self.sse_is_native(t_beg, t_end):
                out.write("NATIVE\n")
                local = self.Compare_to_Native.get_local_qt_shift(t_beg,
                                                                  t_end)
                for f in col.get_all_frags_qt_sorted():
                    out.write(f.render_one_line(self.templ_seq,
                                                self.query_seq))
                    out.write(
                        f", {_g(np.float32(f.qt()) - np.float32(local))}")
                    status = col.get_frag_status(f)
                    if status == 1:
                        out.write(" -- ACTIVE ")
                    if status == -1:
                        out.write(" -- REDUNDANT")
                    if status == -2:
                        raise RuntimeError(
                            "Frag status undefined.  Frag not found in "
                            "sse_frag_set.")
                    out.write("\n")
            out.write("------SSE FRAG SET----------\n")

    def sse_is_native(self, t_beg: int, t_end: int) -> bool:
        """frag_matrix.cpp sse_is_native: the native alignment covers the
        SSE span with at least the minimum window length."""
        if self.Compare_to_Native is None:
            return False
        sse_ali = self.Compare_to_Native.get_local_native_ali(t_beg, t_end)
        return len(sse_ali) >= find_min_ali_len(t_end - t_beg + 1)


def _g(v) -> str:
    """C++ default ostream float formatting (6 significant digits)."""
    return f"{float(v):g}"
