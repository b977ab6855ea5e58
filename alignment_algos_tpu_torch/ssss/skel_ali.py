"""A skeleton alignment: ordered fragment connections with incremental
score, coverage and SSE contact order (skel_ali.{h,cpp})."""

from __future__ import annotations

import numpy as np

from .defs import FragConnection

F32 = np.float32


class SkelAli:
    __slots__ = ("connections", "score", "shift", "param",
                 "num_aligned_residues", "SSE_CO", "contacting_residues",
                 "num_contacting_residues", "templ_len", "Str", "Frags")

    def __init__(self, str_data, frag_set, fc: FragConnection | None = None,
                 num_ali_init: int = 0) -> None:
        self.Str = str_data
        self.Frags = frag_set
        self.templ_len = str_data.templ_len
        self.connections: list[FragConnection] = []
        self.score = F32(0.0)
        self.shift = 0.0
        self.param = 0.0
        self.num_aligned_residues = 0
        self.SSE_CO = 0.0
        self.num_contacting_residues = 0
        self.contacting_residues = np.full(self.templ_len, -1, dtype=np.int8)
        if fc is not None:
            self.connections.append(fc)
            self.score = F32(self.get_frag(fc.prev_frag).ss())
            self.score = F32(self.score + F32(fc.connection_score))
            self.score = F32(self.score + F32(self.get_frag(fc.next_frag).ss()))
            self.num_aligned_residues = num_ali_init + (
                self.get_frag(fc.next_frag).core_t1() - fc.next_beg_res_idx + 1)
            self.contacting_residues[
                fc.next_beg_res_idx : self.get_frag(fc.next_frag).core_t1() + 1] = 0

    def copy(self) -> "SkelAli":
        sa = SkelAli(self.Str, self.Frags)
        sa.connections = list(self.connections)
        sa.score = self.score
        sa.num_aligned_residues = self.num_aligned_residues
        sa.SSE_CO = self.SSE_CO
        sa.contacting_residues = self.contacting_residues.copy()
        sa.num_contacting_residues = self.num_contacting_residues
        return sa

    def get_frag(self, f):
        return self.Frags.get_frag(f)

    def num_connections(self):
        return len(self.connections)

    def get_connection(self, i):
        return self.connections[i]

    def get_last_connection(self):
        return self.connections[-1]

    def last_frag_is_C_terminal(self) -> bool:
        return self.get_frag(self.connections[-1].next_frag).frag_is_C_terminal

    def get_last_templ_res_idx(self) -> int:
        if self.connections:
            return self.get_frag(self.connections[-1].next_frag).core_t1()
        return 0

    def add_connection(self, fc: FragConnection) -> None:
        """skel_ali.cpp:92-125."""
        self.connections.append(fc)
        self.score = F32(self.score + F32(self.get_frag(fc.next_frag).ss()))
        self.score = F32(self.score + F32(fc.connection_score))

        prev_core_t1 = self.get_frag(fc.prev_frag).core_t1()
        if not self.get_frag(fc.next_frag).frag_is_C_terminal:
            self.num_aligned_residues += (
                (fc.prev_end_res_idx - prev_core_t1)
                + (self.get_frag(fc.next_frag).core_t1()
                   - fc.next_beg_res_idx + 1))
        else:
            self.num_aligned_residues += fc.prev_end_res_idx - prev_core_t1

        # zero out contacts of prev's C-extension and next's span
        for i in range(fc.prev_end_res_idx, prev_core_t1, -1):
            self.contacting_residues[i] = 0
        nb = fc.next_beg_res_idx
        ne = self.get_frag(fc.next_frag).core_t1()
        self.contacting_residues[nb : ne + 1] = 0
        self._update_contacted_residues()

    def _mark_contacts(self, t_new_range, fc_hi: int) -> None:
        contacts = self.Str.templ_contacts
        cr = self.contacting_residues
        for t_new in t_new_range:
            for fc_idx in range(1, fc_hi):
                beg = self.connections[fc_idx - 1].next_beg_res_idx
                end = self.connections[fc_idx].prev_end_res_idx
                for t_prev in range(beg, end + 1):
                    if contacts[t_new, t_prev]:
                        if cr[t_new] == 0:
                            self.num_contacting_residues += 1
                            cr[t_new] = 1
                        if cr[t_prev] == 0:
                            self.num_contacting_residues += 1
                            cr[t_prev] = 1

    def _update_contacted_residues(self) -> None:
        """skel_ali.cpp:128-198."""
        last = self.connections[-1]
        t_prev_end = last.prev_end_res_idx
        t_prev_core_end = self.get_frag(last.prev_frag).core_t1()
        self._mark_contacts(range(t_prev_end, t_prev_core_end, -1),
                            len(self.connections) - 1)
        t_curr_beg = last.next_beg_res_idx
        t_curr_core_end = self.get_frag(last.next_frag).core_t1()
        self._mark_contacts(range(t_curr_beg, t_curr_core_end + 1),
                            len(self.connections))

    def calc_skel_SSE_CO(self) -> None:
        self.SSE_CO = float(F32(F32(self.num_contacting_residues)
                                / F32(self.num_aligned_residues)))

    def export_vrp(self):
        """Polyline of connection endpoints (skel_ali.cpp:211-231)."""
        from ..analysis.ali_dist import ResPair
        res = []
        for fc in self.connections:
            res.append(ResPair(fc.prev_end_res_idx,
                               self.get_frag(fc.prev_frag).q(fc.prev_end_res_idx)))
            res.append(ResPair(fc.next_beg_res_idx,
                               self.get_frag(fc.next_frag).q(fc.next_beg_res_idx)))
        return res

    def same_skeleton(self, other: "SkelAli") -> bool:
        """operator== (identical fragment sequence)."""
        if self.num_connections() != other.num_connections():
            return False
        for a, b in zip(self.connections, other.connections):
            if self.get_frag(a.prev_frag) is not other.get_frag(b.prev_frag):
                return False
        return (self.get_frag(self.connections[-1].next_frag)
                is other.get_frag(other.connections[-1].next_frag))

    def get_sse_id_list(self) -> list[int]:
        return [fc.next_frag.sse_idx for fc in self.connections[:-1]]

    def get_num_aligned(self):
        return self.num_aligned_residues

    def get_contact_order(self):
        return self.SSE_CO

    def get_score(self):
        return float(self.score)

    # ---- tracking-mode rendering (skel_ali.cpp:281-319) ------------------
    def render_print(self, query_seq: str, templ_seq: str) -> str:
        """Skel_Ali::print(qseq, tseq, min_ali_res, ostream) — the culled-
        skeleton dump written to the track_*.txt files."""
        def g(v):
            return f"{float(v):g}"
        out = ["-----------\n",
               "Skel info:    \n",
               f"#frags:       {len(self.connections)}\n",
               f"score:        {g(self.get_score())}\n",
               f"native shift: {g(self.shift)}\n",
               f"SSE_CO:       {g(self.get_contact_order())}\n",
               f"cov_res:      {self.get_num_aligned()}\n",
               "Frags:        \n", "\n"]
        first = self.get_frag(self.connections[0].prev_frag)
        out.append(first.render_block(query_seq, templ_seq))
        out.append(f"cnxn score: {g(self.connections[0].connection_score)}\n")
        out.append("\n")
        for i in range(1, len(self.connections)):
            beg = self.connections[i - 1].next_beg_res_idx
            end = self.connections[i].prev_end_res_idx
            out.append("\n")
            out.append(self.get_frag(self.connections[i].prev_frag)
                       .render_block_window(query_seq, templ_seq, beg, end))
            out.append("\n")
            out.append(f"cnxn score: "
                       f"{g(self.connections[i].connection_score)}\n")
        out.append("\n")
        last = self.get_frag(self.connections[-1].next_frag)
        beg = self.connections[-1].next_beg_res_idx
        end = last.core_t1()
        out.append(last.render_block_window(query_seq, templ_seq, beg, end))
        out.append("\n")
        out.append("-----------\n")
        return "".join(out)
