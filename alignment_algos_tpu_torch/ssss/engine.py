"""SSSS — Sample Shifts in Secondary Structures (ssss.h).

The signature near-optimal enumerator: phase 1 builds a fragment graph (best
window per (template SSE, diagonal shift)); phase 2 recombines fragments
into skeleton alignments by DFS with structural filters, then renders each
skeleton into a full alignment by filling inter-fragment loops with local
sub-DP builds (memoized by endpoint key).
"""

from __future__ import annotations

import io
import sys

import numpy as np

from ..analysis.ali_dist import AliDist
from ..core.alignment import Alignment, AlignmentSet
from ..core.dp import DPMatrix
from ..core.enumerators import OptimalSubali
from .defs import SSEData
from .frag_matrix import FragMatrix
from .frag_set import FragSet
from .skel_set import SkelSet
from .strand_eval import AlignmentStrandEvaluator

F32 = np.float32


class StrData:
    """Shared read-only blackboard (ali_str_info.{h,cpp})."""

    def __init__(self) -> None:
        self.templ_len = 0
        self.query_len = 0
        self.templ_seq = ""
        self.query_seq = ""
        self.sims = None            # [query][templ] float32
        self.cb_dists = None        # [templ][templ] float32
        self.templ_contacts = None  # bool
        self.query_predicted_loops = None
        self.sses: list[SSEData] = []
        self.num_templ_sses = 0
        self.tsr_to_n = None
        self.tsr_to_c = None


class SSSS:
    """Enumerator over HMAP query x SMAP template (any evaluator whose DP
    matrix exposes sims; ssss.h:40-165)."""

    def __init__(self, params, evaluator, dpm: DPMatrix,
                 num_alis_kept: int, max_alis: int, min_cov: float,
                 min_CO: float, max_frag_shift: int, ali_mode: int,
                 max_cluster_shift: float, tracking: int = 0,
                 native_ali: str = "",
                 strand_rule_bug_compat: bool = True,
                 cluster: bool = False) -> None:
        self.params = params
        self.evaluator = evaluator
        self.dpm = dpm
        self.max_subopt = num_alis_kept
        self.max_alis_to_search = max_alis
        self.min_coverage = min_cov
        self.min_SSE_CO = min_CO
        self.max_in_betw_shift = max_frag_shift
        self.ali_mode = ali_mode
        self.max_avg_shift = max_cluster_shift
        self.tracking_mode = tracking == 1
        self.native_ali = native_ali
        self.strand_rule_bug_compat = strand_rule_bug_compat
        # opt-in working version of the reference's dead cluster_alignments
        # (skel_set.cpp:625-683); off by default for parity (never called
        # in the reference)
        self.cluster_mode = cluster

        self.query_len = dpm.get_query_size() - 1
        self.templ_len = dpm.get_template_size() - 1
        self.min_ali_residues = min_cov * (self.query_len - 1)
        self.query_seq = dpm.query_seq.get_string()
        self.templ_seq = dpm.templ_seq.get_string()
        self.query = dpm.query_seq
        self.templ = dpm.templ_seq
        self.max_contact_dist = 6.0
        self.nfill = 0
        self.loops: dict[str, Alignment] = {}
        self.Returned_Skel_Alis = []
        self.ali_counter = 0

        self.Str = StrData()
        self._setup_data_structures()

        self.Dist_Measurer = None
        if native_ali:
            self.Dist_Measurer = AliDist()
            self.Dist_Measurer.load_main_fasta(native_ali)

        self.All_Frags = FragSet()
        self.Old_Frag_Statuses = None
        self.Strand_Eval = AlignmentStrandEvaluator()
        self.Main_Frag_Selector = FragMatrix(
            int(self.min_ali_residues), self.All_Frags, self.Str,
            self.max_in_betw_shift, self.ali_mode, self.Dist_Measurer)

        self.Main_Frag_Selector.create_all_fragments(self.All_Frags)
        self.All_Frags.initialize_all_zscores()
        self.All_Frags.seed_all_columns()
        self.Main_Frag_Selector.find_fragment_connections(self.All_Frags)
        self.All_Frags.count_frag_children()

        self.Strand_Eval.load_SSE_contacts(len(self.Str.sses) + 2,
                                           self.strand_pairings)
        self.Strand_Eval.load_all_strands(self.Str.sses)
        self.Strand_Eval.determine_rules()

    def estimate_size(self) -> int:
        return self.params.number_suboptimal

    # ------------------------------------------------------------------
    def _setup_data_structures(self) -> None:
        """ssss.h:804-1005."""
        S = self.Str
        qs = len(self.query_seq)
        ts = len(self.templ_seq)
        S.templ_len = ts
        S.query_len = qs
        S.templ_seq = self.templ_seq
        S.query_seq = self.query_seq
        S.sims = np.asarray(self.dpm.costs.S, dtype=np.float32)

        cb = self.templ.cb_xyz
        diff = cb[:, None, :] - cb[None, :, :]
        S.cb_dists = np.sqrt((diff * diff).sum(-1)).astype(np.float32)

        contacts = S.cb_dists < np.float32(self.max_contact_dist)
        contacts[0, :] = False
        contacts[:, 0] = False
        contacts[ts - 1, :] = False
        contacts[:, ts - 1] = False
        S.templ_contacts = contacts

        qpl = np.zeros(self.query_len + 1, dtype=bool)
        sse_v = self.query.sse_values
        conf = self.query.sse_confid
        for i in range(self.query_len + 1):
            qpl[i] = (sse_v[i, 2] == 1.0) and (conf[i] > 0.85)
        S.query_predicted_loops = qpl

        # template SSE scan (min length 3) from isse (ssss.h:881-918)
        isse = self.templ.isse
        sses = []
        idx = 0
        sse_id = 1
        while idx < ts:
            while idx < ts and isse[idx] == -1:
                idx += 1
            if idx >= ts:
                break
            beg = idx
            ss_type = int(self.templ.sse_type[idx])
            while idx < ts and isse[idx] != -1:
                idx += 1
            end = idx - 1
            if end - beg + 1 < 3:
                continue
            sses.append(SSEData(sse_id, ss_type, beg, end))
            sse_id += 1
        S.sses = sses
        S.num_templ_sses = len(sses)

        # TSR coverage arrays (ssss.h:921-960)
        tsr_n = np.zeros(ts, dtype=np.int64)
        idx = 0
        while idx < sses[0].beg_id:
            tsr_n[idx] = 0
            idx += 1
        for i in range(len(sses) - 1):
            for idx in range(sses[i].beg_id, sses[i].end_id + 1):
                tsr_n[idx] = tsr_n[idx - 1] + 1
            idx = sses[i].end_id + 1
            while idx < sses[i + 1].beg_id:
                tsr_n[idx] = tsr_n[idx - 1]
                idx += 1
        for idx in range(sses[-1].beg_id, sses[-1].end_id + 1):
            tsr_n[idx] = tsr_n[idx - 1] + 1
        idx = sses[-1].end_id + 1
        while idx < ts:
            tsr_n[idx] = tsr_n[sses[-1].end_id]
            idx += 1
        total = int(tsr_n[ts - 1])
        tsr_c = total - tsr_n
        for s in sses:
            for idx in range(s.beg_id, s.end_id + 1):
                tsr_c[idx] = (total + 1) - tsr_n[idx]
        S.tsr_to_n = tsr_n
        S.tsr_to_c = tsr_c

        # strand pairings from backbone H-bonds (ssss.h:963-1003)
        n2 = len(sses) + 2
        sp = [[False] * (i + 1) for i in range(n2)]
        for i in range(1, len(sses)):
            s1 = sses[i]
            for j in range(i):
                s2 = sses[j]
                total_hb = 0
                for m in range(s1.beg_id, s1.end_id + 1):
                    for n in range(s2.beg_id, s2.end_id + 1):
                        if self.templ.get_backbone_hb_contact(m, n):
                            total_hb += 1
                if total_hb > 0:
                    sp[s1.sse_id][s2.sse_id] = True
        self.strand_pairings = sp

    # ------------------------------------------------------------------
    def fill_frag_matrix(self) -> None:
        print("\nAdding fragments until search space exceeds maximum:",
              file=sys.stderr)
        self.Old_Frag_Statuses = self.All_Frags.snapshot_statuses()
        z = 0.0
        if self.nfill > 0:
            for _ in range(self.nfill):
                cont, z = self.Main_Frag_Selector.activate_next_fragment(
                    self.max_alis_to_search, self.All_Frags)
                if not cont:
                    break
        else:
            while True:
                cont, z = self.Main_Frag_Selector.activate_next_fragment(
                    self.max_alis_to_search, self.All_Frags)
                if not cont:
                    break
        print(f"Last frag z-score: {z:g}\n", file=sys.stderr)

    def build_alignments(self) -> None:
        self.Returned_Skel_Alis = []
        builder = SkelSet(int(self.min_ali_residues), self.min_SSE_CO,
                          int(self.max_subopt),
                          self.max_avg_shift * self.templ_len,
                          self.All_Frags, self.Str, self.Strand_Eval,
                          self.Dist_Measurer,
                          strand_rule_bug_compat=self.strand_rule_bug_compat)
        from .native_search import find_top_skeletons_native
        if not find_top_skeletons_native(builder):
            builder.find_top_skeletons()
        if self.tracking_mode:
            builder.send_culled_alis_to_files()  # ssss.h:414
        if self.cluster_mode:
            builder.cluster_alignments()
        self.Returned_Skel_Alis = builder.get_top_skels()

    def enumerate(self, dpm_fwd: DPMatrix, as_: AlignmentSet,
                  pir_stream=None) -> None:
        """ssss.h:332-393; note as.clear() discards any previously added
        optimal alignment (reference defect, replicated)."""
        self.fill_frag_matrix()
        self.Main_Frag_Selector.find_N_terminal_connections(self.All_Frags)
        # fragment-quality-vs-native tables (no-ops outside tracking mode;
        # ssss.h:354-355)
        self.Main_Frag_Selector.report_frag_quality(self.All_Frags)
        self.Main_Frag_Selector.report_full_sse_frag_set_info(self.All_Frags)
        print("Final number of alis to search: "
              f"{self.Main_Frag_Selector.get_number_of_alis_to_search(self.All_Frags)}",
              file=sys.stderr)
        self.build_alignments()

        print(f"\n\nAlignment info:\nMin aligned residues (coverage): "
              f"{int(self.min_ali_residues)}", file=sys.stderr)
        print(f"Number of alignments found: {len(self.Returned_Skel_Alis)}",
              file=sys.stderr)

        as_.clear()
        pir_stream = pir_stream if pir_stream is not None else sys.stdout
        for ali_id, skel in enumerate(self.Returned_Skel_Alis, start=1):
            self.output_pir_ali(skel, ali_id, dpm_fwd, as_, pir_stream)

    # ------------------------------------------------------------------
    def _loop_alignment(self, q_beg0, t_beg0, q_end1, t_end1) -> Alignment:
        """Optimal sub-alignment between anchors via a sub-built DP."""
        sub_dpm = DPMatrix(self.dpm.query_seq, self.dpm.templ_seq,
                           self.evaluator, "fwd",
                           sub_bounds=(q_beg0, t_beg0, q_end1, t_end1))
        out = AlignmentSet()
        OptimalSubali(q_beg0, t_beg0, q_end1, t_end1).enumerate(sub_dpm, out)
        return out[0]

    def output_pir_ali(self, sa, ali_id: int, dpm_fwd: DPMatrix,
                       as_: AlignmentSet, os_) -> None:
        """Render one skeleton to PIR text + append the parsed alignment
        (ssss.h:567-802)."""
        t_seq = ["^"]
        q_seq = ["^"]
        next_t_res = 1
        next_q_res = 1
        self.ali_counter += 1
        os_.write("#start\n")

        for i in range(1, sa.num_connections()):
            prev_af = sa.get_frag(sa.get_connection(i - 1).prev_frag)
            next_af = sa.get_frag(sa.get_connection(i - 1).next_frag)
            t_beg = sa.get_connection(i - 1).next_beg_res_idx
            t_end = sa.get_connection(i).prev_end_res_idx
            q_beg = next_af.q(t_beg)
            q_end = next_af.q(t_end)

            t_loop_beg, q_loop_beg = next_t_res, next_q_res
            t_loop_end, q_loop_end = t_beg - 1, q_beg - 1
            key = f"{t_loop_beg-1}\t{q_loop_beg-1}\t{t_loop_end+1}\t{q_loop_end+1}"

            if key not in self.loops:
                if next_af.sse_id - prev_af.sse_id == 1:
                    # no SSEs skipped: local DP loop fill
                    self.loops[key] = self._loop_alignment(
                        q_loop_beg - 1, t_loop_beg - 1,
                        q_loop_end + 1, t_loop_end + 1)
                else:
                    # skipped SSE(s): straight fill of shared loop residues
                    loop_ali = Alignment()
                    loop_ali.append(q_loop_beg - 1, t_loop_beg - 1)
                    # ssss.h:642-645 indexes the SSE vector at
                    # prev_sse_id + 1 (vector index, not column id)
                    loop_frag = self.Str.sses[prev_af.sse_id + 1]
                    num_q = q_loop_end - q_loop_beg + 1
                    num_t = loop_frag.beg_id - t_loop_beg
                    for j in range(min(num_q, num_t)):
                        loop_ali.append(q_loop_beg + j, t_loop_beg + j)
                    loop_ali.append(q_loop_end + 1, t_loop_end + 1)
                    self.loops[key] = loop_ali

            loop = self.loops[key]
            tmp_t = loop.get_templ_string(self.templ_seq)[1:-1]
            tmp_q = loop.get_query_string(self.query_seq)[1:-1]
            t_seq.append(tmp_t)
            q_seq.append(tmp_q)
            for t in range(t_beg, t_end + 1):
                t_seq.append(self.templ_seq[t])
                q_seq.append(self.query_seq[next_af.q(t)])
            next_t_res = t_end + 1
            next_q_res = q_end + 1

        # C-terminal loop
        t_loop_beg, q_loop_beg = next_t_res, next_q_res
        t_loop_end = len(self.templ_seq) - 1
        q_loop_end = len(self.query_seq) - 1
        key = f"{t_loop_beg-1}\t{q_loop_beg-1}\t{t_loop_end+1}\t{q_loop_end+1}"
        if key not in self.loops:
            self.loops[key] = self._loop_alignment(
                q_loop_beg - 1, t_loop_beg - 1, q_loop_end, t_loop_end)
        loop = self.loops[key]
        tmp_t = loop.get_templ_string(self.templ_seq)[1:-1]
        tmp_q = loop.get_query_string(self.query_seq)[1:-1]
        t_seq.append(tmp_t + "*")
        q_seq.append(tmp_q + "*")

        t_str = "".join(t_seq)
        q_str = "".join(q_seq)

        os_.write(">P1;templ\nstructure:\n")
        for i in range(0, len(t_str), 60):
            os_.write(t_str[i : i + 60] + "\n")
        os_.write(f">P1;query\nsequence:mdl_{ali_id}\n")
        for i in range(0, len(q_str), 60):
            os_.write(q_str[i : i + 60] + "\n")
        os_.write("#end\n")

        # parse the gapped strings into an Alignment (ssss.h:783-800)
        al = Alignment()
        t_idx = q_idx = 1
        for i in range(1, len(t_str)):
            tc, qc = t_str[i], q_str[i]
            if tc == "-":
                if qc != "-":
                    q_idx += 1
                continue
            if qc == "-":
                t_idx += 1
                continue
            al.append(q_idx, t_idx)
            q_idx += 1
            t_idx += 1
        as_.append(al)
