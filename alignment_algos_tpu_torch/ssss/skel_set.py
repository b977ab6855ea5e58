"""Skeleton beam/DFS search (skel_set.{h,cpp}).

DFS from each valid N-cap connection with pre-emptive low-coverage pruning;
completed skeletons pass coverage / SSE_CO / strand filters and then the
constrained-regrowth duplicate suppression: a skeleton is kept only if it is
the best constrained completion of itself among earlier-or-equal starting
fragments (skel_set.cpp:130-348).
"""

from __future__ import annotations

import sys

from .skel_ali import SkelAli


class SkelSet:
    def __init__(self, min_ali: int, min_CO_fraction: float, max_kept: int,
                 max_cluster_size: float, frags, str_data, strand_eval,
                 measurer=None, strand_rule_bug_compat: bool = True) -> None:
        self.Frags = frags
        self.Str = str_data
        self.Strand_Eval = strand_eval
        self.Measurer = measurer
        self.min_aligned_residues = min_ali
        self.min_SSE_CO_fraction = min_CO_fraction
        self.max_alis = max_kept
        self.max_cluster_size = max_cluster_size
        self.max_bad_alis = 100
        self.templ_seq = str_data.templ_seq
        self.query_seq = str_data.query_seq
        self.strand_rule_bug_compat = strand_rule_bug_compat

        self.Top_Skels: list[SkelAli] = []
        self.Low_Coverage: list[SkelAli] = []
        self.Low_SSE_CO: list[SkelAli] = []
        self.Bad_Strands: list[SkelAli] = []
        self.Low_Score: list[SkelAli] = []
        self.num_culled = {1: 0, 2: 0, 3: 0, 4: 0}
        self.top_constrained_skel: SkelAli | None = None
        self.tracking_mode = measurer is not None

        ncap = self.get_frag(0, 0)
        self.Start_Skels = [SkelAli(str_data, frags, ncap.get_next(i), 0)
                            for i in range(ncap.num_next())]

        template_SSE_CO = self.find_template_SSE_CO()
        print(f"Template SSE_CO: {template_SSE_CO:g}", file=sys.stderr)
        self.min_SSE_CO = min_CO_fraction * template_SSE_CO
        print(f"Minimum SSE_CO: {self.min_SSE_CO:g}", file=sys.stderr)

    def get_frag(self, f, frag_idx: int | None = None):
        return self.Frags.get_frag(f, frag_idx)

    # ------------------------------------------------------------------
    def find_top_skeletons(self) -> None:
        for sa in self.Start_Skels:
            self._grow_skel(sa)
        for reason, label in ((1, "coverage"), (2, "contact order"),
                              (3, "strand rules"), (4, "score")):
            print(f"Num culled by {label}: {self.num_culled[reason]}",
                  file=sys.stderr)
        self.num_culled = {1: 0, 2: 0, 3: 0, 4: 0}

    def _grow_skel(self, sa: SkelAli) -> None:
        if (sa.get_num_aligned() + self.Str.tsr_to_c[sa.get_last_templ_res_idx()]
                < self.min_aligned_residues):
            self._pre_empt_low_coverage(sa)
            return
        if sa.last_frag_is_C_terminal():
            self._handle_completed_skel(sa)
            return
        curr = sa.get_last_connection()
        frag = self.get_frag(curr.next_frag)
        for i in range(frag.num_next()):
            child = sa.copy()
            child.add_connection(frag.get_next(i))
            self._grow_skel(child)

    def _pre_empt_low_coverage(self, sa: SkelAli) -> None:
        if (self.tracking_mode and
                sa.get_num_aligned() > 0.75 * self.min_aligned_residues):
            if not sa.last_frag_is_C_terminal():
                last_fc = sa.get_last_connection()
                cap_fc = self.get_frag(last_fc.next_frag).get_last_next()
                sa.add_connection(cap_fc)
            self._handle_culled_skel_ali(sa, 1)

    def _passes_all_filters(self, sa: SkelAli):
        if sa.get_num_aligned() < self.min_aligned_residues:
            return False, 1
        if sa.get_contact_order() < self.min_SSE_CO:
            return False, 2
        passes = self.Strand_Eval.ali_passes_rules(sa.get_sse_id_list())
        # skel_set.cpp:442 rejects when ali_passes_rules() is TRUE; with
        # bug_compat off, the sane sense (reject on False) applies
        if self.strand_rule_bug_compat:
            if passes:
                return False, 3
        else:
            if not passes:
                return False, 3
        return True, -1

    def _handle_completed_skel(self, sa: SkelAli) -> None:
        sa.calc_skel_SSE_CO()
        ok, reason = self._passes_all_filters(sa)
        if ok:
            self._find_top_constrained_skel(sa)
            if not self.top_constrained_skel.same_skeleton(sa):
                return  # duplicate; the canonical version is found elsewhere
            sa.param = sa.get_score()
            self._sort_top_skels(sa)
        elif self.tracking_mode:
            self._handle_culled_skel_ali(sa, reason)

    # constrained re-growth duplicate suppression -----------------------
    def _find_top_constrained_skel(self, orig: SkelAli) -> None:
        self.top_constrained_skel = None
        orig_first = orig.get_connection(0).next_frag
        ncap = self.get_frag(0, 0)
        for i in range(ncap.num_next()):
            tmp_fc = ncap.get_next(i)
            nf = tmp_fc.next_frag
            if (nf.sse_idx < orig_first.sse_idx
                    or (nf.sse_idx == orig_first.sse_idx
                        and nf.frag_idx == orig_first.frag_idx)):
                sa = SkelAli(self.Str, self.Frags, tmp_fc, 0)
                self._grow_constrained_skel(sa, orig, 1)
        if self.top_constrained_skel is None:
            raise RuntimeError(
                "grow_constrained_skel did not find the original skel")

    def _grow_constrained_skel(self, sa: SkelAli, orig: SkelAli,
                               post_idx: int) -> None:
        if sa.last_frag_is_C_terminal():
            self._handle_completed_constrained_skel(sa)
            return
        post = self.get_frag(orig.get_connection(post_idx).next_frag)
        curr = sa.get_last_connection()
        frag = self.get_frag(curr.next_frag)
        for i in range(frag.num_next()):
            tmp_fc = frag.get_next(i)
            nf = tmp_fc.next_frag
            if nf.sse_idx > post.sse_id:
                break
            if nf.sse_idx == post.sse_id and nf.frag_idx > post.frag_id:
                break
            if nf.sse_idx == post.sse_id and nf.frag_idx < post.frag_id:
                continue
            if (not (nf.sse_idx == post.sse_id and nf.frag_idx == post.frag_id)
                    and not self.Frags.frags_in_order(self.get_frag(nf), post)):
                continue
            child = sa.copy()
            child.add_connection(tmp_fc)
            next_post_idx = self._find_next_post(child, orig, post_idx)
            self._grow_constrained_skel(child, orig, next_post_idx)

    def _find_next_post(self, curr: SkelAli, orig: SkelAli,
                        old_post_idx: int) -> int:
        curr_last = self.get_frag(curr.get_last_connection().next_frag)
        old_post = self.get_frag(orig.get_connection(old_post_idx).next_frag)
        if curr_last.sse_id < old_post.sse_id:
            return old_post_idx
        if curr_last.sse_id == old_post.sse_id:
            if curr_last.frag_id == old_post.frag_id:
                return old_post_idx + 1
            raise RuntimeError("Frag in skel ali is in same SSE but "
                               "different frag than post")
        raise RuntimeError("Frag in skel ali has passed that in post")

    def _handle_completed_constrained_skel(self, sa: SkelAli) -> None:
        sa.calc_skel_SSE_CO()
        ok, _ = self._passes_all_filters(sa)
        if not ok:
            return
        sa.param = sa.get_score()
        if self.top_constrained_skel is None \
                or sa.get_score() > self.top_constrained_skel.get_score():
            self.top_constrained_skel = sa

    # ranked insertion --------------------------------------------------
    def _sort_top_skels(self, sa: SkelAli) -> None:
        """Insert-sorted by param descending; cap at max_alis
        (skel_set.cpp:451-477)."""
        pos = len(self.Top_Skels)
        while pos > 0 and self.Top_Skels[pos - 1].param < sa.param:
            pos -= 1
        self.Top_Skels.insert(pos, sa)
        if len(self.Top_Skels) > self.max_alis:
            last = self.Top_Skels.pop()
            if self.tracking_mode:
                self._handle_culled_skel_ali(last, 4)

    def _sort_culled_skels(self, sa: SkelAli, lst: list[SkelAli]) -> None:
        pos = len(lst)
        while pos > 0 and lst[pos - 1].param > sa.param:
            pos -= 1
        lst.insert(pos, sa)
        if len(lst) > self.max_bad_alis:
            lst.pop()

    def _handle_culled_skel_ali(self, sa: SkelAli, reason: int) -> None:
        self.Measurer.load_test_vrp(sa.export_vrp())
        dist = self.Measurer.get_dist_between_main_and_test()
        sa.shift = dist
        sa.param = sa.shift
        lists = {1: self.Low_Coverage, 2: self.Low_SSE_CO,
                 3: self.Bad_Strands, 4: self.Low_Score}
        self._sort_culled_skels(sa, lists[reason])
        self.num_culled[reason] += 1

    def send_culled_alis_to_files(self, directory: str = ".") -> None:
        """skel_set.cpp:580-622 — dump the tracked culled skeletons to the
        four track_*.txt files (reference file names, opened in the ctor
        there so they exist even when empty) with the per-item stderr
        narration."""
        import os

        def g(v):
            return f"{float(v):g}"

        files = {
            1: ("Low_Coverage", self.Low_Coverage, "track_low_coverage.txt"),
            2: ("Low_SSE_CO", self.Low_SSE_CO, "track_low_CO.txt"),
            3: ("Bad_Strands", self.Bad_Strands, "track_bad_strands.txt"),
            4: ("Low_Score", self.Low_Score, "track_low_score.txt"),
        }
        for reason in (1, 2, 3, 4):
            label, lst, fn = files[reason]
            print(label, file=sys.stderr)
            with open(os.path.join(directory, fn), "w") as ofs:
                for sa in lst:
                    ofs.write(sa.render_print(self.query_seq, self.templ_seq))
                    if reason == 1:
                        print(f"shift: {g(sa.shift)}, coverage: "
                              f"{sa.get_num_aligned()} of "
                              f"{self.min_aligned_residues}", file=sys.stderr)
                    elif reason == 2:
                        print(f"shift: {g(sa.shift)}, SSE_CO: "
                              f"{g(sa.get_contact_order())} of "
                              f"{g(self.min_SSE_CO)}", file=sys.stderr)
                    elif reason == 3:
                        print(f"shift: {g(sa.shift)}", file=sys.stderr)
                    else:
                        print(f"shift: {g(sa.shift)}, score: "
                              f"{g(sa.get_score())}", file=sys.stderr)
            print("\n", file=sys.stderr)

    # ------------------------------------------------------------------
    def find_template_SSE_CO(self) -> float:
        """skel_set.cpp:534-577 (note: iterates j/n over [beg_id, end_id) —
        the last SSE residue is excluded from the contact scan but included
        in the residue count)."""
        contacts = self.Str.templ_contacts
        sses = self.Str.sses
        contacting = [False] * len(self.templ_seq)
        num_in_contact = 0
        for i, si in enumerate(sses):
            for j in range(si.beg_id, si.end_id):
                for m, sm in enumerate(sses):
                    if m == i:
                        continue
                    for n in range(sm.beg_id, sm.end_id):
                        if j == n:
                            continue
                        if contacts[j, n]:
                            if not contacting[j]:
                                contacting[j] = True
                                num_in_contact += 1
                            if not contacting[n]:
                                contacting[n] = True
                                num_in_contact += 1
        num_sse_res = sum(s.end_id - s.beg_id + 1 for s in sses)
        return float(num_in_contact) / float(num_sse_res)

    def get_top_skels(self) -> list[SkelAli]:
        return list(self.Top_Skels)

    # ------------------------------------------------------------------
    def get_exact_inter_ali_areas(self, skels: list[SkelAli]):
        """All-pairs exact area distance between skeleton polylines
        (skel_set.cpp:686-759, minus its hard-coded debug probes/pauses);
        native C++ engine (native/alidist.cpp) when available."""
        import numpy as np
        from ..analysis.ali_dist import area_matrix
        area = area_matrix([sk.export_vrp() for sk in skels])
        bad = np.argwhere(area < 0.0)
        if bad.size:
            i, j = bad[0]
            raise ValueError(f"invalid area measurement between alis {i} "
                             f"and {j}: {area[i, j]}")
        return area.astype(np.float64)

    def cluster_alignments(self) -> None:
        """UPGMA-cluster Top_Skels by exact inter-alignment area and keep
        one representative per cluster.

        A *working* implementation of the reference's dead code
        (skel_set.cpp:625-683, entire body commented out): transfer
        Top_Skels, compute the exact area matrix, UPGMA-cluster, cut the
        tree at ``max_cluster_size``, keep the first member of each cluster
        (the reference's own NOTE says it "arbitrarily selects the first
        member"), then insertion-re-sort descending by score with the
        reference's exact tie behavior (a new skeleton is inserted *before*
        equal-scored earlier ones, skel_set.cpp:663-678)."""
        if len(self.Top_Skels) < 2 or self.max_cluster_size <= 0.0:
            return
        from ..analysis.upgma import UPGMAClusterer
        skels = list(self.Top_Skels)
        area = self.get_exact_inter_ali_areas(skels)
        clusterer = UPGMAClusterer(area)
        clusterer.cluster()
        clusters = clusterer.find_clusters_under_threshold(
            self.max_cluster_size)
        print(f"cluster_alignments: max_cluster_size: "
              f"{self.max_cluster_size:g}", file=sys.stderr)
        print(f"cluster_alignments: # clusters found: {len(clusters)}",
              file=sys.stderr)
        reps = [skels[members[0]] for members in clusters]
        sorted_skels: list[SkelAli] = []
        for sa in reps:
            pos = 0
            while (pos < len(sorted_skels)
                   and sa.get_score() < sorted_skels[pos].get_score()):
                pos += 1
            sorted_skels.insert(pos, sa)
        self.Top_Skels = sorted_skels
