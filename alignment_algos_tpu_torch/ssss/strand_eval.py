"""Beta-strand topology rules (ali_strand_eval.{h,cpp}).

All_Strands_Paired: an aligned strand must have >=1 aligned H-bond partner.
No_Missing_Cores: if two partners of a core strand are aligned, the core
must be too.

NOTE the caller's sense (skel_set.cpp:442): a skeleton is REJECTED when
``ali_passes_rules`` returns TRUE — the reference's inverted-looking use is
replicated via the ``bug_compat`` flag in SkelSet.
"""

from __future__ import annotations

from .defs import SSEData, STRAND


class AlignmentStrandEvaluator:
    def __init__(self) -> None:
        self.num_sses = 0
        self.contacts = None  # symmetric accessor: (hi, lo) lower-tri matrix
        self.All_Strands: list[int] = []
        self.Edge_Strands: list[int] = []
        self.Core_Strands: list[int] = []
        self.All_Strands_Paired: list[list[int]] = []
        self.No_Missing_Cores: list[list[int]] = []

    def load_SSE_contacts(self, size: int, contacts) -> None:
        """contacts[i][j] defined for j <= i (lower triangular bool)."""
        self.num_sses = size
        self.contacts = contacts

    def load_all_strands(self, sses: list[SSEData]) -> None:
        self.All_Strands = [s.sse_id for s in sses if s.ss_type == STRAND]

    def determine_rules(self) -> None:
        st = self.All_Strands
        c = self.contacts
        for i in range(len(st)):
            num_partners = 0
            for j in range(i):
                if c[st[i]][st[j]]:
                    num_partners += 1
            for k in range(i + 1, len(st)):
                if c[st[k]][st[i]]:
                    num_partners += 1
            if num_partners == 1:
                self.Edge_Strands.append(st[i])
            elif num_partners > 1:
                self.Core_Strands.append(st[i])

        for i in range(len(st)):
            tmp = [st[i]]
            for j in range(i):
                if c[st[i]][st[j]]:
                    tmp.append(st[j])
            for k in range(i + 1, len(st)):
                if c[st[k]][st[i]]:
                    tmp.append(st[k])
            self.All_Strands_Paired.append(tmp)

        for core in self.Core_Strands:
            partners = []
            for s in st:
                if core > s and c[core][s]:
                    partners.append(s)
                elif s > core and c[s][core]:
                    partners.append(s)
            for j in range(1, len(partners)):
                for k in range(j):
                    self.No_Missing_Cores.append([partners[k], partners[j], core])

    def ali_passes_rules(self, sse_id_list: list[int]) -> bool:
        ids = set(sse_id_list)
        for rule in self.All_Strands_Paired:
            if rule[0] in ids:
                if not any(s in ids for s in rule[1:]):
                    return False
        for s1, s2, core in self.No_Missing_Cores:
            if s1 in ids and s2 in ids and core not in ids:
                return False
        return True
