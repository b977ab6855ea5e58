"""Common-coordinate gapped rendering (gstrings.{h,cpp}).

Computes per-template-position maximum insert lengths ("anchors") across an
alignment set and renders any sequence or alignment into that shared gapped
coordinate system; zigzag stretches are rendered lowercase.
"""

from __future__ import annotations

import numpy as np

GAP_CHAR = "-"


class SequenceGaps:
    def __init__(self, as_, mask=None, query_len: int | None = None,
                 template_len: int | None = None) -> None:
        self.query_len = (query_len if query_len is not None
                          else as_.get_query_sequence().size())
        self.template_len = (template_len if template_len is not None
                             else as_.get_template_sequence().size())
        self.anchors = [0] * (self.template_len - 1)
        self.gap_total = 0
        self._build_anchors(as_, mask)

    def _build_anchors(self, as_, mask) -> None:
        do_all = mask is None
        for i, ali in enumerate(as_):
            if not (do_all or mask[i]):
                continue
            pairs = list(ali.pairs)
            prev = pairs[0]
            for cur in pairs[1:]:
                if cur[0] != prev[0] + 1:
                    gap = cur[0] - prev[0] - 1
                    if gap > self.anchors[prev[1]]:
                        self.anchors[prev[1]] = gap
                prev = cur
        self.gap_total = sum(self.anchors)

    def build_plain(self, seq: str, gc: str = GAP_CHAR) -> str:
        """Render the template string in common coordinates (gstrings.cpp)."""
        assert self.template_len == len(seq)
        out = []
        for i in range(self.template_len - 1):
            out.append(seq[i])
            out.append(gc * self.anchors[i])
        out.append(seq[self.template_len - 1])
        return "".join(out)

    def build_aligned(self, seq: str, ali, gc: str = GAP_CHAR) -> str:
        """Render a query through an alignment in common coordinates
        (gstrings.h:118-164); zigzag stretches lowercased."""
        assert self.query_len == len(seq)
        pairs = list(ali.pairs)
        pi = 0
        result = []
        rlen = 0
        for j in range(self.template_len - 1):
            a_gap = self.anchors[j] + 1
            if pi < len(pairs) and pairs[pi][1] == j:
                a, x = pairs[pi][1], pairs[pi][0]
                pi += 1
                if pi < len(pairs):
                    b, y = pairs[pi][1], pairs[pi][0]
                else:
                    b, y = a + 1, x + 1
                sub = seq[x:y]
                if not (b - a == 1 or y - x == 1):
                    sub = sub[0] + sub[1:].lower()  # zigzag
                result.append(sub)
                rlen += len(sub)
                a_gap -= y - x
            result.append(gc * a_gap)
            rlen += max(a_gap, 0)
            if a_gap < 0:
                # string::append with negative length is UB in the reference;
                # clamp here
                pass
        z = self.template_len + self.gap_total - rlen
        if z > 1:
            result.append(gc * (z - 1))
        result.append(seq[-1])
        return "".join(result)
