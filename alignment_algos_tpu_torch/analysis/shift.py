"""Residue-based shift metric (get_shifts.cpp:18-90): renders the native and
test alignments into common gapped coordinates, masks non-core and
native-zigzag query residues, then accumulates |running occupancy diff|."""

from __future__ import annotations

from ..core.alignment import Alignment
from ..io.gstrings import SequenceGaps


class _MiniSet(list):
    """Just enough AlignmentSet surface for SequenceGaps."""

    def __init__(self, alis, q_len, t_len):
        super().__init__(alis)
        self._q = q_len
        self._t = t_len

    def get_query_sequence(self):
        return _Sized(self._q)

    def get_template_sequence(self):
        return _Sized(self._t)


class _Sized:
    def __init__(self, n):
        self._n = n

    def size(self):
        return self._n


def get_shift(test: Alignment, native: Alignment, qstr: str, core) -> tuple[int, int]:
    """Returns (shift, ali_len)."""
    if test.get_last_query_idx() != core.size() - 1:
        raise ValueError("Core file length does not match alignment")

    q_len = native.get_last_query_idx() + 1
    t_len = native.get_last_template_idx() + 1
    as_ = _MiniSet([native, test], q_len, t_len)
    sg = SequenceGaps(as_, query_len=q_len, template_len=t_len)

    qchars = list(qstr)
    for i in range(len(qchars)):
        if not core[i]:
            qchars[i] = "."
    # mask native zigzag query stretches
    pairs = list(native.pairs)
    prev = pairs[0]
    for cur in pairs[1:]:
        if cur[0] - prev[0] > 1 and cur[1] - prev[1] > 1:
            for i in range(prev[0] + 1, cur[0]):
                qchars[i] = "."
        prev = cur
    qstr_m = "".join(qchars)

    tstr = "*" * t_len
    tpl_gapped = sg.build_plain(tstr, "-")
    nat_gapped = sg.build_aligned(qstr_m, native, "-")
    ali_gapped = sg.build_aligned(qstr_m, test, "-")

    ali_len = -2
    diff = 0
    shift = 0
    for i in range(len(nat_gapped)):
        if nat_gapped[i] not in "-.":
            diff += 1
        if i < len(ali_gapped) and ali_gapped[i] not in "-.":
            diff -= 1
        shift += abs(diff)
        if (i < len(ali_gapped) and ali_gapped[i] != "-"
                and i < len(tpl_gapped) and tpl_gapped[i] != "-"):
            ali_len += 1
    return shift, ali_len
