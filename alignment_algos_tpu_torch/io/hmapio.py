"""Human-readable HMAP alignment rendering (hmapio.{h,cpp}): 5-row blocks of
template SSE / template / match marks / query / query SSE, with ``|`` for
identity, ``:`` for positive substitution score, ``.`` for positive
similarity."""

from __future__ import annotations

from .gstrings import SequenceGaps
from ..scoring.submatrix import BlosumMatrix


def _fix_ends(s: str) -> str:
    if s and s[0] == "^":
        s = s[1:]
    if s and s[-1] == "$":
        s = s[:-1]
    return s


def _fmt(v: float) -> str:
    return f"{float(v):.6g}"


class HMAPWriter:
    def __init__(self, stream, submatrix_fn: str = "", line_length: int = 60) -> None:
        self.out = stream
        self.line_length = line_length
        self.submatrix_fn = submatrix_fn

    def write_set(self, as_) -> None:
        templ = as_.get_template_sequence()
        query = as_.get_query_sequence()
        bm = BlosumMatrix(self.submatrix_fn) if self.submatrix_fn else None
        for count, ali in enumerate(as_):
            mask = [False] * len(as_)
            mask[count] = True
            gaps = SequenceGaps(as_, mask)

            annot = (f"(sc={_fmt(ali.score)},ev={_fmt(ali.significance)},"
                     f"id={_fmt(ali.identity)}%)  UID={ali.uid}")
            self.out.write(f">{query.seq_name}_{count} {annot}\n\n")
            self.out.write(f"model: length {templ.size() - 2}\n")
            self.out.write(f"query: length {query.size() - 2}\n")

            g_templ_sse = _fix_ends(gaps.build_plain(templ.get_sse_string(), " "))
            g_templ = _fix_ends(gaps.build_plain(templ.get_string()))
            marks = self._generate_marks(ali, as_, bm)
            g_marks = _fix_ends(gaps.build_aligned(marks, ali, " "))
            g_query = _fix_ends(gaps.build_aligned(query.get_string(), ali))
            g_query_sse = _fix_ends(gaps.build_aligned(query.get_sse_string(),
                                                       ali, " "))
            for i in range(0, len(g_templ), self.line_length):
                sl = slice(i, i + self.line_length)
                self.out.write("\n")
                self.out.write(f"       {g_templ_sse[sl]}\n")
                self.out.write(f"model: {g_templ[sl]}\n")
                self.out.write(f"       {g_marks[sl]}\n")
                self.out.write(f"query: {g_query[sl]}\n")
                self.out.write(f"       {g_query_sse[sl]}\n")
            self.out.write("\n")

    def _generate_marks(self, ali, as_, bm) -> str:
        q_seq = as_.get_query_sequence().get_string()
        t_seq = as_.get_template_sequence().get_string()
        qp = -1
        buf = []
        for qi, ti in ali.pairs:
            qc = q_seq[qi]
            tc = t_seq[ti]
            s = as_.dpm.get_sim(qi, ti)
            buf.append(" " * (qi - qp - 1))
            qp = qi
            if qc in "^$":
                buf.append(qc)
            elif qc == tc:
                buf.append("|")
            elif bm is not None and bm.score(qc, tc) > 0:
                buf.append(":")
            elif s > 0:
                buf.append(".")
            else:
                buf.append(" ")
        return "".join(buf)
