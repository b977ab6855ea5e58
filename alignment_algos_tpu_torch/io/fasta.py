"""FASTA read/write (fastaio.{h,cpp})."""

from __future__ import annotations

import io

from ..core.alignment import Alignment
from .gstrings import SequenceGaps


def _wrap(s: str, line_length: int) -> str:
    return "\n".join(s[i : i + line_length] for i in range(0, len(s), line_length))


class FastaWriter:
    def __init__(self, stream, line_length: int = 60) -> None:
        self.out = stream
        self.line_length = line_length

    def write_string(self, s: str) -> None:
        self.out.write(_wrap(s, self.line_length))
        self.out.write("\n")

    def write_sequence(self, seq) -> None:
        self.out.write(f"> {seq.seq_name}\n")
        self.write_string(seq.get_string())

    def write_set(self, as_) -> None:
        """Alignment set as gapped FASTA with per-alignment annotations
        (fastaio.h:50-90): the template once in common coordinates, then each
        query rendering."""
        gaps = SequenceGaps(as_)
        templ = as_.get_template_sequence()
        query = as_.get_query_sequence()
        self.out.write(f"> {templ.seq_name}\n")
        self.write_string(gaps.build_plain(templ.get_string()))
        for count, ali in enumerate(as_):
            annot = (f"(sc={_fmt(ali.score)},ev={_fmt(ali.significance)},"
                     f"id={_fmt(ali.identity)}%)")
            self.out.write(f"> {query.seq_name}_{count} {annot}\n")
            self.write_string(gaps.build_aligned(query.get_string(), ali))


def _fmt(v: float) -> str:
    """C++ default ostream float formatting (6 significant digits)."""
    return f"{float(v):.6g}"


class FastaReader:
    """fastaio.h:112-169: read the next FASTA record into a sequence object,
    optionally searching for a header substring, optionally bracketing with
    sentinels."""

    def __init__(self, stream, find: str = "", head_tail: bool = True) -> None:
        self.stream = stream
        self.find = find
        self.head_tail = head_tail
        self._peeked: str | None = None

    def _readline(self):
        if self._peeked is not None:
            l, self._peeked = self._peeked, None
            return l
        return self.stream.readline()

    def _peek(self):
        if self._peeked is None:
            self._peeked = self.stream.readline()
        return self._peeked

    def read_into(self, seq) -> None:
        # scan for a matching header
        name = None
        while True:
            line = self._readline()
            if not line:
                if self.find == "":
                    raise ValueError("Error reading fasta file")
                raise ValueError(f"Could not find search string: {self.find}")
            if line.startswith(">"):
                hdr = line[1:].lstrip(" ").rstrip("\n")
                if self.find == "" or self.find in hdr:
                    name = hdr
                    break
        seq.seq_name = name
        if self.head_tail:
            seq.append("^")
        while True:
            nxt = self._peek()
            if not nxt or nxt.startswith(">"):
                break
            seq.append(self._readline().rstrip("\n"))
        if self.head_tail:
            seq.append("$")

    def read_string_pair(self) -> tuple[str, str]:
        """Read two gapped records (template first) as plain strings."""
        a = _StrSeq()
        self.read_into(a)
        b = _StrSeq()
        self.read_into(b)
        return a.s, b.s


class _StrSeq:
    def __init__(self) -> None:
        self.s = ""
        self.seq_name = ""

    def append(self, x: str) -> None:
        self.s += x


def read_fasta_alignment(stream, head_tail: bool = True) -> Alignment:
    """FastaAlignmentRead (fastaio.h:191-203): template record then query
    record; returns the parsed Alignment."""
    r = FastaReader(stream, head_tail=head_tail)
    templ, query = r.read_string_pair()
    a = Alignment()
    a.read_from(query, templ)
    return a
