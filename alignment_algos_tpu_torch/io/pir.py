"""PIR read/write (pirio.{h,cpp}): ``#start``/``#end`` delimited blocks with
``>P1;`` headers, ``structure:``/``sequence:`` description lines and ``*``
terminated gapped strings, one alignment per block."""

from __future__ import annotations

from ..core.alignment import Alignment
from .gstrings import SequenceGaps


def _wrap(s: str, line_length: int) -> str:
    return "\n".join(s[i : i + line_length] for i in range(0, len(s), line_length))


def _fix_ends(s: str) -> str:
    """Erase the sentinel characters (PIRWrite::fix_ends, pirio.cpp:19-25;
    note the reference writes no ``*`` terminator)."""
    if s.startswith("^"):
        s = s[1:]
    if s.endswith("$"):
        s = s[:-1]
    return s


class PIRWriter:
    def __init__(self, stream, line_length: int = 60) -> None:
        self.out = stream
        self.line_length = line_length

    def write_set(self, as_) -> None:
        templ = as_.get_template_sequence()
        query = as_.get_query_sequence()
        for count, ali in enumerate(as_):
            mask = [False] * len(as_)
            mask[count] = True
            gaps = SequenceGaps(as_, mask)
            self.out.write("#start\n\n")
            self.out.write(f">P1;{templ.seq_name}\n")
            self.out.write(f"structureN:{templ.seq_name}::::\n")
            self.out.write(_wrap(_fix_ends(gaps.build_plain(templ.get_string())),
                                 self.line_length) + "\n")
            self.out.write("\n")
            self.out.write(f">P1;{query.seq_name}\n")
            self.out.write(f"sequence:{query.seq_name}::::\n")
            self.out.write(_wrap(_fix_ends(gaps.build_aligned(query.get_string(), ali)),
                                 self.line_length) + "\n")
            self.out.write("\n#end\n")


def read_pir(stream, head_tail: bool = True) -> Alignment:
    """PIRRead (pirio.h:129-176): parse the next #start block into an
    Alignment.  Raises EOFError when no further block exists."""
    line = stream.readline()
    while "#start" not in line:
        line = stream.readline()
        if not line:
            raise EOFError("Error (1) parsing PIR")

    while "structure" not in line:
        line = stream.readline()
        if not line:
            raise EOFError("Error (2) parsing PIR")
    line = stream.readline()
    templ = ""
    while True:
        templ += line.rstrip("\n")
        if line.rstrip("\n") == "" or templ.endswith("*"):
            break
        line = stream.readline()

    while "sequence" not in line:
        line = stream.readline()
    line = stream.readline()
    query = ""
    while True:
        query += line.rstrip("\n")
        if line.rstrip("\n") == "" or query.endswith("*"):
            break
        line = stream.readline()

    if templ.endswith("*"):
        templ = templ[:-1]
    if query.endswith("*"):
        query = query[:-1]
    if head_tail:
        if not templ.startswith("^"):
            templ = "^" + templ
        if not templ.endswith("$"):
            templ = templ + "$"
        if not query.startswith("^"):
            query = "^" + query
        if not query.endswith("$"):
            query = query + "$"
    a = Alignment()
    a.read_from(query, templ)
    return a


def read_pir_batch(stream, head_tail: bool = True) -> list[Alignment]:
    out = []
    while True:
        try:
            out.append(read_pir(stream, head_tail))
        except EOFError:
            break
    return out
