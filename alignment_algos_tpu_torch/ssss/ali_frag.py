"""A fragment: one diagonal placement of the query against a template SSE
(ali_frag.{h,cpp})."""

from __future__ import annotations

from .defs import FragConnection, FragID

ACTIVE = 1
AVAILABLE = 0
REDUNDANT = -1


class AliFrag:
    __slots__ = ("t_sse_beg", "t_sse_end", "t_core_beg", "t_core_end",
                 "qt_shift", "next_frags", "status", "sse_id", "frag_id",
                 "frag_is_N_terminal", "frag_is_C_terminal", "score",
                 "z_score", "num_children")

    def __init__(self, t1_sse: int, t2_sse: int, t1_core: int, t2_core: int,
                 qt: int, score: float, n_term: bool, c_term: bool) -> None:
        self.t_sse_beg = t1_sse
        self.t_sse_end = t2_sse
        self.t_core_beg = t1_core
        self.t_core_end = t2_core
        self.qt_shift = qt
        self.score = float(score)
        self.z_score = 0.0
        self.num_children = 0
        self.frag_is_N_terminal = n_term
        self.frag_is_C_terminal = c_term
        self.next_frags: list[FragConnection] = []
        self.status = AVAILABLE
        self.sse_id = -1
        self.frag_id = -1

    @classmethod
    def full(cls, t1: int, t2: int, qt: int, score: float, n_term: bool,
             c_term: bool) -> "AliFrag":
        return cls(t1, t2, t1, t2, qt, score, n_term, c_term)

    # geometry accessors (ali_frag.h:47-62)
    def core_t0(self): return self.t_core_beg
    def core_t1(self): return self.t_core_end
    def core_q0(self): return self.t_core_beg + self.qt_shift
    def core_q1(self): return self.t_core_end + self.qt_shift
    def sse_t0(self): return self.t_sse_beg
    def sse_t1(self): return self.t_sse_end
    def sse_q0(self): return self.t_sse_beg + self.qt_shift
    def sse_q1(self): return self.t_sse_end + self.qt_shift
    def q(self, t): return t + self.qt_shift
    def qt(self): return self.qt_shift
    def core_len(self): return self.t_core_end - self.t_core_beg + 1
    def sse_len(self): return self.t_sse_end - self.t_sse_beg + 1
    def ss(self): return self.score
    def zs(self): return self.z_score

    def is_active(self): return self.status == ACTIVE
    def is_available(self): return self.status == AVAILABLE
    def is_redundant(self): return self.status == REDUNDANT
    def make_active(self): self.status = ACTIVE
    def make_available(self): self.status = AVAILABLE
    def make_redundant(self): self.status = REDUNDANT

    def get_id(self) -> FragID:
        return FragID(self.sse_id, self.frag_id)

    def make_connection(self, f_next: FragID, prev_end: int, next_beg: int,
                        score: float) -> None:
        self.next_frags.append(FragConnection(
            self.get_id(), f_next, prev_end, next_beg, float(score)))

    def num_next(self): return len(self.next_frags)
    def get_next(self, i): return self.next_frags[i]
    def get_last_next(self): return self.next_frags[-1]
    def clear_next(self): self.next_frags = []

    # ---- tracking-mode rendering (ali_frag.cpp:94-160; byte-parity with
    # ---- the reference's cerr/ofstream output) -------------------------
    def render_info(self) -> str:
        g = _g
        return (f"Frag: sse id: {self.sse_id}, frag_id: {self.frag_id}\n"
                f"      core: [{self.core_t0()},{self.core_q0()}] - "
                f"[{self.core_t1()},{self.core_q1()}]\n"
                f"       sse: [{self.sse_t0()},{self.sse_q0()}] - "
                f"[{self.sse_t1()},{self.sse_q1()}]\n"
                f"        qt: {self.qt_shift}\n"
                f" -- score:   {g(self.score)}\n"
                f" -- z-score: {g(self.z_score)}\n")

    def render_block(self, query_seq: str, templ_seq: str) -> str:
        t_row = templ_seq[self.t_core_beg : self.t_core_end + 1]
        q_row = "".join(query_seq[t + self.qt_shift]
                        for t in range(self.t_core_beg, self.t_core_end + 1))
        return self.render_info() + f"T: {t_row}\nQ: {q_row}\n"

    def render_block_window(self, query_seq: str, templ_seq: str,
                            t_beg: int, t_end: int) -> str:
        lines = [self.render_info()]
        lines.append(templ_seq[self.t_sse_beg : self.t_sse_end + 1] + "\n")
        lines.append("".join(
            "|" if t_beg <= t <= t_end else " "
            for t in range(self.t_sse_beg, self.t_sse_end + 1)) + "\n")
        lines.append("".join(
            query_seq[t + self.qt_shift]
            for t in range(self.t_sse_beg, self.t_sse_end + 1)) + "\n")
        return "".join(lines)

    def render_one_line(self, templ_seq: str, query_seq: str) -> str:
        g = _g
        return (f"{self.qt_shift}, {g(self.score)}, {g(self.z_score)}, "
                f"{templ_seq[self.t_core_beg : self.t_core_beg + 3]}/"
                f"{query_seq[self.q(self.t_core_beg) : self.q(self.t_core_beg) + 3]}")


def _g(v) -> str:
    """C++ default ostream float formatting (6 significant digits)."""
    return f"{float(v):g}"
