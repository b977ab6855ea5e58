"""Reference-semantics DP builder (numpy, host).

A faithful reimplementation of the recurrence in dpmatrix.h:356-1030 —
general (non-affine-restricted) gap DP where each cell considers the match
predecessor, every deletion predecessor in its row, and every insertion
predecessor in its column, with the reference's exact candidate ordering and
strict-improvement tie-breaking:

  match first; then deletion candidates (ascending k in the forward build,
  descending in the reverse build); then insertion candidates; a candidate
  replaces the incumbent only when strictly greater (dpmatrix.h:447-486).

Arithmetic is float32 with the reference's operation order
(s = H[pred]; s -= gap; s += sim).  This module is the correctness oracle
for the vectorized TPU engine in dp_engine.py and the host fallback for tiny
problems.  Computed cells outside the built region keep score 0 and null
(-1) traceback, as in the reference.
"""

from __future__ import annotations

import numpy as np

from ..scoring.base import DPCosts

NULL = -1
F32 = np.float32


class DPResult:
    """Scores + traceback of one build. H, PQ, PT have shape (Q+2, T+2)."""

    __slots__ = ("H", "PQ", "PT")

    def __init__(self, q2: int, t2: int) -> None:
        self.H = np.zeros((q2, t2), dtype=np.float32)
        self.PQ = np.full((q2, t2), NULL, dtype=np.int32)
        self.PT = np.full((q2, t2), NULL, dtype=np.int32)

    def set_tb(self, i: int, j: int, pq: int, pt: int, s: float) -> None:
        self.H[i, j] = s
        self.PQ[i, j] = pq
        self.PT[i, j] = pt


def _pick(cur_s: np.float32, cands: np.ndarray):
    """Running strict-improvement max: returns (max, first-argmax) if the
    candidate array improves on cur_s, else (cur_s, None)."""
    if cands.size:
        m = cands.max()
        if m > cur_s:
            return m, int(np.argmax(cands))
    return cur_s, None


def _ins_cost_vec(c: DPCosts, ks: np.ndarray, q2_pos: int, j: int) -> np.ndarray:
    """insertion(k, q2_pos, j-1, j) vectorized over query start positions ks."""
    cost = c.ins_cost_of_dist(q2_pos - ks, j)
    if c.ins_zero_head_q:
        cost = np.where(ks == 0, F32(0.0), cost)
    if c.ins_zero_tail_q and q2_pos == c.q_size - 1:
        cost = np.zeros_like(cost)
    return cost


# ---- native engine (native/dpref.cpp) -----------------------------------

_nlib = None
_ntried = False


def _load_native():
    """Self-building ctypes bridge; AAT_DPREF_BACKEND=python forces the
    numpy implementation."""
    global _nlib, _ntried
    import os
    if os.environ.get("AAT_DPREF_BACKEND", "auto") == "python":
        return None
    if _nlib is not None or _ntried:
        return _nlib
    _ntried = True
    import ctypes
    d = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "native")
    src = os.path.join(d, "dpref.cpp")
    from ..native import build_native
    lib = build_native("dpref", [src])
    if lib is None:
        return None
    lib.dpref_build_forward.restype = ctypes.c_long
    lib.dpref_build_reverse.restype = ctypes.c_long
    _nlib = lib
    return lib


def _native_call(lib, c: DPCosts, q0, q1, t0, t1, local, res,
                 reverse=False, bug_compat=True):
    import ctypes
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    S = np.ascontiguousarray(c.S, dtype=np.float32)
    D = np.ascontiguousarray(c.D, dtype=np.float32)
    A = np.ascontiguousarray(c.A, dtype=np.float32)
    B = np.ascontiguousarray(c.B, dtype=np.float32)
    has_c = c.C is not None
    Cv = np.ascontiguousarray(c.C if has_c else np.zeros(1),
                              dtype=np.float32)
    args = [S.ctypes.data_as(fp), D.ctypes.data_as(fp),
            A.ctypes.data_as(fp), B.ctypes.data_as(fp),
            Cv.ctypes.data_as(fp) if has_c else ctypes.cast(None, fp),
            ctypes.c_long(c.ins_dist_offset),
            ctypes.c_int(1 if c.ins_zero_head_q else 0),
            ctypes.c_int(1 if c.ins_zero_tail_q else 0),
            ctypes.c_long(c.q_size), ctypes.c_long(c.t_size),
            ctypes.c_long(q0), ctypes.c_long(q1),
            ctypes.c_long(t0), ctypes.c_long(t1),
            ctypes.c_int(1 if local else 0)]
    if reverse:
        args.append(ctypes.c_int(1 if bug_compat else 0))
    args += [res.H.ctypes.data_as(fp), res.PQ.ctypes.data_as(ip),
             res.PT.ctypes.data_as(ip)]
    fn = lib.dpref_build_reverse if reverse else lib.dpref_build_forward
    return fn(*args)


def build_forward(c: DPCosts, q0: int, q1: int, t0: int, t1: int,
                  local: bool = False, res: DPResult | None = None) -> DPResult:
    """build_forw_dpm_nonlinear_gaps / build_forw_local_dpm_nonlinear_gaps.
    Dispatches to the bit-identical native engine when available."""
    if q1 <= q0 or t1 <= t0:
        raise ValueError("Illegal bounds building DPM")
    lib = _load_native()
    if lib is not None:
        if res is None:
            res = DPResult(c.q_size, c.t_size)
        if _native_call(lib, c, q0, q1, t0, t1, local, res) == 0:
            return res
    return _build_forward_py(c, q0, q1, t0, t1, local=local, res=res)


def _build_forward_py(c: DPCosts, q0: int, q1: int, t0: int, t1: int,
                      local: bool = False, res: DPResult | None = None) -> DPResult:
    """Pure-numpy implementation (the parity reference)."""
    S, D = c.S, c.D
    if res is None:
        res = DPResult(c.q_size, c.t_size)
    H = res.H
    if q1 <= q0 or t1 <= t0:
        raise ValueError("Illegal bounds building DPM")
    s_init = F32(H[q0, t0])

    def clamp(x):
        return np.maximum(F32(0.0), x) if local else x

    # forced single-step cases (dpmatrix.h:375-390)
    if q1 == q0 + 1:
        s = F32(F32(s_init - F32(c.deletion(q0, q1, t0, t1))) + S[q1, t1])
        res.set_tb(q1, t1, q0, t0, s)
        return res
    if t1 == t0 + 1:
        s = F32(F32(s_init - F32(c.insertion(q0, q1, t0, t1))) + S[q1, t1])
        res.set_tb(q1, t1, q0, t0, s)
        return res

    # boundary cells
    res.set_tb(q0 + 1, t0 + 1, q0, t0, clamp(F32(s_init + S[q0 + 1, t0 + 1])))
    for j in range(t0 + 2, t1):  # top row: forced deletion from origin
        s = F32(F32(s_init - D[t0, j]) + S[q0 + 1, j])
        res.set_tb(q0 + 1, j, q0, t0, clamp(s))
    for i in range(q0 + 2, q1):  # left col: forced insertion from origin
        s = F32(F32(s_init - F32(c.insertion(q0, i, t0, t0 + 1))) + S[i, t0 + 1])
        res.set_tb(i, t0 + 1, q0, t0, clamp(s))

    # interior cells
    for i in range(q0 + 2, q1):
        for j in range(t0 + 2, t1):
            sim = S[i, j]
            opt_i, opt_j = i - 1, j - 1
            opt_s = clamp(F32(H[i - 1, j - 1] + sim))

            ks = np.arange(t0 + 1, j - 1)
            if ks.size:
                cands = clamp(((H[i - 1, ks] - D[ks, j]) + sim).astype(np.float32))
                m, a = _pick(opt_s, cands)
                if a is not None:
                    opt_s, opt_i, opt_j = m, i - 1, int(ks[a])

            ks = np.arange(q0 + 1, i - 1)
            if ks.size:
                cost = _ins_cost_vec(c, ks, i, j)
                cands = clamp(((H[ks, j - 1] - cost) + sim).astype(np.float32))
                m, a = _pick(opt_s, cands)
                if a is not None:
                    opt_s, opt_i, opt_j = m, int(ks[a]), j - 1

            res.set_tb(i, j, opt_i, opt_j, opt_s)

    # closing cell (q1, t1) (dpmatrix.h:504-534)
    sim = S[q1, t1]
    opt_i, opt_j = q1 - 1, t1 - 1
    opt_s = clamp(F32(H[q1 - 1, t1 - 1] + sim))

    ks = np.arange(t0 + 1, t1)
    cands = clamp(((H[q1 - 1, ks] - D[ks, t1]) + sim).astype(np.float32))
    m, a = _pick(opt_s, cands)
    if a is not None:
        opt_s, opt_i, opt_j = m, q1 - 1, int(ks[a])

    ks = np.arange(q0 + 1, q1)
    cost = _ins_cost_vec(c, ks, q1, t1)
    cands = clamp(((H[ks, t1 - 1] - cost) + sim).astype(np.float32))
    m, a = _pick(opt_s, cands)
    if a is not None:
        opt_s, opt_i, opt_j = m, int(ks[a]), t1 - 1

    res.set_tb(q1, t1, opt_i, opt_j, opt_s)
    return res


def build_reverse(c: DPCosts, q0: int, q1: int, t0: int, t1: int,
                  local: bool = False, res: DPResult | None = None,
                  bug_compat: bool = True) -> DPResult:
    """build_rev_dpm_nonlinear_gaps / build_rev_local_dpm_nonlinear_gaps.

    ``bug_compat`` replicates the reference defect at dpmatrix.h:868: in the
    non-local reverse build's closing scan, an insertion winner records
    prev_template_idx = t1-1 instead of t0+1.  Dispatches to the
    bit-identical native engine when available."""
    if q1 <= q0 or t1 <= t0:
        raise ValueError("Illegal bounds building DPM")
    lib = _load_native()
    if lib is not None:
        if res is None:
            res = DPResult(c.q_size, c.t_size)
        if _native_call(lib, c, q0, q1, t0, t1, local, res, reverse=True,
                        bug_compat=bug_compat) == 0:
            return res
    return _build_reverse_py(c, q0, q1, t0, t1, local=local, res=res,
                             bug_compat=bug_compat)


def _build_reverse_py(c: DPCosts, q0: int, q1: int, t0: int, t1: int,
                      local: bool = False, res: DPResult | None = None,
                      bug_compat: bool = True) -> DPResult:
    """Pure-numpy implementation (the parity reference)."""
    S, D = c.S, c.D
    if res is None:
        res = DPResult(c.q_size, c.t_size)
    H = res.H
    if q1 <= q0 or t1 <= t0:
        raise ValueError("Illegal bounds building DPM")
    s_init = F32(H[q1, t1])

    def clamp(x):
        return np.maximum(F32(0.0), x) if local else x

    if q1 == q0 + 1:
        s = F32(F32(s_init - F32(c.deletion(q0, q1, t0, t1))) + S[q0, t0])
        res.set_tb(q0, t0, q1, t1, s)
        return res
    if t1 == t0 + 1:
        s = F32(F32(s_init - F32(c.insertion(q0, q1, t0, t1))) + S[q0, t0])
        res.set_tb(q0, t0, q1, t1, s)
        return res

    res.set_tb(q1 - 1, t1 - 1, q1, t1, clamp(F32(s_init + S[q1 - 1, t1 - 1])))
    for j in range(t1 - 2, t0, -1):  # bottom row: deletion (j, t1)
        s = F32(F32(s_init - D[j, t1]) + S[q1 - 1, j])
        res.set_tb(q1 - 1, j, q1, t1, clamp(s))
    for i in range(q1 - 2, q0, -1):  # right col: insertion (i, q1)
        s = F32(F32(s_init - F32(c.insertion(i, q1, t1 - 1, t1))) + S[i, t1 - 1])
        res.set_tb(i, t1 - 1, q1, t1, clamp(s))

    for i in range(q1 - 2, q0, -1):
        for j in range(t1 - 2, t0, -1):
            sim = S[i, j]
            opt_i, opt_j = i + 1, j + 1
            opt_s = clamp(F32(H[i + 1, j + 1] + sim))

            ks = np.arange(t1 - 1, j + 1, -1)  # descending, candidate order
            if ks.size:
                cands = clamp(((H[i + 1, ks] - D[j, ks]) + sim).astype(np.float32))
                m, a = _pick(opt_s, cands)
                if a is not None:
                    opt_s, opt_i, opt_j = m, i + 1, int(ks[a])

            ks = np.arange(q1 - 1, i + 1, -1)
            if ks.size:
                cost = c.ins_cost_of_dist(ks - i, j + 1)
                if c.ins_zero_head_q:
                    cost = np.where(np.int64(i) == 0, F32(0.0), cost)
                if c.ins_zero_tail_q:
                    cost = np.where(ks == c.q_size - 1, F32(0.0), cost)
                cands = clamp(((H[ks, j + 1] - cost) + sim).astype(np.float32))
                m, a = _pick(opt_s, cands)
                if a is not None:
                    opt_s, opt_i, opt_j = m, int(ks[a]), j + 1

            res.set_tb(i, j, opt_i, opt_j, opt_s)

    # closing cell (q0, t0) (dpmatrix.h:844-874)
    sim = S[q0, t0]
    opt_i, opt_j = q0 + 1, t0 + 1
    opt_s = clamp(F32(H[q0 + 1, t0 + 1] + sim))

    ks = np.arange(t1 - 1, t0, -1)
    cands = clamp(((H[q0 + 1, ks] - D[t0, ks]) + sim).astype(np.float32))
    m, a = _pick(opt_s, cands)
    if a is not None:
        opt_s, opt_i, opt_j = m, q0 + 1, int(ks[a])

    ks = np.arange(q1 - 1, q0, -1)
    # insertion(q0, k, t0, t0+1) vectorized over k
    cost = c.ins_cost_of_dist(ks - q0, t0 + 1)
    if c.ins_zero_head_q and q0 == 0:
        cost = np.zeros_like(cost)
    if c.ins_zero_tail_q:
        cost = np.where(ks == c.q_size - 1, F32(0.0), cost)
    cands = clamp(((H[ks, t0 + 1] - cost) + sim).astype(np.float32))
    m, a = _pick(opt_s, cands)
    if a is not None:
        if local or not bug_compat:
            opt_s, opt_i, opt_j = m, int(ks[a]), t0 + 1
        else:
            # dpmatrix.h:868 assigns t1-1 instead of t0+1 here
            opt_s, opt_i, opt_j = m, int(ks[a]), t1 - 1

    res.set_tb(q0, t0, opt_i, opt_j, opt_s)
    return res


def build(c: DPCosts, direction: str = "fwd", local: bool = False,
          q0: int | None = None, q1: int | None = None,
          t0: int | None = None, t1: int | None = None,
          bug_compat: bool = True) -> DPResult:
    """Full or sub-rectangle build (DPMatrix::build / build_subdpm)."""
    q2, t2 = c.q_size, c.t_size
    q0 = 0 if q0 is None else q0
    t0 = 0 if t0 is None else t0
    q1 = q2 - 1 if q1 is None else q1
    t1 = t2 - 1 if t1 is None else t1
    if direction == "fwd":
        return build_forward(c, q0, q1, t0, t1, local=local)
    return build_reverse(c, q0, q1, t0, t1, local=local, bug_compat=bug_compat)
