"""ctypes bridge to the native SSSS phase-2 engine
(native/ssss_search.cpp): skeleton DFS + constrained-regrowth dedup +
filters, including tracking mode (culled-skeleton measurement against the
native alignment via the alidist area engine compiled into the same
shared object).  Falls back to the Python SkelSet search on any error;
AAT_SSSS_BACKEND=python forces the fallback."""

from __future__ import annotations

import ctypes
import os
import sys

import numpy as np

from ..native import build_native
from .skel_ali import SkelAli

_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_SRC = os.path.join(_DIR, "ssss_search.cpp")
_ALIDIST_SRC = os.path.join(_DIR, "alidist.cpp")

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    lib = build_native("ssss_search", [_SRC, _ALIDIST_SRC])
    if lib is None:
        return None
    lib.ssss_find_top_skels.restype = ctypes.c_long
    _lib = lib
    return lib


def _i32(a):
    return np.ascontiguousarray(a, dtype=np.int32)


def _ptr(a, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def find_top_skeletons_native(builder) -> bool:
    """Fill builder.Top_Skels (and, in tracking mode, the four culled-
    skeleton lists) via the C++ engine.  Returns False when the native
    path is unavailable (caller runs the Python search)."""
    if os.environ.get("AAT_SSSS_BACKEND", "auto") == "python":
        return False
    lib = _load()
    if lib is None:
        return False

    frags = []          # AliFrag in global-index order
    gidx = {}           # (sse_id, frag_id) -> global index
    cols = builder.Frags.Frag_Columns
    for col in cols:
        for f in col.Frags:
            gidx[(f.sse_id, f.frag_id)] = len(frags)
            frags.append(f)
    nf = len(frags)

    conn_objs = []      # FragConnection in global-connection order
    conn_off = np.zeros(nf + 1, dtype=np.int64)
    c_prev, c_next, c_pend, c_nbeg, c_score = [], [], [], [], []
    for i, f in enumerate(frags):
        conn_off[i] = len(conn_objs)
        for fc in f.next_frags:
            conn_objs.append(fc)
            c_prev.append(gidx[(fc.prev_frag.sse_idx, fc.prev_frag.frag_idx)])
            c_next.append(gidx[(fc.next_frag.sse_idx, fc.next_frag.frag_idx)])
            c_pend.append(fc.prev_end_res_idx)
            c_nbeg.append(fc.next_beg_res_idx)
            c_score.append(np.float32(fc.connection_score))
    conn_off[nf] = len(conn_objs)
    nc = len(conn_objs)
    if nc == 0:
        return False

    f_sse = _i32([f.sse_id for f in frags])
    f_fid = _i32([f.frag_id for f in frags])
    f_ct0 = _i32([f.core_t0() for f in frags])
    f_ct1 = _i32([f.core_t1() for f in frags])
    f_qt = _i32([f.qt() for f in frags])
    f_score = np.ascontiguousarray([f.ss() for f in frags], dtype=np.float32)
    f_cterm = np.ascontiguousarray(
        [1 if f.frag_is_C_terminal else 0 for f in frags], dtype=np.uint8)

    contacts = np.ascontiguousarray(builder.Str.templ_contacts,
                                    dtype=np.uint8)
    templ_len = contacts.shape[0]
    tsr_to_c = _i32(builder.Str.tsr_to_c)

    se = builder.Strand_Eval
    asp_rows = se.All_Strands_Paired
    asp_off = np.zeros(len(asp_rows) + 1, dtype=np.int64)
    np.cumsum([len(r) for r in asp_rows], out=asp_off[1:])
    asp_data = _i32([x for r in asp_rows for x in r] or [0])
    nmc = se.No_Missing_Cores
    nmc_data = _i32([x for t in nmc for x in t] or [0])

    ncap = gidx[(0, 0)]
    max_conns = len(cols) + 2
    out_conns = np.zeros((builder.max_alis, max_conns), dtype=np.int32)
    out_lens = np.zeros(builder.max_alis, dtype=np.int32)

    tracking = 1 if builder.tracking_mode else 0
    if tracking:
        m = builder.Measurer
        main_t = np.asarray([p.t for p in m.main_ali], dtype=np.float32)
        main_q = np.asarray([p.q for p in m.main_ali], dtype=np.float32)
        main_templ_len = float(m.templ_length)
    else:
        main_t = np.zeros(1, dtype=np.float32)
        main_q = np.zeros(1, dtype=np.float32)
        main_templ_len = 1.0
    cull_conns = np.zeros((4 * 100, max_conns), dtype=np.int32)
    cull_lens = np.zeros(4 * 100, dtype=np.int32)
    cull_shifts = np.zeros(4 * 100, dtype=np.float32)
    cull_cos = np.zeros(4 * 100, dtype=np.float32)
    cull_counts = np.zeros(4, dtype=np.int64)
    cull_totals = np.zeros(4, dtype=np.int64)

    n = lib.ssss_find_top_skels(
        _ptr(f_sse, ctypes.c_int32), _ptr(f_fid, ctypes.c_int32),
        _ptr(f_ct0, ctypes.c_int32), _ptr(f_ct1, ctypes.c_int32),
        _ptr(f_qt, ctypes.c_int32), _ptr(f_score, ctypes.c_float),
        _ptr(f_cterm, ctypes.c_uint8), ctypes.c_long(nf),
        _ptr(conn_off, ctypes.c_int64),
        _ptr(_i32(c_prev), ctypes.c_int32), _ptr(_i32(c_next), ctypes.c_int32),
        _ptr(_i32(c_pend), ctypes.c_int32), _ptr(_i32(c_nbeg), ctypes.c_int32),
        _ptr(np.ascontiguousarray(c_score, dtype=np.float32), ctypes.c_float),
        ctypes.c_long(nc), ctypes.c_long(ncap),
        _ptr(contacts, ctypes.c_uint8), ctypes.c_long(templ_len),
        _ptr(tsr_to_c, ctypes.c_int32),
        ctypes.c_long(builder.min_aligned_residues),
        ctypes.c_double(builder.min_SSE_CO),
        ctypes.c_long(builder.max_alis),
        _ptr(asp_data, ctypes.c_int32), _ptr(asp_off, ctypes.c_int64),
        ctypes.c_long(len(asp_rows)),
        _ptr(nmc_data, ctypes.c_int32), ctypes.c_long(len(nmc)),
        ctypes.c_int(1 if builder.strand_rule_bug_compat else 0),
        ctypes.c_int(tracking),
        _ptr(main_t, ctypes.c_float), _ptr(main_q, ctypes.c_float),
        ctypes.c_long(len(main_t)), ctypes.c_double(main_templ_len),
        _ptr(out_conns, ctypes.c_int32), _ptr(out_lens, ctypes.c_int32),
        ctypes.c_long(max_conns),
        _ptr(cull_conns, ctypes.c_int32), _ptr(cull_lens, ctypes.c_int32),
        _ptr(cull_shifts, ctypes.c_float), _ptr(cull_cos, ctypes.c_float),
        _ptr(cull_counts, ctypes.c_int64), _ptr(cull_totals, ctypes.c_int64))
    if n < 0:
        return False

    def replay(ids):
        fcs = [conn_objs[int(j)] for j in ids]
        sa = SkelAli(builder.Str, builder.Frags, fcs[0], 0)
        for fc in fcs[1:]:
            sa.add_connection(fc)
        return sa

    # rebuild SkelAli objects by replaying the connection sequences (the
    # replay recomputes score/coverage/contacts identically)
    tops = []
    for i in range(n):
        sa = replay(out_conns[i, : out_lens[i]])
        sa.calc_skel_SSE_CO()
        sa.param = sa.get_score()
        tops.append(sa)
    builder.Top_Skels = tops

    if tracking:
        lists = (builder.Low_Coverage, builder.Low_SSE_CO,
                 builder.Bad_Strands, builder.Low_Score)
        for r, lst in enumerate(lists):
            lst.clear()
            for i in range(int(cull_counts[r])):
                row = r * 100 + i
                sa = replay(cull_conns[row, : cull_lens[row]])
                sa.shift = float(cull_shifts[row])
                sa.param = sa.shift
                sa.SSE_CO = float(cull_cos[row])
                lst.append(sa)
    counts = cull_totals if tracking else [0, 0, 0, 0]
    for reason, label in ((1, "coverage"), (2, "contact order"),
                          (3, "strand rules"), (4, "score")):
        print(f"Num culled by {label}: {int(counts[reason - 1])}",
              file=sys.stderr)
    return True
