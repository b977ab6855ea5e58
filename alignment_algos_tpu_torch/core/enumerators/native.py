"""ctypes bridge to the native enumeration engine (native/enumerate.cpp).

Provides drop-in equivalents of the cw/ucw/kscw/crcw enumerators that run
the recursive traceback in C++ over the device-computed DP arrays — the
same byte-level semantics (verified against the Python implementations and
the reference oracle), ~2 orders of magnitude faster on large enumerations.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ...native import build_native
from ..alignment import Alignment

_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_SRC = os.path.join(_DIR, "enumerate.cpp")

MODES = {"cw": 0, "ucw": 1, "kscw": 2, "crcw": 3}


class _Result(ctypes.Structure):
    _fields_ = [
        ("n_alis", ctypes.c_int32),
        ("pair_counts", ctypes.POINTER(ctypes.c_int32)),
        ("scores", ctypes.POINTER(ctypes.c_float)),
        ("uids", ctypes.POINTER(ctypes.c_int32)),
        ("pairs", ctypes.POINTER(ctypes.c_int32)),
        ("count_redundant", ctypes.c_uint32),
        ("count_subpaths", ctypes.c_uint32),
    ]


_lib = None


def load() -> ctypes.CDLL | None:
    global _lib
    if _lib is not None:
        return _lib
    lib = build_native("enumerate", [_SRC])
    if lib is None:
        return None
    lib.enumerate_tracebacks.restype = ctypes.POINTER(_Result)
    lib.enumerate_tracebacks.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_float, ctypes.c_uint, ctypes.c_uint,
        ctypes.c_uint, ctypes.c_float,
    ]
    lib.free_result.argtypes = [ctypes.POINTER(_Result)]
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def enumerate_native(mode: str, dpm, params, subopt=None) -> list[Alignment]:
    """Run one enumerator natively; returns the sorted/truncated alignments
    (the sortSet step runs inside the engine)."""
    lib = load()
    if lib is None:
        raise RuntimeError("native enumeration engine unavailable")
    c = dpm.costs
    q2, t2 = c.q_size, c.t_size
    H = np.ascontiguousarray(dpm.res.H, dtype=np.float32)
    PQ = np.ascontiguousarray(dpm.res.PQ, dtype=np.int32)
    PT = np.ascontiguousarray(dpm.res.PT, dtype=np.int32)
    S = np.ascontiguousarray(c.S, dtype=np.float32)
    D = np.ascontiguousarray(c.D, dtype=np.float32)
    A = np.ascontiguousarray(c.A, dtype=np.float32)
    B = np.ascontiguousarray(c.B, dtype=np.float32)
    has_C = c.C is not None
    C = np.ascontiguousarray(c.C if has_C else np.zeros(t2), dtype=np.float32)
    if subopt is not None:
        flags = np.ascontiguousarray(subopt.flags.astype(np.uint8))
    else:
        flags = np.ones(t2, dtype=np.uint8)

    res = lib.enumerate_tracebacks(
        MODES[mode], q2, t2, _fptr(H), _iptr(PQ), _iptr(PT), _fptr(S),
        _fptr(D), _fptr(A), _fptr(B), _fptr(C), int(has_C),
        int(c.ins_dist_offset), int(c.ins_zero_head_q),
        int(c.ins_zero_tail_q),
        flags.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        int(params.number_suboptimal), float(params.delta_ratio),
        int(params.k_limit), int(params.sort_limit), int(params.user_limit),
        float(params.max_overlap))
    try:
        from collections import deque
        r = res.contents
        n = r.n_alis
        if n == 0:
            return []
        counts = np.ctypeslib.as_array(r.pair_counts, shape=(n,))
        scores = np.ctypeslib.as_array(r.scores, shape=(n,))
        uids = np.ctypeslib.as_array(r.uids, shape=(n,))
        total = int(counts.sum())
        # bulk-materialize: one flat copy + per-alignment zip, instead of
        # a Python-level append per pair (the per-pair loop was ~95% of
        # the enumeration wall at production NUM_SUBOPT)
        flat = np.ctypeslib.as_array(r.pairs, shape=(2 * total,))
        qs = flat[0::2].tolist()
        ts = flat[1::2].tolist()
        out = []
        off = 0
        for i in range(n):
            npairs = int(counts[i])
            a = Alignment()
            a.score = float(scores[i])
            a.uid = int(uids[i])
            a.pairs = deque(zip(qs[off:off + npairs], ts[off:off + npairs]))
            off += npairs
            out.append(a)
        return out
    finally:
        lib.free_result(res)
