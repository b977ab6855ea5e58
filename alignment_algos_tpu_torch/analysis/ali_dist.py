"""Alignment-distance metric (ali_dist.{h,cpp}).

Treats two alignments as piecewise-linear curves in (template, query) space:
classify each vertex above/below/on the other curve, insert pairwise segment
intersections and matching-abscissa points into both polylines, then sum
signed trapezoid differences.  dist = area / template_length.
Float32 arithmetic throughout, as the reference's ``float`` math.
"""

from __future__ import annotations

import numpy as np

F32 = np.float32


class ResPair:
    __slots__ = ("t", "q", "rel_pos")

    def __init__(self, t, q, rel_pos=-2):
        self.t = F32(t)
        self.q = F32(q)
        self.rel_pos = rel_pos

    def __repr__(self):
        return f"({self.t},{self.q})"


def strings_to_vrp(templ: str, query: str) -> list[ResPair]:
    """Gapped strings -> matched-pair polyline; '^'/'$' count as residues so
    the head pair is (0,0) (ali_dist.cpp:10-41)."""
    if len(templ) != len(query):
        raise ValueError("Sequences are of unequal lengths.")
    vrp = []
    ti = qi = 0
    for tc, qc in zip(templ, query):
        if tc != "-" and qc != "-":
            vrp.append(ResPair(ti, qi))
            ti += 1
            qi += 1
        elif tc != "-":
            ti += 1
        elif qc != "-":
            qi += 1
    return vrp


def pairs_to_vrp(pairs) -> list[ResPair]:
    """(q,t) index pairs (Alignment.pairs convention) -> polyline."""
    return [ResPair(t, q) for q, t in pairs]


def _seq_length_str(s: str) -> int:
    return sum(1 for c in s if c not in "-^$")


def _format_string_ends(s: str) -> str:
    if s.endswith("*"):
        s = s[:-1]
    if not s.startswith("^"):
        s = "^" + s
    if not s.endswith("$"):
        s = s + "$"
    return s


class AliDist:
    def __init__(self) -> None:
        self.main_ali: list[ResPair] = []
        self.test_ali: list[ResPair] = []
        self.templ_length = 0
        self.query_length = 0
        self.batch_dists: list[list[float]] = []
        self._main_arr = None  # cached (t, q) float32 arrays (native path)

    # ---- loading ------------------------------------------------------
    def load_main_fasta(self, fn: str) -> None:
        """2-record gapped FASTA (template first), ali_dist.cpp load_main."""
        with open(fn) as f:
            lines = f.read().splitlines()
        i = 0
        while i < len(lines) and not lines[i].startswith(">"):
            i += 1
        i += 1
        templ = ""
        while i < len(lines) and not lines[i].startswith(">"):
            templ += lines[i]
            i += 1
        i += 1
        query = ""
        while i < len(lines):
            query += lines[i]
            i += 1
        templ = _format_string_ends(templ)
        query = _format_string_ends(query)
        self.templ_length = _seq_length_str(templ)
        self.query_length = _seq_length_str(query)
        self.main_ali = strings_to_vrp(templ, query)
        self._main_arr = None

    def load_main_vrp(self, vrp: list[ResPair]) -> None:
        self.main_ali = list(vrp)
        self.templ_length = int(vrp[-1].t) - 1
        self.query_length = int(vrp[-1].q) - 1
        self._main_arr = None

    def load_test_vrp(self, vrp: list[ResPair]) -> None:
        self.test_ali = list(vrp)

    # ---- geometry -----------------------------------------------------
    @staticmethod
    def _relative_position(t, q, pts: list[ResPair]) -> int:
        """+1 above / -1 below / 0 on the polyline (ali_dist.cpp:160-218)."""
        nxt = 1
        while nxt < len(pts) and pts[nxt].t < t:
            nxt += 1
        if nxt >= len(pts):
            raise ValueError("get_rel_pos: point outside alignment range")
        p, n = pts[nxt - 1], pts[nxt]
        if t == n.t:
            if q == n.q:
                return 0
            return 1 if q > n.q else -1
        m = F32((n.q - p.q) / (n.t - p.t))
        b = F32(p.q - m * p.t)
        shadow = F32(m * F32(t) + b)
        if q == shadow:
            return 0
        return 1 if q > shadow else -1

    @staticmethod
    def _advance(a1, a2, i1, i2):
        """Move up whichever 'next' pointer trails (both if even)."""
        if a1[i1].t < a2[i2].t:
            return i1 + 1, i2
        if a1[i1].t > a2[i2].t:
            return i1, i2 + 1
        return i1 + 1, i2 + 1

    def _insert_intersections(self, a1: list[ResPair], a2: list[ResPair]):
        i1 = i2 = 1
        while i1 < len(a1) and i2 < len(a2):
            p1, n1 = a1[i1 - 1], a1[i1]
            p2, n2 = a2[i2 - 1], a2[i2]
            if (p1.rel_pos * n1.rel_pos == -1) or (p2.rel_pos * n2.rel_pos == -1):
                m1 = F32((n1.q - p1.q) / (n1.t - p1.t))
                m2 = F32((n2.q - p2.q) / (n2.t - p2.t))
                if m1 == m2:
                    i1, i2 = self._advance(a1, a2, i1, i2)
                    continue
                xp = F32((F32(p1.q - p2.q) - F32(m1 * p1.t - m2 * p2.t))
                         / F32(m2 - m1))
                yp = F32(p1.q + m1 * F32(xp - p1.t))
                if not (p1.t < xp < n1.t and p2.t < xp < n2.t):
                    i1, i2 = self._advance(a1, a2, i1, i2)
                    continue
                pt = ResPair(xp, yp, 0)
                a1.insert(i1, ResPair(xp, yp, 0))
                a2.insert(i2, ResPair(xp, yp, 0))
                # next pointers now reference the inserted point
            else:
                i1, i2 = self._advance(a1, a2, i1, i2)

    def _insert_matching_points(self, a1: list[ResPair], a2: list[ResPair]):
        i1 = i2 = 1
        while i1 < len(a1) and i2 < len(a2):
            n1, n2 = a1[i1], a2[i2]
            if n1.t != n2.t:
                if n1.t < n2.t:  # add point to a2
                    p2 = a2[i2 - 1]
                    m = F32((n2.q - p2.q) / (n2.t - p2.t))
                    b = F32(p2.q - m * p2.t)
                    shadow = F32(m * n1.t + b)
                    a2.insert(i2, ResPair(n1.t, shadow, -1 * n1.rel_pos))
                else:
                    p1 = a1[i1 - 1]
                    m = F32((n1.q - p1.q) / (n1.t - p1.t))
                    b = F32(p1.q - m * p1.t)
                    shadow = F32(m * n2.t + b)
                    a1.insert(i1, ResPair(n2.t, shadow, -1 * n2.rel_pos))
            else:
                i1 += 1
                i2 += 1

    @staticmethod
    def _area_between(a1: list[ResPair], a2: list[ResPair]) -> float:
        if len(a1) != len(a2):
            raise ValueError("Alignments must be the same size before "
                             "calculating area.")
        total = F32(0.0)
        for i in range(1, len(a2)):
            if a1[i - 1].rel_pos == 0 and a1[i].rel_pos == 0:
                continue
            area1 = F32(F32((a1[i].q + a1[i - 1].q) / F32(2.0))
                        * F32(a1[i].t - a1[i - 1].t))
            area2 = F32(F32((a2[i].q + a2[i - 1].q) / F32(2.0))
                        * F32(a2[i].t - a2[i - 1].t))
            if a1[i - 1].rel_pos > 0 or a1[i].rel_pos > 0:
                total = F32(total + F32(area1 - area2))
            else:
                total = F32(total + F32(area2 - area1))
        return float(total)

    # ---- coverage -----------------------------------------------------
    def _mutual_coverage(self, attr: str) -> float:
        common = 0
        avg = F32((len(self.main_ali) - 2 + len(self.test_ali) - 2)) / F32(2.0)
        i = j = 1
        while i < len(self.main_ali) and j < len(self.test_ali):
            a = getattr(self.main_ali[i], attr)
            b = getattr(self.test_ali[j], attr)
            if a == b:
                common += 1
                i += 1
                j += 1
            elif a < b:
                i += 1
            else:
                j += 1
        return float(F32(common) / avg)

    # ---- public API ---------------------------------------------------
    def get_area_between_main_and_test(self) -> float:
        # native engine fast path (bit-identical float32 op order): SSSS
        # tracking mode measures every culled skeleton — 500k+ calls on
        # realistic fixtures, 80%+ of tracking wall time in pure Python
        lib = _load_native()
        if lib is not None:
            import ctypes
            if getattr(self, "_main_arr", None) is None:
                self._main_arr = (
                    np.asarray([p.t for p in self.main_ali], np.float32),
                    np.asarray([p.q for p in self.main_ali], np.float32))
            mt, mq = self._main_arr
            ts = np.asarray([p.t for p in self.test_ali], np.float32)
            qs = np.asarray([p.q for p in self.test_ali], np.float32)
            offs = np.array([0, len(ts)], np.int64)
            out = np.zeros(1, np.float32)
            rc = lib.ali_area_one_to_many(
                mt.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                mq.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                ctypes.c_long(len(mt)),
                ts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                qs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                ctypes.c_long(1),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            if rc == 0:
                return float(out[0])
        main_tmp = [ResPair(p.t, p.q, p.rel_pos) for p in self.main_ali]
        for p in main_tmp:
            p.rel_pos = self._relative_position(p.t, p.q, self.test_ali)
        for p in self.test_ali:
            p.rel_pos = self._relative_position(p.t, p.q, main_tmp)
        self._insert_intersections(main_tmp, self.test_ali)
        self._insert_matching_points(main_tmp, self.test_ali)
        return self._area_between(main_tmp, self.test_ali)

    def get_dist_between_main_and_test(self) -> float:
        return float(F32(self.get_area_between_main_and_test())
                     / F32(self.templ_length))

    def batch_compare_to_main_ali(self, fn: str) -> None:
        """Parse concatenated PIR blocks, tabulating dist + coverages
        (ali_dist.cpp:568-604).  Areas go through the native batch engine
        when available (bit-identical to the in-place path)."""
        with open(fn) as f:
            text = f.read()
        vrps = [strings_to_vrp(t, q) for t, q in _iter_pir_strings(text)]
        covs = []
        for vrp in vrps:
            self.test_ali = vrp
            covs.append((self._mutual_coverage("t"),
                         self._mutual_coverage("q")))
        areas = area_one_to_many(self.main_ali, vrps)
        for (tmc, qmc), area in zip(covs, areas):
            dist = float(F32(area) / F32(self.templ_length))
            self.batch_dists.append([dist, tmc, qmc, float(F32(tmc) * F32(qmc))])

    def print_batch_dists(self, out) -> None:
        out.write("ali#\tshift\tmin_shift\n")
        min_idx, min_dist = -1, float("inf")
        for i, row in enumerate(self.batch_dists):
            if row[0] < min_dist:
                min_dist = row[0]
                min_idx = i
            out.write(f"{i + 1}\t{_g(row[0])}\t{_g(min_dist)}\t"
                      f"{_g(row[1])}\t{_g(row[2])}\t{_g(row[3])}\n")
        out.write(f"Rank of closest:  {min_idx + 1}\n")
        out.write(f"Shift of closest: {_g(min_dist)}\n")

    def get_local_native_ali(self, t_beg: int, t_end: int) -> list[ResPair]:
        res = []
        idx = 0
        while idx < len(self.main_ali) and self.main_ali[idx].t < t_beg:
            idx += 1
        if idx < len(self.main_ali) and self.main_ali[idx].t < t_end:
            while idx < len(self.main_ali) and self.main_ali[idx].t <= t_end:
                res.append(self.main_ali[idx])
                idx += 1
        return res

    def get_local_qt_shift(self, t_beg: int, t_end: int) -> float:
        local = self.get_local_native_ali(t_beg, t_end)
        if not local:
            raise ValueError(f"No native pairs between template residues "
                             f"{t_beg} and {t_end}.")
        s = F32(0.0)
        for p in local:
            s = F32(s + F32(p.q - p.t))
        return float(F32(s / F32(len(local))))


def _g(v: float) -> str:
    return f"{float(v):.6g}"


# ---- native all-pairs engine (native/alidist.cpp) ----------------------

_native_lib = None
_native_tried = False


def _load_native():
    """Self-building ctypes bridge, same pattern as core/enumerators/native:
    AAT_ALIDIST_BACKEND=python forces the host implementation."""
    global _native_lib, _native_tried
    import os
    if os.environ.get("AAT_ALIDIST_BACKEND", "auto") == "python":
        return None
    if _native_lib is not None or _native_tried:
        return _native_lib
    _native_tried = True
    import ctypes
    from ..native import build_native
    d = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "native")
    src = os.path.join(d, "alidist.cpp")
    lib = build_native("alidist", [src])
    if lib is None:
        return None
    lib.ali_area_matrix.restype = ctypes.c_long
    lib.ali_area_one_to_many.restype = ctypes.c_long
    _native_lib = lib
    return lib


def _vrps_to_arrays(vrps):
    ts = np.concatenate([[p.t for p in v] for v in vrps]).astype(np.float32)
    qs = np.concatenate([[p.q for p in v] for v in vrps]).astype(np.float32)
    offs = np.zeros(len(vrps) + 1, dtype=np.int64)
    np.cumsum([len(v) for v in vrps], out=offs[1:])
    return ts, qs, offs


def area_matrix(vrps: list[list[ResPair]]) -> np.ndarray:
    """Symmetric K x K exact area matrix over alignment polylines.  Native
    C++ engine when available (bit-identical float32 op order), pure-Python
    AliDist otherwise."""
    import ctypes
    k = len(vrps)
    out = np.zeros((k, k), dtype=np.float32)
    lib = _load_native()
    if lib is not None and k:
        ts, qs, offs = _vrps_to_arrays(vrps)
        rc = lib.ali_area_matrix(
            ts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            qs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_long(k),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc == 0:
            return out
    X = AliDist()
    for i in range(k):
        X.load_main_vrp(vrps[i])
        for j in range(i):
            X.load_test_vrp(vrps[j])
            a = np.float32(X.get_area_between_main_and_test())
            out[i, j] = out[j, i] = a
    return out


def area_one_to_many(main_vrp: list[ResPair],
                     test_vrps: list[list[ResPair]]) -> np.ndarray:
    """Exact areas of one polyline vs many (get_shifts batch shape)."""
    import ctypes
    k = len(test_vrps)
    out = np.zeros(k, dtype=np.float32)
    lib = _load_native()
    if lib is not None and k:
        mt = np.asarray([p.t for p in main_vrp], dtype=np.float32)
        mq = np.asarray([p.q for p in main_vrp], dtype=np.float32)
        ts, qs, offs = _vrps_to_arrays(test_vrps)
        rc = lib.ali_area_one_to_many(
            mt.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            mq.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_long(len(main_vrp)),
            ts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            qs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_long(k),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc == 0:
            return out
    X = AliDist()
    X.load_main_vrp(main_vrp)
    for j in range(k):
        X.load_test_vrp(test_vrps[j])
        out[j] = np.float32(X.get_area_between_main_and_test())
    return out


def _iter_pir_strings(text: str):
    """Yield (templ, query) gapped strings per #start block, with sentinel
    bracketing (ali_dist.cpp extract_next_ali)."""
    lines = text.splitlines()
    i = 0
    n = len(lines)
    while True:
        while i < n and "#start" not in lines[i]:
            i += 1
        if i >= n:
            return
        while i < n and "structure" not in lines[i]:
            i += 1
        i += 1
        templ = ""
        while i < n:
            templ += lines[i]
            if lines[i] == "" or templ.endswith("*"):
                i += 1
                break
            i += 1
        while i < n and "sequence" not in lines[i]:
            i += 1
        i += 1
        query = ""
        while i < n:
            query += lines[i]
            if lines[i] == "" or query.endswith("*"):
                i += 1
                break
            i += 1
        yield _format_string_ends(templ), _format_string_ends(query)
