"""O(Q*T) affine fast path for the general-gap forward build (round 5).

The reference recurrence (dpmatrix.h:447-486) scans EVERY deletion
predecessor k in the row and every insertion predecessor in the column —
O(Q*T*(Q+T)) — because gap costs are arbitrary tables.  For the
substitution evaluators the tables ARE affine with constant coefficients
(aasubalib.h: one gap_init/gap_extn pair), so the candidate scans
collapse to running prefix maxima:

  deletion:  v_k = H[i-1,k] - (gp + ep*(j-k-2)) + sim
           = (H[i-1,k] + ep*k) - gp - ep*(j-2) + sim
  insertion: v_k = H[k,j-1] - (gi + ge*(i-k-2)) + sim
           = (H[k,j-1] + ge*k) - gi - ge*(i-2) + sim

so one prefix-max over f_k = H[i-1,k] + ep*k (per row) and one running
column max of w_k = H[k,j-1] + ge*k (updated once per row) replace the
scans.  BYTE parity with ops/dp_ref is preserved because:

- the gate requires integer-valued similarity and gap costs with
  |values| < 2^22: every candidate is an exact f32 integer, so the
  reference's fl(fl(H - cost) + sim) equals the reassociated arithmetic
  exactly and max() is order-free;
- the reference's tie rules are replicated structurally: candidates
  replace the incumbent only when STRICTLY greater (match first, then
  deletions ascending k, then insertions ascending k), and the
  prefix/running argmaxes keep the FIRST k achieving the max (strict-
  improvement updates), which is np.argmax's first-max semantics;
- local clamping commutes: clamped-to-zero candidates can never
  strictly beat the (already >= 0) incumbent, so the unclamped argmax
  is decisive exactly when the reference's clamped one is;
- boundary rows/columns and the closing cell run the generic dp_ref
  formulas verbatim (they are O(Q+T)).

Full H/PQ/PT byte-equality vs dp_ref is asserted in
tests/test_dp_affine.py across alignment modes; DPMatrix routes here
for full forward builds when `affine_consts` accepts the cost model
(AAT_AFFINE_FAST=0 disables).
"""

from __future__ import annotations

import os

import numpy as np

from ..scoring.base import DPCosts
from .dp_ref import DPResult, F32, _ins_cost_vec


def affine_consts(c: DPCosts):
    """(gi, ge) when the cost model is constant-affine and integer-exact;
    None otherwise."""
    if os.environ.get("AAT_AFFINE_FAST", "1") == "0":
        return None
    if c.C is not None or c.ins_dist_offset != 2:
        return None
    if c.del_gi_vec is None or c.del_ge_vec is None or c.del_align is None:
        return None
    gi_v, ge_v = c.del_gi_vec, c.del_ge_vec
    gi, ge = float(gi_v[0]), float(ge_v[0])
    if not ((gi_v == gi_v[0]).all() and (ge_v == ge_v[0]).all()):
        return None
    # A/B must be the same constants (A[0]/B[0] pair with roll; for a
    # constant vector every entry equals the constant)
    if not ((c.A == F32(gi)).all() and (c.B == F32(ge)).all()):
        return None
    S = c.S
    bound = (abs(S).max() if S.size else 0) + max(abs(gi), abs(ge)) * \
        (c.q_size + c.t_size)
    # exactness tiers: order-free arithmetic needs every value to be a
    # multiple of 2^-m with all intermediates below 2^(24-m)
    if gi == round(gi) and ge == round(ge) and np.all(S == np.round(S)):
        if bound < 2 ** 22:
            return F32(gi), F32(ge)
        return None
    sc = 256.0
    if (gi * sc == round(gi * sc) and ge * sc == round(ge * sc)
            and np.all(S * sc == np.round(S * sc)) and bound < 2 ** 14):
        return F32(gi), F32(ge)
    return None


def build_forward_affine(c: DPCosts, q0: int, q1: int, t0: int, t1: int,
                         gi: np.float32, ge: np.float32,
                         local: bool = False,
                         res: DPResult | None = None) -> DPResult:
    """Byte-identical replacement for dp_ref.build_forward on
    constant-affine integer cost models (full-matrix forward builds)."""
    S, D = c.S, c.D
    if res is None:
        res = DPResult(c.q_size, c.t_size)
    H, PQ, PT = res.H, res.PQ, res.PT
    if q1 <= q0 or t1 <= t0:
        raise ValueError("Illegal bounds building DPM")
    if q1 == q0 + 1 or t1 == t0 + 1:
        from . import dp_ref
        return dp_ref.build_forward(c, q0, q1, t0, t1, local=local, res=res)
    s_init = F32(H[q0, t0])
    NEGI = F32(-(2 ** 24))

    def clamp(x):
        return np.maximum(F32(0.0), x) if local else x

    # boundary cells — generic dp_ref formulas (O(Q+T))
    res.set_tb(q0 + 1, t0 + 1, q0, t0,
               clamp(F32(s_init + S[q0 + 1, t0 + 1])))
    js = np.arange(t0 + 2, t1)
    if js.size:
        top = clamp(((s_init - D[t0, js]) + S[q0 + 1, js]
                     ).astype(np.float32))
        H[q0 + 1, js] = top
        PQ[q0 + 1, js] = q0
        PT[q0 + 1, js] = t0
    iss = np.arange(q0 + 2, q1)
    if iss.size:
        cost = c.ins_cost_of_dist(iss - q0, t0 + 1)
        if c.ins_zero_head_q and q0 == 0:
            cost = np.zeros_like(cost)
        left = clamp(((s_init - cost) + S[iss, t0 + 1]).astype(np.float32))
        H[iss, t0 + 1] = left
        PQ[iss, t0 + 1] = q0
        PT[iss, t0 + 1] = t0

    # interior sweep
    jj = np.arange(t0 + 2, t1)           # interior columns
    nj = jj.size
    t2 = c.t_size
    karange = np.arange(t2, dtype=np.float32)
    # running column max over k <= i-2 of w_k = H[k, col] + ge*k, and the
    # first k achieving it (strict-improvement updates keep the first)
    wmax = np.full(t2, NEGI, dtype=np.float32)
    warg = np.zeros(t2, dtype=np.int64)
    if nj:
        for i in range(q0 + 2, q1):
            # admit k = i - 2 into the column running max
            k = i - 2
            if k >= q0 + 1:
                wk = (H[k] + ge * F32(k)).astype(np.float32)
                better = wk > wmax
                wmax = np.where(better, wk, wmax)
                warg = np.where(better, k, warg)

            sim = S[i, jj]
            match = clamp((H[i - 1, jj - 1] + sim).astype(np.float32))
            opt_i = np.full(nj, i - 1, dtype=np.int64)
            opt_j = (jj - 1).astype(np.int64)

            # deletion prefix over k in [t0+1, j-2] of f_k = H[i-1,k]+ep*k
            f = (H[i - 1] + ge * karange).astype(np.float32)
            f[:t0 + 1] = NEGI
            rm = np.maximum.accumulate(f)
            prev_rm = np.concatenate(([NEGI], rm[:-1]))
            newm = f > prev_rm
            am = np.maximum.accumulate(
                np.where(newm, np.arange(t2), -1))
            have_del = jj - 2 >= t0 + 1
            dmax = rm[np.maximum(jj - 2, 0)]
            darg = am[np.maximum(jj - 2, 0)]
            dval = clamp(((dmax - gi) - ge * (jj - 2).astype(np.float32)
                          + sim).astype(np.float32))
            take_d = have_del & (dval > match)
            opt_s = np.where(take_d, dval, match).astype(np.float32)
            opt_j = np.where(take_d, darg, opt_j)
            # opt_i stays i-1 for both match and deletion

            # insertion from the column running max (k <= i-2, col j-1)
            have_ins = i - 2 >= q0 + 1
            if have_ins:
                ival = clamp(((wmax[jj - 1] - gi)
                              - ge * F32(i - 2) + sim).astype(np.float32))
                take_i = ival > opt_s
                opt_s = np.where(take_i, ival, opt_s).astype(np.float32)
                opt_i = np.where(take_i, warg[jj - 1], opt_i)
                opt_j = np.where(take_i, jj - 1, opt_j)

            H[i, jj] = opt_s
            PQ[i, jj] = opt_i
            PT[i, jj] = opt_j

    # closing cell (q1, t1) — generic dp_ref code
    sim = S[q1, t1]
    opt_i, opt_j = q1 - 1, t1 - 1
    opt_s = clamp(F32(H[q1 - 1, t1 - 1] + sim))
    ks = np.arange(t0 + 1, t1)
    cands = clamp(((H[q1 - 1, ks] - D[ks, t1]) + sim).astype(np.float32))
    if cands.size:
        m = cands.max()
        if m > opt_s:
            opt_s, opt_i, opt_j = m, q1 - 1, int(ks[int(np.argmax(cands))])
    ks = np.arange(q0 + 1, q1)
    cost = _ins_cost_vec(c, ks, q1, t1)
    cands = clamp(((H[ks, t1 - 1] - cost) + sim).astype(np.float32))
    if cands.size:
        m = cands.max()
        if m > opt_s:
            opt_s, opt_i, opt_j = m, int(ks[int(np.argmax(cands))]), t1 - 1
    res.set_tb(q1, t1, opt_i, opt_j, opt_s)
    return res
