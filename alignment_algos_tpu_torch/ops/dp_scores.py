"""Batched exact general-gap DP scores on PyTorch + CUDA (counterpart of
``alignment_algos_tpu/ops/dp_scores.py``).

The reference's O(Q*T*(Q+T)) forward recurrence (dpmatrix.h:356-536) on
host-exact cost tables.  One hand-written Hopper kernel carries it:

* :func:`dp_general` (K3, ``csrc/dp_general.cu``) returns H[q1, t1] per
  pair, or the full H.  It replaces the TPU's ``dp_scores._kernel`` and
  ``dp_pallas._kernel`` / ``_row_body``, which compute one function.
* :func:`dp_general_plain` is its plain PyTorch version: a loop over rows,
  vectorized over (n, t2), with the (n, t2, t2) deletion slab.

Exactness: every candidate value is fl(fl(H - cost) + sim) in the cost
tables' float32 values; the similarity is added after the masked max and
the local clamp comes last (dp_scores.py:29-33: fl(x + s) and max(0, x) are
monotone, so both orders give the same bits).  Max propagates NaN.  Kernel
and plain version therefore agree bit for bit, and both equal ``dp_ref``,
``dp_pallas`` and ``dp_scores`` of the JAX package.

The TPU's 8-pair sublane groups, 128-lane padding and VMEM cap have no
counterpart: the layout is (n, q2, t2), and a pair of any length runs in
K3 (no ``supported()`` gate, no fallback).  The bounds are the whole
matrix, q0 = t0 = 0, q1 = q2 - 1, t1 = t2 - 1, as every caller uses them.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

NEG = -3.0e38

__all__ = ["NEG", "dp_general", "dp_general_plain", "forward_scores_batch",
           "prepare_tables"]


# ----------------------------------------------------------- plain version

def _clamp(x: torch.Tensor, local: bool) -> torch.Tensor:
    return torch.clamp_min(x, 0.0) if local else x


def _neg_max(x: torch.Tensor, neg: torch.Tensor, dim: int) -> torch.Tensor:
    """max(NEG, max over ``dim``), NEG for an empty ``dim`` (K3 starts each
    candidate scan at NEG)."""
    if x.shape[dim] == 0:
        shape = list(x.shape)
        del shape[dim]
        return neg.expand(shape)
    return torch.maximum(neg, x.amax(dim=dim))


def dp_general_plain(S, D, Cm, ins0, insc, dclose, *, local: bool = False,
                     full_h: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K3 (see :func:`dp_general` for the
    shapes): rows in order, each row vectorized over (n, t2).

    Mirrors dp_pallas.py:97-177: row 0 zero; boundary row 1 from D[0, j]
    and column 1 from ins0; interior cells from the match, the masked
    deletion slab over k in [1, j-2] and the insertion history over gap
    distances m in [2, i-1]; the closing row holds only (q1, t1).  Returns
    H (n, q2, t2) or H[:, q1, t1] (n,)."""
    n, q2, t2 = S.shape
    q1, t1 = q2 - 1, t2 - 1
    dev = S.device
    neg = torch.full((), NEG, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    H = torch.zeros((n, q2, t2), dtype=torch.float32, device=dev)
    jj = torch.arange(t2, device=dev)
    kk = jj[:, None]
    dmask = (kk >= 1) & (kk <= jj[None, :] - 2)             # (k, j)
    interior = (jj >= 2) & (jj <= t1 - 1)

    brow = _clamp((0.0 - D[:, 0, :]) + S[:, 1, :], local)
    brow = torch.where(jj == 1, _clamp(S[:, 1, :], local), brow)
    H[:, 1] = torch.where((jj >= 1) & (jj <= t1 - 1), brow, zero)

    for i in range(2, q1):
        sim = S[:, i, :]
        hp = H[:, i - 1, :]
        match = _clamp(torch.cat([zero.expand(n, 1), hp[:, :-1]], 1) + sim,
                       local)
        slab = torch.where(dmask, hp[:, :, None] - D, neg)  # (n, k, j)
        del_ = _clamp(_neg_max(slab, neg, 1) + sim, local)
        # rows r = i - m for m = i-1 .. 2, at column j - 1
        hist = H[:, 1:i - 1, :-1]                           # (n, i-2, t2-1)
        cost = Cm[:, 2:i, 1:].flip(1)                       # m = i-1 .. 2
        ins = torch.cat([neg.expand(n, 1),
                         _neg_max(hist - cost, neg, 1)], 1)
        ins = _clamp(ins + sim, local)
        best = torch.maximum(match, torch.maximum(del_, ins))
        bcol = _clamp((0.0 - ins0[:, i:i + 1]) + sim[:, 1:2], local)
        row = torch.where(interior, best, zero)
        H[:, i] = torch.where(jj == 1, bcol, row)

    hp = H[:, q1 - 1, :]
    sc = S[:, q1, t1]
    match = _clamp(hp[:, t1 - 1] + sc, local)
    dacc = _neg_max(hp[:, 1:t1] - dclose[:, 1:t1], neg, 1)
    # m = 1 .. q1-1 reads row q1 - m at column t1 - 1
    iacc = _neg_max(H[:, 1:q1, t1 - 1].flip(1) - insc[:, 1:q1], neg, 1)
    best = torch.maximum(match, torch.maximum(_clamp(dacc + sc, local),
                                              _clamp(iacc + sc, local)))
    if not full_h:
        return best
    H[:, q1, t1] = best
    return H


# ------------------------------------------------------------------ kernel

def _check(S, D, Cm, ins0, insc, dclose):
    """Validate K3's input contract; returns (n, q2, t2)."""
    dev = S.device
    if S.dim() != 3:
        raise ValueError(f"S must be (n, q2, t2), got {tuple(S.shape)}")
    n, q2, t2 = S.shape
    want = {"S": (n, q2, t2), "D": (n, t2, t2), "Cm": (n, q2, t2),
            "ins0": (n, q2), "insc": (n, q2), "dclose": (n, t2)}
    for name, x in zip(want, (S, D, Cm, ins0, insc, dclose)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: expected torch.float32, got {x.dtype}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, S on {dev}")
        if tuple(x.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if n < 1 or q2 < 3 or t2 < 3:
        raise ValueError(f"K3 needs n >= 1, q2 >= 3 and t2 >= 3, got "
                         f"n={n}, q2={q2}, t2={t2}")
    return n, q2, t2


def dp_general(S, D, Cm, ins0, insc, dclose, *, local: bool = False,
               full_h: bool = False) -> torch.Tensor:
    """K3: exact general-gap forward DP for n same-shape pairs.

    S (n, q2, t2) similarity; D (n, t2, t2) deletion cost D[k, j]; Cm
    (n, q2, t2) insertion cost by gap distance m at column j; ins0 (n, q2)
    boundary-column insertion cost by row; insc (n, q2) closing-cell
    insertion cost by distance; dclose (n, t2) = D[:, :, t1].  All float32,
    contiguous, on one device.  Returns H[:, q1, t1] (n,), or with
    ``full_h`` the whole H (n, q2, t2).

    CPU tensors run :func:`dp_general_plain`; CUDA tensors launch the
    kernel (a build or launch failure raises)."""
    n, q2, t2 = _check(S, D, Cm, ins0, insc, dclose)
    if S.device.type == "cpu":
        return dp_general_plain(S, D, Cm, ins0, insc, dclose, local=local,
                                full_h=full_h)
    if S.device.type != "cuda":
        raise ValueError(f"no kernel for device {S.device}")
    lib = _build.load().lib
    H = torch.empty((n, q2, t2), dtype=torch.float32, device=S.device)
    out = torch.empty((n,), dtype=torch.float32, device=S.device)
    with torch.cuda.device(S.device):
        stream = torch.cuda.current_stream(S.device).cuda_stream
        err = lib.dp_general_launch(
            S.data_ptr(), D.data_ptr(), Cm.data_ptr(), ins0.data_ptr(),
            insc.data_ptr(), dclose.data_ptr(), H.data_ptr(), out.data_ptr(),
            n, q2, t2, int(bool(local)), stream)
    _build.check(err, "dp_general_launch")
    dp_general.launches += 1
    return H if full_h else out


dp_general.launches = 0


# -------------------------------------------------- tables and entry point

def prepare_tables(S, D, A, Bv, C, *, zero_head: bool, zero_tail: bool,
                   off: int, has_c: bool, vec_d: bool, del_free: bool):
    """Port of ``_prep_and_run``'s table build (dp_scores.py:309-378) on
    the tensors' device: returns K3's (S, D, Cm, ins0, insc, dclose).

    S (n, q2, t2); D (n, 2, t2) gap-init/extension vectors when ``vec_d``
    (rebuilt here into D[k, j] = min(gi)+min(ge)*(j-k-2), 0 for j-k < 2,
    with the overhang zeroing when ``del_free``), else (n, t2, t2); A, Bv,
    C (n, t2).  Each value is one multiply then one add (then + C), the
    reference's order; eager torch ops round each step and never fuse."""
    n, q2, t2 = S.shape
    dev = S.device
    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=dev)
    if vec_d:
        gi_v, ge_v = D[:, 0, :], D[:, 1, :]
        gp = torch.minimum(gi_v[:, :, None], gi_v[:, None, :])
        ep = torch.minimum(ge_v[:, :, None], ge_v[:, None, :])
        kk = torch.arange(t2, device=dev)[:, None]
        jj = torch.arange(t2, device=dev)[None, :]
        dist = (jj - kk).to(f32)
        D = gp + ep * (dist - 2.0)
        D = torch.where(jj - kk < 2, zero, D)
        if del_free:
            D[:, 0, :] = 0.0
            D[:, :, t2 - 1] = 0.0
    m = torch.arange(q2, device=dev).to(f32)
    Cm = A[:, None, :] + Bv[:, None, :] * (m[None, :, None] - float(off))
    if has_c:
        Cm = Cm + C[:, None, :]
    Cm = torch.where(m[None, :, None] < 2, zero, Cm)
    # ins0[b, i]: distance i at column 1; insc[b, m]: distance m at column t1
    t1 = t2 - 1
    i0 = A[:, 1:2] + Bv[:, 1:2] * (m[None] - float(off))
    ic = A[:, t1:t1 + 1] + Bv[:, t1:t1 + 1] * (m[None] - float(off))
    if has_c:
        i0 = i0 + C[:, 1:2]
        ic = ic + C[:, t1:t1 + 1]
    i0 = torch.where(m[None] < 2, zero, i0)
    ic = torch.where(m[None] < 2, zero, ic)
    if zero_head:
        i0 = torch.zeros_like(i0)
    if zero_tail:
        ic = torch.zeros_like(ic)
    return (S.contiguous(), D.contiguous(), Cm.contiguous(),
            i0.contiguous(), ic.contiguous(), D[:, :, t1].contiguous())


def forward_scores_batch(costs: list, local: bool = False, *,
                         device: torch.device) -> np.ndarray:
    """Optimal global scores H[q1, t1] for a batch of same-shape cost
    models (``DPCosts``), float32 (n,); bit-identical to the JAX
    ``dp_scores.forward_scores_batch`` and to ``dp_ref``.

    Only the per-pair data crosses to ``device`` (S, the two gap vectors or
    D, and the A/B/C insertion coefficients); the tables are built there
    (:func:`prepare_tables`) and K3 runs on them."""
    from ..scoring.base import _DEL_FREE_OVERHANG_MODES
    from . import dp_pallas

    q2, t2 = dp_pallas._bucket_shape(costs)
    if q2 < 3 or t2 < 3:
        return dp_pallas.forward_h_reference(costs, local=local)[:, -1, -1]

    vec_d = all(c.del_gi_vec is not None and c.del_align == costs[0].del_align
                for c in costs)
    if vec_d:
        D = np.stack([np.stack([c.del_gi_vec, c.del_ge_vec]) for c in costs])
    else:
        D = np.stack([c.D for c in costs])
    C = np.stack([np.zeros(t2, np.float32) if c.C is None
                  else c.C.astype(np.float32) for c in costs])
    S, D, A, Bv, C = (torch.from_numpy(np.ascontiguousarray(x, np.float32))
                      .to(device) for x in
                      (np.stack([c.S for c in costs]), D,
                       np.stack([c.A for c in costs]),
                       np.stack([c.B for c in costs]), C))
    tables = prepare_tables(
        S, D, A, Bv, C,
        zero_head=bool(costs[0].ins_zero_head_q),
        zero_tail=bool(costs[0].ins_zero_tail_q),
        off=int(costs[0].ins_dist_offset),
        has_c=any(c.C is not None for c in costs), vec_d=vec_d,
        del_free=bool(vec_d and costs[0].del_align
                      in _DEL_FREE_OVERHANG_MODES))
    return dp_general(*tables, local=local).cpu().numpy()
