"""General-gap DP builds with tracebacks on PyTorch + CUDA (counterpart of
``alignment_algos_tpu/ops/dp_engine.py``).

The reference recurrence (dpmatrix.h:356-536) over a bounded rectangle
(q0, q1, t0, t1), forward or reverse, local or global, returning H and the
traceback pointers PQ/PT that every enumerator walks.  One hand-written
Hopper kernel carries it:

* :func:`dp_forward_tb` (K7, ``csrc/dp_traceback.cu``) replaces the TPU's
  ``dp_engine._dp_forward`` (a ``lax.scan`` over rows) and its vmap
  ``_dp_forward_batched``: n same-shape pairs, one thread-block cluster
  each, its interior columns cut over the cluster's blocks by
  :func:`k7_plan` (a pure function of the shapes, which also picks the
  memory mode: D and Cm resident in shared memory, or streamed).
* :func:`dp_forward_tb_plain` is its plain PyTorch version: rows in order,
  each vectorized over (n, t2), with the (n, t2, t2) deletion slab and the
  (n, rows, t2) insertion history.

Exactness (tolerance 0 against ``dp_engine`` and ``dp_ref``): every
candidate is clamp(fl(fl(H - cost) + s)) in the host tables' float32
values, compared *after* the add and the clamp, because two candidates
that differ before the add can round to one value after it, and the first
of them must win.  Deletions and insertions each take their first maximum
in ascending predecessor index; match, then deletion, then insertion, each
replacing the incumbent only when strictly greater (dp_engine.py:102-111).

The cost tables stay on the host (numpy, the reference's multiply-then-add)
and the kernel multiplies nothing.  The reverse build runs the forward
build on the mirrored cost model, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..scoring.base import DPCosts
from ..utils import profiling
from . import _build, dp_ref
from .dp_ref import NULL, DPResult
from .dp_pallas import _bucket_shape, _host_tables
from .dp_scores import NEG

__all__ = ["K7Plan", "build_forward", "build_forward_batched",
           "build_reverse", "device_tables", "dp_forward_tb",
           "dp_forward_tb_plain", "k7_candidates", "k7_plan", "launch_plan"]


# ----------------------------------------------------------- plain version

def _first_max(x: torch.Tensor, neg: torch.Tensor, dim: int):
    """(value at the first argmax, first argmax) over ``dim``; (NEG, 0)
    where ``dim`` is empty (``jnp.max``/``jnp.argmax`` over an all-NEG
    masked axis).  The value is gathered, not ``amax``: its bits are the
    first maximum's on every device (a -0.0 before a +0.0 stays -0.0), as
    K7's are."""
    if x.shape[dim] == 0:
        shape = list(x.shape)
        del shape[dim]
        return (neg.expand(shape),
                torch.zeros(shape, dtype=torch.int64, device=x.device))
    arg = x.argmax(dim=dim)
    return x.gather(dim, arg.unsqueeze(dim)).squeeze(dim), arg


def dp_forward_tb_plain(S, D, Cm, ins0, insc, *, q0: int, q1: int, t0: int,
                        t1: int, local: bool = False):
    """Plain PyTorch version of K7 (see :func:`dp_forward_tb` for the
    shapes): mirrors ``_dp_forward``'s boundary row and column, its
    ``step`` (dp_engine.py:75-117) for each interior row and its closing
    cell (:124-149).  Returns (H, PQ, PT)."""
    n, q2, t2 = S.shape
    dev = S.device
    f32, i32 = torch.float32, torch.int32
    neg = torch.full((), NEG, dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)

    def clamp(x):
        return torch.maximum(zero, x) if local else x

    H = torch.zeros((n, q2, t2), dtype=f32, device=dev)
    PQ = torch.full((n, q2, t2), NULL, dtype=i32, device=dev)
    PT = torch.full((n, q2, t2), NULL, dtype=i32, device=dev)
    jj = torch.arange(t2, device=dev)

    # boundary row q0+1 and column t0+1: from the origin (q0, t0)
    brow = clamp((0.0 - D[:, t0, :]) + S[:, q0 + 1, :])
    brow = torch.where(jj == t0 + 1, clamp(0.0 + S[:, q0 + 1, :]), brow)
    H[:, q0 + 1, t0 + 1:t1] = brow[:, t0 + 1:t1]
    H[:, q0 + 2:q1, t0 + 1] = clamp((0.0 - ins0[:, q0 + 2:q1])
                                    + S[:, q0 + 2:q1, t0 + 1])
    for P, origin in ((PQ, q0), (PT, t0)):
        P[:, q0 + 1, t0 + 1:t1] = origin
        P[:, q0 + 2:q1, t0 + 1] = origin

    kk = jj[:, None]
    del_mask = (kk >= t0 + 1) & (kk <= jj[None, :] - 2)       # (k, j)
    cols = slice(t0 + 2, t1)                                  # interior j
    prev_col = (jj - 1).to(i32).expand(n, t2)
    for i in range(q0 + 2, q1):
        sim = S[:, i, :]
        hp = H[:, i - 1, :]
        match = clamp(torch.cat([hp[:, :1], hp[:, :-1]], 1) + sim)
        dc = clamp((hp[:, :, None] - D) + sim[:, None, :])   # (n, k, j)
        del_max, del_arg = _first_max(torch.where(del_mask, dc, neg), neg, 1)
        # rows k = q0+1 .. i-2 at column j-1, cost by distance i-k
        hist = torch.cat([zero.expand(n, i - q0 - 2, 1),
                          H[:, q0 + 1:i - 1, :-1]], 2)
        cost = Cm[:, 2:i - q0, :].flip(1)
        ins_max, ins_arg = _first_max(clamp((hist - cost) + sim[:, None, :]),
                                      neg, 1)
        bq = torch.full((n, t2), i - 1, dtype=i32, device=dev)
        use_del = del_max > match
        best = torch.where(use_del, del_max, match)
        bt = torch.where(use_del, del_arg.to(i32), prev_col)
        use_ins = ins_max > best
        best = torch.where(use_ins, ins_max, best)
        bq = torch.where(use_ins, (ins_arg + (q0 + 1)).to(i32), bq)
        bt = torch.where(use_ins, prev_col, bt)
        H[:, i, cols] = best[:, cols]
        PQ[:, i, cols] = bq[:, cols]
        PT[:, i, cols] = bt[:, cols]

    # closing cell (q1, t1)
    sc = S[:, q1, t1]
    match = clamp(H[:, q1 - 1, t1 - 1] + sc)
    del_max, del_arg = _first_max(
        clamp((H[:, q1 - 1, t0 + 1:t1] - D[:, t0 + 1:t1, t1]) + sc[:, None]),
        neg, 1)
    ins_max, ins_arg = _first_max(
        clamp((H[:, q0 + 1:q1, t1 - 1] - insc[:, q0 + 1:q1]) + sc[:, None]),
        neg, 1)
    bq = torch.full((n,), q1 - 1, dtype=i32, device=dev)
    use_del = del_max > match
    best = torch.where(use_del, del_max, match)
    bt = torch.where(use_del, (del_arg + (t0 + 1)).to(i32),
                     torch.full_like(bq, t1 - 1))
    use_ins = ins_max > best
    H[:, q1, t1] = torch.where(use_ins, ins_max, best)
    PQ[:, q1, t1] = torch.where(use_ins, (ins_arg + (q0 + 1)).to(i32), bq)
    PT[:, q1, t1] = torch.where(use_ins, torch.full_like(bq, t1 - 1), bt)
    return H, PQ, PT


# ------------------------------------------------------- K7's launch plan

K7_THREADS = 1024            # csrc/dp_traceback.cu kThreads
K7_CLUSTERS = (16, 8)        # blocks per pair, the first the card places
K7_SMEM_LIMIT = 232_448      # shared memory a block opts into on an H100


@dataclass(frozen=True)
class K7Plan:
    """How K7 runs one shape: ``mode`` ("resident": each block keeps its
    columns of D and Cm and their insertion history in shared memory;
    "streamed": those stay in device memory), ``cluster`` blocks per pair,
    block b owning the interior columns [cuts[b], cuts[b+1]), and the
    dynamic shared memory each block is given."""
    mode: str
    cluster: int
    cuts: tuple
    smem_bytes: int


def k7_candidates(q0: int, q1: int, t0: int, t1: int) -> np.ndarray:
    """Gap candidates K7 scans for each interior column j in [t0+2, t1-1]
    over the whole build: per interior row i, j - t0 - 2 deletions and
    i - q0 - 2 insertions."""
    rows = q1 - q0 - 2
    j = np.arange(t0 + 2, t1, dtype=np.int64)
    return rows * (j - t0 - 2) + rows * (rows - 1) // 2


def _cut(weights: np.ndarray, parts: int) -> list:
    """parts + 1 offsets into ``weights`` that cut it into contiguous runs
    of near-equal sums (each offset the nearest to its share); equal
    widths where every weight is 0."""
    n, total = len(weights), int(weights.sum())
    if total == 0:
        return [b * n // parts for b in range(parts + 1)]
    prefix = np.concatenate([[0], np.cumsum(weights)])
    out = [0]
    for b in range(1, parts):
        target = b * total / parts
        m = int(np.searchsorted(prefix, target))
        if m > 0 and target - prefix[m - 1] <= prefix[m] - target:
            m -= 1
        out.append(max(m, out[-1]))
    return out + [n]


def k7_smem_bytes(mode: str, q2: int, t2: int, q0: int, q1: int, t0: int,
                  cuts) -> int:
    """The largest dynamic shared memory any block of the plan needs
    (``dp_traceback.cu`` ``smem_floats``): two rows of t2, the parts'
    (value, k) pairs of both gap kinds, then per block its columns' D rows
    t0+1 .. hi-3, Cm distances 2 .. q1-q0-2 and history rows q0+1 .. q1-3
    (resident), or the history of the column left of its slice
    (streamed)."""
    base = 2 * t2 + 4 * K7_THREADS
    if mode == "streamed":
        return 4 * (base + q2)
    cm_rows = max(0, q1 - q0 - 3)
    need = max((hi - lo) * (max(0, hi - 3 - t0) + 2 * cm_rows)
               for lo, hi in zip(cuts[:-1], cuts[1:]))
    return 4 * (base + need)


@functools.lru_cache(maxsize=256)
def k7_plan(q2: int, t2: int, q0: int, q1: int, t0: int, t1: int,
            cluster: int = 16, smem_limit: int = K7_SMEM_LIMIT) -> K7Plan:
    """K7's plan for one shape: the interior columns cut over ``cluster``
    blocks by equal gap-candidate counts (:func:`k7_candidates`: the right
    columns scan longer deletion rows, so their slices are narrower), and
    the resident mode where its shared memory fits ``smem_limit``, else the
    streamed one.  Raises ValueError when neither fits."""
    lo = t0 + 2
    cuts = tuple(lo + c for c in _cut(k7_candidates(q0, q1, t0, t1),
                                      cluster))
    for mode in ("resident", "streamed"):
        smem = k7_smem_bytes(mode, q2, t2, q0, q1, t0, cuts)
        if smem <= smem_limit:
            return K7Plan(mode, cluster, cuts, smem)
    raise ValueError(f"K7: a {q2} x {t2} build needs {smem} bytes of shared "
                     f"memory per block even streamed; the card gives "
                     f"{smem_limit}")


@functools.lru_cache(maxsize=None)
def _smem_optin(index: int) -> int:
    with torch.cuda.device(index):
        return int(_build.load().lib.dp_tb_smem_optin())


@functools.lru_cache(maxsize=256)
def _clusters_fit(index: int, cluster: int, smem: int, resident: bool) -> int:
    with torch.cuda.device(index):
        return int(_build.load().lib.dp_tb_max_active_clusters(
            cluster, smem, int(resident)))


def launch_plan(device, q2: int, t2: int, q0: int, q1: int, t0: int,
                t1: int) -> K7Plan:
    """The plan :func:`dp_forward_tb` launches on ``device`` (a CUDA
    device): the first of ``K7_CLUSTERS`` whose cluster the card can place
    with the plan's shared memory (``cudaOccupancyMaxActiveClusters``).
    Raises RuntimeError when none can be placed."""
    device = torch.device(device)
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    limit = _smem_optin(index)
    for cluster in K7_CLUSTERS:
        plan = k7_plan(q2, t2, q0, q1, t0, t1, cluster, limit)
        fit = _clusters_fit(index, cluster, plan.smem_bytes,
                            plan.mode == "resident")
        if fit >= 1:
            return plan
        if fit < 0:
            raise RuntimeError(f"K7: CUDA error {-fit} asking whether a "
                               f"cluster of {cluster} blocks fits")
    raise RuntimeError(f"K7: the card places no cluster of "
                       f"{' or '.join(map(str, K7_CLUSTERS))} blocks for a "
                       f"{q2} x {t2} build")


# ------------------------------------------------------------------ kernel

def _check(S, D, Cm, ins0, insc, q0, q1, t0, t1):
    """Validate K7's input contract; returns (n, q2, t2)."""
    dev = S.device
    if S.dim() != 3:
        raise ValueError(f"S must be (n, q2, t2), got {tuple(S.shape)}")
    n, q2, t2 = S.shape
    want = {"S": (n, q2, t2), "D": (n, t2, t2), "Cm": (n, q2, t2),
            "ins0": (n, q2), "insc": (n, q2)}
    for name, x in zip(want, (S, D, Cm, ins0, insc)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: expected torch.float32, got {x.dtype}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, S on {dev}")
        if tuple(x.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if n < 1 or not (0 <= q0 and q0 + 2 <= q1 < q2
                     and 0 <= t0 and t0 + 2 <= t1 < t2):
        raise ValueError(f"K7 needs n >= 1, 0 <= q0, q0 + 2 <= q1 < q2 and "
                         f"0 <= t0, t0 + 2 <= t1 < t2; got n={n}, "
                         f"bounds ({q0}, {q1}, {t0}, {t1}), shape {q2}x{t2}")
    return n, q2, t2


def dp_forward_tb(S, D, Cm, ins0, insc, *, q0: int, q1: int, t0: int,
                  t1: int, local: bool = False):
    """K7: general-gap forward DP with first-argmax tracebacks for n
    same-shape pairs over the rectangle (q0, q1, t0, t1).

    S (n, q2, t2) similarity; D (n, t2, t2) deletion cost D[k, j]; Cm
    (n, q2, t2) insertion cost by gap distance m at column j (0 for
    m < 2); ins0 (n, q2) boundary-column insertion cost by row; insc
    (n, q2) closing-cell insertion cost by row.  All float32, contiguous,
    on one device.  Returns H (n, q2, t2) float32 and PQ, PT (n, q2, t2)
    int32: the cells the build sets, 0 and NULL elsewhere, exactly the
    ``DPResult`` of ``dp_engine.build_forward_jax``.

    CPU tensors run :func:`dp_forward_tb_plain`; CUDA tensors launch the
    kernel with :func:`launch_plan`'s cluster and mode (a build or launch
    failure, or a cluster the card cannot place, raises).  Span: ``k7``."""
    with profiling.span("k7"):
        n, q2, t2 = _check(S, D, Cm, ins0, insc, q0, q1, t0, t1)
        if S.device.type == "cpu":
            return dp_forward_tb_plain(S, D, Cm, ins0, insc, q0=q0, q1=q1,
                                       t0=t0, t1=t1, local=local)
        if S.device.type != "cuda":
            raise ValueError(f"no kernel for device {S.device}")
        lib = _build.load().lib
        plan = launch_plan(S.device, q2, t2, q0, q1, t0, t1)
        cuts = (ctypes.c_int * len(plan.cuts))(*plan.cuts)
        H = torch.empty((n, q2, t2), dtype=torch.float32, device=S.device)
        PQ = torch.empty((n, q2, t2), dtype=torch.int32, device=S.device)
        PT = torch.empty((n, q2, t2), dtype=torch.int32, device=S.device)
        with torch.cuda.device(S.device):
            stream = torch.cuda.current_stream(S.device).cuda_stream
            err = lib.dp_tb_launch(
                S.data_ptr(), D.data_ptr(), Cm.data_ptr(), ins0.data_ptr(),
                insc.data_ptr(), H.data_ptr(), PQ.data_ptr(), PT.data_ptr(),
                n, q2, t2, q0, q1, t0, t1, int(bool(local)),
                int(plan.mode == "resident"), plan.cluster,
                ctypes.cast(cuts, ctypes.c_void_p), plan.smem_bytes, stream)
        _build.check(err, "dp_tb_launch")
        dp_forward_tb.launches += 1
        return H, PQ, PT


dp_forward_tb.launches = 0


# ----------------------------------------------------- host builds (numpy)

def _tables(c: DPCosts, q0: int, q1: int, t0: int, t1: int):
    """K7's host tables for one cost model (dp_engine.py:163-183): Cm by
    distance, ins0 and ins_close by row."""
    Cm, ins0, _, _ = _host_tables(c, q0, q1, t0, t1)
    ins_close = c.ins_cost_of_dist(q1 - np.arange(c.q_size, dtype=np.int64),
                                   t1)
    if c.ins_zero_tail_q and q1 == c.q_size - 1:
        ins_close = np.zeros_like(ins_close)
    return c.S, c.D, Cm, ins0, ins_close


def device_tables(costs: list, q0: int, q1: int, t0: int, t1: int, *,
                  device: torch.device) -> list:
    """K7's inputs (S, D, Cm, ins0, insc) for same-shape cost models,
    stacked and copied to ``device``."""
    arrays = [np.stack(a) for a in zip(*(_tables(c, q0, q1, t0, t1)
                                         for c in costs))]
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
            for a in arrays]


def _run(costs: list, q0, q1, t0, t1, local, device) -> list:
    """Run K7 (or its plain version) on ``device`` over the pairs' tables
    and return one ``DPResult`` per pair."""
    tensors = device_tables(costs, q0, q1, t0, t1, device=device)
    H, PQ, PT = (x.cpu().numpy() for x in dp_forward_tb(
        *tensors, q0=q0, q1=q1, t0=t0, t1=t1, local=local))
    out = []
    for b in range(len(costs)):
        res = DPResult(*H.shape[1:])
        res.H, res.PQ, res.PT = H[b], PQ[b], PT[b]
        out.append(res)
    return out


def build_forward(c: DPCosts, q0: int, q1: int, t0: int, t1: int,
                  local: bool = False, *, device: torch.device) -> DPResult:
    """Forward build of one cost model (``build_forward_jax``): K7 on
    ``device``; a one-row or one-column rectangle goes to ``dp_ref``."""
    if q1 <= q0 or t1 <= t0:
        raise ValueError("Illegal bounds building DPM")
    if q1 == q0 + 1 or t1 == t0 + 1:
        return dp_ref.build_forward(c, q0, q1, t0, t1, local=local)
    return _run([c], q0, q1, t0, t1, local, device)[0]


def build_forward_batched(costs: list, local: bool = False, *,
                          device: torch.device) -> list:
    """Whole-matrix forward builds of same-shape cost models in one K7
    launch (``build_forward_jax_batched``); a list of ``DPResult``."""
    q2, t2 = _bucket_shape(costs)
    if q2 < 3 or t2 < 3:
        return [build_forward(c, 0, q2 - 1, 0, t2 - 1, local, device=device)
                for c in costs]
    return _run(costs, 0, q2 - 1, 0, t2 - 1, local, device)


def _flip_costs(c: DPCosts) -> DPCosts:
    """Mirror the cost model so the forward build computes the reverse
    build (a copy of ``dp_engine._flip_costs``, whose module imports
    jax)."""
    S_f = np.ascontiguousarray(c.S[::-1, ::-1])
    D_f = np.ascontiguousarray(c.D[::-1, ::-1].T)
    A_f = c.A.copy()
    B_f = c.B.copy()
    A_f[1:] = c.A[1:][::-1]
    B_f[1:] = c.B[1:][::-1]
    C_f = None
    if c.C is not None:
        C_f = c.C.copy()
        C_f[1:] = c.C[1:][::-1]
    return DPCosts(S=S_f, D=D_f, A=A_f, B=B_f,
                   ins_zero_head_q=c.ins_zero_tail_q,
                   ins_zero_tail_q=c.ins_zero_head_q,
                   C=C_f, ins_dist_offset=c.ins_dist_offset)


def build_reverse(c: DPCosts, q0: int, q1: int, t0: int, t1: int,
                  local: bool = False, bug_compat: bool = True, *,
                  device: torch.device) -> DPResult:
    """Reverse build (``build_reverse_jax``): the forward build of the
    mirrored cost model, mapped back; ``bug_compat`` keeps the reference
    defect at dpmatrix.h:868 (a closing-cell insertion winner records
    t1 - 1)."""
    q2, t2 = c.q_size, c.t_size
    if q1 == q0 + 1 or t1 == t0 + 1:
        return dp_ref.build_reverse(c, q0, q1, t0, t1, local=local,
                                    bug_compat=bug_compat)
    fres = build_forward(_flip_costs(c), q2 - 1 - q1, q2 - 1 - q0,
                         t2 - 1 - t1, t2 - 1 - t0, local, device=device)
    res = DPResult(q2, t2)
    res.H = np.ascontiguousarray(fres.H[::-1, ::-1])
    pq = fres.PQ[::-1, ::-1]
    pt = fres.PT[::-1, ::-1]
    valid = pq != NULL
    res.PQ = np.where(valid, (q2 - 1) - pq, NULL).astype(np.int32)
    res.PT = np.where(valid, (t2 - 1) - pt, NULL).astype(np.int32)
    if bug_compat and not local:
        if res.PQ[q0, t0] > q0 + 1 and res.PT[q0, t0] == t0 + 1:
            res.PT[q0, t0] = t1 - 1
    return res
