"""Device HMAP similarity producer and profile screen on PyTorch + CUDA
(counterpart of ``alignment_algos_tpu/ops/hmap_device.py``).

Per-position profile data (about 25 KB per 256-residue sequence) goes to
the device once per library and query; the z-normalized, shifted
similarity of every (query, template) pair is rebuilt there bit-identically
to ``HMAPaliEval.build_costs``'s S (hmap_eval.h:47-61, hmap_eval.cpp:38-51,
simmatrix.h:50-73):

    ip  = dot20(q_profile_i, t_profile_j)       serial f32 chain in k
    pc  = dot3(zsse_q_i, zsse_t_j) / 3          row z-norms done on the host
    S   = ip * expf(((alpha * pc) * conf_q_i) * conf_t_j); nan_to_num; 0 borders
    S   = (S - avg) / std - zero_shift on [1, q2-1) x [1, t2-1), 0 borders

Two hand-written kernels (``csrc/hmap_device.cu``) carry it, each beside
its plain PyTorch version and each one launch over every bucket of a
screen: K5 (:func:`hmap_sim_ragged`) the raw similarity, K6
(:func:`hmap_znorm_ragged`) the z-norm and shift.  The z-norm's mean and
variance are strictly serial float32 sums in row-major region order
(``utils/hmath.seq_sum_f32``): ``torch.sum`` and ``torch.cumsum`` round
differently (the CPU accumulates float32 in double, CUDA scans in
parallel), so the plain version is a loop of float32 adds, vectorized only
across pairs.  Its divisions divide by a tensor, never by a Python or CPU
scalar: PyTorch's CUDA division multiplies by the reciprocal of a CPU
scalar, which is not the correctly rounded quotient.  Then K3
(``dp_scores.dp_general_ragged``) scores every bucket of the library in one
launch, its costs built in the kernel from the gap vectors.  A bucket
whose templates are longer than K3's rows in shared memory hold
(``dp_scores.vec_max_t2``, 7,200 on an H100) is scored exactly on K7, as
the JAX package sends a bucket past its VMEM cap to ``dp_engine``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..scoring.base import (_DEL_FREE_OVERHANG_MODES, DPCosts,
                            affine_deletion_table, ins_zero_flags)
from ..scoring.hmap_eval import HMAPaliEval
from ..utils import profiling
from ..utils.hmath import seq_sum_f32
from ..utils.params import AlignT, HMAPaliParams
from . import _build, dp_engine, dp_scores
from .expf import expf_plain

__all__ = ["DeviceLibrary", "HMAPaliEval", "HMAPaliParams", "K5_TILE",
           "SIM_PAIR_DTYPE", "ZPAIR_DTYPE", "bucket_tables",
           "build_similarity_device", "hmap_sim", "hmap_sim_plain",
           "hmap_sim_ragged", "hmap_sim_ragged_plain", "query_tensors",
           "ragged_flags",
           "hmap_znorm", "hmap_znorm_plain", "hmap_znorm_ragged",
           "hmap_znorm_ragged_plain", "pack_sequence",
           "pack_template_costs", "screen_buckets", "screen_hmap_device",
           "serial_sums", "sqrt_rn"]


# ------------------------------------------------------- host-side packing

def _znorm_rows_host(rows: np.ndarray) -> np.ndarray:
    """The per-row z-norm inside utils/hmath.pearson_rows, verbatim."""
    rows = rows.astype(np.float32)
    k = rows.shape[1]
    avg = (seq_sum_f32(rows, axis=1) / np.float32(k))[:, None]
    sumsq = seq_sum_f32(rows * rows, axis=1)[:, None]
    var = sumsq / np.float32(k) - avg * avg
    std = np.sqrt(var).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        return ((rows - avg) / std).astype(np.float32)


def pack_sequence(seq) -> dict:
    """Per-sequence payload: profile, z-normed SSE rows, confidences."""
    return {
        "aa": np.ascontiguousarray(seq.aa_profile, np.float32),
        "zsse": _znorm_rows_host(seq.sse_values),
        "conf": np.ascontiguousarray(seq.sse_confid, np.float32),
    }


def pack_template_costs(ev, templ) -> dict:
    """Per-template gap machinery (host; identical to build_costs)."""
    gi_vec, ge_vec = ev._gap_vectors(templ)
    A = np.minimum(gi_vec, np.roll(gi_vec, 1)).astype(np.float32)
    B = np.minimum(ge_vec, np.roll(ge_vec, 1)).astype(np.float32)
    return {"gi": gi_vec.astype(np.float32), "ge": ge_vec.astype(np.float32),
            "A": A, "B": B}


# ------------------------------------------------------- K5: raw similarity

def _seq_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(q2, K) x (n, t2, K) -> (n, q2, t2), the serial-in-K float32
    multiply-then-add order of utils/hmath.seq_matmul_f32 (eager torch ops
    never contract a multiply and an add)."""
    out = a[None, :, 0:1] * b[:, None, :, 0]
    for k in range(1, a.shape[1]):
        out = out + a[None, :, k:k + 1] * b[:, None, :, k]
    return out


def _border(q2: int, t2: int, device) -> torch.Tensor:
    border = torch.zeros((q2, t2), dtype=torch.bool, device=device)
    border[0, :] = border[-1, :] = True
    border[:, 0] = border[:, -1] = True
    return border


def hmap_sim_plain(q_aa, q_zsse, q_conf, t_aa, t_zsse, t_conf,
                   alpha: float) -> torch.Tensor:
    """Plain version of K5: the raw similarity (n, q2, t2), nan_to_num,
    borders zeroed (hmap_device.py:144-159 of the JAX package)."""
    q2, t2 = q_aa.shape[0], t_aa.shape[1]
    ip = _seq_dot(q_aa, t_aa)
    dot3 = _seq_dot(q_zsse, t_zsse)
    pc = dot3 / torch.full_like(dot3, float(q_zsse.shape[1]))
    arg = torch.tensor(alpha, dtype=torch.float32, device=pc.device) * pc
    arg = arg * q_conf[None, :, None]
    arg = arg * t_conf[:, None, :]
    S = ip * expf_plain(arg)
    S = torch.where(torch.isfinite(S), S, 0.0)
    return torch.where(_border(q2, t2, S.device), 0.0, S)


def hmap_sim_ragged_plain(q_aa, q_zsse, q_conf, stacks,
                          alpha: float) -> list:
    """Plain version of K5 over every stack ``(t_aa, t_zsse, t_conf)`` of
    ``stacks``: :func:`hmap_sim_plain` of each, in order."""
    return [hmap_sim_plain(q_aa, q_zsse, q_conf, *st, alpha)
            for st in stacks]


def _check_f32(dev, **xs):
    for name, x in xs.items():
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: expected torch.float32, got {x.dtype}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _cuda_stream(dev):
    if dev.type == "cpu":
        return None
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return torch.cuda.current_stream(dev).cuda_stream


def _check_sim(q_aa, q_zsse, q_conf, stacks):
    """Validate K5's input contract; returns (device, q2, ka, ks)."""
    dev = q_aa.device
    _check_f32(dev, q_aa=q_aa, q_zsse=q_zsse, q_conf=q_conf)
    if q_aa.dim() != 2 or q_zsse.dim() != 2:
        raise ValueError("q_aa must be (q2, ka) and q_zsse (q2, ks)")
    q2, ka = q_aa.shape
    ks = q_zsse.shape[1]
    if tuple(q_conf.shape) != (q2,):
        raise ValueError(f"q_conf must be ({q2},), got {tuple(q_conf.shape)}")
    if not stacks:
        raise ValueError("K5 needs at least one stack")
    for t_aa, t_zsse, t_conf in stacks:
        _check_f32(dev, t_aa=t_aa, t_zsse=t_zsse, t_conf=t_conf)
        if t_aa.dim() != 3:
            raise ValueError("t_aa must be (n, t2, ka)")
        n, t2, _ = t_aa.shape
        want = {"t_aa": (n, t2, ka), "t_zsse": (n, t2, ks), "t_conf": (n, t2)}
        for name, x in (("t_aa", t_aa), ("t_zsse", t_zsse),
                        ("t_conf", t_conf)):
            if tuple(x.shape) != want[name]:
                raise ValueError(f"{name} must be {want[name]}, got "
                                 f"{tuple(x.shape)}")
        if min(n, ka, ks) < 1 or q2 < 3 or t2 < 3:
            raise ValueError(f"K5 needs n, ka, ks >= 1 and q2, t2 >= 3, got "
                             f"n={n}, q2={q2}, t2={t2}, ka={ka}, ks={ks}")
        if q2 * t2 >= 2 ** 31:
            raise ValueError(f"K5 indexes a pair in 32 bits: q2 x t2 = "
                             f"{q2} x {t2} is too large")
    return dev, q2, ka, ks


# K5's tile: a block computes K5_TILE[1] template columns of one pair, in
# passes of K5_TILE[0] query rows (csrc/hmap_device.cu kTileQ, kTileT; the
# launcher refuses any other).
K5_TILE = (32, 64)

# One pair of a K5 launch, as ``struct SimPair`` of csrc/hmap_device.cu:
# the device addresses of its template rows and of its S, t2 and its first
# tile.
SIM_PAIR_DTYPE = np.dtype([("t_aa", "<u8"), ("t_zsse", "<u8"),
                           ("t_conf", "<u8"), ("S", "<u8"), ("t2", "<i4"),
                           ("tile0", "<i4")])


def _sim_descriptors(q2: int, ka: int, ks: int, shapes, addrs):
    """The pairs of a K5 launch from each stack's (n, t2) and base
    addresses (t_aa, t_zsse, t_conf, S), in K6's order (longest region
    first, stable), each with its first tile of ``K5_TILE[1]`` columns:
    (pairs, the launch's tile count).  Offsets are 64-bit."""
    n = np.asarray([sh[0] for sh in shapes], np.int64)
    t2 = np.asarray([sh[1] for sh in shapes], np.int64)
    p = (np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)).astype(
        np.uint64)
    base = np.asarray(addrs, np.uint64).reshape(len(shapes), 4)
    pairs = np.zeros(len(p), SIM_PAIR_DTYPE)
    for col, (field, width) in enumerate((("t_aa", ka), ("t_zsse", ks),
                                          ("t_conf", 1), ("S", q2))):
        step = np.repeat((4 * width * t2).astype(np.uint64), n)
        pairs[field] = np.repeat(base[:, col], n) + p * step
    pairs["t2"] = np.repeat(t2, n)
    region = (q2 - 2) * (pairs["t2"].astype(np.int64) - 2)
    pairs = pairs[np.argsort(-region, kind="stable")]
    tiles = -(-pairs["t2"].astype(np.int64) // K5_TILE[1])
    if tiles.sum() >= 2 ** 31:
        raise ValueError(f"K5: {tiles.sum()} tiles exceed one launch's grid")
    pairs["tile0"] = np.cumsum(tiles) - tiles
    return np.ascontiguousarray(pairs), int(tiles.sum())


class SimPlan(NamedTuple):
    """One K5 launch's state on the card: the outputs (views into one
    allocation, in stack order), the descriptors in device memory, the
    query transposed (ka + ks + 1, q2), the pair and tile counts and the
    query's (q2, ka, ks)."""
    outs: list
    desc: torch.Tensor
    qt: torch.Tensor
    pairs: int
    tiles: int
    dims: tuple


def _sim_plan(q_aa, q_zsse, q_conf, stacks) -> SimPlan:
    """K5's launch state for the checked CUDA ``stacks``; the descriptors'
    copy and the query's transpose are queued on the current stream."""
    dev = q_aa.device
    q2, ka = q_aa.shape
    ks = q_zsse.shape[1]
    shapes = [tuple(t_aa.shape[:2]) for t_aa, _, _ in stacks]
    sizes = [n * q2 * t2 for n, t2 in shapes]
    flat = torch.empty((sum(sizes),), dtype=torch.float32, device=dev)
    outs = [x.view(n, q2, t2) for x, (n, t2) in
            zip(torch.split(flat, sizes), shapes)]
    pairs, tiles = _sim_descriptors(
        q2, ka, ks, shapes, [(a.data_ptr(), z.data_ptr(), c.data_ptr(),
                              S.data_ptr())
                             for (a, z, c), S in zip(stacks, outs)])
    with torch.cuda.device(dev):
        desc = torch.from_numpy(pairs.view(np.uint8)).pin_memory().to(
            dev, non_blocking=True)
    qt = torch.cat([q_aa, q_zsse, q_conf[:, None]], dim=1).t().contiguous()
    return SimPlan(outs, desc, qt, len(pairs), tiles, (q2, ka, ks))


def _sim_launch(plan: SimPlan, alpha: float) -> None:
    """Launch K5 over ``plan`` on the current stream."""
    dev = plan.desc.device
    with torch.cuda.device(dev):
        err = _build.load().lib.hmap_sim_launch(
            plan.desc.data_ptr(), plan.pairs, plan.tiles, plan.qt.data_ptr(),
            *plan.dims, float(np.float32(alpha)), *K5_TILE,
            _cuda_stream(dev))
    _build.check(err, "hmap_sim_launch")


def hmap_sim_ragged(q_aa, q_zsse, q_conf, stacks, alpha: float) -> list:
    """K5: raw HMAP similarity of one query against every stack of
    same-length templates in ``stacks`` (a sequence of (t_aa, t_zsse,
    t_conf), one per length bucket); returns one (n, q2, t2) tensor per
    stack, in order.

    q_aa (q2, ka), q_zsse (q2, ks), q_conf (q2,); t_aa (n, t2, ka), t_zsse
    (n, t2, ks), t_conf (n, t2); float32, contiguous, one device.  CPU
    tensors run :func:`hmap_sim_ragged_plain`; CUDA tensors launch the
    kernel once over every pair of every stack, on the current stream and
    without a host sync, the outputs views into one allocation (a build or
    launch failure raises).  Span: ``k5``."""
    with profiling.span("k5"):
        stacks = [tuple(st) for st in stacks]
        dev, *_ = _check_sim(q_aa, q_zsse, q_conf, stacks)
        if _cuda_stream(dev) is None:
            return hmap_sim_ragged_plain(q_aa, q_zsse, q_conf, stacks, alpha)
        plan = _sim_plan(q_aa, q_zsse, q_conf, stacks)
        _sim_launch(plan, alpha)
        hmap_sim_ragged.launches += 1
        return plan.outs


hmap_sim_ragged.launches = 0


def hmap_sim(q_aa, q_zsse, q_conf, t_aa, t_zsse, t_conf,
             alpha: float) -> torch.Tensor:
    """K5 on one stack of n same-length templates: :func:`hmap_sim_ragged`
    of ``[(t_aa, t_zsse, t_conf)]`` (its launch counts there)."""
    return hmap_sim_ragged(q_aa, q_zsse, q_conf, [(t_aa, t_zsse, t_conf)],
                           alpha)[0]


# ------------------------------------------------ K6: z-norm and the shift

def serial_sums(v: torch.Tensor, acc: torch.Tensor | None = None,
                acc2: torch.Tensor | None = None):
    """(n, m) -> (acc, acc2) (n,): sum v and sum v*v along m as one strictly
    serial float32 chain per row, from 0 (fl(0 + x) = x) or, when given,
    onward from ``acc`` and ``acc2`` (updated in place).  Equals
    utils/hmath.seq_sum_f32; torch.sum and torch.cumsum do not."""
    n, m = v.shape
    if acc is None:
        acc = torch.zeros((n,), dtype=torch.float32, device=v.device)
        acc2 = torch.zeros((n,), dtype=torch.float32, device=v.device)
    cols = v.t().contiguous()
    sq = cols * cols                           # each square rounded alone
    for r in range(m):
        acc.add_(cols[r])
        acc2.add_(sq[r])
    return acc, acc2


# Chain steps per block of the plain z-norm's stats: its scratch is about
# 12 bytes x this x the pairs whose regions reach the block.
STATS_BLOCK = 4096


def _znorm_stats_plain(Ss):
    """Mean and standard deviation of each pair's [1, q2-1) x [1, t2-1)
    region, exactly as hmath.norm_elements_vec (JAX ``_znorm_scalars``),
    for every pair of the stacks ``Ss`` at once: (avg, std), each (sum of
    n,) in stack order.

    Every pair's chain runs in one loop (one step per element of the
    longest region, not of every stack): the stacks go longest region
    first, and :func:`serial_sums` walks :data:`STATS_BLOCK` region
    elements at a time of the pairs whose regions reach that far, a
    shorter one among them padded with +0.0 to the block's end.  The
    padding leaves each chain's bits as they are: a chain starts at +0.0
    and fl(a + b) is -0.0 only when a and b both are, so no chain is ever
    -0.0, and acc + 0.0 = acc for every other float32, NaN and inf
    included."""
    regions = [S[:, 1:S.shape[1] - 1, 1:S.shape[2] - 1].reshape(S.shape[0], -1)
               for S in Ss]
    order = sorted(range(len(regions)), key=lambda b: -regions[b].shape[1])
    counts = [regions[b].shape[0] for b in order]
    ends = np.cumsum(counts)
    dev = Ss[0].device
    acc = torch.zeros((int(ends[-1]),), dtype=torch.float32, device=dev)
    acc2 = torch.zeros_like(acc)
    longest = regions[order[0]].shape[1]
    for start in range(0, longest, STATS_BLOCK):
        live = [b for b in order if regions[b].shape[1] > start]
        rows = int(ends[len(live) - 1])
        v = torch.zeros((rows, min(STATS_BLOCK, longest - start)),
                        dtype=torch.float32, device=dev)
        p = 0
        for b in live:
            r = regions[b][:, start:start + v.shape[1]]
            v[p:p + r.shape[0], :r.shape[1]] = r
            p += r.shape[0]
        serial_sums(v, acc[:rows], acc2[:rows])
    back = np.argsort(order)                   # stack b's place in order
    acc, acc2 = (torch.cat([torch.split(x, counts)[i] for i in back])
                 for x in (acc, acc2))
    m = torch.tensor(np.repeat(np.asarray([r.shape[1] for r in regions],
                                          np.float32),
                               [r.shape[0] for r in regions]), device=dev)
    avg = acc / m
    var = acc2 / m - avg * avg
    return avg, sqrt_rn(var)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root: in float64, rounded once
    (exact for sqrt).  float32 ``torch.sqrt`` on the CPU is not correctly
    rounded (about 0.6% of random inputs come out 1 ulp off)."""
    return torch.sqrt(x.double()).to(torch.float32)


def hmap_znorm_ragged_plain(Ss, zero_shift: float, *,
                            normalize: bool = True) -> list:
    """Plain version of K6 (hmap_device.py:161-167 of the JAX package) for
    every stack of ``Ss``: (S - avg) / std + zero_shift inside each pair's
    region (only + zero_shift when not normalizing), 0 on the borders; the
    stats of all pairs in one padded chain (:func:`_znorm_stats_plain`).
    ``zero_shift`` is the signed shift (the params' zero_shift negated)."""
    if normalize:
        avg, std = _znorm_stats_plain(Ss)
    outs, p = [], 0
    for S in Ss:
        n, q2, t2 = S.shape
        border = _border(q2, t2, S.device)
        if normalize:
            S = torch.where(border, S, (S - avg[p:p + n, None, None])
                            / std[p:p + n, None, None])
        shift = torch.tensor(zero_shift, dtype=torch.float32, device=S.device)
        S = torch.where(border, S, S + shift)
        outs.append(torch.where(border, 0.0, S))
        p += n
    return outs


def hmap_znorm_plain(S: torch.Tensor, zero_shift: float, *,
                     normalize: bool = True) -> torch.Tensor:
    """Plain version of K6 for one (n, q2, t2) stack."""
    return hmap_znorm_ragged_plain([S], zero_shift, normalize=normalize)[0]


# One pair of a K6 launch, as ``struct ZPair`` of csrc/hmap_device.cu: the
# device addresses of its S and its output, q2, t2 and its first apply
# block.
ZPAIR_DTYPE = np.dtype([("S", "<u8"), ("out", "<u8"), ("q2", "<i4"),
                        ("t2", "<i4"), ("blk0", "<i4"), ("pad", "<i4")])


def _check_znorm(Ss) -> torch.device:
    """Validate K6's input contract; returns the device."""
    if not Ss:
        raise ValueError("K6 needs at least one stack")
    dev = Ss[0].device
    for S in Ss:
        _check_f32(dev, S=S)
        if S.dim() != 3:
            raise ValueError(f"S must be (n, q2, t2), got {tuple(S.shape)}")
        n, q2, t2 = S.shape
        if n < 1 or q2 < 3 or t2 < 3:
            raise ValueError(f"K6 needs n >= 1 and q2, t2 >= 3, got n={n}, "
                             f"q2={q2}, t2={t2}")
        if q2 * t2 >= 2 ** 31 - 2 ** 16:
            raise ValueError(f"K6 indexes a pair in 32 bits: q2 x t2 = "
                             f"{q2} x {t2} is too large")
    return dev


def _znorm_descriptors(Ss, outs, per_block: int):
    """The pairs of a K6 launch, longest region first, each with its first
    apply block (``per_block`` elements a block); returns (pairs, the
    apply pass's block count)."""
    shapes = np.asarray([tuple(S.shape) for S in Ss], np.int64)
    n = shapes[:, 0]
    p = (np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)).astype(
        np.uint64)
    step = np.repeat((4 * shapes[:, 1] * shapes[:, 2]).astype(np.uint64), n)
    pairs = np.zeros(len(p), ZPAIR_DTYPE)
    pairs["S"] = np.repeat(np.asarray([S.data_ptr() for S in Ss],
                                      np.uint64), n) + p * step
    pairs["out"] = np.repeat(np.asarray([o.data_ptr() for o in outs],
                                        np.uint64), n) + p * step
    pairs["q2"] = np.repeat(shapes[:, 1], n)
    pairs["t2"] = np.repeat(shapes[:, 2], n)
    region = (pairs["q2"].astype(np.int64) - 2) * (pairs["t2"] - 2)
    pairs = pairs[np.argsort(-region, kind="stable")]
    blocks = -(-(pairs["q2"].astype(np.int64) * pairs["t2"]) // per_block)
    pairs["blk0"] = np.cumsum(blocks) - blocks
    return np.ascontiguousarray(pairs), int(blocks.sum())


class ZPlan(NamedTuple):
    """One K6 launch's state on the card: the outputs, the descriptors in
    device memory, the (pairs, 2) stats scratch and the apply pass's block
    count."""
    outs: list
    desc: torch.Tensor
    stats: torch.Tensor
    blocks: int


def _znorm_plan(Ss) -> ZPlan:
    """K6's launch state for the CUDA stacks ``Ss`` (checked); the
    descriptors' copy is queued on the current stream."""
    dev = Ss[0].device
    outs = [torch.empty_like(S) for S in Ss]
    pairs, blocks = _znorm_descriptors(
        Ss, outs, _build.load().lib.hmap_znorm_apply_elems())
    with torch.cuda.device(dev):
        desc = torch.from_numpy(pairs.view(np.uint8)).pin_memory().to(
            dev, non_blocking=True)
    stats = torch.empty((len(pairs), 2), dtype=torch.float32, device=dev)
    return ZPlan(outs, desc, stats, blocks)


def _znorm_launch(plan: ZPlan, zero_shift: float, normalize: bool) -> None:
    """Launch K6's passes over ``plan`` on the current stream."""
    dev = plan.desc.device
    with torch.cuda.device(dev):
        err = _build.load().lib.hmap_znorm_launch(
            plan.desc.data_ptr(), plan.stats.data_ptr(), plan.stats.shape[0],
            plan.blocks, float(np.float32(zero_shift)), int(bool(normalize)),
            _cuda_stream(dev))
    _build.check(err, "hmap_znorm_launch")


def hmap_znorm_ragged(Ss, zero_shift: float, *,
                      normalize: bool = True) -> list:
    """K6: z-normalize and shift the similarity stacks ``Ss`` (a sequence
    of (n, q2, t2) float32 tensors, one per length bucket, on one device);
    returns new tensors in the same order.

    CPU tensors run :func:`hmap_znorm_ragged_plain`; CUDA tensors launch
    the kernel once for every pair of every stack (its stats pass only
    when ``normalize``), on the current stream and without a host sync (a
    build or launch failure raises).  Span: ``k6``."""
    with profiling.span("k6"):
        Ss = list(Ss)
        dev = _check_znorm(Ss)
        if _cuda_stream(dev) is None:
            return hmap_znorm_ragged_plain(Ss, zero_shift,
                                           normalize=normalize)
        plan = _znorm_plan(Ss)
        _znorm_launch(plan, zero_shift, normalize)
        hmap_znorm_ragged.launches += 1
        return plan.outs


hmap_znorm_ragged.launches = 0


def hmap_znorm(S: torch.Tensor, zero_shift: float, *,
               normalize: bool = True) -> torch.Tensor:
    """K6 on one (n, q2, t2) stack: :func:`hmap_znorm_ragged` of ``[S]``
    (its launch counts there)."""
    return hmap_znorm_ragged([S], zero_shift, normalize=normalize)[0]


def build_similarity_device(q_aa, q_zsse, q_conf, t_aa, t_zsse, t_conf,
                            alpha: float, zero_shift: float, *,
                            normalize: bool = True) -> torch.Tensor:
    """(n, q2, t2) z-normalized, shifted similarity stack, bit-identical to
    ``HMAPaliEval.build_costs``'s S for each pair (query, template b):
    K5 then K6 on the tensors' device.  ``zero_shift`` is the signed shift
    (``-params.zero_shift``)."""
    S = hmap_sim(q_aa, q_zsse, q_conf, t_aa, t_zsse, t_conf, alpha)
    return hmap_znorm(S, zero_shift, normalize=normalize)


# ------------------------------------------------------------ the screen

def _to(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C")).to(
        device)


class DeviceLibrary:
    """A resident, length-bucketed template library for HMAP screens:
    ``buckets[t2]`` holds the library indices (``idx``) and, on
    ``device``, ``aa`` (n, t2, 20), ``zsse`` (n, t2, 3), ``conf`` (n, t2),
    ``D`` (n, 2, t2) gap-init/extension vectors, ``A`` and ``B`` (n, t2).
    Spans: ``hmap.pack`` (the host pack: every template's payload and
    costs, then each bucket's stacks) and ``hmap.copy`` (each bucket's
    arrays as contiguous float32 to ``device``).  A bucket's templates are
    dropped once it is stacked, and its stacks once it is copied, so the
    host holds about one copy of the library at a time."""

    def __init__(self, templates, ev, *, device: torch.device):
        self.templates = templates
        self.device = torch.device(device)
        self.buckets: dict[int, dict] = {}
        packed: dict[int, dict] = {}
        with profiling.span("hmap.pack"):
            for idx, t in enumerate(templates):
                b = packed.setdefault(t.size(), {"idx": [], "seq": [],
                                                 "cost": []})
                b["idx"].append(idx)
                b["seq"].append(pack_sequence(t))
                b["cost"].append(pack_template_costs(ev, t))
            stacked: dict[int, tuple] = {}
            for t2 in list(packed):
                b = packed.pop(t2)
                stacked[t2] = (
                    b["idx"],
                    np.stack([s["aa"] for s in b["seq"]]),
                    np.stack([s["zsse"] for s in b["seq"]]),
                    np.stack([s["conf"] for s in b["seq"]]),
                    np.stack([np.stack([c["gi"], c["ge"]])
                              for c in b["cost"]]),
                    np.stack([c["A"] for c in b["cost"]]),
                    np.stack([c["B"] for c in b["cost"]]))
        with profiling.span("hmap.copy"):
            for t2 in list(stacked):
                self.buckets[t2] = self._bucket(*stacked.pop(t2))

    def _bucket(self, idx, aa, zsse, conf, D, A, B) -> dict:
        dev = self.device
        return {"idx": list(idx), "aa": _to(aa, dev), "zsse": _to(zsse, dev),
                "conf": _to(conf, dev), "D": _to(D, dev), "A": _to(A, dev),
                "B": _to(B, dev)}

    @classmethod
    def from_jax(cls, lib, *, device: torch.device) -> "DeviceLibrary":
        """The port's library from the JAX package's ``DeviceLibrary``
        (its bucket arrays read as numpy): the same state on ``device``."""
        self = cls.__new__(cls)
        self.templates = lib.templates
        self.device = torch.device(device)
        self.buckets = {
            t2: self._bucket(b["idx"], *(np.asarray(b[key]) for key in
                                         ("aa", "zsse", "conf", "D", "A",
                                          "B")))
            for t2, b in lib.buckets.items()}
        return self


def query_tensors(query, device: torch.device) -> dict:
    """The query's payload (:func:`pack_sequence`) as tensors on
    ``device``."""
    return {key: _to(v, device) for key, v in pack_sequence(query).items()}


def _znorm(Ss, params) -> list:
    """K6 over the stacks ``Ss`` with the params' signed shift and
    normalize flag."""
    return hmap_znorm_ragged(Ss, float(-np.float32(params.zero_shift)),
                             normalize=bool(params.normalize_mtx))


def _raw_similarity(qt: dict, buckets, params) -> list:
    """K5 over the :class:`DeviceLibrary` buckets ``buckets`` (one launch;
    ``qt`` :func:`query_tensors`)."""
    return hmap_sim_ragged(qt["aa"], qt["zsse"], qt["conf"],
                           [(b["aa"], b["zsse"], b["conf"]) for b in buckets],
                           float(np.float32(params.alpha)))


def ragged_flags(params) -> dict:
    """K3's cost flags of the HMAP path for ``params.align_type``."""
    at = AlignT(params.align_type)
    zh, zt = ins_zero_flags(at)
    return dict(zero_head=zh, zero_tail=zt, off=2,
                del_free=at in _DEL_FREE_OVERHANG_MODES)


def screen_buckets(qt: dict, library: "DeviceLibrary", params) -> list:
    """K3's ragged input for the whole library: per bucket (S, D, A, B,
    None), S from K5 and then K6, each one launch over every bucket, on
    the library's device, no host sync; ``dp_scores.dp_general_ragged``
    takes the list with :func:`ragged_flags`."""
    buckets = list(library.buckets.values())
    Ss = _znorm(_raw_similarity(qt, buckets, params), params)
    return [(S, b["D"], b["A"], b["B"], None) for S, b in zip(Ss, buckets)]


def bucket_tables(qt: dict, b: dict, params):
    """K3's six table-form tensors for one length bucket: K5 and K6 build
    S, then ``dp_scores.prepare_tables`` rebuilds D from the gap vectors
    and builds the insertion tables there (the input of
    ``dp_scores.dp_general``)."""
    S, = _znorm(_raw_similarity(qt, [b], params), params)
    return dp_scores.prepare_tables(
        S, b["D"], b["A"], b["B"], torch.zeros_like(b["A"]), has_c=False,
        vec_d=True, **ragged_flags(params))


def _k7_costs(bucket, params) -> list:
    """Each pair's host ``DPCosts`` of a :func:`screen_buckets` bucket, as
    the JAX package's ``hmap_device._scores_xla`` (:288-309) builds them:
    S pulled from the device, the deletion table of the min-paired gap
    vectors."""
    S, G, A, B = (x.cpu().numpy() for x in bucket[:4])
    at = AlignT(params.align_type)
    zh, zt = ins_zero_flags(at)
    return [DPCosts(S=S[i], D=affine_deletion_table(
                        np.minimum.outer(G[i, 0], G[i, 0]),
                        np.minimum.outer(G[i, 1], G[i, 1]), at),
                    A=A[i], B=B[i], ins_zero_head_q=zh,
                    ins_zero_tail_q=zt, del_gi_vec=G[i, 0],
                    del_ge_vec=G[i, 1], del_align=at)
            for i in range(S.shape[0])]


def _scores_k7(bucket, params, device) -> np.ndarray:
    """The scores of a bucket K3 cannot hold, as the JAX package scores an
    oversized bucket: :func:`_k7_costs` built exactly by
    ``dp_engine.build_forward_batched`` (K7 on the card), H[-1, -1] per
    pair."""
    res = dp_engine.build_forward_batched(_k7_costs(bucket, params),
                                          device=device)
    return np.asarray([r.H[-1, -1] for r in res], np.float32)


def screen_hmap_device(query, templates, params, k: int = 10,
                       library: DeviceLibrary | None = None, ev=None, *,
                       device: torch.device):
    """One HMAP query against a template library with the similarity built
    on ``device``; scores bit-identical to the JAX package's
    ``screen_profiles`` with an ``HMAPaliEval`` factory.

    K5 once and K6 once (:func:`screen_buckets`), then K3 once
    over every bucket whose t2 it holds (``dp_scores.vec_max_t2``: all of
    them on the CPU) and one copy of the scores to the host; a longer
    template's bucket goes to K7 (:func:`_scores_k7`).  Returns (scores
    float32 (N,), top-k indices, score descending then index
    ascending).  Spans: ``hmap.screen``, and beneath it the library's
    ``hmap.pack`` and ``hmap.copy``, ``hmap.query``, ``k5``, ``k6``,
    ``k3``, ``hmap.pull`` (the scores to the host) and any ``k7``."""
    with profiling.span("hmap.screen"):
        device = torch.device(device)
        if ev is None:
            ev = HMAPaliEval(params)
        if library is None:
            library = DeviceLibrary(templates, ev, device=device)
        with profiling.span("hmap.query"):
            qt = query_tensors(query, device)
        cap = dp_scores.vec_max_t2(device)
        scores = np.zeros(len(library.templates), np.float32)
        fits, big = [], []
        for bk, b in zip(screen_buckets(qt, library, params),
                         library.buckets.values()):
            (fits if cap is None or bk[0].shape[2] <= cap else big).append(
                (bk, b["idx"]))
        if fits:
            out = dp_scores.dp_general_ragged([bk for bk, _ in fits],
                                              **ragged_flags(params))
            with profiling.span("hmap.pull"):
                got = out.cpu().numpy()
            scores[[i for _, idx in fits for i in idx]] = got
        for bk, idx in big:
            scores[idx] = _scores_k7(bk, params, device)
        order = np.lexsort((np.arange(len(scores)), -scores))[:k]
        return scores, order
