"""Batched exact general-gap DP scores on PyTorch + CUDA (counterpart of
``alignment_algos_tpu/ops/dp_scores.py``).

The reference's O(Q*T*(Q+T)) forward recurrence (dpmatrix.h:356-536) on
exact costs.  One hand-written Hopper kernel carries it, K3
(``csrc/dp_general.cu``), behind two wrappers:

* :func:`dp_general_ragged` scores a ragged batch of pairs (length buckets
  of any q2 and t2) in one launch, the costs given as the HMAP gap vectors
  and insertion coefficients; K3 rebuilds D and Cm from them.  The profile
  screen runs it once per screen.
* :func:`dp_general` takes n same-shape pairs with the cost tables built
  (:func:`prepare_tables`, or the host tables of ``dp_pallas``) and
  returns H[q1, t1] per pair, or the full H.
* :func:`dp_general_plain` is the plain PyTorch version: a loop over rows,
  vectorized over (n, t2), with the (n, t2, t2) deletion slab;
  :func:`dp_general_ragged_plain` runs it per bucket after
  :func:`prepare_tables`.

Exactness: every candidate value is fl(H - cost) in the cost tables'
float32 values; the similarity is added after the masked max and the
local clamp comes last (dp_scores.py:29-33: fl(x + s) and max(x, 0) are
monotone, so both orders give the same bits).  Every max propagates NaN.
A gap maximum gets "+0 +" before the similarity, as the JAX kernel adds
its 0 / NEG mask to every candidate, so its sign of zero is +0 whatever
the order of the scan; the other maxima are ordered (:func:`_maxp`) and
the clamp turns -0 into +0, as ``jnp.maximum`` does.  ``torch.maximum``
and ``torch.clamp_min`` fix no sign of zero (on the CPU it differs between
their scalar and vector loops), so the plain version uses none of them
where a sign can survive.  Kernel and plain version therefore agree bit
for bit, -0.0 and NaN inputs included; both equal ``dp_ref``,
``dp_pallas`` and ``dp_scores`` of the JAX package, and on -0.0 and NaN
inputs the scores of its ``dp_scores`` kernel (its full-H ``dp_pallas``
kernel places NaN, and the sign of a few zeros, otherwise).

The TPU's 8-pair sublane groups, 128-lane padding and VMEM cap have no
counterpart and there is no ``supported()`` gate and no fallback: K3 keeps
its rows in shared memory, which holds t2 up to 7,200 in the vector form
and 19,200 in the table form (a longer pair raises at launch).
:func:`vec_max_t2` and :func:`table_max_t2` read the two forms' caps from
the kernel's library, and the profile screens score a longer template's
bucket on K7 instead (``hmap_device.screen_hmap_device``, and
``parallel/screen`` through :func:`max_t2`).  The bounds are the whole matrix,
q0 = t0 = 0, q1 = q2 - 1, t1 = t2 - 1, as every caller uses them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils import profiling
from . import _build

NEG = -3.0e38

__all__ = ["NEG", "PAIR_DTYPE", "dp_general", "dp_general_plain",
           "dp_general_ragged", "dp_general_ragged_plain",
           "forward_scores_batch", "max_t2", "prepare_tables",
           "table_max_t2", "vec_max_t2", "vector_form"]


# ----------------------------------------------------------- plain version

def _maxp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K3's ordered max: ``a`` if a > b or a is NaN, else ``b``."""
    return torch.where((a > b) | torch.isnan(a), a, b)


def _clamp(x: torch.Tensor, local: bool) -> torch.Tensor:
    """max(x, +0) when local (-0.0 becomes +0.0, NaN stays)."""
    return _maxp(x, torch.zeros((), dtype=x.dtype, device=x.device)) \
        if local else x


def _neg_max(x: torch.Tensor, neg: torch.Tensor, dim: int) -> torch.Tensor:
    """+0 + max(NEG, max over ``dim``), NEG for an empty ``dim`` (K3 starts
    each candidate scan at NEG).  ``amax`` may return either zero of a tie;
    the +0 makes a zero maximum +0, as in K3."""
    if x.shape[dim] == 0:
        shape = list(x.shape)
        del shape[dim]
        return neg.expand(shape)
    return torch.maximum(neg, x.amax(dim=dim)) + torch.zeros_like(neg)


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
        best = _maxp(match, _maxp(del_, ins))
        bcol = _clamp((0.0 - ins0[:, i:i + 1]) + sim[:, 1:2], local)
        row = torch.where(interior, best, zero)
        H[:, i] = torch.where(jj == 1, bcol, row)

    hp = H[:, q1 - 1, :]
    sc = S[:, q1, t1]
    match = _clamp(hp[:, t1 - 1] + sc, local)
    dacc = _neg_max(hp[:, 1:t1] - dclose[:, 1:t1], neg, 1)
    # m = 1 .. q1-1 reads row q1 - m at column t1 - 1
    iacc = _neg_max(H[:, 1:q1, t1 - 1].flip(1) - insc[:, 1:q1], neg, 1)
    best = _maxp(match, _maxp(_clamp(dacc + sc, local),
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


# One pair of a K3 launch, as ``struct Pair`` of csrc/dp_general.cu: device
# addresses of S, of its H buffer and of five cost arrays (the vector form:
# gi, ge, A, B, C or 0; the table form: D, Cm, ins0, insc, dclose), then
# q2, t2 and the output slot.
PAIR_DTYPE = np.dtype([("S", "<u8"), ("H", "<u8"), ("c0", "<u8"),
                       ("c1", "<u8"), ("c2", "<u8"), ("c3", "<u8"),
                       ("c4", "<u8"), ("q2", "<i4"), ("t2", "<i4"),
                       ("slot", "<i4"), ("pad", "<i4")])


def _launch(pairs: np.ndarray, out: torch.Tensor, *, vec: bool, local: bool,
            zero_head: bool = False, zero_tail: bool = False,
            del_free: bool = False, off: float = 0.0) -> None:
    """One K3 launch over ``pairs`` (a PAIR_DTYPE array), longest pairs
    first; the descriptors cross in one pinned copy, with no host sync."""
    dev = out.device
    work = pairs["q2"].astype(np.int64) * pairs["t2"] * (pairs["q2"]
                                                         + pairs["t2"])
    pairs = np.ascontiguousarray(pairs[np.argsort(-work, kind="stable")])
    lib = _build.load().lib
    with torch.cuda.device(dev):
        desc = torch.from_numpy(pairs.view(np.uint8)).pin_memory().to(
            dev, non_blocking=True)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dp_general_launch(
            desc.data_ptr(), out.data_ptr(), len(pairs),
            int(pairs["t2"].max()), int(vec), int(bool(local)),
            int(bool(zero_head)), int(bool(zero_tail)), int(bool(del_free)),
            float(np.float32(off)), stream)
    _build.check(err, "dp_general_launch")


def _addr(x) -> tuple:
    """(device address, bytes from one pair to the next) of a per-pair
    float32 tensor; (0, 0), a null pointer, for None."""
    return (0, 0) if x is None else (x.data_ptr(), 4 * x.stride(0))


def _descriptors(shapes, addrs) -> np.ndarray:
    """The pairs of a launch, bucket by bucket: ``shapes`` per bucket (n,
    q2, t2), ``addrs`` per bucket the :func:`_addr` of S, H and the five
    costs.  Pair p of a bucket sits at address + p * step of each; slots
    follow the buckets' order."""
    shapes = np.asarray(shapes, np.int64).reshape(-1, 3)
    addrs = np.asarray(addrs, np.uint64).reshape(-1, 7, 2)
    n = shapes[:, 0]
    pairs = np.zeros(int(n.sum()), PAIR_DTYPE)
    p = (np.arange(len(pairs)) - np.repeat(np.cumsum(n) - n, n)).astype(
        np.uint64)
    for k, name in enumerate(("S", "H", "c0", "c1", "c2", "c3", "c4")):
        pairs[name] = (np.repeat(addrs[:, k, 0], n)
                       + p * np.repeat(addrs[:, k, 1], n))
    pairs["q2"] = np.repeat(shapes[:, 1], n)
    pairs["t2"] = np.repeat(shapes[:, 2], n)
    pairs["slot"] = np.arange(len(pairs))
    return pairs


def dp_general(S, D, Cm, ins0, insc, dclose, *, local: bool = False,
               full_h: bool = False) -> torch.Tensor:
    """K3 on the table form: exact general-gap forward DP for n same-shape
    pairs.

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
    H = torch.empty((n, q2, t2), dtype=torch.float32, device=S.device)
    out = torch.empty((n,), dtype=torch.float32, device=S.device)
    _launch(_descriptors((n, q2, t2), [_addr(x) for x in
                                       (S, H, D, Cm, ins0, insc, dclose)]),
            out, vec=False, local=local)
    dp_general.launches += 1
    return H if full_h else out


dp_general.launches = 0


def _check_ragged(buckets) -> torch.device:
    """Validate the ragged form's input contract; returns the device."""
    if not buckets:
        raise ValueError("K3 needs at least one bucket")
    dev = buckets[0][0].device
    for S, G, A, B, C in buckets:
        if S.dim() != 3:
            raise ValueError(f"S must be (n, q2, t2), got {tuple(S.shape)}")
        n, q2, t2 = S.shape
        if n < 1 or q2 < 3 or t2 < 3:
            raise ValueError(f"K3 needs n >= 1, q2 >= 3 and t2 >= 3, got "
                             f"n={n}, q2={q2}, t2={t2}")
        want = {"S": (n, q2, t2), "G": (n, 2, t2), "A": (n, t2),
                "B": (n, t2), "C": (n, t2)}
        for name, x in zip(want, (S, G, A, B, C)):
            if x is None and name == "C":
                continue
            if x.dtype != torch.float32:
                raise TypeError(f"{name}: expected torch.float32, got "
                                f"{x.dtype}")
            if x.device != dev:
                raise ValueError(f"{name} is on {x.device}, expected {dev}")
            if tuple(x.shape) != want[name]:
                raise ValueError(f"{name} must be {want[name]}, got "
                                 f"{tuple(x.shape)}")
            if not x.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
    return dev


def _ragged_descriptors(buckets, H: torch.Tensor) -> np.ndarray:
    """The vector form's pairs: S, the pair's slice of the flat scratch
    ``H`` (buckets in order), gi and ge (rows 0 and 1 of G), A, B and C."""
    shapes = [tuple(S.shape) for S, *_ in buckets]
    h0 = np.cumsum([0] + [n * q2 * t2 for n, q2, t2 in shapes])
    addrs = [(_addr(S), (H.data_ptr() + 4 * int(h), 4 * q2 * t2), _addr(G),
              (G.data_ptr() + 4 * t2, 8 * t2), _addr(A), _addr(B), _addr(C))
             for (S, G, A, B, C), (_, q2, t2), h in zip(buckets, shapes, h0)]
    return _descriptors(shapes, addrs)


def dp_general_ragged_plain(buckets, *, local: bool = False,
                            zero_head: bool = False, zero_tail: bool = False,
                            off: int = 2, del_free: bool = False
                            ) -> torch.Tensor:
    """Plain version of :func:`dp_general_ragged`: per bucket,
    :func:`prepare_tables` then :func:`dp_general_plain`."""
    outs = []
    for S, G, A, B, C in buckets:
        tabs = prepare_tables(
            S, G, A, B, torch.zeros_like(A) if C is None else C,
            zero_head=zero_head, zero_tail=zero_tail, off=off,
            has_c=C is not None, vec_d=True, del_free=del_free)
        outs.append(dp_general_plain(*tabs, local=local))
    return torch.cat(outs)


def dp_general_ragged(buckets, *, local: bool = False,
                      zero_head: bool = False, zero_tail: bool = False,
                      off: int = 2, del_free: bool = False) -> torch.Tensor:
    """K3 on the vector form: H[q1, t1] of every pair of a ragged batch, in
    one launch.

    ``buckets``: a sequence of (S, G, A, B, C), one per shape: S (n, q2,
    t2) similarity, G (n, 2, t2) the gap-init and gap-extension vectors
    (D[k, j] = min(gi) + min(ge) * (j - k - 2), 0 for j - k < 2; with
    ``del_free`` row 0 and column t1 are 0), A and B (n, t2) the insertion
    coefficients (Cm[m, j] = A[j] + B[j] * (m - off), 0 for m < 2), C (n,
    t2) an added insertion term or None.  ``zero_head`` / ``zero_tail``
    zero the boundary column's and the closing cell's insertion costs.
    All float32, contiguous, on one device.  Returns the scores (sum of n,)
    in bucket order.

    CPU tensors run :func:`dp_general_ragged_plain`; CUDA tensors launch
    the kernel once, on the current stream and without a host sync (a
    build or launch failure raises).  Span: ``k3``."""
    with profiling.span("k3"):
        flags = dict(local=local, zero_head=zero_head, zero_tail=zero_tail,
                     off=off, del_free=del_free)
        dev = _check_ragged(buckets)
        if dev.type == "cpu":
            return dp_general_ragged_plain(buckets, **flags)
        if dev.type != "cuda":
            raise ValueError(f"no kernel for device {dev}")
        # each pair's H scratch (the insertion scan's history), bucket by
        # bucket
        H = torch.empty((sum(S.numel() for S, *_ in buckets),),
                        dtype=torch.float32, device=dev)
        pairs = _ragged_descriptors(buckets, H)
        out = torch.empty((len(pairs),), dtype=torch.float32, device=dev)
        _launch(pairs, out, vec=True, **flags)
        dp_general_ragged.launches += 1
        return out


dp_general_ragged.launches = 0


@functools.lru_cache(maxsize=None)
def _max_t2_on(index: int, vec: bool) -> int:
    with torch.cuda.device(index):
        return int(_build.load().lib.dp_general_max_t2(int(vec)))


def _max_t2(device, vec: bool) -> int | None:
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return _max_t2_on(device.index if device.index is not None
                      else torch.cuda.current_device(), vec)


def vec_max_t2(device) -> int | None:
    """The longest t2 that :func:`dp_general_ragged` takes on ``device``
    (its rows in shared memory: 7,200 on an H100), read from the kernel's
    library once per card; None on the CPU, where the plain version has no
    cap."""
    return _max_t2(device, True)


def table_max_t2(device) -> int | None:
    """The longest t2 that :func:`dp_general` takes on ``device`` (19,200
    on an H100); None on the CPU, as :func:`vec_max_t2`."""
    return _max_t2(device, False)


def vector_form(costs: list) -> bool:
    """Whether :func:`forward_scores_batch` scores ``costs`` in K3's vector
    form (every pair has gap vectors and one deletion mode), else in its
    table form."""
    return all(c.del_gi_vec is not None and c.del_align == costs[0].del_align
               for c in costs)


def max_t2(costs: list, device) -> int | None:
    """The longest t2 that :func:`forward_scores_batch` takes on ``device``
    for ``costs``: the cap of the form it picks (:func:`vector_form`)."""
    return (vec_max_t2 if vector_form(costs) else table_max_t2)(device)


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
    D, and the A/B/C insertion coefficients).  With gap vectors K3 builds
    the costs itself (:func:`dp_general_ragged`); with a full D the tables
    are built there (:func:`prepare_tables`) and K3 runs on them."""
    from ..scoring.base import _DEL_FREE_OVERHANG_MODES
    from . import dp_pallas

    q2, t2 = dp_pallas._bucket_shape(costs)
    if q2 < 3 or t2 < 3:
        return dp_pallas.forward_h_reference(costs, local=local)[:, -1, -1]

    vec_d = vector_form(costs)
    if vec_d:
        D = np.stack([np.stack([c.del_gi_vec, c.del_ge_vec]) for c in costs])
    else:
        D = np.stack([c.D for c in costs])
    has_c = any(c.C is not None for c in costs)
    C = np.stack([np.zeros(t2, np.float32) if c.C is None
                  else c.C.astype(np.float32) for c in costs])
    S, D, A, Bv, C = (torch.from_numpy(np.ascontiguousarray(x, np.float32))
                      .to(device) for x in
                      (np.stack([c.S for c in costs]), D,
                       np.stack([c.A for c in costs]),
                       np.stack([c.B for c in costs]), C))
    flags = dict(zero_head=bool(costs[0].ins_zero_head_q),
                 zero_tail=bool(costs[0].ins_zero_tail_q),
                 off=int(costs[0].ins_dist_offset))
    if vec_d:
        return dp_general_ragged(
            [(S, D, A, Bv, C if has_c else None)], local=local,
            del_free=costs[0].del_align in _DEL_FREE_OVERHANG_MODES,
            **flags).cpu().numpy()
    tables = prepare_tables(S, D, A, Bv, C, has_c=has_c, vec_d=False,
                            del_free=False, **flags)
    return dp_general(*tables, local=local).cpu().numpy()
