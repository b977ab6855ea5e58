"""Batched local affine-gap Smith-Waterman (Gotoh) on PyTorch + CUDA.

Counterpart of ``alignment_algos_tpu/ops/swaffine.py``.  Three
hand-written Hopper kernels carry the screen:

* :func:`sw_affine_scores` (K1, ``csrc/sw_gotoh.cu``): (B,) best local
  scores.  It replaces the TPU's ``swscan._rowscan_kernel``,
  ``swstrip._sw_strip_kernel`` and ``swaffine._sw_kernel``, which compute
  one function (their docstrings and tests say bit-equal).
* :func:`sw_affine_tb` (K2, same file): per-cell traceback codes, per-row
  running max and its anti-diagonal.  It replaces
  ``swaffine._sw_tb_kernel``.
* :func:`sw_decode` (K8, ``csrc/sw_decode.cu``): the walk of K2's codes
  into matched-pair records, in the mode :func:`k8_plan` picks.  It
  replaces the XLA device loop ``swaffine._decode_tb_device``.

Beside each kernel is its plain PyTorch version, a line-by-line port of
the JAX twin (``sw_affine_scores_xla`` / ``sw_affine_tb_xla`` over the
skewed similarity; ``_decode_tb_device``'s loop).  A wrapper given CPU
tensors runs the plain version; given CUDA tensors it launches its kernel
or raises (no fallback).  Every value is built with float32 add, subtract
and max in the twins' op order, so kernel, plain version and JAX agree bit
for bit at any gap values.

Kernel input layout (see :func:`to_device`): query codes (Q,) int32 for one
query shared by all lanes, or (Q, B) for one query per lane; template codes
(T, B) int32; substitution table (A, A) float32; gap (2,) float32
``[gi, ge]``.  Unlike the TPU package nothing is padded to tile multiples.
On a card :func:`to_device` writes the (T, B) and (Q, B) codes with a
fourth kernel, :func:`transpose_codes` (``csrc/layout.cu``), from the host's
(B, T) and (B, Q) copied as they stand.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils import profiling
from . import _build

NEG = -3.0e38
MAX_ALPHABET = 64     # the table is staged whole in shared memory


def to_device(q_codes, t_codes, table, gi: float, ge: float,
              device: torch.device):
    """Host arrays in the JAX package's layout -> the kernels' tensors.

    q_codes (Q,) or (B, Q) -> (Q,) or (Q, B) int32; t_codes (B, T) ->
    (T, B) int32; table -> (A, A) float32; gi, ge -> (2,) float32.  To a
    card the 2-D codes are copied as they stand (no host copy of a
    C-contiguous int32 array) and :func:`transpose_codes` lays them out
    there; elsewhere numpy transposes them on the host.  Spans:
    ``to_device``, and beneath it ``to_device.layout`` (the host layout,
    and on a card again after the copy: the transposes' launches) and
    ``to_device.copy``, which counts ``h2d_bytes`` to a card."""
    card = torch.device(device).type == "cuda"
    with profiling.span("to_device"):
        with profiling.span("to_device.layout"):
            q = np.asarray(q_codes, dtype=np.int32)
            t = np.asarray(t_codes, dtype=np.int32)
            tab = np.asarray(table, dtype=np.float32)
            gap = np.array([gi, ge], dtype=np.float32)
            if card:
                host = [np.ascontiguousarray(x) for x in (q, t, tab, gap)]
            else:
                host = [np.array(x, order="C")
                        for x in (q.T, t.T, tab, gap)]
        with profiling.span("to_device.copy"):
            if profiling.recording() and card:
                profiling.count("h2d_bytes", sum(x.nbytes for x in host))
            out = [torch.from_numpy(x).to(device) for x in host]
        if card:
            with profiling.span("to_device.layout"):
                # the (B, T) staging tensors go once their launches queue
                out[:2] = [transpose_codes(x) if x.dim() == 2 else x
                           for x in out[:2]]
        return tuple(out)


def transpose_codes(x: torch.Tensor) -> torch.Tensor:
    """(R, C) int32 on a card -> its (C, R) transpose, contiguous: one
    launch of ``csrc/layout.cu``'s ``transpose_i32_kernel`` on the current
    stream (none when R or C is 0).  Elsewhere :func:`to_device`
    transposes on the host."""
    if (x.device.type != "cuda" or x.dtype != torch.int32 or x.dim() != 2
            or not x.is_contiguous()):
        raise ValueError(f"expected a contiguous 2-D int32 CUDA tensor, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    rows, cols = x.shape
    out = torch.empty((cols, rows), dtype=torch.int32, device=x.device)
    if out.numel():
        with torch.cuda.device(x.device):
            err = _build.load().lib.transpose_i32_launch(
                x.data_ptr(), out.data_ptr(), rows, cols,
                torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(err, "transpose_i32_launch")
        transpose_codes.launches += 1
    return out


transpose_codes.launches = 0


# ---------------------------------------------------------------- producers

def _sim_qtb(q: torch.Tensor, t: torch.Tensor,
             table: torch.Tensor) -> torch.Tensor:
    """Kernel-layout codes -> (Q, T, B) similarity [i, j, b] =
    table[q[i(, b)], t[j, b]], by gather (exact, no matmul)."""
    rows = table[q.long()]                         # (Q, A) or (Q, B, A)
    tl = t.long()                                  # (T, B)
    if q.dim() == 1:
        return rows[:, tl]                         # (Q, T, B)
    nq, b = q.shape
    idx = tl.t().unsqueeze(0).expand(nq, b, tl.shape[0])
    return torch.gather(rows, 2, idx).permute(0, 2, 1)


def _skew(sim: torch.Tensor) -> torch.Tensor:
    """(Q, T, B) -> (D, Q, B) with slab d holding sim[i, d-i, b] (0 off the
    band), D = Q + T - 1."""
    nq, nt, _ = sim.shape
    dev = sim.device
    d = torch.arange(nq + nt - 1, device=dev)[:, None]
    i = torch.arange(nq, device=dev)[None, :]
    j = d - i
    valid = (j >= 0) & (j < nt)
    sd = sim[i.expand_as(j), j.clamp(0, nt - 1)]
    return torch.where(valid[..., None], sd, torch.zeros((), dtype=sd.dtype,
                                                         device=dev))


def skewed_similarity(q: torch.Tensor, t: torch.Tensor,
                      table: torch.Tensor) -> torch.Tensor:
    """Kernel-layout codes (see :func:`to_device`) -> (D, Q, B) skewed
    similarity: the plain versions' input."""
    return _skew(_sim_qtb(q, t, table))


def similarity_from_codes(q_codes: torch.Tensor, t_codes: torch.Tensor,
                          table: torch.Tensor) -> torch.Tensor:
    """(B, Q) x (B, T) codes + (A, A) table -> (B, Q, T) similarity."""
    return _sim_qtb(q_codes.t(), t_codes.t(), table).permute(2, 0, 1)


def skewed_similarity_from_codes(q_codes: torch.Tensor,
                                 t_codes: torch.Tensor,
                                 table: torch.Tensor) -> torch.Tensor:
    """(B, Q) x (B, T) codes -> (D, Q, B) skewed similarity, batch last:
    [d, i, b] = table[q[b, i], t[b, d-i]]."""
    return skewed_similarity(q_codes.t(), t_codes.t(), table)


# ----------------------------------------------------------- plain versions

def _shift_down(x: torch.Tensor) -> torch.Tensor:
    """Row i takes row i-1; row 0 takes 0."""
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]])


def sw_affine_scores_plain(sd: torch.Tensor, gap: torch.Tensor, *, q: int,
                           t: int) -> torch.Tensor:
    """Port of ``sw_affine_scores_xla``: a loop over skewed diagonals.
    sd: (D, Qp, B) skewed similarity; gap: (2,) [gi, ge] -> (B,) scores."""
    nd, qp, b = sd.shape
    dev = sd.device
    gi, ge = gap[0], gap[1]
    ii = torch.arange(qp, device=dev)[:, None]
    row0 = ii == 0
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    neg = torch.full((), NEG, dtype=torch.float32, device=dev)
    hm1 = hm2 = torch.zeros((qp, b), dtype=torch.float32, device=dev)
    e = f = torch.full((qp, b), NEG, dtype=torch.float32, device=dev)
    m = torch.zeros((qp, b), dtype=torch.float32, device=dev)
    for d in range(nd):
        s = sd[d].float()
        jj = d - ii
        valid = (ii < q) & (jj >= 0) & (jj < t)
        e_new = torch.maximum(e - ge, hm1 - gi)
        f_new = torch.maximum(
            torch.where(row0, neg, _shift_down(f) - ge),
            torch.where(row0, neg, _shift_down(hm1) - gi))
        h_new = torch.maximum(torch.maximum(_shift_down(hm2) + s, zero),
                              torch.maximum(e_new, f_new))
        h_new = torch.where(valid, h_new, zero)
        e = torch.where(valid, e_new, neg)
        f = torch.where(valid, f_new, neg)
        m = torch.maximum(m, h_new)
        hm2, hm1 = hm1, h_new
    return m.max(dim=0).values


def sw_affine_tb_plain(sd: torch.Tensor, gap: torch.Tensor, *, q: int,
                       t: int):
    """Port of ``sw_affine_tb_xla``: returns (tb (D, Qp, B) int8 codes,
    m (Qp, B) float32 running max, dat (Qp, B) int32 diagonal of max)."""
    nd, qp, b = sd.shape
    dev = sd.device
    gi, ge = gap[0], gap[1]
    ii = torch.arange(qp, device=dev)[:, None]
    row0 = ii == 0
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    neg = torch.full((), NEG, dtype=torch.float32, device=dev)
    hm1 = hm2 = torch.zeros((qp, b), dtype=torch.float32, device=dev)
    e = f = torch.full((qp, b), NEG, dtype=torch.float32, device=dev)
    m = torch.zeros((qp, b), dtype=torch.float32, device=dev)
    dat = torch.zeros((qp, b), dtype=torch.int32, device=dev)
    tb = torch.empty((nd, qp, b), dtype=torch.int8, device=dev)
    for d in range(nd):
        s = sd[d].float()
        jj = d - ii
        valid = (ii < q) & (jj >= 0) & (jj < t)
        e_open = hm1 - gi
        e_ext = e - ge
        e_new = torch.maximum(e_ext, e_open)
        f_open = torch.where(row0, neg, _shift_down(hm1) - gi)
        f_ext = torch.where(row0, neg, torch.roll(f, 1, dims=0) - ge)
        f_new = torch.maximum(f_ext, f_open)
        diag = _shift_down(hm2) + s
        h_new = torch.maximum(torch.maximum(diag, zero),
                              torch.maximum(e_new, f_new))
        h_new = torch.where(valid, h_new, zero)
        code = torch.where(h_new == 0.0, 0, torch.where(
            h_new == diag, 1, torch.where(h_new == e_new, 2, 3)))
        code = code | torch.where(e_ext > e_open, 4, 0)
        code = code | torch.where(f_ext > f_open, 8, 0)
        tb[d] = torch.where(valid, code, 0).to(torch.int8)
        upd = h_new > m
        dat = torch.where(upd, d, dat)
        m = torch.where(upd, h_new, m)
        hm2, hm1, e, f = hm1, h_new, e_new, f_new
    return tb, m, dat


# ---------------------------------------------------------------- kernels

def _check_inputs(q_codes, t_codes, table, gap):
    """Validate the kernels' input contract; returns (Q, T, B, A)."""
    dev = t_codes.device
    for name, x, dt in (("q_codes", q_codes, torch.int32),
                        ("t_codes", t_codes, torch.int32),
                        ("table", table, torch.float32),
                        ("gap", gap, torch.float32)):
        if x.dtype != dt:
            raise TypeError(f"{name}: expected {dt}, got {x.dtype}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, t_codes on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if t_codes.dim() != 2:
        raise ValueError(f"t_codes must be (T, B), got {tuple(t_codes.shape)}")
    nt, b = t_codes.shape
    if q_codes.dim() not in (1, 2) or (q_codes.dim() == 2
                                       and q_codes.shape[1] != b):
        raise ValueError(f"q_codes must be (Q,) or (Q, {b}), got "
                         f"{tuple(q_codes.shape)}")
    nq = q_codes.shape[0]
    if min(nq, nt, b) < 1:
        raise ValueError(f"empty problem: Q={nq}, T={nt}, B={b}")
    if table.dim() != 2 or table.shape[0] != table.shape[1] \
            or table.shape[0] > MAX_ALPHABET:
        raise ValueError(f"table must be (A, A) with A <= {MAX_ALPHABET}, "
                         f"got {tuple(table.shape)}")
    if tuple(gap.shape) != (2,):
        raise ValueError(f"gap must be (2,) [gi, ge], got {tuple(gap.shape)}")
    a = table.shape[0]
    # the kernels index the shared-memory table with these codes; one
    # reduction, so one host sync per launch
    q_lo, q_hi, t_lo, t_hi = torch.stack(
        [*torch.aminmax(q_codes), *torch.aminmax(t_codes)]).tolist()
    for name, lo, hi in (("q_codes", q_lo, q_hi), ("t_codes", t_lo, t_hi)):
        if lo < 0 or hi >= a:
            raise ValueError(f"{name} holds codes outside [0, {a})")
    return nq, nt, b, a


def _launch(entry: str, q_codes, t_codes, table, gap, nt, b, *outs):
    lib = _build.load().lib
    dev = t_codes.device
    nq = q_codes.shape[0]
    # the boundary row between query chunks: (B, T) H and F, only when one
    # warp's stripes do not cover the query
    shape = (b, nt) if nq > lib.sw_rows_per_warp() else (1,)
    bnd_h = torch.empty(shape, dtype=torch.float32, device=dev)
    bnd_f = torch.empty(shape, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, entry)(
            q_codes.data_ptr(), int(q_codes.dim() == 2), t_codes.data_ptr(),
            table.data_ptr(), table.shape[0], gap.data_ptr(),
            bnd_h.data_ptr(), bnd_f.data_ptr(),
            *(o.data_ptr() for o in outs), nq, nt, b, stream)
    _build.check(err, entry)


def sw_affine_scores(q_codes: torch.Tensor, t_codes: torch.Tensor,
                     table: torch.Tensor, gap: torch.Tensor) -> torch.Tensor:
    """K1: (B,) local affine SW scores (counterpart of
    ``sw_affine_scores_from_skewed`` and ``swstrip.sw_affine_scores_striped``).

    Exact for every gap value, fractional ones included, so the TPU
    package's integer-gap gate (``swscan.supported``) has no counterpart.
    CPU tensors run the plain version; CUDA tensors launch the kernel.
    Spans: ``k1``, counting ``q`` and the ``cells`` launched (Q x T x B),
    and beneath it ``k1.check``, the range check's host sync."""
    with profiling.span("k1"):
        with profiling.span("k1.check"):
            nq, nt, b, _ = _check_inputs(q_codes, t_codes, table, gap)
        profiling.count("q", nq)
        profiling.count("cells", nq * nt * b)
        if t_codes.device.type == "cpu":
            return sw_affine_scores_plain(
                skewed_similarity(q_codes, t_codes, table), gap, q=nq, t=nt)
        if t_codes.device.type != "cuda":
            raise ValueError(f"no kernel for device {t_codes.device}")
        out = torch.empty((b,), dtype=torch.float32, device=t_codes.device)
        _launch("sw_scores_launch", q_codes, t_codes, table, gap, nt, b, out)
        sw_affine_scores.launches += 1
        return out


sw_affine_scores.launches = 0


def sw_affine_tb(q_codes: torch.Tensor, t_codes: torch.Tensor,
                 table: torch.Tensor, gap: torch.Tensor):
    """K2: traceback codes (counterpart of ``sw_affine_tb_from_skewed``).

    Returns (tb (Q+T-1, Q, B) int8 with tb[i+j, i, b] the code of cell
    (i, j), m (Q, B) float32 per-row max, dat (Q, B) int32 anti-diagonal
    of that max).  CPU tensors run the plain version; CUDA tensors launch
    the kernel.  Span: ``k2``."""
    with profiling.span("k2"):
        nq, nt, b, _ = _check_inputs(q_codes, t_codes, table, gap)
        if t_codes.device.type == "cpu":
            return sw_affine_tb_plain(
                skewed_similarity(q_codes, t_codes, table), gap, q=nq, t=nt)
        if t_codes.device.type != "cuda":
            raise ValueError(f"no kernel for device {t_codes.device}")
        dev = t_codes.device
        # zeroed: the kernel writes only the valid cells of each
        # anti-diagonal
        tb = torch.zeros((nq + nt - 1, nq, b), dtype=torch.int8, device=dev)
        m = torch.empty((nq, b), dtype=torch.float32, device=dev)
        dat = torch.empty((nq, b), dtype=torch.int32, device=dev)
        _launch("sw_tb_launch", q_codes, t_codes, table, gap, nt, b, tb, m,
                dat)
        sw_affine_tb.launches += 1
        return tb, m, dat


sw_affine_tb.launches = 0


# ----------------------------------------------------------------- decode

def decode_local_tracebacks(tb: np.ndarray, m: np.ndarray, dat: np.ndarray,
                            q: int, t: int, nb: int | None = None):
    """Vectorized host decode of the traceback codes (a copy of the JAX
    package's numpy decode).

    Returns (scores (B,), paths) where paths[b] is the list of matched
    (query_idx, template_idx) 0-based pairs, N-to-C order (empty when the
    best local score is 0)."""
    tb = np.asarray(tb)
    m = np.asarray(m)
    dat = np.asarray(dat)
    b = m.shape[1] if nb is None else nb
    scores = m[:q, :b].max(axis=0)
    bi = m[:q, :b].argmax(axis=0)
    bd = dat[bi, np.arange(b)]

    lanes = np.arange(b)
    i = bi.astype(np.int64)
    j = (bd - bi).astype(np.int64)
    state = np.zeros(b, np.int8)       # 0 = H, 1 = E, 2 = F
    alive = scores > 0.0
    max_steps = q + t + 2
    rec_i = np.full((max_steps, b), -1, np.int32)
    rec_j = np.full((max_steps, b), -1, np.int32)
    for step in range(max_steps):
        if not alive.any():
            break
        inb = alive & (i >= 0) & (j >= 0)
        alive = inb
        if not alive.any():
            break
        c = np.zeros(b, np.int8)
        al = np.where(alive)[0]
        c[al] = tb[i[al] + j[al], i[al], lanes[al]]
        in_h = alive & (state == 0)
        hb = c & 3
        stop = in_h & (hb == 0)
        alive = alive & ~stop
        match = alive & (state == 0) & (hb == 1)
        rec_i[step, match] = i[match]
        rec_j[step, match] = j[match]
        to_e = alive & (state == 0) & (hb == 2)
        to_f = alive & (state == 0) & (hb == 3)
        state = np.where(to_e, 1, np.where(to_f, 2, state)).astype(np.int8)
        i = np.where(match, i - 1, i)
        j = np.where(match, j - 1, j)
        in_e = alive & (state == 1) & ~to_e & ~match
        in_e = in_e | to_e
        in_f = (alive & (state == 2) & ~to_f & ~match) | to_f
        # E consumes one template column; leaves E when the open bit won
        e_ext = (c & 4) != 0
        f_ext = (c & 8) != 0
        j = np.where(in_e, j - 1, j)
        state = np.where(in_e & ~e_ext, 0, state).astype(np.int8)
        i = np.where(in_f, i - 1, i)
        state = np.where(in_f & ~f_ext, 0, state).astype(np.int8)
    return scores, _paths(rec_i, rec_j, b)


def _paths(rec_i: np.ndarray, rec_j: np.ndarray, b: int):
    paths = []
    for lane in range(b):
        msk = rec_i[:, lane] >= 0
        pi = rec_i[msk, lane][::-1]
        pj = rec_j[msk, lane][::-1]
        paths.append(list(zip(pi.tolist(), pj.tolist())))
    return paths


def decode_tb_plain(tb: torch.Tensor, m: torch.Tensor, dat: torch.Tensor,
                    *, q: int, t: int, b: int):
    """K8's plain version: a port of the JAX ``_decode_tb_device`` loop, on
    the tensors' device.  Returns (scores (b,) float32, the column max of
    m[:q, :b]; rec_i, rec_j (q + t + 2, b) int32, the matched (i, j) of
    each walk at the step that matched it, -1 elsewhere).  Stops early
    once no lane is alive (checked every 32 steps); the records are
    unchanged by the steps it skips."""
    dev = tb.device
    lanes = torch.arange(b, device=dev)
    mq = m[:q, :b]
    scores = mq.max(dim=0).values
    bi = mq.argmax(dim=0)                  # first maximum, as jnp.argmax
    bd = dat[bi, lanes].long()
    max_steps = q + t + 2
    i = bi
    j = bd - bi
    state = torch.zeros(b, dtype=torch.int8, device=dev)
    alive = scores > 0.0
    rec_i = torch.full((max_steps, b), -1, dtype=torch.int32, device=dev)
    rec_j = torch.full((max_steps, b), -1, dtype=torch.int32, device=dev)
    nd, qp = tb.shape[0], tb.shape[1]
    for step in range(max_steps):
        if step % 32 == 0 and not bool(alive.any()):
            break
        alive = alive & (i >= 0) & (j >= 0)
        d0 = (i + j).clamp(0, nd - 1)
        i0 = i.clamp(0, qp - 1)
        c = torch.where(alive, tb[d0, i0, lanes].to(torch.int32), 0)
        hb = c & 3
        in_h = alive & (state == 0)
        stop = in_h & (hb == 0)
        alive = alive & ~stop
        match = alive & (state == 0) & (hb == 1)
        rec_i[step] = torch.where(match, i, -1)
        rec_j[step] = torch.where(match, j, -1)
        to_e = alive & (state == 0) & (hb == 2)
        to_f = alive & (state == 0) & (hb == 3)
        state = torch.where(to_e, 1, torch.where(to_f, 2, state)).to(
            torch.int8)
        i = torch.where(match, i - 1, i)
        j = torch.where(match, j - 1, j)
        in_e = (alive & (state == 1) & ~to_e & ~match) | to_e
        in_f = (alive & (state == 2) & ~to_f & ~match) | to_f
        e_ext = (c & 4) != 0
        f_ext = (c & 8) != 0
        j = torch.where(in_e, j - 1, j)
        state = torch.where(in_e & ~e_ext, 0, state).to(torch.int8)
        i = torch.where(in_f, i - 1, i)
        state = torch.where(in_f & ~f_ext, 0, state).to(torch.int8)
    return scores, rec_i, rec_j


K8_WINDOW = (64, 32)      # csrc/sw_decode.cu kDw x kIw: a window's codes
K8_WINDOW_LANES = 512     # lanes up to which a decode takes windows


@dataclass(frozen=True)
class K8Plan:
    """How K8 decodes one shape: ``mode`` "windowed" (one block a lane,
    the lane's codes staged in shared memory in windows of ``dw``
    anti-diagonals x ``iw`` rows) or "lane" (one thread a lane, each step
    read from device memory; dw = iw = 0)."""
    mode: str
    dw: int
    iw: int


def k8_plan(q: int, t: int, b: int, nd: int, qp: int, ldb: int,
            mode: str | None = None) -> K8Plan:
    """K8's plan for a decode of b lanes of q x t walks over tb (nd, qp,
    ldb): windowed up to :data:`K8_WINDOW_LANES` lanes, where a window's
    load and shared-memory steps beat a device-memory latency a step, else
    the lane mode, whose traffic is one sector a step against a window's
    sector a cell once ldb >= 32 (the windowed mode's traffic grows with
    the lanes, the lane mode's time stays a walk's latency).  ``mode``
    forces one.  A window is :data:`K8_WINDOW` clipped to the matrix (nd x
    qp)."""
    if mode is None:
        mode = "windowed" if b <= K8_WINDOW_LANES else "lane"
    if mode == "lane":
        return K8Plan("lane", 0, 0)
    if mode != "windowed":
        raise ValueError(f"K8 has no mode {mode!r}")
    return K8Plan("windowed", min(K8_WINDOW[0], nd), min(K8_WINDOW[1], qp))


def _check_decode(tb, m, dat, q: int, t: int, b: int) -> None:
    """Validate K8's input contract (tb (ND, QP, LDB) int8; m, dat (>= q,
    LDM) float32 / int32; 1 <= b <= min(LDB, LDM))."""
    dev = tb.device
    for name, x, dt in (("tb", tb, torch.int8), ("m", m, torch.float32),
                        ("dat", dat, torch.int32)):
        if x.dtype != dt:
            raise TypeError(f"{name}: expected {dt}, got {x.dtype}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, tb on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tb.dim() != 3 or m.dim() != 2 or dat.shape != m.shape:
        raise ValueError(f"expected tb (ND, QP, LDB) and m, dat (rows, LDM) "
                         f"of one shape; got {tuple(tb.shape)}, "
                         f"{tuple(m.shape)}, {tuple(dat.shape)}")
    if min(tb.shape) < 1 or min(q, t, b) < 1 or q > m.shape[0] \
            or b > min(m.shape[1], tb.shape[2]):
        raise ValueError(f"q={q}, t={t}, b={b} do not fit tb "
                         f"{tuple(tb.shape)} and m {tuple(m.shape)}")


def sw_decode(tb: torch.Tensor, m: torch.Tensor, dat: torch.Tensor, *,
              q: int, t: int, b: int, plan: K8Plan | None = None):
    """K8: the traceback decode of K2's codes (counterpart of the JAX
    ``_decode_tb_device``); returns what :func:`decode_tb_plain` returns.

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (``csrc/sw_decode.cu``) in the mode of ``plan`` (default
    :func:`k8_plan`'s; a plan made for another shape raises), with no host
    sync.  Span: ``k8``."""
    with profiling.span("k8"):
        _check_decode(tb, m, dat, q, t, b)
        shape = (q, t, b, *tb.shape)
        if plan is None:
            plan = k8_plan(*shape)
        elif plan != k8_plan(*shape, mode=plan.mode):
            raise ValueError(f"K8: {plan} is not the plan of q, t, b = {q}, "
                             f"{t}, {b} over tb {tuple(tb.shape)}")
        if tb.device.type == "cpu":
            return decode_tb_plain(tb, m, dat, q=q, t=t, b=b)
        if tb.device.type != "cuda":
            raise ValueError(f"no kernel for device {tb.device}")
        dev = tb.device
        max_steps = q + t + 2
        scores = torch.empty((b,), dtype=torch.float32, device=dev)
        # the kernel writes every entry: a match's (i, j), else -1
        rec_i = torch.empty((max_steps, b), dtype=torch.int32, device=dev)
        rec_j = torch.empty((max_steps, b), dtype=torch.int32, device=dev)
        _decode_launch(tb, m, dat, scores, rec_i, rec_j, q, t, b, plan)
        sw_decode.launches += 1
        return scores, rec_i, rec_j


def _decode_launch(tb, m, dat, scores, rec_i, rec_j, q: int, t: int, b: int,
                   plan: K8Plan) -> None:
    """Launch K8 in ``plan``'s mode on the current stream, into the
    outputs ``scores`` (b,), ``rec_i`` and ``rec_j`` (q + t + 2, b)."""
    dev = tb.device
    with torch.cuda.device(dev):
        err = _build.load().lib.sw_decode_launch(
            tb.data_ptr(), m.data_ptr(), dat.data_ptr(), scores.data_ptr(),
            rec_i.data_ptr(), rec_j.data_ptr(), q, t, b, *tb.shape,
            m.shape[1], int(plan.mode == "windowed"), plan.dw, plan.iw,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "sw_decode_launch")


sw_decode.launches = 0


def decode_local_tracebacks_device(tb: torch.Tensor, m: torch.Tensor,
                                   dat: torch.Tensor, q: int, t: int,
                                   nb: int | None = None):
    """Decode on the tensors' device (K8, or its plain version on the CPU),
    then extract paths on the host; the same (scores, paths) as
    :func:`decode_local_tracebacks`.  The pull and the paths are the span
    ``cluster.paths`` (``aat_screen`` clusters its hits through here)."""
    b = m.shape[1] if nb is None else nb
    scores, rec_i, rec_j = sw_decode(tb, m, dat, q=q, t=t, b=b)
    with profiling.span("cluster.paths"):
        return (scores.cpu().numpy(),
                _paths(rec_i.cpu().numpy(), rec_j.cpu().numpy(), b))


def sw_affine_tb_batch(q_codes, t_codes, table, gi: float, ge: float, *,
                       device: torch.device):
    """End-to-end batched local SW with alignments: host codes (B, Q) x
    (B, T) -> K2 and K8 on ``device`` (their plain versions on the CPU).
    Returns (scores (B,), paths) as the JAX package's
    ``sw_affine_tb_batch``; routes on the tensors' device."""
    q, t, tab, gap = to_device(q_codes, t_codes, table, gi, ge, device)
    nq, nt = q.shape[0], t.shape[0]
    tb, m, dat = sw_affine_tb(q, t, tab, gap)
    return decode_local_tracebacks_device(tb, m, dat, nq, nt, nb=t.shape[1])


def sw_affine_reference(s: np.ndarray, gi: float, ge: float) -> np.ndarray:
    """Numpy Gotoh SW oracle for testing: s (B, Q, T) -> (B,) scores (a
    copy of the JAX package's oracle)."""
    b, q, t = s.shape
    out = np.zeros(b, dtype=np.float32)
    for bi in range(b):
        h = np.zeros((q + 1, t + 1), np.float32)
        e = np.full((q + 1, t + 1), -np.inf, np.float32)
        f = np.full((q + 1, t + 1), -np.inf, np.float32)
        best = 0.0
        for i in range(1, q + 1):
            for j in range(1, t + 1):
                e[i, j] = max(e[i, j - 1] - ge, h[i, j - 1] - gi)
                f[i, j] = max(f[i - 1, j] - ge, h[i - 1, j] - gi)
                h[i, j] = max(0.0, h[i - 1, j - 1] + s[bi, i - 1, j - 1],
                              e[i, j], f[i, j])
                best = max(best, h[i, j])
        out[bi] = best
    return out
