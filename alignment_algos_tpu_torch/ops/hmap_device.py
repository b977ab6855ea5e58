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
its plain PyTorch version: K5 (:func:`hmap_sim`) the raw similarity, K6
(:func:`hmap_znorm`) the z-norm and shift.  The z-norm's mean and variance
are strictly serial float32 sums in row-major region order
(``utils/hmath.seq_sum_f32``): ``torch.sum`` and ``torch.cumsum`` round
differently (the CPU accumulates float32 in double, CUDA scans in
parallel), so the plain version is a loop of float32 adds, vectorized only
across pairs.  Its divisions divide by a tensor, never by a Python or CPU
scalar: PyTorch's CUDA division multiplies by the reciprocal of a CPU
scalar, which is not the correctly rounded quotient.  Then K3
(``dp_scores.dp_general_ragged``) scores every bucket of the library in one
launch, its costs built in the kernel from the gap vectors.  There is no
VMEM cap and no host fallback: every bucket goes producer -> K3.
"""

from __future__ import annotations

import numpy as np
import torch

from ..scoring.base import _DEL_FREE_OVERHANG_MODES, ins_zero_flags
from ..scoring.hmap_eval import HMAPaliEval
from ..utils.hmath import seq_sum_f32
from ..utils.params import AlignT, HMAPaliParams
from . import _build, dp_scores
from .expf import expf_plain

__all__ = ["DeviceLibrary", "HMAPaliEval", "HMAPaliParams",
           "bucket_tables", "build_similarity_device", "hmap_sim",
           "hmap_sim_plain", "query_tensors", "ragged_flags",
           "hmap_znorm", "hmap_znorm_plain", "pack_sequence",
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


def hmap_sim(q_aa, q_zsse, q_conf, t_aa, t_zsse, t_conf,
             alpha: float) -> torch.Tensor:
    """K5: raw HMAP similarity (n, q2, t2) of one query against n
    same-length templates.

    q_aa (q2, ka), q_zsse (q2, ks), q_conf (q2,); t_aa (n, t2, ka),
    t_zsse (n, t2, ks), t_conf (n, t2); float32, contiguous, one device.
    CPU tensors run :func:`hmap_sim_plain`; CUDA tensors launch the
    kernel."""
    dev = t_aa.device
    _check_f32(dev, q_aa=q_aa, q_zsse=q_zsse, q_conf=q_conf, t_aa=t_aa,
               t_zsse=t_zsse, t_conf=t_conf)
    if q_aa.dim() != 2 or t_aa.dim() != 3:
        raise ValueError("q_aa must be (q2, ka) and t_aa (n, t2, ka)")
    q2, ka = q_aa.shape
    n, t2, _ = t_aa.shape
    ks = q_zsse.shape[-1]
    want = {"t_aa": (n, t2, ka), "q_zsse": (q2, ks), "q_conf": (q2,),
            "t_zsse": (n, t2, ks), "t_conf": (n, t2)}
    for name, x in (("t_aa", t_aa), ("q_zsse", q_zsse), ("q_conf", q_conf),
                    ("t_zsse", t_zsse), ("t_conf", t_conf)):
        if tuple(x.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got "
                             f"{tuple(x.shape)}")
    if min(n, ka, ks) < 1 or q2 < 3 or t2 < 3:
        raise ValueError(f"K5 needs n, ka, ks >= 1 and q2, t2 >= 3, got "
                         f"n={n}, q2={q2}, t2={t2}, ka={ka}, ks={ks}")
    stream = _cuda_stream(dev)
    if stream is None:
        return hmap_sim_plain(q_aa, q_zsse, q_conf, t_aa, t_zsse, t_conf,
                              alpha)
    lib = _build.load().lib
    S = torch.empty((n, q2, t2), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.hmap_sim_launch(
            q_aa.data_ptr(), q_zsse.data_ptr(), q_conf.data_ptr(),
            t_aa.data_ptr(), t_zsse.data_ptr(), t_conf.data_ptr(),
            float(np.float32(alpha)), S.data_ptr(), n, q2, t2, ka, ks,
            stream)
    _build.check(err, "hmap_sim_launch")
    hmap_sim.launches += 1
    return S


hmap_sim.launches = 0


# ------------------------------------------------ K6: z-norm and the shift

def serial_sums(v: torch.Tensor):
    """(n, m) -> (acc, acc2) (n,): sum v and sum v*v along m as one strictly
    serial float32 chain per row, from 0 (fl(0 + x) = x).  Equals
    utils/hmath.seq_sum_f32; torch.sum and torch.cumsum do not."""
    n, m = v.shape
    acc = torch.zeros((n,), dtype=torch.float32, device=v.device)
    acc2 = torch.zeros((n,), dtype=torch.float32, device=v.device)
    cols = v.t().contiguous()
    sq = cols * cols                           # each square rounded alone
    for r in range(m):
        acc.add_(cols[r])
        acc2.add_(sq[r])
    return acc, acc2


def _znorm_stats_plain(S: torch.Tensor):
    """Mean and standard deviation of each pair's [1, q2-1) x [1, t2-1)
    region, exactly as hmath.norm_elements_vec (JAX ``_znorm_scalars``)."""
    n, q2, t2 = S.shape
    acc, acc2 = serial_sums(S[:, 1:q2 - 1, 1:t2 - 1].reshape(n, -1))
    m = torch.full_like(acc, float((q2 - 2) * (t2 - 2)))
    avg = acc / m
    var = acc2 / m - avg * avg
    return avg, sqrt_rn(var)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root: in float64, rounded once
    (exact for sqrt).  float32 ``torch.sqrt`` on the CPU is not correctly
    rounded (about 0.6% of random inputs come out 1 ulp off)."""
    return torch.sqrt(x.double()).to(torch.float32)


def hmap_znorm_plain(S: torch.Tensor, zero_shift: float, *,
                     normalize: bool = True) -> torch.Tensor:
    """Plain version of K6 (hmap_device.py:161-167 of the JAX package):
    (S - avg) / std + zero_shift inside the region (only + zero_shift when
    not normalizing), 0 on the borders.  ``zero_shift`` is the signed shift
    (the params' zero_shift negated)."""
    n, q2, t2 = S.shape
    border = _border(q2, t2, S.device)
    if normalize:
        avg, std = _znorm_stats_plain(S)
        S = torch.where(border, S, (S - avg[:, None, None])
                        / std[:, None, None])
    shift = torch.tensor(zero_shift, dtype=torch.float32, device=S.device)
    S = torch.where(border, S, S + shift)
    return torch.where(border, 0.0, S)


def hmap_znorm(S: torch.Tensor, zero_shift: float, *,
               normalize: bool = True) -> torch.Tensor:
    """K6: z-normalize and shift a (n, q2, t2) similarity stack; returns a
    new tensor.  CPU tensors run :func:`hmap_znorm_plain`; CUDA tensors
    launch the kernel (its stats pass only when ``normalize``)."""
    dev = S.device
    _check_f32(dev, S=S)
    if S.dim() != 3:
        raise ValueError(f"S must be (n, q2, t2), got {tuple(S.shape)}")
    n, q2, t2 = S.shape
    if n < 1 or q2 < 3 or t2 < 3:
        raise ValueError(f"K6 needs n >= 1 and q2, t2 >= 3, got n={n}, "
                         f"q2={q2}, t2={t2}")
    stream = _cuda_stream(dev)
    if stream is None:
        return hmap_znorm_plain(S, zero_shift, normalize=normalize)
    lib = _build.load().lib
    out = torch.empty_like(S)
    stats = torch.empty((n, 2), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.hmap_znorm_launch(
            S.data_ptr(), out.data_ptr(), stats.data_ptr(),
            float(np.float32(zero_shift)), n, q2, t2, int(bool(normalize)),
            stream)
    _build.check(err, "hmap_znorm_launch")
    hmap_znorm.launches += 1
    return out


hmap_znorm.launches = 0


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
    ``D`` (n, 2, t2) gap-init/extension vectors, ``A`` and ``B`` (n, t2)."""

    def __init__(self, templates, ev, *, device: torch.device):
        self.templates = templates
        self.device = torch.device(device)
        self.buckets: dict[int, dict] = {}
        packed: dict[int, dict] = {}
        for idx, t in enumerate(templates):
            b = packed.setdefault(t.size(), {"idx": [], "seq": [],
                                             "cost": []})
            b["idx"].append(idx)
            b["seq"].append(pack_sequence(t))
            b["cost"].append(pack_template_costs(ev, t))
        for t2, b in packed.items():
            self.buckets[t2] = self._bucket(
                b["idx"],
                np.stack([s["aa"] for s in b["seq"]]),
                np.stack([s["zsse"] for s in b["seq"]]),
                np.stack([s["conf"] for s in b["seq"]]),
                np.stack([np.stack([c["gi"], c["ge"]]) for c in b["cost"]]),
                np.stack([c["A"] for c in b["cost"]]),
                np.stack([c["B"] for c in b["cost"]]))

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


def _similarity(qt: dict, b: dict, params) -> torch.Tensor:
    """K5 then K6 for one bucket (``b`` a :class:`DeviceLibrary` bucket,
    ``qt`` :func:`query_tensors`)."""
    return build_similarity_device(
        qt["aa"], qt["zsse"], qt["conf"], b["aa"], b["zsse"], b["conf"],
        float(np.float32(params.alpha)), float(-np.float32(params.zero_shift)),
        normalize=bool(params.normalize_mtx))


def ragged_flags(params) -> dict:
    """K3's cost flags of the HMAP path for ``params.align_type``."""
    at = AlignT(params.align_type)
    zh, zt = ins_zero_flags(at)
    return dict(zero_head=zh, zero_tail=zt, off=2,
                del_free=at in _DEL_FREE_OVERHANG_MODES)


def screen_buckets(qt: dict, library: "DeviceLibrary", params) -> list:
    """K3's ragged input for the whole library: per bucket (S, D, A, B,
    None), S from K5 and K6 on the library's device (launched per bucket,
    no host sync); ``dp_scores.dp_general_ragged`` takes the list with
    :func:`ragged_flags`."""
    return [(_similarity(qt, b, params), b["D"], b["A"], b["B"], None)
            for b in library.buckets.values()]


def bucket_tables(qt: dict, b: dict, params):
    """K3's six table-form tensors for one length bucket: K5 and K6 build
    S, then ``dp_scores.prepare_tables`` rebuilds D from the gap vectors
    and builds the insertion tables there (the input of
    ``dp_scores.dp_general``)."""
    f = ragged_flags(params)
    return dp_scores.prepare_tables(
        _similarity(qt, b, params), b["D"], b["A"], b["B"],
        torch.zeros_like(b["A"]), has_c=False, vec_d=True, **f)


def screen_hmap_device(query, templates, params, k: int = 10,
                       library: DeviceLibrary | None = None, ev=None, *,
                       device: torch.device):
    """One HMAP query against a template library with the similarity built
    on ``device``; scores bit-identical to the JAX package's
    ``screen_profiles`` with an ``HMAPaliEval`` factory.

    K5 and K6 per length bucket (:func:`screen_buckets`), then K3 once
    over the whole library and one copy of the scores to the host.
    Returns (scores float32 (N,), top-k indices, score descending then
    index ascending)."""
    device = torch.device(device)
    if ev is None:
        ev = HMAPaliEval(params)
    if library is None:
        library = DeviceLibrary(templates, ev, device=device)
    qt = query_tensors(query, device)
    out = dp_scores.dp_general_ragged(screen_buckets(qt, library, params),
                                      **ragged_flags(params))
    scores = np.zeros(len(library.templates), np.float32)
    scores[[i for b in library.buckets.values() for i in b["idx"]]] = \
        out.cpu().numpy()
    order = np.lexsort((np.arange(len(scores)), -scores))[:k]
    return scores, order
