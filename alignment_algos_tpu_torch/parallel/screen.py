"""Library, grid and profile screens over a mesh of devices (counterpart of
``alignment_algos_tpu/parallel/screen.py``).

One query against a template library: K1 scores every template, then a
deterministic top-k ranks them (score descending, library index ascending,
as the JAX package's ``jax.lax.top_k`` does).  The exact profile screen
scores with the reference evaluators through K3 (``ops/dp_scores``), and
on K7 a bucket past K3's shared-memory cap.

A :class:`Mesh` lays devices out on named axes, as ``jax.sharding.Mesh``
does.  ``screen_library`` splits the library over its entries, each
shard scored on its entry's device with its own top k; ``screen_grid``
splits queries over the first axis and the library over the second;
``screen_profiles`` splits each length bucket over the first axis.  The
merge orders every shard's candidates by score descending, then global
index ascending (:func:`merge_topk`), so every result is the one-device
result bit for bit.  An entry may name a device more than once: its
shards then run one after another there.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import swaffine
from ..ops.swaffine import to_device  # counterpart of the JAX ``_put``
from ..utils import profiling
from ..utils.torchenv import device_from_env

__all__ = ["Mesh", "default_mesh", "grid_mesh", "merge_topk",
           "screen_grid", "screen_library", "screen_library_host",
           "screen_profiles", "shard_bounds", "to_device"]

# the most lanes (query x template pairs) one K1 launch of a grid block
# takes: its per-lane codes are (Q + T) x 4 bytes a lane
GRID_LANES = 1 << 16


class Mesh:
    """Devices on named axes: ``devices`` (a numpy object array of
    ``torch.device``), ``axis_names``, ``shape`` (axis name -> size) and
    ``size``, the parts of ``jax.sharding.Mesh`` the screens read."""

    def __init__(self, devices, axis_names):
        arr = np.asarray(devices, dtype=object)
        self.devices = np.empty(arr.shape, dtype=object)
        for pos, d in np.ndenumerate(arr):
            self.devices[pos] = torch.device(d)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names) or not self.devices.size:
            raise ValueError(f"a mesh of shape {self.devices.shape} cannot "
                             f"take the axes {self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def _visible(n: int | None, device) -> list:
    """n entries of ``device``'s type: the first n visible cards (all of
    them for None; fewer raises), or the CPU n times (once for None)."""
    device = device_from_env() if device is None else torch.device(device)
    if n is not None and n < 1:
        raise ValueError(f"a mesh needs at least one entry, got {n}")
    if device.type == "cpu":
        return [torch.device("cpu")] * (n or 1)
    if device.type != "cuda":
        raise ValueError(f"no mesh of {device.type} devices")
    have = torch.cuda.device_count()
    n = have if n is None else n
    if have < n:
        raise RuntimeError(f"a mesh of {n} cards needs {n} visible cards; "
                           f"{have} visible")
    return [torch.device("cuda", i) for i in range(n)]


def default_mesh(n_devices: int | None = None, axis: str = "dp", *,
                 device: torch.device | None = None) -> Mesh:
    """A 1-D mesh of the first ``n_devices`` devices of ``device``'s type
    (default :func:`device_from_env`)."""
    return Mesh(_visible(n_devices, device), (axis,))


def grid_mesh(shape: tuple[int, int], axes=("qb", "lib"), *,
              device: torch.device | None = None) -> Mesh:
    """2-D mesh: query blocks on one axis, library shards on the other."""
    devs = _visible(shape[0] * shape[1], device)
    return Mesh(np.array(devs, dtype=object).reshape(shape), axes)


def shard_bounds(n: int, shards: int) -> list:
    """(lo, hi) of each of ``shards`` contiguous shards of n rows, ceil(n /
    shards) rows each, the last ones shorter or empty: the JAX package's
    padded layout (``_pad_library``) without its pad rows."""
    per = -(-n // shards)
    return [(min(s * per, n), min((s + 1) * per, n)) for s in range(shards)]


def merge_topk(scores: np.ndarray, idx: np.ndarray, k: int):
    """The top k candidates along the last axis: score descending, then
    index ascending (stable sorts; ``idx`` holds distinct global
    indices)."""
    o = np.argsort(idx, axis=-1, kind="stable")
    scores, idx = (np.take_along_axis(x, o, -1) for x in (scores, idx))
    o = np.argsort(-scores, axis=-1, kind="stable")[..., :k]
    return (np.take_along_axis(scores, o, -1),
            np.take_along_axis(idx, o, -1))


def _top(scores: torch.Tensor, k: int):
    """The top k of ``scores`` on their device (score desc, ties by index
    asc: a stable sort of the negated scores; ``torch.topk`` promises no
    tie order)."""
    order = torch.sort(-scores, stable=True).indices[:k]
    return scores[order], order


def _launch_shards(q_codes, t_codes, table, gi: float, ge: float, k: int,
                   devices, bounds) -> list:
    """Each non-empty shard ``bounds[s]`` copied to ``devices[s]``, scored
    there by K1 and ranked by its own top min(k, shard size), nothing read
    back: [(scores, order, lo)] on the devices.  Span: ``mesh.shard`` a
    shard (counters ``card``, the shard's position s, which is the card's
    index on a mesh of distinct cards, and ``templates``), around its
    ``to_device`` and ``k1``."""
    pending = []
    for card, (dev, (lo, hi)) in enumerate(zip(devices, bounds)):
        if lo == hi:
            continue
        with profiling.span("mesh.shard", card=card, templates=hi - lo):
            q, t, tab, gap = to_device(q_codes, t_codes[lo:hi], table, gi,
                                       ge, dev)
            s, i = _top(swaffine.sw_affine_scores(q, t, tab, gap),
                        min(k, hi - lo))
        pending.append((s, i, lo))
    return pending


def _pull(pending: list) -> tuple:
    """Every shard's candidates, concatenated in shard order as numpy
    (scores float32, global indices int64): waits for each card in turn.
    Span: ``screen.topk``."""
    with profiling.span("screen.topk"):
        return (np.concatenate([s.cpu().numpy() for s, _, _ in pending]),
                np.concatenate([i.cpu().numpy() + lo
                                for _, i, lo in pending]))


def shard_candidates(q_codes, t_codes, table, gi: float, ge: float, k: int,
                     devices, bounds) -> tuple:
    """Each shard ``bounds[s]`` of the library scored on ``devices[s]``
    with its own top min(k, shard size); returns every shard's candidates,
    concatenated in shard order as numpy (scores float32, global indices
    int64).  Every shard is launched before the first is read back."""
    return _pull(_launch_shards(q_codes, t_codes, table, gi, ge, k, devices,
                                bounds))


def screen_library(q_codes: np.ndarray, t_codes: np.ndarray,
                   table: np.ndarray, gi: float, ge: float, k: int = 10, *,
                   mesh: Mesh | None = None,
                   device: torch.device | None = None):
    """One query (Q,) against a library (N, T) of pad-encoded templates.

    Returns (scores float32 (k,), indices int32 (k,)) as numpy arrays, the
    same values and types as the JAX ``screen_library``.  mesh: None = one
    K1 launch on ``device`` (None = :func:`device_from_env`); else the
    library split over the mesh's entries (:func:`shard_bounds`), one K1
    launch per shard on its entry's device, the candidates merged by
    :func:`merge_topk`.  Spans: ``screen.library``, and beneath it
    ``to_device``, ``k1`` and ``screen.topk`` (the sort and the pull of
    the scores).  With a mesh, ``mesh.shard`` holds each shard's
    ``to_device`` and ``k1`` (the feed), and ``mesh.drain`` the pull
    (``screen.topk``, which waits for the slowest card) and the host merge
    (``mesh.merge``)."""
    with profiling.span("screen.library"):
        t_codes = np.asarray(t_codes, dtype=np.int32)
        k = min(k, t_codes.shape[0])
        if mesh is not None:
            devices = list(mesh.devices.flat)
            pending = _launch_shards(
                q_codes, t_codes, table, gi, ge, k, devices,
                shard_bounds(t_codes.shape[0], len(devices)))
            with profiling.span("mesh.drain"):
                candidates = _pull(pending)
                with profiling.span("mesh.merge"):
                    scores, idx = merge_topk(*candidates, k)
            return scores.astype(np.float32), idx.astype(np.int32)
        device = device_from_env() if device is None else torch.device(device)
        q, t, tab, gap = to_device(q_codes, t_codes, table, gi, ge, device)
        scores = swaffine.sw_affine_scores(q, t, tab, gap)
        with profiling.span("screen.topk"):
            scores, idx = _top(scores, k)
            return (scores.cpu().numpy().astype(np.float32),
                    idx.cpu().numpy().astype(np.int32))


def _block_scores(q_codes: np.ndarray, t_codes: np.ndarray, table, gi, ge,
                  device) -> torch.Tensor:
    """(nq, nt) scores of every query of a block against every template of
    a shard, on ``device``: K1 in its per-lane form, one lane a pair, at
    most :data:`GRID_LANES` lanes a launch (so one range check and host
    sync a launch, not one a query)."""
    q, t, tab, gap = to_device(q_codes, t_codes, table, gi, ge, device)
    nq, nt = q.shape[1], t.shape[1]
    step = max(1, GRID_LANES // nt)
    rows = []
    for lo in range(0, nq, step):
        m = min(step, nq - lo)
        lanes_q = q[:, lo:lo + m].repeat_interleave(nt, dim=1)
        rows.append(swaffine.sw_affine_scores(
            lanes_q, t.repeat(1, m), tab, gap).view(m, nt))
    return torch.cat(rows)


def screen_grid(q_codes: np.ndarray, t_codes: np.ndarray, table: np.ndarray,
                gi: float, ge: float, k: int = 5, *, mesh: Mesh | None = None,
                device: torch.device | None = None):
    """Many queries (nq, Q) against a library (nt, T) on a 2-D (query
    block, library shard) mesh; default ``grid_mesh((1, n))`` over the n
    visible devices of ``device``'s type.

    Each block is scored on its entry's device (:func:`_block_scores`);
    every block is launched before the first is read back.  Each query's
    top k ranks its row, every library shard's scores, by
    :func:`merge_topk`.  Returns (scores float32 (nq, nt), topk_scores
    float32 (nq, k), topk_idx int32 (nq, k)), the JAX ``screen_grid``'s
    values and types."""
    if mesh is None:
        mesh = grid_mesh((1, len(_visible(None, device))), device=device)
    q_codes = np.asarray(q_codes, dtype=np.int32)
    t_codes = np.asarray(t_codes, dtype=np.int32)
    nq, nt = q_codes.shape[0], t_codes.shape[0]
    pending = []
    for a, (qlo, qhi) in enumerate(shard_bounds(nq, mesh.devices.shape[0])):
        for b, (tlo, thi) in enumerate(shard_bounds(nt,
                                                    mesh.devices.shape[1])):
            if qlo < qhi and tlo < thi:
                pending.append((qlo, qhi, tlo, thi, _block_scores(
                    q_codes[qlo:qhi], t_codes[tlo:thi], table, gi, ge,
                    mesh.devices[a, b])))
    scores = np.empty((nq, nt), np.float32)
    for qlo, qhi, tlo, thi, sc in pending:
        scores[qlo:qhi, tlo:thi] = sc.cpu().numpy()
    ts, ti = merge_topk(scores, np.broadcast_to(np.arange(nt), scores.shape),
                        min(k, nt))
    return scores, ts, ti.astype(np.int32)


def screen_library_host(q_codes, t_codes, table, gi, ge, k=10, *,
                        device: torch.device | None = None):
    """Reference for testing: the plain version on ``device`` (default the
    CPU), ranked on the host with ``np.lexsort``."""
    device = torch.device("cpu") if device is None else torch.device(device)
    q, t, tab, gap = to_device(q_codes, np.asarray(t_codes), table, gi, ge,
                               device)
    sd = swaffine.skewed_similarity(q, t, tab)
    scores = swaffine.sw_affine_scores_plain(
        sd, gap, q=q.shape[0], t=t.shape[0]).cpu().numpy()
    order = np.lexsort((np.arange(len(scores)), -scores))
    top = order[:k]
    return scores[top], top


def _bucket_scores(costs: list, device, local: bool = False) -> np.ndarray:
    """Optimal global scores of one same-shape bucket of cost models on
    ``device``: K3 (``dp_scores.forward_scores_batch``) when its form
    holds the bucket's t2 (``dp_scores.max_t2``; no cap on the CPU), else
    K7 (``dp_engine.build_forward_batched``) and H[-1, -1] per pair, as the
    JAX package scores a bucket past its kernels' caps."""
    from ..ops import dp_engine, dp_scores

    cap = dp_scores.max_t2(costs, device)
    if cap is None or costs[0].t_size <= cap:
        return dp_scores.forward_scores_batch(costs, local, device=device)
    res = dp_engine.build_forward_batched(costs, local, device=device)
    return np.asarray([r.H[-1, -1] for r in res], np.float32)


def _sharded_bucket_scores(batch: list, mesh: Mesh,
                           local: bool = False) -> np.ndarray:
    """One same-shape bucket split over the mesh's first axis
    (:func:`shard_bounds`), each shard scored on its entry's device by
    :func:`_bucket_scores`.  Each pair's computation is unchanged, so the
    concatenated scores equal one device's bit for bit."""
    devices = mesh.devices.reshape(mesh.devices.shape[0], -1)[:, 0]
    out = np.empty(len(batch), np.float32)
    for dev, (lo, hi) in zip(devices, shard_bounds(len(batch),
                                                   len(devices))):
        if lo < hi:
            out[lo:hi] = _bucket_scores(batch[lo:hi], dev, local)
    return out


def screen_profiles(query, templates, evaluator_factory, k: int = 10, *,
                    device: torch.device, mesh: Mesh | None = None):
    """Exact-scoring profile screen: one query profile against a list of
    template profiles, scores bit-equal to per-pair reference DP builds.

    With no mesh, evaluators of exactly the classes ``HMAPaliEval`` or
    ``Hmap2Eval`` build the similarity on ``device``
    (``hmap_device.screen_hmap_device``, which reuses the first template's
    evaluator for the whole library).  Every other evaluator, subclasses
    of those included (one may keep per-template state or its own gap
    vectors), and every evaluator when a mesh is given (as the JAX package
    routes them), builds its costs on the host per pair; each (q2, t2)
    bucket is scored by :func:`_bucket_scores` on ``device``, or split over
    the mesh's first axis (:func:`_sharded_bucket_scores`).

    evaluator_factory(query, templ) -> evaluator with build_costs().
    Returns (scores float32 (N,), top-k indices, score descending then index
    ascending)."""
    from ..ops import hmap_device
    from ..scoring.hmap2_eval import Hmap2Eval
    from ..scoring.hmap_eval import HMAPaliEval

    device = torch.device(device)
    if mesh is None and templates:
        ev0 = evaluator_factory(query, templates[0])
        if type(ev0) in (HMAPaliEval, Hmap2Eval):
            return hmap_device.screen_hmap_device(
                query, templates, ev0.params, k=k, ev=ev0, device=device)

    buckets: dict[tuple[int, int], list[int]] = {}
    costs = [None] * len(templates)
    for idx, templ in enumerate(templates):
        c = evaluator_factory(query, templ).build_costs(query, templ)
        costs[idx] = c
        buckets.setdefault((c.q_size, c.t_size), []).append(idx)

    scores = np.zeros(len(templates), dtype=np.float32)
    for idxs in buckets.values():
        batch = [costs[i] for i in idxs]
        scores[idxs] = (_bucket_scores(batch, device) if mesh is None
                        else _sharded_bucket_scores(batch, mesh))
    order = np.lexsort((np.arange(len(scores)), -scores))[:k]
    return scores, order
