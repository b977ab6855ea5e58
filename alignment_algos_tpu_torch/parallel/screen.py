"""Library and profile screens on one device (counterpart of
``alignment_algos_tpu/parallel/screen.py``'s ``screen_library`` and
``screen_profiles``).

One query against a template library: K1 scores every template, then a
deterministic top-k ranks them (score descending, library index ascending,
as the JAX package's ``jax.lax.top_k`` does).  The exact profile screen
scores with the reference evaluators through K3 (``ops/dp_scores``).  The
mesh and grid screens of the JAX module belong to a later slice.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import swaffine
from ..ops.swaffine import to_device  # counterpart of the JAX ``_put``
from ..utils.torchenv import device_from_env

__all__ = ["screen_library", "screen_library_host", "screen_profiles",
           "to_device"]


def _screen_step(q_codes: torch.Tensor, t_codes: torch.Tensor,
                 table: torch.Tensor, gap: torch.Tensor, *, k: int):
    """Scores of one library on its device (K1 on CUDA tensors, its plain
    version on CPU ones), then the top k (score desc, ties by index asc: a
    stable sort of the negated scores; ``torch.topk`` promises no tie
    order)."""
    scores = swaffine.sw_affine_scores(q_codes, t_codes, table, gap)
    order = torch.sort(-scores, stable=True).indices[:k]
    return scores[order], order


def screen_library(q_codes: np.ndarray, t_codes: np.ndarray,
                   table: np.ndarray, gi: float, ge: float, k: int = 10, *,
                   device: torch.device | None = None):
    """One query (Q,) against a library (N, T) of pad-encoded templates.

    Returns (scores float32 (k,), indices int32 (k,)) as numpy arrays, the
    same values and types as the JAX ``screen_library``.  device: None =
    :func:`device_from_env`."""
    device = device_from_env() if device is None else torch.device(device)
    t_codes = np.asarray(t_codes, dtype=np.int32)
    k = min(k, t_codes.shape[0])
    q, t, tab, gap = to_device(q_codes, t_codes, table, gi, ge, device)
    scores, idx = _screen_step(q, t, tab, gap, k=k)
    return (scores.cpu().numpy().astype(np.float32),
            idx.cpu().numpy().astype(np.int32))


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


def screen_profiles(query, templates, evaluator_factory, k: int = 10, *,
                    device: torch.device):
    """Exact-scoring profile screen: one query profile against a list of
    template profiles, scores bit-equal to per-pair reference DP builds.

    Evaluators of exactly the classes ``HMAPaliEval`` or ``Hmap2Eval``
    build the similarity on ``device`` (``hmap_device.screen_hmap_device``,
    which reuses the first template's evaluator for the whole library);
    every other evaluator, subclasses of those included (one may keep
    per-template state or its own gap vectors), builds its costs on the
    host per pair, and each (q2, t2) bucket is scored by K3
    (``dp_scores.forward_scores_batch``).

    evaluator_factory(query, templ) -> evaluator with build_costs().
    Returns (scores float32 (N,), top-k indices, score descending then index
    ascending)."""
    from ..ops import dp_scores, hmap_device
    from ..scoring.hmap2_eval import Hmap2Eval
    from ..scoring.hmap_eval import HMAPaliEval

    device = torch.device(device)
    if templates:
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
        scores[idxs] = dp_scores.forward_scores_batch(
            [costs[i] for i in idxs], device=device)
    order = np.lexsort((np.arange(len(scores)), -scores))[:k]
    return scores, order
