"""Library screen on one device (counterpart of
``alignment_algos_tpu/parallel/screen.py``'s ``screen_library`` path).

One query against a template library: K1 scores every template, then a
deterministic top-k ranks them (score descending, library index ascending,
as the JAX package's ``jax.lax.top_k`` does).  The mesh, grid and profile
screens of the JAX module belong to later slices of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import swaffine
from ..ops.swaffine import to_device  # counterpart of the JAX ``_put``
from ..utils.torchenv import device_from_env

__all__ = ["screen_library", "screen_library_host", "to_device"]


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
