"""Checkpoint/resume for long library screens (counterpart of
``alignment_algos_tpu/parallel/checkpoint.py``, over the port's
``screen_library``).

After each chunk of the library the running global top-k and the set of
completed chunks are written atomically (tmp + rename) to one ``.npz``, so
a preempted sweep rerun with the same arguments resumes where it stopped
and reproduces the direct screen's result bit for bit: the merge is the
same deterministic ranking (score descending, template id ascending).
The file format is the JAX package's, so either package can resume the
other's checkpoint.  With a mesh, each chunk is screened over it.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .screen import Mesh, merge_topk, screen_library


class ScreenCheckpoint:
    """On-disk state of a chunked screen: done-chunk bitmap + running top-k."""

    def __init__(self, path: str, n_chunks: int, k: int):
        self.path = path
        self.n_chunks = n_chunks
        self.done = np.zeros(n_chunks, dtype=bool)
        self.scores = np.empty(0, dtype=np.float32)
        self.idx = np.empty(0, dtype=np.int64)
        self.k = k

    @classmethod
    def load_or_create(cls, path: str, n_chunks: int, k: int):
        self = cls(path, n_chunks, k)
        if path and os.path.exists(path):
            with np.load(path) as z:
                if int(z["n_chunks"]) != n_chunks or int(z["k"]) != k:
                    raise ValueError(
                        f"checkpoint {path} was written for a different "
                        f"screen shape (n_chunks={int(z['n_chunks'])}, "
                        f"k={int(z['k'])}); delete it or change the path")
                self.done = z["done"]
                self.scores = z["scores"]
                self.idx = z["idx"]
        return self

    def record(self, chunk: int, scores, idx) -> None:
        # deterministic top-k merge: score desc, ties by template id asc
        self.scores, self.idx = merge_topk(
            np.concatenate([self.scores, scores]),
            np.concatenate([self.idx, idx]), self.k)
        self.done[chunk] = True
        self.save()

    def save(self) -> None:
        if not self.path:
            return
        tmp = self.path + ".tmp"
        np.savez(tmp, done=self.done, scores=self.scores, idx=self.idx,
                 n_chunks=self.n_chunks, k=self.k)
        # np.savez appends .npz to names without it
        if not tmp.endswith(".npz"):
            tmp += ".npz"
        os.replace(tmp, self.path)


def screen_library_checkpointed(q_codes, t_codes, table, gi: float, ge: float,
                                k: int = 10, chunk_size: int = 1024,
                                ckpt_path: str = "", mesh: Mesh | None = None,
                                max_chunks: int | None = None, *,
                                device: torch.device | None = None):
    """Resumable chunked screen of one query against a template library.

    Same result as ``screen_library``, processed ``chunk_size`` templates
    at a time with the running state checkpointed to ``ckpt_path`` after
    every chunk; ``mesh`` goes to each chunk's ``screen_library``.
    ``max_chunks`` bounds how many incomplete chunks this
    call processes; the result is complete only when ``all_done``.

    Returns (scores, indices, all_done)."""
    t_codes = np.asarray(t_codes)
    n = t_codes.shape[0]
    n_chunks = -(-n // chunk_size)
    k_eff = min(k, n)
    ckpt = ScreenCheckpoint.load_or_create(ckpt_path, n_chunks, k_eff)

    processed = 0
    for c in range(n_chunks):
        if ckpt.done[c]:
            continue
        if max_chunks is not None and processed >= max_chunks:
            break
        lo, hi = c * chunk_size, min((c + 1) * chunk_size, n)
        scores, idx = screen_library(q_codes, t_codes[lo:hi], table, gi, ge,
                                     k=min(k_eff, hi - lo), mesh=mesh,
                                     device=device)
        ckpt.record(c, scores.astype(np.float32), idx.astype(np.int64) + lo)
        processed += 1

    return ckpt.scores, ckpt.idx, bool(ckpt.done.all())
