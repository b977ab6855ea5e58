"""``aat_screen --profiles 1`` fold recognition over a directory of HMAP
template profiles, one query profile per call, as a user runs it: the
profiles are parsed, the library packed and copied, and K5, K6 and K3
score every template.

The reference check takes a sample of the window's screens (the longest
query's and others drawn from the seed) and scores every template again
from the same files.  Compared, each with its limit from the traffic
file: screens that failed, screens whose output differs from an earlier
screen of the same query, the widest gap between a printed score and the
reference's score of that template, and the widest gap by which a
printed hit's reference score lies below the reference's score at that
rank; both gaps relative to the reference score (at least 1).  A gap
that is not a number (a printed ``nan``) counts as infinite.

The control (:class:`Control`) is the reference computed in bfloat16 in
the program's place: its ranked hits printed as the screen prints them,
and judged by the same :func:`check`.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from aat_bench import screening
from aat_bench.reference import hmap_profile


class Session(screening.Session):
    def __init__(self, cfg: dict, traffic: dict, inputs: dict, root: str,
                 device: torch.device):
        super().__init__(cfg, traffic, inputs, root, device)
        self.args = ["--profiles", "1", "--top_k", str(traffic["top_k"])]
        for key, value in cfg["hmap_params"].items():
            self.args += ["--" + key, f"{value:g}"]

    def work(self, i: int) -> dict:
        return {"templates": self.inputs["templates"]}


class Control(Session):
    """The reference in bfloat16 in the program's place."""

    def screen(self, i: int) -> tuple[int, str]:
        low = _ref_scores(self, self.query(i), torch.bfloat16)
        top = np.lexsort((np.arange(len(low)), -low))[:self.traffic["top_k"]]
        names = [os.path.basename(f) for f in _files(self)]
        return 0, screening.render([(int(t), float(low[t])) for t in top],
                                   names)


def _files(session: Session) -> list:
    return sorted(glob.glob(os.path.join(session.inputs["library"],
                                         "*.prof")))


def _ref_scores(session: Session, qlen: int, dtype=torch.float32):
    return hmap_profile.scores(session.inputs["queries"][qlen],
                               _files(session),
                               session.cfg["hmap_params"], session.device,
                               dtype)


def gaps(hits: list, ref: np.ndarray) -> tuple[float, float]:
    """(score gap, rank gap) of printed hits [(index, score)] against the
    reference's scores of every template."""
    best = np.sort(ref)[::-1]
    score = rank = 0.0
    for r, (idx, s) in enumerate(hits):
        scale = max(1.0, abs(best[r]))
        score = max(score, _number(abs(s - ref[idx])
                                   / max(1.0, abs(ref[idx]))))
        rank = max(rank, _number((best[r] - ref[idx]) / scale))
    return score, rank


def _number(gap: float) -> float:
    """A gap, with one that is not a number read as infinite (``max``
    would pass over it)."""
    return float("inf") if np.isnan(gap) else float(gap)


def check(session: Session, outputs: list, seed: int,
          device: torch.device) -> list:
    """[(name, value, limit)] of the compared numbers."""
    spec = session.traffic["check"]
    lim = spec["limits"]
    failed = sum(rc != 0 for _, rc, _ in outputs)
    repeat = screening.repeat_mismatch(outputs, session.query)
    score = rank = 0.0
    k = session.traffic["top_k"]
    for qlen, _, out in screening.sample(outputs, session.query,
                                         spec["sample"], seed):
        hits = [(r[2], r[1]) for r in screening.hit_rows(out)]
        if len(hits) != min(k, session.inputs["templates"]):
            score = rank = float("inf")
            continue
        s, r = gaps(hits, _ref_scores(session, qlen))
        score, rank = max(score, s), max(rank, r)
    return [("failed_screens", failed, lim["failed_screens"]),
            ("repeat_mismatch", repeat, lim["repeat_mismatch"]),
            ("score_gap", score, lim["score_gap"]),
            ("rank_gap", rank, lim["rank_gap"])]
