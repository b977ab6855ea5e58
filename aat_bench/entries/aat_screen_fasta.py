"""``aat_screen`` homology search over a FASTA library, one query per
call, as a user runs it: K1 scores the library, the top hits get K2
tracebacks decoded by K8, and ali_dist + UPGMA cluster them.

The reference check takes a sample of the window's screens (the longest
query's and others drawn from the seed) and works each answer out again
from the same files: every template's score, the top hits in the
program's order (score descending, index ascending), their alignments
and the UPGMA cut of their distances.  Compared, each with its limit from
the traffic file: screens that failed, screens whose output differs from
an earlier screen of the same query, ranked hits (index and score) that
differ from the reference's, and sampled screens whose clusters differ.

The control (:class:`Control`) is the reference computed in bfloat16 in
the program's place: its hits and their clusters printed as the screen
prints them, and judged by the same :func:`check`.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from aat_bench import screening
from aat_bench.reference import clusters, sw_local


class Session(screening.Session):
    def __init__(self, cfg: dict, traffic: dict, inputs: dict, root: str,
                 device: torch.device):
        super().__init__(cfg, traffic, inputs, root, device)
        self.matrix = os.path.join(root, cfg["submatrix"])
        self.args = ["--SUB_MATRIX", self.matrix,
                     "--gap_init", f"{cfg['gap_init']:g}",
                     "--gap_extn", f"{cfg['gap_extn']:g}",
                     "--top_k", str(traffic["top_k"]),
                     "--cluster_threshold",
                     f"{traffic['cluster_threshold']:g}"]

    def work(self, i: int) -> dict:
        """Cells the screen needs: query length x the library's real
        residues."""
        return {"cells": self.query(i) * self.inputs["residues"]}


class Control(Session):
    """The reference in bfloat16 in the program's place."""

    ref = None

    def screen(self, i: int) -> tuple[int, str]:
        self.ref = self.ref or Reference(self)
        q = self.ref.query(self.query(i))
        hits = self.ref.hits(q, torch.bfloat16)
        cl = self.ref.clusters(q, [t for t, _ in hits])
        return 0, (screening.render(hits, self.ref.names)
                   + "".join(f"cluster {ci}: {', '.join(sorted(c))}\n"
                             for ci, c in enumerate(cl, start=1)))

    def release(self) -> None:
        self.ref = None


def _clusters(out: str) -> set:
    return {frozenset(n.strip() for n in line.split(":", 1)[1].split(","))
            for line in out.splitlines() if line.startswith("cluster ")}


class Reference:
    """The library and matrix read again from the generated files."""

    def __init__(self, session: Session):
        self.s = session
        self.alphabet, self.table = sw_local.read_matrix(session.matrix)
        lib = sw_local.read_fasta(session.inputs["library"])
        self.names = [n for n, _ in lib]
        self.codes = [sw_local.encode(s, self.alphabet) for _, s in lib]

    def query(self, qlen: int) -> np.ndarray:
        path = self.s.inputs["queries"][qlen]
        return sw_local.encode(sw_local.read_fasta(path)[0][1], self.alphabet)

    def hits(self, q, dtype=torch.float32):
        sc = sw_local.best_scores(q, self.codes, self.table,
                                  self.s.cfg["gap_init"],
                                  self.s.cfg["gap_extn"], self.s.device, dtype)
        top = sw_local.top_hits(sc, self.s.traffic["top_k"])
        return [(int(t), float(sc[t])) for t in top]

    def clusters(self, q, top) -> set:
        if len(top) < 2:
            return set()
        hits = [self.codes[t] for t in top]
        paths = sw_local.alignments(q, hits, self.table,
                                    self.s.cfg["gap_init"],
                                    self.s.cfg["gap_extn"], self.s.device)
        dist = clusters.distances(paths, len(q), [len(h) for h in hits])
        return {frozenset(self.names[top[m]] for m in c) for c in
                clusters.clusters(dist, self.s.traffic["cluster_threshold"])}


def _mismatch(got: list, want: list) -> int:
    return sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))


def check(session: Session, outputs: list, seed: int,
          device: torch.device) -> list:
    """[(name, value, limit)] of the compared numbers."""
    spec = session.traffic["check"]
    lim = spec["limits"]
    failed = sum(rc != 0 for _, rc, _ in outputs)
    repeat = screening.repeat_mismatch(outputs, session.query)
    ref = Reference(session)
    hit_bad = cluster_bad = 0
    for qlen, _, out in screening.sample(outputs, session.query,
                                         spec["sample"], seed):
        q = ref.query(qlen)
        want = ref.hits(q)
        got = [(r[2], r[1]) for r in screening.hit_rows(out)]
        hit_bad += _mismatch(got, want)
        cluster_bad += _clusters(out) != ref.clusters(q, [t for t, _ in want])
    return [("failed_screens", failed, lim["failed_screens"]),
            ("repeat_mismatch", repeat, lim["repeat_mismatch"]),
            ("hit_mismatch", hit_bad, lim["hit_mismatch"]),
            ("cluster_mismatch", int(cluster_bad), lim["cluster_mismatch"])]
