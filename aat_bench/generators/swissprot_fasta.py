"""A FASTA template library and its queries, from a configuration and a
seed (chip_smoke.make_fastas's recipe, vectorized).

The configuration fixes the length list (:func:`aat_bench.recipes.lengths`)
and the query lengths; the seed permutes the lengths over the slots, draws
every residue uniformly over the 20 standard amino acids, and plants
``homologs.per_query`` homologs of each query: a core of the query with
``ancestor_redraw`` of it redrawn, between random flanks, then
``homolog_redraw`` more per homolog, fitted to its slot's length.  So the
library's length list, longest template and total residues are the same
for every seed.
"""

from __future__ import annotations

import os

import numpy as np

from aat_bench import recipes


def make(cfg: dict, seed: int, workdir: str) -> dict:
    """Write ``library.fa`` and one ``q<length>.fa`` per query length into
    ``workdir``; returns their paths and the library's sizes."""
    rng = np.random.default_rng(seed)
    lens = rng.permutation(recipes.lengths(cfg))
    n, total = len(lens), int(lens.sum())
    offs = np.concatenate([[0], np.cumsum(lens)])

    def rand(k):
        return rng.integers(0, 20, int(k), dtype=np.uint8)

    def mutate(s, frac):
        s = s.copy()
        pos = rng.choice(len(s), int(len(s) * frac), replace=False)
        s[pos] = rand(len(pos))
        return s

    codes = rand(total)
    qlens = list(cfg["query_lengths"])
    queries = [rand(q) for q in qlens]
    hom = cfg["homologs"]
    per = hom["per_query"]
    slots = rng.choice(n, per * len(qlens), replace=False)
    for qi, q in enumerate(queries):
        a, b = recipes.core(len(q))
        ancestor = np.concatenate([rand(20), mutate(q[a:b],
                                                    hom["ancestor_redraw"]),
                                   rand(20)])
        for s in slots[qi * per:(qi + 1) * per]:
            codes[offs[s]:offs[s + 1]] = recipes.fit(
                rng, mutate(ancestor, hom["homolog_redraw"]), lens[s], rand)

    letters = np.frombuffer(recipes.AA.encode(), np.uint8)
    text = letters[codes].tobytes().decode()
    library = os.path.join(workdir, "library.fa")
    with open(library, "w") as f:
        f.write("".join(f">t{i:05d}\n{text[offs[i]:offs[i + 1]]}\n"
                        for i in range(n)))
    paths = {}
    for qlen, q in zip(qlens, queries):
        paths[qlen] = os.path.join(workdir, f"q{qlen}.fa")
        with open(paths[qlen], "w") as f:
            f.write(f">q{qlen}\n{letters[q].tobytes().decode()}\n")
    return {"library": library, "queries": paths, "templates": n,
            "residues": total, "longest": int(lens.max())}


def small(cfg: dict, traffic: dict) -> tuple[dict, dict]:
    """The configuration and mix at a CPU rehearsal's size: 40 templates
    of about 50 residues, each query length L as 16 + L // 40."""
    cfg = {**cfg, "n_templates": 40,
           "lengths": {**cfg["lengths"], "median": 50, "max": 160},
           "query_lengths": [16 + q // 40 for q in cfg["query_lengths"]],
           "homologs": {**cfg["homologs"], "per_query": 2}}
    traffic = {**traffic, "queries": [16 + q // 40
                                      for q in traffic["queries"]]}
    return cfg, traffic
