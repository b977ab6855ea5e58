"""A directory of HMAP template profiles and a pool of query profiles,
from a configuration and a seed (tools/make_profiles.py's recipe, as
chip_smoke._residues / _profile_text vectorize it, copied here).

The configuration fixes the template length list and the query lengths;
the seed permutes the lengths over the slots, draws every row, and plants
``homologs.per_query`` homologs of each query: the query's core rows with
``redraw`` of them drawn anew, fitted to the slot's length.
"""

from __future__ import annotations

import os

import numpy as np

from aat_bench import recipes

# one row: one-letter code index, 20 profile values, 4 gap values, 6 SSE
# values (p_helix, p_strand, p_coil, confidence, two surface values)
ROW = 31
_FMT = ("%4d %s " + " ".join(["%.2f"] * 20)
        + "\n   -   %.3f %.3f 0.000 0.000 %.3f %.3f\n   *   "
        + " ".join(["%.3f"] * 6) + "\n")


def residues(rng: np.random.Generator, n: int) -> np.ndarray:
    """n rows drawn with make_profile's recipe: (n, ROW) float64."""
    n = int(n)
    k = n // 3 + 1
    states = np.repeat(rng.integers(0, 3, k), rng.integers(3, 9, k))[:n]
    rows = np.arange(n)
    olc = rng.integers(0, 20, n)
    prof = rng.dirichlet(np.full(20, 0.3), size=n) * 100.0 * 0.4
    prof[rows, olc] += 60.0
    gap = np.column_stack([rng.uniform(2.0, 6.0, n), rng.uniform(0.1, 0.6, n),
                           rng.uniform(0.0, 1.0, (n, 2))])
    base = rng.dirichlet(np.ones(3), size=n) * 0.3
    base[rows, states] += 0.7
    base /= base.sum(axis=1, keepdims=True)
    sse = np.column_stack([base, rng.uniform(0.3, 0.99, n),
                           rng.uniform(0.0, 1.0, (n, 2))])
    return np.column_stack([olc, prof, gap, sse])


def profile_text(name: str, rows: np.ndarray) -> str:
    head = (f"ID : {name}\nDE : synthetic\nSR : none\nEVD: 20 6\n"
            f"LEN: {len(rows)}\n")
    body = "".join(_FMT % (i, recipes.AA[int(r[0])], *r[1:])
                   for i, r in enumerate(rows, start=1))
    return head + body + "//\n"


def make(cfg: dict, seed: int, workdir: str) -> dict:
    """Write ``lib/t<slot>.prof`` and one ``q<length>.prof`` per query
    length into ``workdir``; returns their paths and the library's
    sizes."""
    rng = np.random.default_rng(seed)
    lens = rng.permutation(recipes.lengths(cfg))
    n = len(lens)
    qlens = list(cfg["query_lengths"])
    queries = [residues(rng, q) for q in qlens]
    hom = cfg["homologs"]
    per = hom["per_query"]
    slots = rng.choice(n, per * len(qlens), replace=False)
    planted = {}
    for qi, q in enumerate(queries):
        a, b = recipes.core(len(q))
        for s in slots[qi * per:(qi + 1) * per]:
            c = q[a:b].copy()
            redraw = rng.choice(len(c), int(len(c) * hom["redraw"]),
                                replace=False)
            c[redraw] = residues(rng, len(redraw))
            planted[int(s)] = recipes.fit(rng, c, lens[s],
                                          lambda k: residues(rng, k))
    lib = os.path.join(workdir, "lib")
    os.makedirs(lib, exist_ok=True)
    for i in range(n):
        rows = planted[i] if i in planted else residues(rng, lens[i])
        with open(os.path.join(lib, f"t{i:04d}.prof"), "w") as f:
            f.write(profile_text(f"t{i:04d}", rows))
    paths = {}
    for qlen, q in zip(qlens, queries):
        paths[qlen] = os.path.join(workdir, f"q{qlen}.prof")
        with open(paths[qlen], "w") as f:
            f.write(profile_text(f"q{qlen}", q))
    return {"library": lib, "queries": paths, "templates": n,
            "residues": int(lens.sum()), "longest": int(lens.max())}


def small(cfg: dict, traffic: dict) -> tuple[dict, dict]:
    """The configuration and mix at a CPU rehearsal's size: 24 templates
    of about 40 residues, each query length L as 16 + L // 8."""
    cfg = {**cfg, "n_templates": 24,
           "lengths": {**cfg["lengths"], "median": 40, "max": 90},
           "query_lengths": [16 + q // 8 for q in cfg["query_lengths"]],
           "homologs": {**cfg["homologs"], "per_query": 2}}
    traffic = {**traffic, "queries": [16 + q // 8
                                      for q in traffic["queries"]]}
    return cfg, traffic
