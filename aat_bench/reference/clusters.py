"""Plain clustering of a screen's hits: the alignment distance and HMAP's
UPGMA cut, in NumPy (float64).

An alignment is a polyline over the query axis: (0, 0), each matched pair
(query index + 1, template index + 1), then (query length + 1, template
length + 1).  The distance of two hits is the area between their
polylines (the integral of the absolute difference of the two piecewise
linear functions of the query position) over the query length, as HMAP's
Ali_Dist measures it.

HMAP's UPGMA merges the closest pair (average linkage, weighted by
cluster size) and gives each merged node the mean leaf distance
(w_l (d / 2) + w_r (d / 2)) / 2 = w d / 4 for a merge of w leaves at
distance d.  The cut keeps a node whole where that value is under the
threshold, and splits it otherwise; a leaf stands alone.
"""

from __future__ import annotations

import numpy as np


def polyline(path, qlen: int, tlen: int) -> tuple[np.ndarray, np.ndarray]:
    x = [0.0] + [qi + 1.0 for qi, _ in path] + [qlen + 1.0]
    y = [0.0] + [ti + 1.0 for _, ti in path] + [tlen + 1.0]
    return np.asarray(x), np.asarray(y)


def area(a, b) -> float:
    """Integral of |y_a(x) - y_b(x)| over the shared x range."""
    xs = np.union1d(a[0], b[0])
    d = np.interp(xs, *a) - np.interp(xs, *b)
    d0, d1, dx = d[:-1], d[1:], np.diff(xs)
    same = d0 * d1 >= 0
    whole = (np.abs(d0) + np.abs(d1)) / 2 * dx
    denom = np.where(same, 1.0, np.abs(d0) + np.abs(d1))
    split = (d0 * d0 + d1 * d1) / (2 * denom) * dx
    return float(np.sum(np.where(same, whole, split)))


def distances(paths, qlen: int, tlens) -> np.ndarray:
    lines = [polyline(p, qlen, t) for p, t in zip(paths, tlens)]
    n = len(lines)
    out = np.zeros((n, n))
    for i in range(n):
        for j in range(i):
            out[i, j] = out[j, i] = area(lines[i], lines[j]) / qlen
    return out


def clusters(dist: np.ndarray, thresh: float) -> list[frozenset]:
    """The UPGMA cut's clusters, as sets of hit positions."""
    n = len(dist)
    members = {i: [i] for i in range(n)}
    score = {i: 0.0 for i in range(n)}
    children = {}
    d = {(i, j): dist[i, j] for i in range(n) for j in range(i)}
    active = list(range(n))
    nxt = n
    while len(active) > 1:
        (a, b), m = min(d.items(), key=lambda kv: kv[1])
        wa, wb = len(members[a]), len(members[b])
        for c in active:
            if c not in (a, b):
                dac = d.pop((max(a, c), min(a, c)))
                dbc = d.pop((max(b, c), min(b, c)))
                d[(nxt, c)] = (wa * dac + wb * dbc) / (wa + wb)
        del d[(a, b)]
        members[nxt] = members[a] + members[b]
        score[nxt] = len(members[nxt]) * m / 4
        children[nxt] = (a, b)
        active = [c for c in active if c not in (a, b)] + [nxt]
        nxt += 1
    out = []

    def walk(node):
        if node not in children or score[node] < thresh:
            out.append(frozenset(members[node]))
        else:
            for c in children[node]:
                walk(c)

    if active:
        walk(active[0])
    return out
