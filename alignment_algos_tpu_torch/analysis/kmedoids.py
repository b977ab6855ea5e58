"""K-medoids clustering with simulated annealing over the cluster count —
byte-faithful to the reference (kmedoidclusterer.{h,cpp}, clusterset.{h,cpp}).

The reference anneals with merge-two/split-one moves (Metropolis accept,
kT *= 0.9 cooling), grows the cluster count until the per-cluster variance
constraint passes, then shrinks it keeping the smallest k whose clusters
all pass (variance <= max_var and member distance^2 <= 1.6*max_var).

Determinism: the reference's only nondeterminism is ``srand(time(NULL))``
(kmedoidclusterer.cpp:67).  This implementation consumes a bit-exact glibc
``rand()`` replica (utils/crand.py) in the reference's exact call order, so
with a pinned seed every random draw, Metropolis test, and state copy
matches the oracle build byte for byte (tests/test_kmedoid_oracle.py).
All arithmetic is float32 in the reference's source order; the two exp()
calls promote to float64 exactly as C's double ``exp`` does.

Replicated reference defects (kept for parity, flagged here):
  * ``update_cluster_centroid`` (kmedoidclusterer.cpp:440-461) seeds its
    minimum with the distances to global POINT 0 (``min_idx`` is 0, used as
    a point index) rather than to the cluster's first member; the final
    centroid is ``members[min_idx]`` with ``min_idx`` now a member
    POSITION.  A cluster whose best medoid is its first member therefore
    reports the variance about point 0.
  * ``get_broadest_cluster`` (kmedoidclusterer.cpp:755-775) starts its scan
    at index 1, never considering cluster 0.
  * ``randomly_choose_initial_clusters`` sets initial variances through an
    out-of-bounds ``dist_sq(-1, m)`` read (centroid still -1).  The value
    is dead — ``cluster()`` recomputes variances before any use — so this
    implementation stores 0 instead of replicating the UB read.
"""

from __future__ import annotations

import numpy as np

from ..utils.crand import GlibcRandom

F = np.float32


class ClusterSet:
    """Triangular distance + squared-distance store (clusterset.h:14-44).
    dist_sq mirrors set_dist_sq's pow(d, 2): exact double product rounded
    once to float32 == float32 square."""

    def __init__(self, distance: np.ndarray) -> None:
        d = np.asarray(distance, dtype=np.float32)
        self.D = np.tril(d) + np.tril(d, -1).T
        self.D2 = (self.D ** 2).astype(np.float32)
        self.n = d.shape[0]

    def dist(self, i: int, j: int) -> np.float32:
        return self.D[i, j]

    def dist_sq(self, i: int, j: int) -> np.float32:
        return self.D2[i, j]


class _Cluster:
    __slots__ = ("members", "centroid", "variance")

    def __init__(self, centroid: int = -1) -> None:
        self.members: list[int] = []
        self.centroid = centroid
        self.variance = F(0)

    def copy(self) -> "_Cluster":
        c = _Cluster(self.centroid)
        c.members = list(self.members)
        c.variance = self.variance
        return c


class KMedoidClusterer:
    """Reference call stacks: find_good_clustering kmedoidclusterer.cpp:62-99,
    simulated_annealing :102-229, cluster :233-249."""

    def __init__(self, points: ClusterSet, k_max: int, seed: int = 1) -> None:
        self.points = points
        self.num_points = points.n
        self.k_max = k_max
        self.seed = seed
        self.rng = GlibcRandom(seed)
        self.kT = F(1)

    # ---- randomness (header inline random_p, get_random_cluster) -------
    def _random_p(self) -> F:
        return F(self.rng.rand() % 100) / F(100)

    def _random_cluster(self, vc: list[_Cluster]) -> _Cluster:
        return vc[self.rng.rand() % len(vc)]

    @staticmethod
    def _exp(x) -> np.float64:
        with np.errstate(over="ignore", invalid="ignore"):
            return np.exp(np.float64(x))

    # ---- core k-medoids (cpp:233-249, 375-461) -------------------------
    def _update_cluster_centroid(self, c: _Cluster) -> None:
        d2 = self.points.D2
        m = c.members
        if not m:
            raise RuntimeError(
                "update_cluster_centroid on an empty cluster (reference UB, "
                "kmedoidclusterer.cpp:460 members[min_idx] out of bounds)")
        min_variance = F(0)
        min_idx = 0  # NB reference defect: used first as point index 0
        for mi in m:
            min_variance = F(min_variance + d2[mi, min_idx])
        for i in range(1, len(m)):
            curr = F(0)
            for mj in m:
                curr = F(curr + d2[mj, m[i]])
            if curr < min_variance:
                min_variance = curr
                min_idx = i
        c.centroid = m[min_idx]
        c.variance = F(min_variance / F(len(m)))

    def _put_with_nearest_centroid(self, p: int,
                                   vc: list[_Cluster]) -> None:
        d2 = self.points.D2
        min_d = d2[p, vc[0].centroid]
        min_cluster = 0
        for i in range(1, len(vc)):
            d = d2[p, vc[i].centroid]
            if d < min_d:
                min_d = d
                min_cluster = i
        c = vc[min_cluster]
        c.variance = F(c.variance
                       + F(F(min_d - c.variance) / F(len(c.members) + 1)))
        c.members.append(p)

    def _assign_all_points(self, vc: list[_Cluster]) -> None:
        for c in vc:
            c.members = []
        for p in range(self.num_points):
            self._put_with_nearest_centroid(p, vc)

    def cluster(self, vc: list[_Cluster]) -> F:
        # reference defect (kmedoidclusterer.cpp:233-249): the convergence
        # loop never refreshes curr_centroids inside the loop, so
        # prev == curr after ONE iteration — cluster() always performs
        # exactly one update-centroids + assign pass, never iterating
        # k-medoids to convergence.  Replicated for byte parity.
        for c in vc:
            self._update_cluster_centroid(c)
        self._assign_all_points(vc)
        return self._total_variance(vc)

    def _total_variance(self, vc: list[_Cluster]) -> F:
        tot = F(0)
        for c in vc:
            tot = F(tot + F(c.variance * F(len(c.members))))
        return F(tot / F(self.num_points))

    def _get_cluster_variance(self, c: _Cluster) -> F:
        if not c.members:
            return F(-1)
        v = F(0)
        for m in c.members:
            v = F(v + self.points.D2[c.centroid, m])
        return F(v / F(len(c.members)))

    def _below_max_var(self, vc: list[_Cluster], max_var) -> bool:
        max_var = F(max_var)
        for c in vc:
            if c.variance > max_var:
                return False
        lim = F(F(1.6) * max_var)
        for c in vc:
            for m in c.members:
                if self.points.D2[m, c.centroid] > lim:
                    return False
        return True

    # ---- annealing moves (cpp:527-712) ---------------------------------
    def _choose_clusters_to_merge(self, vc):
        cand1 = self._random_cluster(vc)
        cand2 = cand1
        while cand2 is cand1:
            cand2 = self._random_cluster(vc)
        i = 0
        max_attempts = 10 * len(vc)
        while True:
            if not i < max_attempts:
                break
            with np.errstate(over="ignore", invalid="ignore",
                             divide="ignore"):
                q = F(self.points.D2[cand1.centroid, cand2.centroid]
                      / self.kT)
            if not self._exp(q) < self._random_p():
                break
            cand1 = self._random_cluster(vc)
            cand2 = cand1
            while cand2 is cand1:
                cand2 = self._random_cluster(vc)
            i += 1
        if i >= max_attempts:
            return None, None
        return cand1, cand2

    def _get_nearest_clusters(self, vc):
        dm = self.points.D
        min_d = dm[vc[0].centroid, vc[1].centroid]
        i1, i2 = 0, 1
        for i in range(len(vc) - 1):
            for j in range(i + 1, len(vc)):
                d = dm[vc[i].centroid, vc[j].centroid]
                if d < min_d:
                    min_d = d
                    i1, i2 = i, j
        return vc[i1], vc[i2]

    def _merge_clusters(self, c1: _Cluster, c2: _Cluster) -> _Cluster:
        res = _Cluster()
        res.members = list(c1.members)
        res.centroid = c1.centroid
        res.variance = c1.variance
        res.members.extend(c2.members)
        self._update_cluster_centroid(res)
        return res

    def _merge_two_clusters(self, vc: list[_Cluster]) -> None:
        c1, c2 = self._choose_clusters_to_merge(vc)
        if c1 is None:
            c1, c2 = self._get_nearest_clusters(vc)
        merged = self._merge_clusters(c1, c2)
        vc.remove(c1)
        vc.remove(c2)
        vc.append(merged)

    def _choose_cluster_to_split(self, vc):
        total = self._total_variance(vc)
        cand = self._random_cluster(vc)
        i = 0
        max_attempts = 2 * len(vc)
        while i < max_attempts:
            with np.errstate(invalid="ignore", divide="ignore"):
                q = F(cand.variance / total)
            if q > self._random_p() and len(cand.members) > 1:
                break
            cand = self._random_cluster(vc)
            i += 1
        if i >= max_attempts:
            return None
        return cand

    def _get_broadest_cluster(self, vc):
        max_variance = F(-1)
        max_idx = -1
        for i in range(1, len(vc)):  # reference defect: skips cluster 0
            if vc[i].variance > max_variance and len(vc[i].members) > 1:
                max_variance = vc[i].variance
                max_idx = i
        if max_idx < 0:
            raise RuntimeError("no cluster found with more than one member "
                               "(reference exit(-1), cpp:769-772)")
        return vc[max_idx]

    def _split_cluster(self, c: _Cluster) -> list[_Cluster]:
        if len(c.members) <= 1:
            raise RuntimeError("cannot split a cluster with one or fewer "
                               "members (reference exit(-1), cpp:600-605)")
        dm = self.points.D
        far1 = far2 = -1
        max_d = F(-1)
        for i in range(len(c.members) - 1):
            for j in range(i + 1, len(c.members)):
                d = dm[c.members[i], c.members[j]]
                if d > max_d:
                    max_d = d
                    far1, far2 = i, j
        res = [_Cluster(c.members[far1]), _Cluster(c.members[far2])]
        for m in c.members:
            self._put_with_nearest_centroid(m, res)
        return res

    def _split_one_cluster(self, vc: list[_Cluster]) -> None:
        to_split = self._choose_cluster_to_split(vc)
        if to_split is None:
            to_split = self._get_broadest_cluster(vc)
        split = self._split_cluster(to_split)
        vc.remove(to_split)
        vc.append(split[0])
        vc.append(split[1])

    # ---- state helpers (cpp:252-307, 357-372) --------------------------
    def _randomly_choose_initial_clusters(self, vc: list[_Cluster]) -> None:
        for c in vc:
            c.members = []
            c.centroid = -1
            c.variance = F(0)
        for i, c in enumerate(vc):
            c.members.append(i)
        for p in range(len(vc), self.num_points):
            self._random_cluster(vc).members.append(p)
        # reference sets variances via an out-of-bounds dist_sq(-1, m) read
        # here; the value is dead (recomputed by cluster()) — store 0

    @staticmethod
    def _copy_state(vc: list[_Cluster]) -> list[_Cluster]:
        return [c.copy() for c in vc]

    @staticmethod
    def _output(vc: list[_Cluster]) -> list[list[int]]:
        out = []
        for c in vc:
            row = [c.centroid] + [m for m in c.members if m != c.centroid]
            out.append(row)
        return out

    # ---- public API (cpp:62-99, 102-229) -------------------------------
    def find_good_clustering(self, n: int) -> list[list[int]]:
        """n+1 random restarts of plain k-medoids at k_max; returns the
        best state.  Re-seeds like the reference's srand (cpp:67; the
        oracle build pins the seed through AAT_KMED_SEED)."""
        self.rng.srand(self.seed)
        curr = [_Cluster() for _ in range(self.k_max)]
        self._randomly_choose_initial_clusters(curr)
        min_variance = self.cluster(curr)
        best = self._copy_state(curr)
        for _ in range(n):
            self._randomly_choose_initial_clusters(curr)
            curr_variance = self.cluster(curr)
            if curr_variance < min_variance:
                min_variance = curr_variance
                best = self._copy_state(curr)
        return self._output(best)

    def simulated_annealing(self, max_var: float) -> list[list[int]]:
        max_var = F(max_var)
        curr = [_Cluster() for _ in range(self.k_max)]
        self._randomly_choose_initial_clusters(curr)
        for c in curr:
            self._update_cluster_centroid(c)
        e = self.cluster(curr)
        self.kT = e

        # grow until the variance constraint passes (cpp:113-151)
        start_shrinking = False
        while not start_shrinking:
            if self.kT < F(1):
                self.kT = F(e * F(10))
                for _ in range(10):
                    self._split_one_cluster(curr)
            for _ in range(100):
                nxt = self._copy_state(curr)
                self._merge_two_clusters(nxt)
                self._split_one_cluster(nxt)
                e_next = self.cluster(nxt)
                if self._below_max_var(nxt, max_var):
                    curr = self._copy_state(nxt)
                    start_shrinking = True
                    break
                with np.errstate(invalid="ignore", divide="ignore"):
                    q = F(F(-F(e_next - e)) / self.kT)
                if self._exp(q) > self._random_p():
                    curr = self._copy_state(nxt)
                    e = e_next
            self.kT = F(np.float64(self.kT) * 0.9)

        # shrink keeping the smallest k that still passes (cpp:153-227)
        e = self.cluster(curr)
        self.kT = e
        best = self._copy_state(curr)
        final = self._copy_state(curr)
        e_best = e
        while self.kT > F(1):
            i = 0
            while i < len(curr) * len(curr):
                nxt = self._copy_state(curr)
                self._merge_two_clusters(nxt)
                self._split_one_cluster(nxt)
                e_next = self.cluster(nxt)
                if e_next < e_best:
                    best = self._copy_state(nxt)
                    e_best = e_next
                if self._below_max_var(nxt, max_var):
                    final = self._copy_state(nxt)
                    self._merge_two_clusters(nxt)
                    e = self.cluster(nxt)
                    best = self._copy_state(nxt)
                    e_best = e
                    curr = self._copy_state(nxt)
                    self.kT = F(e_best * F(100))
                    break
                with np.errstate(invalid="ignore", divide="ignore"):
                    q = F(F(-F(e_next - e)) / self.kT)
                if self._exp(q) > self._random_p():
                    curr = self._copy_state(nxt)
                    e = e_next
                i += 1
            self.kT = F(np.float64(self.kT) * 0.9)
        return self._output(final)
