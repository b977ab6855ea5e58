"""UPGMA agglomerative clustering (UPGMA_Clusterer.{h,cpp},
UPGMA_Tree.{h,cpp}).

Average-linkage merging over a triangular distance matrix with the
reference's weighted-average update d(new,i) = (w0*d(i,0)+w1*d(i,1))/(w0+w1)
and its quirky avg_leaf_dist recurrence (weighted sum divided by 2,
UPGMA_Tree.cpp:66-70).  Ties in find_closest_pair resolve to the first pair
in (i ascending, j<i ascending) scan order.  The O(n^3) matrix rebuilds of
the reference collapse to numpy row updates.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

F32 = np.float32


@dataclass
class UPGMANode:
    index: int
    left: "UPGMANode | None" = None
    right: "UPGMANode | None" = None
    l_dist: float = -1.0
    r_dist: float = -1.0
    weight: int = 1
    avg_leaf_dist: float = 0.0

    def is_leaf(self) -> bool:
        return self.left is None and self.right is None

    def leaves(self) -> list["UPGMANode"]:
        """Reference emission order (UPGMA_Tree.cpp:95-140): a leaf child is
        emitted FIRST even when it is the right child."""
        if self.is_leaf():
            return [self]
        l_leaf, r_leaf = self.left.is_leaf(), self.right.is_leaf()
        if l_leaf and r_leaf:
            return [self.left, self.right]
        if l_leaf:
            return [self.left] + self.right.leaves()
        if r_leaf:
            return [self.right] + self.left.leaves()
        return self.left.leaves() + self.right.leaves()


def _make_parent(left: UPGMANode, right: UPGMANode, min_dist: float,
                 index: int) -> UPGMANode:
    ld = F32(F32(min_dist) / F32(2.0) - F32(left.avg_leaf_dist))
    rd = F32(F32(min_dist) / F32(2.0) - F32(right.avg_leaf_dist))
    node = UPGMANode(index, left, right, float(ld), float(rd))
    node.weight = left.weight + right.weight
    # quirky reference recurrence: weighted sum over children divided by 2
    node.avg_leaf_dist = float(F32(
        (F32(left.weight) * F32(F32(ld) + F32(left.avg_leaf_dist))
         + F32(right.weight) * F32(F32(rd) + F32(right.avg_leaf_dist)))
        / F32(2.0)))
    return node


class UPGMAClusterer:
    def __init__(self, distance: np.ndarray) -> None:
        """distance: (n, n) symmetric (or lower-triangular) matrix."""
        d = np.asarray(distance, dtype=np.float32)
        n = d.shape[0]
        self.n = n
        self.D = np.tril(d) + np.tril(d, -1).T  # symmetrize from lower tri
        self.root: UPGMANode | None = None
        self.clusters: list[list[UPGMANode]] = []
        # min-distance of each merge in order (matches the reference
        # cluster() narration, UPGMA_Clusterer.cpp:75-110)
        self.merge_dists: list[float] = []

    def cluster(self) -> UPGMANode:
        """Replicates the reference's slot mechanics exactly
        (UPGMA_Clusterer.cpp:75-324): find_closest_pair scans the CURRENT
        permuted matrix (i=1.., j<i, strict <, so the first minimal pair in
        that order wins ties); combine_nodes SWAPS the pair into slots 0/1
        (displacing those slots' previous occupants to the pair's old
        slots), puts the merged cluster at slot 0, and shifts the rest up.
        The slot permutation is tie-order-load-bearing."""
        n = self.n
        D = self.D.copy()
        # per-node-id state; `order` maps current slot -> node id
        w = {i: 1 for i in range(n)}
        nodes = {i: UPGMANode(i) for i in range(n)}
        dist = {}  # pairwise distances keyed by frozenset of node ids

        def get(a, b):
            return dist.get((a, b), dist.get((b, a)))

        for i in range(n):
            for j in range(i):
                dist[(i, j)] = np.float32(D[i, j])
        order = list(range(n))
        next_index = n

        while len(order) > 2:
            # find_closest_pair over current slot order (strict <)
            best = (np.float32(999999.0), -1, -1)
            for si in range(1, len(order)):
                for sj in range(si):
                    dij = get(order[si], order[sj])
                    if dij < best[0]:
                        best = (dij, si, sj)
            _, s_hi, s_lo = best
            n1, n2 = min(s_hi, s_lo), max(s_hi, s_lo)
            # swap pair into slots 0 and 1 (reference swap_cols semantics)
            if n1 != 0:
                order[n1], order[0] = order[0], order[n1]
            if n2 != 1:
                order[n2], order[1] = order[1], order[n2]
            lid, rid = order[0], order[1]
            md = float(get(lid, rid))
            self.merge_dists.append(md)
            parent = _make_parent(nodes[lid], nodes[rid], md, next_index)
            nodes[next_index] = parent
            # weighted-average distances to the new cluster, float32 op
            # order: (w0*d(i,0) + w1*d(i,1)) / (w0+w1)
            w0, w1 = np.float32(w[lid]), np.float32(w[rid])
            for sid in order[2:]:
                nd = np.float32(
                    (w0 * get(sid, lid) + w1 * get(sid, rid))
                    / np.float32(w[lid] + w[rid]))
                dist[(next_index, sid)] = nd
            w[next_index] = w[lid] + w[rid]
            order = [next_index] + order[2:]
            next_index += 1

        lid, rid = order[0], order[1]
        self.merge_dists.append(float(get(lid, rid)))
        self.root = _make_parent(nodes[lid], nodes[rid], float(get(lid, rid)),
                                 next_index)
        return self.root

    def find_clusters_under_threshold(self, thresh: float) -> list[list[int]]:
        self.clusters = []

        def walk(node: UPGMANode):
            if node.is_leaf():
                self.clusters.append([node])
                return
            if node.avg_leaf_dist < thresh:
                self.clusters.append(node.leaves())
            else:
                walk(node.left)
                walk(node.right)

        walk(self.root)
        return [[leaf.index for leaf in c] for c in self.clusters]

