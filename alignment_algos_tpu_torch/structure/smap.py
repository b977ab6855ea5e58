"""SMAP sequences: HMAP profile + 3-D structure features (gn2lib_seq.{h,cpp}).

Loads ``PDB: <path> <chain>`` headed profiles, derives per-residue backbone
coordinates, backbone H-bonds, the broken-H-bond prefix-sum tables, Cbeta
distances, weighted contact numbers, and (gnoali mode) accessibility,
secondary distances and SSE-axis angles.

trollbase (the reference's unshipped structure library) is replaced by
structure/pdb.py + structure/geometry.py; the derived-feature recurrences
mirror gn2lib_seq.cpp exactly, including its quirks:

* the pairwise Cbeta ``distance`` table is computed before the sentinel
  coordinate copy, so rows/columns touching the sentinels measure to the
  origin (gn2lib_seq.cpp:476-493 runs before :188-198);
* the WCN window tests the *squared* distance against (14.5, 256)
  (gn2lib_seq.cpp:282);
* gn2 mode reassigns lods_type to the 3-class scheme (0/1/2 by dominant
  strand/coil, gn2lib_seq.cpp:110-115).
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..seq.hmap import HMAPSequence
from .geometry import (assign_sses_dssp, backbone_hbonds,
                       shrake_rupley_accessibility)
from .pdb import Chain, HELIX_TYPE, SSE, STRAND_TYPE, parse_pdb_chain


class SMAPSequence(HMAPSequence):
    def __init__(self) -> None:
        super().__init__()
        self.pdb_id = ""
        self.pdb_chain = ""
        self.verbose = 0
        self.gn2 = False
        self.chain: Chain | None = None
        # structure-derived arrays (see class docstring)
        self.brokenhb: np.ndarray | None = None          # (nr, nr) uint64
        self.intra_hb_table: np.ndarray | None = None    # (nr, nr) uint64
        self.distance: np.ndarray | None = None          # (n, n+1) float32
        self.weighted_contact_number: np.ndarray | None = None  # (n+2,) f32
        self.isse: np.ndarray | None = None              # (n+2,) int32, -1 coil
        self.sse_type: np.ndarray | None = None          # (n+2,) int32
        self.prev_sse: list | None = None                # per position SSE|None
        self.next_sse: list | None = None
        self.accessibility: np.ndarray | None = None     # (n+2,) float32
        self.distance2: np.ndarray | None = None         # gnoali only
        self.angle: np.ndarray | None = None             # gnoali only
        self._hb_contact: np.ndarray | None = None       # (nr+1, nr+1) bool
        self._cb_dist2: np.ndarray | None = None         # (nr, nr) float32

    # ------------------------------------------------------------------
    @classmethod
    def from_file(cls, fn: str, verbose: int = 0, gn2: bool = False,
                  pdb_dir: str | None = None) -> "SMAPSequence":
        with open(fn) as f:
            return cls.from_stream(f, verbose=verbose, gn2=gn2,
                                   pdb_dir=pdb_dir or os.path.dirname(fn))

    @classmethod
    def from_stream(cls, stream, verbose: int = 0, gn2: bool = False,
                    pdb_dir: str = "") -> "SMAPSequence":
        self = cls()
        self.verbose = verbose
        self.gn2 = gn2
        first = stream.readline()
        if not first.startswith("PDB:"):
            raise ValueError("SMAP file before 'PDB'")
        parts = first.split(":", 1)[1].split()
        self.pdb_id = parts[0]
        self.pdb_chain = parts[1] if len(parts) > 1 else ""
        pdb_path = self.pdb_id
        if not os.path.exists(pdb_path) and pdb_dir:
            pdb_path = os.path.join(pdb_dir, self.pdb_id)
        try:
            self.chain = parse_pdb_chain(pdb_path, self.pdb_chain or None)
        except (OSError, ValueError) as e:
            raise ValueError(f"Can't read PDB file. ({e})")
        self._read_hmap(stream)
        self._calc_struct_properties()
        if self.seq_length != len(self.chain):
            raise ValueError(
                "Length of profile and length of PDB file do not match.")
        return self

    # ------------------------------------------------------------------
    def _calc_struct_properties(self) -> None:
        ch = self.chain
        nr = len(ch)
        n2 = nr + 2

        # gn2 lods reassignment (gn2lib_seq.cpp:110-115)
        self.lods_type[1 : nr + 1] = 0
        self.lods_type[1 : nr + 1][self.sse_values[1 : nr + 1, 1] > 0.5] = 1
        self.lods_type[1 : nr + 1][self.sse_values[1 : nr + 1, 2] > 0.5] = 2

        # SSE assignment: PDB HELIX/SHEET records, else DSSP-lite
        hbonds = backbone_hbonds(ch)
        if not ch.sses:
            ch.sses = assign_sses_dssp(ch, hbonds)
        self.isse = np.full(n2, -1, dtype=np.int32)
        self.sse_type = np.zeros(n2, dtype=np.int32)
        self.prev_sse = [None] * n2
        self.next_sse = [None] * n2
        for si, sse in enumerate(ch.sses):
            for ri in sse.res_indices:
                self.isse[ri + 1] = si
                self.sse_type[ri + 1] = sse.sse_type
                self.prev_sse[ri + 1] = sse
                self.next_sse[ri + 1] = sse
        # coil positions inherit nearest flanking SSEs (gn2lib_seq.cpp:139-155)
        for i in range(nr):
            if self.isse[i + 1] == -1:
                for j in range(i, 0, -1):
                    if self.isse[j] != -1:
                        self.prev_sse[i + 1] = ch.sses[self.isse[j]]
                        break
                for j in range(i + 1, nr):
                    if self.isse[j + 1] != -1:
                        self.next_sse[i + 1] = ch.sses[self.isse[j + 1]]
                        break

        # backbone coordinates (sentinels zero until copied at the end)
        self.n_xyz = np.zeros((n2, 3))
        self.ca_xyz = np.zeros((n2, 3))
        self.c_xyz = np.zeros((n2, 3))
        self.cb_xyz = np.zeros((n2, 3))
        # missing-atom fallback replicates gn2lib_seq.cpp:156-180: if ANY of
        # N/CA/C is absent, all three take the residue's FIRST atom (file
        # order), with a stderr warning; missing CB falls back to CA (silent
        # only for glycine).
        for i, r in enumerate(ch.residues):
            n, ca, c = r.get("N"), r.get("CA"), r.get("C")
            if n is None or ca is None or c is None:
                front = next(iter(r.atoms.values()))
                n = ca = c = front
                print(f"***missing atoms***\nresidue: {r.olc}{i + 1}"
                      f", atoms in residue: {len(r.atoms)}", file=sys.stderr)
            cb = r.get("CB")
            if cb is None:
                if r.olc != "G":
                    print(f"residue: {r.olc}{i + 1}, CB missing",
                          file=sys.stderr)
                cb = ca
            self.n_xyz[i + 1] = n
            self.ca_xyz[i + 1] = ca
            self.c_xyz[i + 1] = c
            self.cb_xyz[i + 1] = cb

        self._calc_hbond_contact_map(hbonds)
        self._calc_broken_hbs(hbonds)
        self._calc_primary_distances()
        self._calc_weighted_contact_number()
        if not self.gn2:
            self._calc_accessibility()
            self._calc_secondary_distances()
            self._calc_ss_angles()

        # sentinel coordinate copy (after the distance tables, as in the
        # reference)
        for arr in (self.n_xyz, self.ca_xyz, self.c_xyz, self.cb_xyz):
            arr[0] = arr[1]
            arr[nr + 1] = arr[nr]
        if self.accessibility is not None:
            self.accessibility[0] = self.accessibility[1]
            self.accessibility[nr + 1] = self.accessibility[nr]

    # ------------------------------------------------------------------
    def _calc_hbond_contact_map(self, hbonds) -> None:
        nr = len(self.chain)
        m = np.zeros((nr + 1, nr + 1), dtype=bool)
        for d, a in hbonds:
            r1, r2 = d + 1, a + 1
            m[max(r1, r2), min(r1, r2)] = True
        self._hb_contact = m

    def get_backbone_hb_contact(self, i: int, j: int) -> bool:
        nr = len(self.chain)
        if i >= nr + 1 or j >= nr + 1:
            raise IndexError("H-bond contact index out of bounds")
        return bool(self._hb_contact[max(i, j), min(i, j)])

    def _calc_broken_hbs(self, hbonds) -> None:
        """2-D prefix-sum recurrences (gn2lib_seq.cpp:387-473)."""
        nr = len(self.chain)
        hb = np.zeros((nr, nr), dtype=np.uint64)
        for d, a in hbonds:
            if d == a:
                continue
            hb[d, a] = 1
            hb[a, d] = 1
        row_sum = hb.sum(axis=1, dtype=np.uint64)

        intra = np.zeros((nr, nr), dtype=np.uint64)
        for i in range(1, nr):
            intra[i, i - 1] = 2 * hb[i, i - 1]
        for i in range(2, nr):
            for j in range(i - 2, -1, -1):
                intra[i, j] = (intra[i - 1, j] + intra[i, j + 1]
                               - intra[i - 1, j + 1] + 2 * hb[i, j])

        broken = np.zeros((nr, nr), dtype=np.uint64)
        np.fill_diagonal(broken, row_sum)
        for i in range(1, nr):
            for j in range(i - 1, -1, -1):
                broken[i, j] = (broken[i - 1, j] + broken[i, j + 1]
                                - broken[i - 1, j + 1])
        broken_l = broken.astype(np.int64)
        intra_l = intra.astype(np.int64)
        il = np.tril_indices(nr, -1)
        broken_l[il] -= intra_l[il]
        self.brokenhb = broken_l.astype(np.uint64)
        self.intra_hb_table = intra

    def _calc_primary_distances(self) -> None:
        """Cbeta distance table in the reference's [i-2][j] layout
        (gn2lib_seq.cpp:476-493; sentinel coords are zero here)."""
        n = self.seq_length
        self.distance = np.zeros((n, n + 1), dtype=np.float32)
        for i in range(2, n + 2):
            d = np.linalg.norm(self.cb_xyz[i] - self.cb_xyz[: i - 1], axis=1)
            self.distance[i - 2, : i - 1] = d.astype(np.float32)

    def dist_pair(self, t1: int, t2: int) -> float:
        """distance between template positions (t1, t2), t1 <= t2-2, as the
        evaluators index it (gn2_eval.h:110-114)."""
        return float(self.distance[t2 - 2, t1])

    def _calc_weighted_contact_number(self) -> None:
        nr = len(self.chain)
        cb = self.cb_xyz[1 : nr + 1]
        diff = cb[:, None, :] - cb[None, :, :]
        d2 = (diff * diff).sum(-1).astype(np.float32)
        self._cb_dist2 = d2
        mask = (d2 > 14.5) & (d2 < 256.0)
        with np.errstate(divide="ignore"):
            contrib = np.where(mask, np.float32(0.722) / d2, np.float32(0.0))
        wcn = np.zeros(nr + 2, dtype=np.float32)
        # sequential accumulation order (j inner loop) for parity
        wcn[1 : nr + 1] = np.cumsum(contrib.astype(np.float32), axis=1,
                                    dtype=np.float32)[:, -1]
        self.weighted_contact_number = wcn

    def update_core(self, alignment_set, ratio: float) -> None:
        """Blend WCN with model-averaged contact number over an alignment
        set — gn2's iterative rounds (gn2lib_seq.cpp:289-326)."""
        nr = len(self.chain)
        d2 = self._cb_dist2
        mask = (d2 > 14.5) & (d2 < 256.0)
        length = np.float32(len(alignment_set))
        model_cn = np.zeros(nr, dtype=np.float32)
        for ali in alignment_set:
            occupancy = np.zeros(nr + 2, dtype=bool)
            for _, t in ali.pairs:
                occupancy[t] = True
            occ = occupancy[1 : nr + 1]
            with np.errstate(divide="ignore"):
                # each term is divided by len BEFORE accumulation
                # (gn2lib_seq.cpp:311: `model_cn[i] += (0.722f/d2)/len`)
                contrib = np.where(mask & occ[None, :],
                                   (np.float32(0.722) / d2) / length,
                                   np.float32(0.0))
            model_cn += np.cumsum(contrib, axis=1, dtype=np.float32)[:, -1]
        wcn = self.weighted_contact_number
        r32 = np.float32(ratio)
        one_minus = np.float32(np.float32(1.0) - r32)  # f32 subtraction order
        for i in range(1, nr + 1):
            wcn[i] = np.float32(wcn[i] * r32)
            wcn[i] = np.float32(wcn[i] + one_minus * model_cn[i - 1])

    def _calc_accessibility(self) -> None:
        nr = len(self.chain)
        acc = np.zeros(nr + 2, dtype=np.float32)
        acc[1 : nr + 1] = shrake_rupley_accessibility(self.chain)
        self.accessibility = acc

    def _calc_secondary_distances(self) -> None:
        """N/C distances once removed (gn2lib_seq.cpp:495-516)."""
        n = self.seq_length
        self.distance2 = np.zeros((n, n + 1), dtype=np.float32)
        for i in range(2, n + 2):
            ii = i + 1 if i < n + 1 else i
            for j in range(i - 1):
                jj = j - 1 if j > 0 else j
                self.distance2[i - 2, j] = np.float32(
                    np.linalg.norm(self.n_xyz[ii] - self.c_xyz[jj]))

    def _calc_ss_angles(self) -> None:
        """Cosine of the angle between flanking SSE axes
        (gn2lib_seq.cpp:518-540)."""
        n = self.seq_length
        ca = self.chain.coords("CA")
        self.angle = np.full((n, n + 1), -1.0, dtype=np.float32)
        axis_cache = {}

        def axis_vec(sse):
            if id(sse) not in axis_cache:
                a, b = sse.axis(ca)
                axis_cache[id(sse)] = b - a
            return axis_cache[id(sse)]

        for i in range(2, n + 2):
            t2_next = self.next_sse[i] if i < n + 2 else None
            for j in range(i - 1):
                t1_prev = self.prev_sse[j]
                if t1_prev is not None and t2_next is not None:
                    a = axis_vec(t1_prev)
                    b = axis_vec(t2_next)
                    na, nb = np.linalg.norm(a), np.linalg.norm(b)
                    ad = 1.0 if (na == 0 or nb == 0) else float(a @ b / na / nb)
                    self.angle[i - 2, j] = np.float32(ad)
