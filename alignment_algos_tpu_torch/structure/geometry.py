"""Structural geometry derived from coordinates — replaces trollbase's
GetHBonds / SurfvSurface / SSE machinery with standard, documented methods:

* backbone H-bonds: Kabsch-Sander electrostatic criterion (DSSP), with the
  amide H reconstructed from the previous residue's C=O;
* secondary-structure assignment fallback (when the PDB has no HELIX/SHEET
  records): DSSP-lite from the H-bond pattern;
* solvent accessibility: Shrake-Rupley sphere sampling, normalized by
  Gly-X-Gly reference areas (clamped to [0,1] like gn2lib_seq.cpp:230).
"""

from __future__ import annotations

import numpy as np

from .pdb import ATOM_RADII, Chain, HELIX_TYPE, SSE, STRAND_TYPE

KS_Q1Q2F = 0.084 * 332.0  # Kabsch-Sander coupling constant (kcal/mol * A)
KS_CUTOFF = -0.5          # kcal/mol

# Gly-X-Gly reference accessible surface areas (A^2), Miller et al. 1987
REF_AREA = {
    "A": 113.0, "R": 241.0, "N": 158.0, "D": 151.0, "C": 140.0,
    "Q": 189.0, "E": 183.0, "G": 85.0, "H": 194.0, "I": 182.0,
    "L": 180.0, "K": 211.0, "M": 204.0, "F": 218.0, "P": 143.0,
    "S": 122.0, "T": 146.0, "W": 259.0, "Y": 229.0, "V": 160.0,
}


def backbone_hbonds(chain: Chain) -> list[tuple[int, int]]:
    """(donor_residue_idx, acceptor_residue_idx) pairs of backbone
    N-H...O=C hydrogen bonds by the Kabsch-Sander energy criterion."""
    n = len(chain)
    N = chain.coords("N")
    CA = chain.coords("CA")
    C = chain.coords("C")
    O = chain.coords("O", fallback="C")

    # reconstruct amide H: H = N + unit(C_{i-1} -> O_{i-1}) reversed
    H = N.copy()
    for i in range(1, n):
        co = C[i - 1] - O[i - 1]
        norm = np.linalg.norm(co)
        if norm > 1e-6:
            H[i] = N[i] + co / norm

    hbonds = []
    for i in range(n):  # donor (needs H; residue 0 and prolines excluded)
        if i == 0 or chain.residues[i].olc == "P":
            continue
        for j in range(n):  # acceptor
            if abs(i - j) < 2:
                continue
            r_on = np.linalg.norm(O[j] - N[i])
            if r_on > 5.2:
                continue
            r_ch = np.linalg.norm(C[j] - H[i])
            r_oh = np.linalg.norm(O[j] - H[i])
            r_cn = np.linalg.norm(C[j] - N[i])
            if min(r_ch, r_oh, r_cn) < 0.5:
                continue
            e = KS_Q1Q2F * (1.0 / r_on + 1.0 / r_ch - 1.0 / r_oh - 1.0 / r_cn)
            if e < KS_CUTOFF:
                hbonds.append((i, j))
    return hbonds


def assign_sses_dssp(chain: Chain, hbonds: list[tuple[int, int]]) -> list[SSE]:
    """DSSP-lite secondary structure from the H-bond pattern: alpha helices
    from i+4 -> i bonds, strands from ladder bonds; minimum length 3."""
    n = len(chain)
    hb = set(hbonds)

    helix = np.zeros(n, dtype=bool)
    for i in range(n - 4):
        # n-turn: donor i+4 accepts... K-S convention: (i+4) N-H -> i C=O
        if (i + 4, i) in hb and (i + 5, i + 1) in hb:
            helix[i + 1 : i + 5] = True

    strand = np.zeros(n, dtype=bool)
    # bridge: residues i,j (|i-j|>2) with paired H-bonds
    partners = {}
    for i in range(n):
        for j in range(i + 3, n):
            para = ((i, j) in hb and (j, i) in hb) or \
                   ((i - 1 >= 0 and (j, i - 1) in hb) and (i + 1 < n and (i + 1, j) in hb))
            anti = ((i, j) in hb and (j, i) in hb) or \
                   ((i - 1 >= 0 and j + 1 < n and (j + 1, i - 1) in hb)
                    and (i + 1 < n and j - 1 >= 0 and (i + 1, j - 1) in hb))
            if para or anti:
                strand[i] = strand[j] = True
                partners.setdefault(i, set()).add(j)
                partners.setdefault(j, set()).add(i)
    strand &= ~helix

    sses: list[SSE] = []

    def runs(mask):
        out = []
        i = 0
        while i < n:
            if mask[i]:
                j = i
                while j + 1 < n and mask[j + 1]:
                    j += 1
                out.append((i, j))
                i = j + 1
            else:
                i += 1
        return out

    for a, b in runs(helix):
        if b - a + 1 >= 3:
            sses.append(SSE(HELIX_TYPE, list(range(a, b + 1))))
    for a, b in runs(strand):
        if b - a + 1 >= 2:
            sses.append(SSE(STRAND_TYPE, list(range(a, b + 1))))
    sses.sort(key=lambda s: s.res_indices[0])
    return sses


def shrake_rupley_accessibility(chain: Chain, probe: float = 1.4,
                                n_points: int = 96) -> np.ndarray:
    """Per-residue relative accessibility in [0,1]: residue ASA summed over
    atoms (Shrake-Rupley sphere sampling) / Gly-X-Gly reference area."""
    atoms = []
    radii = []
    res_of = []
    for ri, r in enumerate(chain.residues):
        for name, xyz in r.atoms.items():
            el = r.elements.get(name, name[:1])
            if el == "H":
                continue
            atoms.append(xyz)
            radii.append(ATOM_RADII.get(el, 1.8) + probe)
            res_of.append(ri)
    xyz = np.asarray(atoms)
    rad = np.asarray(radii)
    res_of = np.asarray(res_of)
    na = len(atoms)

    # Fibonacci sphere sample points
    k = np.arange(n_points, dtype=np.float64)
    phi = np.arccos(1.0 - 2.0 * (k + 0.5) / n_points)
    theta = np.pi * (1.0 + 5.0 ** 0.5) * (k + 0.5)
    sphere = np.stack([np.cos(theta) * np.sin(phi),
                       np.sin(theta) * np.sin(phi), np.cos(phi)], axis=1)

    # neighbor lists via distance threshold
    asa_res = np.zeros(len(chain.residues))
    maxr = rad.max()
    for a in range(na):
        d = np.linalg.norm(xyz - xyz[a], axis=1)
        nb = np.where((d < rad[a] + maxr) & (np.arange(na) != a))[0]
        nb = nb[d[nb] < rad[a] + rad[nb]]
        pts = xyz[a] + rad[a] * sphere
        if nb.size:
            dist2 = ((pts[:, None, :] - xyz[nb][None, :, :]) ** 2).sum(-1)
            buried = (dist2 < (rad[nb] ** 2)[None, :]).any(axis=1)
        else:
            buried = np.zeros(n_points, dtype=bool)
        frac = 1.0 - buried.mean()
        asa_res[res_of[a]] += frac * 4.0 * np.pi * rad[a] ** 2

    rel = np.zeros(len(chain.residues))
    for ri, r in enumerate(chain.residues):
        ref = REF_AREA.get(r.olc, 160.0)
        rel[ri] = min(asa_res[ri] / ref, 1.0)
    return rel
