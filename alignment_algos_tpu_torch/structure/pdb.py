"""Minimal PDB parser — replaces the trollbase PDBFile/Structure/Chain/
Residue machinery the reference links against (struct.h:19-22, not shipped
with the reference repo).

Parses ATOM records for one chain into structure-of-arrays form, plus
HELIX/SHEET header records when present.  Altloc: the first conformer seen
per atom wins (real PDB files order altlocs by descending occupancy, and
some residues carry ONLY a "B" conformer — those must still parse).
Waters and non-residue HETATMs are skipped; MSE/SEC/PYL HETATMs are kept
as chain residues.  ANISOU/SIGATM/TER records are ignored; only the first
MODEL of multi-model files is read.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# Three-letter -> one-letter codes
THREE_TO_ONE = {
    "ALA": "A", "ARG": "R", "ASN": "N", "ASP": "D", "CYS": "C",
    "GLN": "Q", "GLU": "E", "GLY": "G", "HIS": "H", "ILE": "I",
    "LEU": "L", "LYS": "K", "MET": "M", "PHE": "F", "PRO": "P",
    "SER": "S", "THR": "T", "TRP": "W", "TYR": "Y", "VAL": "V",
    "MSE": "M", "SEC": "U", "PYL": "O",
}

# van der Waals-ish radii by element (for accessibility)
ATOM_RADII = {"C": 1.76, "N": 1.65, "O": 1.40, "S": 1.85, "P": 1.87,
              "H": 1.10, "SE": 1.85}

HELIX_TYPE = 329   # ssss_shared_defs.h: helix SSE type tag
STRAND_TYPE = 330  # strand SSE type tag


@dataclass
class Residue:
    resseq: int
    icode: str
    name: str
    olc: str
    atoms: dict = field(default_factory=dict)  # atom name -> xyz (3,)
    elements: dict = field(default_factory=dict)  # atom name -> element

    def get(self, name: str):
        return self.atoms.get(name)


@dataclass
class SSE:
    """One secondary-structure element (helix or strand)."""
    sse_type: int          # HELIX_TYPE or STRAND_TYPE
    res_indices: list      # 0-based residue indices
    sheet_id: str = ""     # for strands: parent sheet identifier

    def axis(self, ca: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Least-squares line through the element's CA coords; returns the
        two endpoints of the fitted axis segment."""
        pts = ca[self.res_indices]
        center = pts.mean(axis=0)
        if len(pts) < 2:
            return center, center
        u, s, vt = np.linalg.svd(pts - center)
        d = vt[0]
        proj = (pts - center) @ d
        return center + proj.min() * d, center + proj.max() * d


class Chain:
    def __init__(self, chain_id: str) -> None:
        self.chain_id = chain_id
        self.residues: list[Residue] = []
        self.sses: list[SSE] = []

    def __len__(self) -> int:
        return len(self.residues)

    def sequence(self) -> str:
        return "".join(r.olc for r in self.residues)

    def coords(self, atom: str, fallback: str | None = "CA") -> np.ndarray:
        """(N,3) coordinates of a named atom per residue, with fallback."""
        out = np.zeros((len(self.residues), 3), dtype=np.float64)
        for i, r in enumerate(self.residues):
            p = r.get(atom)
            if p is None and fallback:
                p = r.get(fallback)
            if p is None and r.atoms:
                p = next(iter(r.atoms.values()))
            if p is not None:
                out[i] = p
        return out


def _element_of(line: str, name: str) -> str:
    el = line[76:78].strip() if len(line) >= 78 else ""
    if not el:
        el = name.strip()[:1]
    return el.upper()


def parse_pdb_chain(path_or_stream, chain_id: str | None = None) -> Chain:
    """Parse one chain (first if chain_id is None) from a PDB file."""
    if hasattr(path_or_stream, "read"):
        lines = path_or_stream.read().splitlines()
    else:
        with open(path_or_stream) as f:
            lines = f.read().splitlines()

    helix_records = []   # (chain, start_resseq, start_icode, end_resseq, end_icode)
    sheet_records = []   # + sheet id
    chain: Chain | None = None
    seen: dict[tuple, int] = {}

    for line in lines:
        rec = line[:6]
        if rec == "HELIX ":
            helix_records.append((line[19], int(line[21:25]), line[25].strip(),
                                  int(line[33:37]), line[37].strip()))
        elif rec == "SHEET ":
            sheet_records.append((line[21], int(line[22:26]), line[26].strip(),
                                  int(line[33:37]), line[37].strip(),
                                  line[11:14].strip()))
        elif rec in ("ATOM  ", "HETATM"):
            resname = line[17:20].strip()
            if resname == "HOH":
                continue
            if rec == "HETATM" and resname not in THREE_TO_ONE:
                continue
            cid = line[21]
            if chain_id is None:
                chain_id = cid  # first chain encountered
            if cid != chain_id:
                continue
            name = line[12:16].strip()
            resseq = int(line[22:26])
            icode = line[26].strip()
            key = (resseq, icode)
            if key not in seen:
                seen[key] = len(seen)
                if chain is None:
                    chain = Chain(chain_id)
                chain.residues.append(Residue(
                    resseq=resseq, icode=icode, name=resname,
                    olc=THREE_TO_ONE.get(resname, "X")))
            res = chain.residues[seen[key]]
            if name not in res.atoms:
                xyz = np.array([float(line[30:38]), float(line[38:46]),
                                float(line[46:54])])
                res.atoms[name] = xyz
                res.elements[name] = _element_of(line, name)
        elif rec in ("ENDMDL",):
            break  # first model only

    if chain is None:
        raise ValueError(f"no ATOM records for chain {chain_id!r}")

    # map HELIX/SHEET records to residue index ranges
    index_of = {(r.resseq, r.icode): i for i, r in enumerate(chain.residues)}

    def res_range(c, s_seq, s_ic, e_seq, e_ic):
        if c != chain.chain_id:
            return None
        lo = index_of.get((s_seq, s_ic))
        hi = index_of.get((e_seq, e_ic))
        if lo is None or hi is None or hi < lo:
            return None
        return list(range(lo, hi + 1))

    for rec_ in helix_records:
        rr = res_range(*rec_)
        if rr:
            chain.sses.append(SSE(HELIX_TYPE, rr))
    for rec_ in sheet_records:
        rr = res_range(*rec_[:5])
        if rr:
            chain.sses.append(SSE(STRAND_TYPE, rr, sheet_id=rec_[5]))
    chain.sses.sort(key=lambda s: s.res_indices[0])
    return chain
