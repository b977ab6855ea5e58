"""Sequence model.

Mirrors sequence.{h,cpp} / aa_seq.{h,cpp} semantics — every sequence is
bracketed by a Head sentinel ``^`` at index 0 and a Tail sentinel ``$`` at
index N+1, and all DP indices are 1-based over the real residues — but is
arrays-first: per-position features live in numpy arrays (structure-of-arrays)
so they can be shipped to the TPU directly, instead of vectors of element
objects.
"""

from __future__ import annotations

import numpy as np

HEAD = "^"
TAIL = "$"


class Sequence:
    """Base sequence: a name plus the sentinel-bracketed character string."""

    def __init__(self, seq_string: str = "", name: str = "") -> None:
        self.seq_name = name
        self._seq_string = seq_string  # includes ^ and $ when non-empty

    # --- reference-compatible accessors -----------------------------------
    @property
    def seq_string(self) -> str:
        return self._seq_string

    def get_string(self) -> str:
        return self._seq_string

    def olc(self, i: int) -> str:
        return self._seq_string[i]

    def size(self) -> int:
        """Total length including sentinels (== vector::size() in reference)."""
        return len(self._seq_string)

    @property
    def seq_length(self) -> int:
        """Residue count without sentinels."""
        return max(0, len(self._seq_string) - 2)

    def __len__(self) -> int:
        return len(self._seq_string)

    def is_head(self, i: int) -> bool:
        return self._seq_string[i] == HEAD

    def is_tail(self, i: int) -> bool:
        return self._seq_string[i] == TAIL


class AASequence(Sequence):
    """Plain amino-acid sequence (aa_seq.{h,cpp}).

    ``append`` accumulates raw characters (the FASTA reader appends ``^`` and
    ``$`` itself, matching FastaRead in fastaio.h:112-169).
    """

    def __init__(self) -> None:
        super().__init__("", "")

    def append(self, s: str) -> None:
        self._seq_string += s

    def cleargaps(self, c: str = "-") -> None:
        self._seq_string = self._seq_string.replace(c, "")

    @classmethod
    def from_residues(cls, residues: str, name: str = "") -> "AASequence":
        seq = cls()
        seq.seq_name = name
        seq.append(HEAD)
        seq.append(residues)
        seq.append(TAIL)
        return seq


def kyte_hydropathy_table() -> np.ndarray:
    """The fixed 20-entry hydropathy table (hmapalib_seq.cpp:119-148),
    ordered A R N D C Q E G H I L K M F P S T W Y V."""
    return np.array(
        [0.5, -2.2, -1.0, -1.3, 1.0, -1.4, -2.1, 0.0, -0.5, 0.9,
         0.8, -3.5, 0.6, 0.7, -0.8, -0.3, -0.2, 0.3, 0.1, 0.8],
        dtype=np.float32,
    )
