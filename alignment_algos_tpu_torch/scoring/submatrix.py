"""Substitution matrices (submatrix.{h,cpp}): NCBI-format BLOSUM parser."""

from __future__ import annotations

import numpy as np


class SubstitutionMatrix:
    def __init__(self) -> None:
        self.alphabet = ""
        self._index: dict[str, int] = {}
        self.matrix = np.zeros((0, 0), dtype=np.float32)

    def has_letter(self, x: str) -> bool:
        return x in self._index

    def score(self, a: str, b: str) -> float:
        return float(self.matrix[self._index[a], self._index[b]])

    def score_table(self) -> tuple[str, np.ndarray]:
        """(alphabet, dense table) for vectorized scoring."""
        return self.alphabet, self.matrix


class BlosumMatrix(SubstitutionMatrix):
    """Parses NCBI-format matrices: comment lines starting with '#', then an
    alphabet line, then one row of scores per letter (submatrix.cpp:16-54).
    """

    def __init__(self, filename: str) -> None:
        super().__init__()
        try:
            f = open(filename)
        except OSError:
            raise ValueError(f"File not found (substitution matrix) {filename}")
        with f:
            lines = f.read().splitlines()
        i = 0
        while i < len(lines) and lines[i].startswith("#"):
            i += 1
        if i >= len(lines):
            raise ValueError("empty substitution matrix file")
        self.alphabet = "".join(lines[i].split())
        n = len(self.alphabet)
        self._index = {c: k for k, c in enumerate(self.alphabet)}
        # remaining tokens: n rows of (letter, n scores)
        toks: list[str] = []
        for l in lines[i + 1 :]:
            toks.extend(l.split())
        self.matrix = np.zeros((n, n), dtype=np.float32)
        p = 0
        for r in range(n):
            p += 1  # row letter token
            for c in range(n):
                self.matrix[r, c] = float(toks[p])
                p += 1
