"""Suboptimal-region flags (sflags.{h,cpp}): per-template-position booleans
marking where branched tracebacks may fork."""

from __future__ import annotations

import numpy as np


class SuboptFlags:
    def __init__(self, fill: bool, length: int) -> None:
        self.flags = np.full(length, bool(fill), dtype=bool)
        self._last = 0
        self.seq_name = "Flags=suboptimal region"

    def __getitem__(self, i: int) -> bool:
        return bool(self.flags[i])

    def __len__(self) -> int:
        return self.flags.size

    def size(self) -> int:
        return self.flags.size

    def append(self, s: str) -> None:
        """Append characters parsed as '0' => False, anything else => True
        (sflags.cpp:23-33)."""
        for ch in s:
            if self._last >= self.flags.size:
                raise ValueError("Sequence flags longer than template!")
            self.flags[self._last] = ch != "0"
            self._last += 1

    def set(self, i: int, b: bool) -> None:
        if i > self.flags.size:
            raise ValueError("Subopt index out of range")
        self.flags[i] = b

    def get_string(self) -> str:
        return "".join("1" if f else "0" for f in self.flags)
