"""Shared SSSS data structures (ssss_shared_defs.h)."""

from __future__ import annotations

from dataclasses import dataclass

HELIX = 329
STRAND = 330


@dataclass
class SSEData:
    sse_id: int = -1
    ss_type: int = -1
    beg_id: int = -1
    end_id: int = -1


@dataclass(frozen=True)
class FragID:
    sse_idx: int
    frag_idx: int


@dataclass
class FragConnection:
    prev_frag: FragID
    next_frag: FragID
    prev_end_res_idx: int
    next_beg_res_idx: int
    connection_score: float
