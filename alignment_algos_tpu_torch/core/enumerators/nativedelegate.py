"""Shared native-engine delegation for the traceback enumerators."""

from __future__ import annotations

import copy
import os


def try_native(mode, self_obj, dpm, as_, subopt=None) -> bool:
    """Delegate the recursion to the C++ engine when enabled (env
    AAT_ENUM_BACKEND: auto | native | python).  The engine returns the
    DFS-ordered alignments, which are merged into ``as_`` and sorted with
    the reference's whole-set sortSet semantics."""
    backend = os.environ.get("AAT_ENUM_BACKEND", "auto")
    if backend == "python":
        return False
    from . import native
    if not native.available():
        if backend == "native":
            raise RuntimeError("native enumeration engine unavailable")
        return False
    p = copy.copy(self_obj.params)
    p.number_suboptimal = -1  # engine-side sort off
    out = native.enumerate_native(mode, dpm, p, subopt)
    as_.extend(out)
    as_.sort_set(self_obj.params.number_suboptimal)
    return True
