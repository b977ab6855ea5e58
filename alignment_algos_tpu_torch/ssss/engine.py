"""SSSS fragment-graph enumeration on the port's DP builds (counterpart of
``alignment_algos_tpu/ssss/engine.py``).

The enumerator is the reference's; only its loop fill, which sub-builds a
``DPMatrix`` between two anchored fragments (ssss/engine.py:277-284), runs
with the port's :class:`~..core.dp.DPMatrix`, so loop rectangles with a
side of 40 or more reach K7 with their bounds.
"""

from __future__ import annotations

from alignment_algos_tpu.ssss import engine as _ref

from ..cli._tools import rebound
from ..core.dp import DPMatrix


class SSSS(_ref.SSSS):
    _loop_alignment = rebound(_ref.SSSS._loop_alignment, DPMatrix=DPMatrix)
