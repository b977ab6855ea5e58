"""``S4_align`` / ``S4_align_gn2`` on the port's DP builds (counterpart of
``alignment_algos_tpu/cli/s4_align.py``).

SSSS fragment-graph enumeration of a query profile over an SMAP template
(Hmap2Eval, or Gn2Eval for ``S4_align_gn2``).  The reference tool's
``_run`` runs unchanged with the port's ``DPMatrix`` and ``SSSS`` in its
globals (:func:`._tools.rebound`), so the output is the reference's byte
for byte.

    AAT_TORCH_DEVICE=cpu python -m alignment_algos_tpu_torch.cli.s4_align \\
        templ.prof query.prof [--max_returned N] [--KEY value ...]
"""

from __future__ import annotations

import sys

from alignment_algos_tpu.cli import s4_align as _ref

from ..core.dp import DPMatrix
from ..ssss.engine import SSSS
from ._tools import rebound, run_tool

_run = rebound(_ref._run, DPMatrix=DPMatrix, SSSS=SSSS)


def main(argv=None, use_gn2: bool = False) -> int:
    return run_tool(_run, argv, use_gn2)


def main_gn2(argv=None) -> int:
    return main(argv, use_gn2=True)


if __name__ == "__main__":
    sys.exit(main(use_gn2="gn2" in sys.argv[0]))
