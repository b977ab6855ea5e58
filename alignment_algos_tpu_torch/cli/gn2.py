"""``gn2`` on the port's DP builds (counterpart of
``alignment_algos_tpu/cli/gn2.py``).

Structure-aware iterative alignment of a query profile against an SMAP
template with Gn2Eval; -crcw rebuilds the DP matrix once per round
(``dpm.reevaluate()``).  The reference tool's ``_run`` runs unchanged with
the port's ``DPMatrix`` in its globals (:func:`._tools.rebound`), so the
output is the reference's byte for byte.

    AAT_TORCH_DEVICE=cpu python -m alignment_algos_tpu_torch.cli.gn2 \\
        q.prof t.prof [t.flag] [-opt | -ucw | -kscw | -crcw] [--KEY value ...]
"""

from __future__ import annotations

import sys

from alignment_algos_tpu.cli import gn2 as _ref

from ..core.dp import DPMatrix
from ._tools import rebound, run_tool

_run = rebound(_ref._run, DPMatrix=DPMatrix)


def main(argv=None) -> int:
    return run_tool(_run, argv)


if __name__ == "__main__":
    sys.exit(main())
