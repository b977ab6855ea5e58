"""``S4_one_ali`` on the port's DP builds (counterpart of
``alignment_algos_tpu/cli/s4_one_ali.py``).

Fragment-by-fragment alignment building on the SSSS fragment graph
(scripted with ``--choices`` or ``--best``, else prompted on stdin).  The
reference tool's ``_run`` runs unchanged with the port's ``DPMatrix`` and
``SSSS`` in its globals (:func:`._tools.rebound`), so the output is the
reference's byte for byte.

    AAT_TORCH_DEVICE=cpu python -m alignment_algos_tpu_torch.cli.s4_one_ali \\
        query.prof templ.prof --best 1 [--gn2 1] [--KEY value ...]
"""

from __future__ import annotations

import sys

from alignment_algos_tpu.cli import s4_one_ali as _ref

from ..core.dp import DPMatrix
from ..ssss.engine import SSSS
from ._tools import rebound, run_tool

_run = rebound(_ref._run, DPMatrix=DPMatrix, SSSS=SSSS)


def main(argv=None) -> int:
    return run_tool(_run, argv)


if __name__ == "__main__":
    sys.exit(main())
