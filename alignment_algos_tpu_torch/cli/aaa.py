"""``aaa`` on the port's DP builds (counterpart of
``alignment_algos_tpu/cli/aaa.py``).

Plain amino-acid alignment with a substitution matrix.  Its whole-matrix
forward build takes the shared host fast path ``dp_affine`` where that
path's exactness gate accepts the gaps (integer gaps); at the default gaps
4.73/0.34 a pair of 40 or more residues runs on K7.  The reference tool's
``_run`` runs unchanged with the port's ``DPMatrix`` in its globals
(:func:`._tools.rebound`), so the output is the reference's byte for byte.

    AAT_TORCH_DEVICE=cpu python -m alignment_algos_tpu_torch.cli.aaa \\
        pair.fa --SUB_MATRIX BLOSUM62 [-opt] [--KEY value ...]
"""

from __future__ import annotations

import sys

from alignment_algos_tpu.cli import aaa as _ref

from ..core.dp import DPMatrix
from ._tools import rebound, run_tool

_run = rebound(_ref._run, DPMatrix=DPMatrix)


def main(argv=None) -> int:
    return run_tool(_run, argv)


if __name__ == "__main__":
    sys.exit(main())
