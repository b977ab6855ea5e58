"""``nalign`` on the port's DP builds (counterpart of
``alignment_algos_tpu/cli/nalign.py``).

HMAP profile-profile alignment: query.prof x template.prof -> optimal and
near-optimal alignments (cw by default, -ucw, -opt).  The reference tool's
``_run`` runs unchanged with the port's ``DPMatrix`` in its globals
(:func:`._tools.rebound`), so the output is the reference's byte for byte.

    AAT_TORCH_DEVICE=cpu python -m alignment_algos_tpu_torch.cli.nalign \\
        q.prof t.prof [t.flag] [-opt | -ucw] [--KEY value ...]
"""

from __future__ import annotations

import sys

from alignment_algos_tpu.cli import nalign as _ref

from ..core.dp import DPMatrix
from ._tools import rebound, run_tool

_run = rebound(_ref._run, DPMatrix=DPMatrix)


def main(argv=None) -> int:
    return run_tool(_run, argv)


if __name__ == "__main__":
    sys.exit(main())
