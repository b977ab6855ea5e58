"""``S4_align_gn2`` on the port's DP builds (counterpart of
``alignment_algos_tpu/cli/s4_align_gn2.py``); see s4_align.py."""

import sys

from .s4_align import main_gn2

if __name__ == "__main__":
    sys.exit(main_gn2())
