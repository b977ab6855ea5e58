"""``S4_align_gn2`` — SSSS enumeration with the Gn2Eval score
(S4_align_gn2.cpp); see s4_align.py."""

import sys

from .s4_align import main_gn2

if __name__ == "__main__":
    sys.exit(main_gn2())
