"""``get_area_diffs`` (get_area_diffs.cpp): batch area distance of PIR
alignments vs a reference gapped-FASTA alignment."""

from __future__ import annotations

import sys

from ..analysis.ali_dist import AliDist
from ._tools import run_tool


def main(argv=None) -> int:
    def run(argv):
        if len(argv) < 2:
            print("usage: get_area_diffs <pir batch> <native fasta>",
                  file=sys.stderr)
            return -1
        x = AliDist()
        x.load_main_fasta(argv[1])
        x.batch_compare_to_main_ali(argv[0])
        x.print_batch_dists(sys.stdout)
        return 0
    return run_tool(run, argv)


if __name__ == "__main__":
    sys.exit(main())
