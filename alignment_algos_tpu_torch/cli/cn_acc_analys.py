"""``cn_acc_analys`` — per-position contact number / accessibility /
hydropathy / SSE-state table from a structure-based alignment
(cn_acc_analys.cpp)."""

from __future__ import annotations

import sys

from ..io.fasta import read_fasta_alignment
from ..seq.hmap import HMAPSequence
from ..structure.smap import SMAPSequence
from ._tools import run_tool


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 3:
        print("Usage: cn_acc_analysis <ali> <templ prof> <query prof>",
              file=sys.stderr)
        return -1
    return run_tool(_run, argv)


def _run(argv) -> int:
    with open(argv[0]) as f:
        ali = read_fasta_alignment(f)
    ali.remove_ends()

    prof = SMAPSequence.from_file(argv[1], gn2=False)
    hmap = HMAPSequence.from_file(argv[2])

    pairs = list(ali.pairs)
    idx = pairs[0][0]
    ali_idx = pairs[0][1]
    out = sys.stdout
    for q_i, t_i in pairs:
        while idx < q_i:
            out.write(f"2\t({q_i - idx})\t-\t-\n")
            idx = q_i
        while ali_idx < t_i:
            out.write(f"0\t{prof.weighted_contact_number[ali_idx]:g}\t"
                      f"{prof.accessibility[ali_idx]:g}\t-\t"
                      f"{prof.olc(ali_idx)}\n")
            ali_idx += 1
        p_h, p_s, p_c = prof.sse_values[ali_idx]
        if p_c > p_s and p_c > p_h:
            state = "c"
        elif p_s > p_c and p_s > p_h:
            state = "e"
        elif p_h > p_s and p_h > p_c:
            state = "h"
        else:
            print("error", file=sys.stderr)
            return 1
        out.write(f"1\t{prof.weighted_contact_number[ali_idx]:g}\t"
                  f"{prof.accessibility[ali_idx]:g}\t"
                  f"{hmap.hydropathy[idx]:g}\t{prof.hydropathy[ali_idx]:g}\t"
                  f"{state}\t{hmap.olc(idx)}\t{prof.olc(ali_idx)}\n")
        idx += 1
        ali_idx += 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
