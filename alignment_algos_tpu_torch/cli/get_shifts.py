"""``get_shifts`` (get_shifts.cpp): alignment-quality benchmark — per-rank
table of %id, aligned length, residue shift, area shift, agreement metrics,
with running and cumulative statistics."""

from __future__ import annotations

import io
import sys

from ..analysis.ali_dist import AliDist
from ..analysis.shift import get_shift
from ..core.alignment import Alignment
from ..io.fasta import read_fasta_alignment
from ..io.pir import read_pir
from ..seq.sflags import SuboptFlags
from ..structure.smap import SMAPSequence
from ..utils.params import Argv
from ._tools import run_tool


def main(argv=None) -> int:
    def run(argv):
        args = Argv(argv)
        use_all = args.get_switch("-all")
        if args.count() < 2:
            print("get_shifts <seq ali> <nat ali> [core flags]",
                  file=sys.stderr)
            return 0
        seq_fn = args.get_arg(0)
        nat_fn = args.get_arg(1)

        x = AliDist()
        x.load_main_fasta(nat_fn)
        x.batch_compare_to_main_ali(seq_fn)

        with open(nat_fn) as f:
            nat_ali = read_fasta_alignment(f)

        q_size = nat_ali.get_last_query_idx() + 1
        q_seq = "*" * q_size
        allr = SuboptFlags(True, q_size)
        core = SuboptFlags(True, q_size)
        if args.count() > 2:
            smap = SMAPSequence.from_file(args.get_arg(2), gn2=True)
            q_seq = smap.get_string()
            if not use_all:
                smap.get_default_flags(core)

        out = sys.stdout
        part2 = io.StringIO()
        if args.count() > 2:
            out.write("Using core definitions\n")
        else:
            out.write("Using all residues\n")
        out.write(f"Native alignment length: {len(nat_ali)}\n")
        out.write(f"Native alignment %ID: {nat_ali.identity:4.2f}\n")
        out.write("\nRunning statistics\n")
        hdr = ("Rank \t%ID\t#ali'd\tshift_r\tshift_a\t#agree\tQ_mod\tQ_dev"
               "\tQ_comb\n")
        out.write(hdr)
        part2.write("\nCummulative statistics\n")
        part2.write(hdr)

        rank = 0
        mins = {"area": 999999999.0, "res": 999999999}
        maxs = {"agree": -1, "q_mod": -1.0, "q_dev": -1.0, "q_comb": -1.0,
                "from_opt": -1.0}
        length = float(nat_ali.get_last_template_idx() - 1)
        opt_ali = None
        bd_idx = 0

        with open(seq_fn) as f:
            while True:
                try:
                    seq_ali = read_pir(f)
                except EOFError:
                    break
                if opt_ali is None:
                    opt_ali = seq_ali

                area_based = x.batch_dists[bd_idx][0]
                bd_idx += 1
                res_based, ali_len = get_shift(seq_ali, nat_ali, q_seq, core)
                n_agree, q_mod, q_dev, q_comb = seq_ali.get_q_all(nat_ali,
                                                                  allr)

                mins["area"] = min(mins["area"], area_based)
                mins["res"] = min(mins["res"], res_based)
                maxs["agree"] = max(maxs["agree"], n_agree)
                maxs["q_mod"] = max(maxs["q_mod"], q_mod)
                maxs["q_dev"] = max(maxs["q_dev"], q_dev)
                maxs["q_comb"] = max(maxs["q_comb"], q_comb)

                out.write(f"{rank}\t{seq_ali.identity:4.2f}\t{ali_len}\t"
                          f"{res_based}\t{area_based:4.2f}\t{n_agree}\t"
                          f"{q_mod * 100:4.2f}\t{q_dev * 100:4.2f}\t"
                          f"{q_comb * 100:4.2f}\t")
                part2.write(f"{rank}\t{seq_ali.identity:4.2f}\t{ali_len}\t"
                            f"{mins['res']}\t{mins['area']:4.2f}\t"
                            f"{maxs['agree']}\t"
                            f"{maxs['q_mod'] * 100:4.2f}\t"
                            f"{maxs['q_dev'] * 100:4.2f}\t"
                            f"{maxs['q_comb'] * 100:4.2f}\t")
                rank += 1
                if rank > 1:
                    from_opt = seq_ali.get_area_diff(opt_ali)
                    out.write(f"{from_opt / length:4.2f}")
                    maxs["from_opt"] = max(maxs["from_opt"], from_opt)
                    part2.write(f"{maxs['from_opt'] / length:4.2f}")
                out.write("\t[R]\n")
                part2.write("\t[C]\n")

        out.write(part2.getvalue())
        return 0

    return run_tool(run, argv)


if __name__ == "__main__":
    sys.exit(main())
