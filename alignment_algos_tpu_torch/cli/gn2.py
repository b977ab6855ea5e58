"""``gn2`` — structure-aware iterative alignment (gn2.cpp).

query.prof x template SMAP profile via Gn2Eval.  -crcw runs iterative
rounds: enumerate -> templ.update_core(alignments, 0.33) -> dpm.reevaluate()
-> repeat, then a final enumerate with final_overlap (gn2.cpp:114-195).
The DP is always built global (gn2.cpp:86-87 passes no align_type).
"""

from __future__ import annotations

import sys
import time

from ..core.alignment import AlignmentSet
from ..core.dp import DPMatrix
from ..core.enumerators import (ConstrainedNearOptimal,
                                CRConstrainedNearOptimal,
                                KSConstrainedNearOptimal, Optimal,
                                UnconstrainedNearOptimal)
from ..io.fasta import FastaReader, FastaWriter
from ..io.hmapio import HMAPWriter
from ..io.pir import PIRWriter
from ..scoring.gn2_eval import Gn2Eval, Gn2Params
from ..seq.hmap import HMAPSequence
from ..seq.sflags import SuboptFlags
from ..structure.smap import SMAPSequence
from ..utils.params import (ApplicationParams, Argv, OutputFormat, RCfile,
                            apply_layers)
from ._tools import run_tool


def smooth_subopt_regions(sf: SuboptFlags) -> None:
    """Remove runs of 1s of length 1 (gn2.cpp:260-266)."""
    for i in range(1, sf.size() - 1):
        if sf[i] and not sf[i - 1] and not sf[i + 1]:
            sf.set(i, False)


def make_subopt_regions(sf: SuboptFlags, regs: int) -> None:
    """Evenly divide into regs regions (gn2.cpp:268-283)."""
    length = float(sf.size()) / float(regs)
    flag = True
    place = length
    for i in range(sf.size()):
        sf.set(i, flag)
        if i > place:
            flag = not flag
            place += length
    sf.set(sf.size() - 1, True)


def _read_flags(args, templ) -> SuboptFlags:
    subopt = SuboptFlags(True, templ.size())
    templ.get_default_flags(subopt)
    if args.count() > 2:
        with open(args.get_arg(2)) as f:
            FastaReader(f, find="Flags=suboptimal region",
                        head_tail=False).read_into(subopt)
        return subopt
    return subopt


def main(argv=None) -> int:
    return run_tool(_run, argv)


def _run(argv) -> int:
    t0 = time.process_time()
    args = Argv(argv)
    if args.dohelp:
        _usage()
        return 0
    topfile = ""
    if args.get_switch("-top", erase=False):
        topfile = args.get_switch_arg("-top", 1)
    optflag = args.get_switch("-opt")
    ucwflag = args.get_switch("-ucw")
    kscwflag = args.get_switch("-kscw")
    crcwflag = args.get_switch("-crcw")
    showrounds = args.get_switch("-showrounds")

    ali_params = Gn2Params()
    app_params = ApplicationParams()
    rc = RCfile()
    top = RCfile(topfile) if topfile else None
    apply_layers([ali_params, app_params], rc, top, args)

    if args.count() not in (2, 3):
        _usage()
        return 0

    print("Reading in query profile...  ", end="", file=sys.stderr)
    query = HMAPSequence.from_file(args.get_arg(0))
    print(f"length {query.seq_length}", file=sys.stderr)

    print("Reading in template profile...  ", end="", file=sys.stderr)
    templ = SMAPSequence.from_file(args.get_arg(1),
                                   verbose=app_params.verbosity, gn2=True)
    print(f"length {templ.seq_length}", file=sys.stderr)

    ge = Gn2Eval(ali_params)
    dpm = DPMatrix(query, templ, ge, "fwd")  # always global (gn2.cpp:86)

    t1 = time.process_time()
    opt = Optimal()
    alignments = AlignmentSet(dpm, opt)
    print("Added optimal alignment to alignment set.", file=sys.stderr)

    if not optflag:
        if ucwflag:
            UnconstrainedNearOptimal(ali_params).enumerate(dpm, alignments)
        elif kscwflag:
            subopt = _read_flags(args, templ)
            KSConstrainedNearOptimal(ali_params, subopt).enumerate(dpm, alignments)
        elif crcwflag:
            regions = 10  # gn2.cpp:117
            subopt = SuboptFlags(True, templ.size())
            templ.get_default_flags(subopt)
            if args.count() > 2:
                print("Reading suboptimal regions from file.", file=sys.stderr)
                with open(args.get_arg(2)) as f:
                    FastaReader(f, find="Flags=suboptimal region",
                                head_tail=False).read_into(subopt)
            elif regions == 0:
                smooth_subopt_regions(subopt)
            else:
                print(f"Generating {regions} evenly-divided suboptimal "
                      "regions.", file=sys.stderr)
                make_subopt_regions(subopt, regions)

            crcno = CRConstrainedNearOptimal(ali_params, subopt)
            user_n = ali_params.number_suboptimal
            ali_params.number_suboptimal = ali_params.subopt_per_round

            ali_rounds = AlignmentSet(dpm, opt)
            for i in range(1, ali_params.rounds + 1):
                crcno.enumerate(dpm, ali_rounds)
                if len(ali_rounds) < 1:
                    break
                templ.update_core(ali_rounds, 0.33)
                dpm.reevaluate()
                print(f"ROUND {i} ({len(ali_rounds)} alignments, "
                      f"opt={ali_rounds[0].score:g}, "
                      f"k_limit={ali_params.k_limit}, "
                      f"sort_limit={ali_params.sort_limit})", file=sys.stderr)
                if showrounds:
                    _write_out(app_params, ali_params, ali_rounds)
                ali_rounds.clear()

            print("FINAL ROUND", file=sys.stderr)
            ali_params.max_overlap = ali_params.final_overlap
            ali_params.number_suboptimal = user_n
            if ali_params.number_suboptimal == 0:
                alignments.clear()
                opt.enumerate(dpm, alignments)
            elif ali_params.number_suboptimal == 1:
                opt.enumerate(dpm, alignments)
            else:
                crcno.enumerate(dpm, alignments)
        else:
            subopt = _read_flags(args, templ)
            ConstrainedNearOptimal(ali_params, subopt).enumerate(dpm, alignments)

    alignments.assign_identity()
    t2 = time.process_time()
    _write_out(app_params, ali_params, alignments)
    print(f"\ntime for alignment was (sec) {t2 - t1:g}", file=sys.stderr)
    print(f"total cpu time was (sec) {t2 - t0:g}\n", file=sys.stderr)
    return 0


def _write_out(app_params, ali_params, alignments) -> None:
    if app_params.output_format == OutputFormat.FASTA:
        FastaWriter(sys.stdout, app_params.line_length).write_set(alignments)
    elif app_params.output_format == OutputFormat.PIR:
        PIRWriter(sys.stdout, app_params.line_length).write_set(alignments)
    else:
        HMAPWriter(sys.stdout, ali_params.submatrix_fn,
                   app_params.line_length).write_set(alignments)


def _usage() -> None:
    print("Usage: gn2 query.prof template.prof [template.flag]", file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
