"""``nalign2`` — HMAP query vs SMAP structure template via Hmap2Eval
(nalign2.cpp): Optimal + {-ucw | -kscw | -crcw | cw}; always-global DP."""

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
from ..scoring.gn2_eval import Gn2Params
from ..scoring.hmap2_eval import Hmap2Eval
from ..seq.hmap import HMAPSequence
from ..seq.sflags import SuboptFlags
from ..structure.smap import SMAPSequence
from ..utils.params import (ApplicationParams, Argv, OutputFormat, RCfile,
                            apply_layers)
from ._tools import run_tool


def main(argv=None) -> int:
    return run_tool(_run, argv)


def _run(argv) -> int:
    t0 = time.process_time()
    args = Argv(argv)
    if args.dohelp:
        print("Usage: nalign2 query.prof template.prof [template.flag]",
              file=sys.stderr)
        return 0
    topfile = ""
    if args.get_switch("-top", erase=False):
        topfile = args.get_switch_arg("-top", 1)
    optflag = args.get_switch("-opt")
    ucwflag = args.get_switch("-ucw")
    kscwflag = args.get_switch("-kscw")
    crcwflag = args.get_switch("-crcw")

    ali_params = Gn2Params()
    app_params = ApplicationParams()
    rc = RCfile()
    top = RCfile(topfile) if topfile else None
    apply_layers([ali_params, app_params], rc, top, args)

    if args.count() not in (2, 3):
        print("Usage: nalign2 query.prof template.prof [template.flag]",
              file=sys.stderr)
        return 0

    query = HMAPSequence.from_file(args.get_arg(0))
    templ = SMAPSequence.from_file(args.get_arg(1),
                                   verbose=app_params.verbosity, gn2=True)

    ge = Hmap2Eval(ali_params)
    dpm = DPMatrix(query, templ, ge, "fwd")  # always global

    t1 = time.process_time()
    opt = Optimal()
    alignments = AlignmentSet(dpm, opt)

    def read_flags() -> SuboptFlags:
        subopt = SuboptFlags(True, templ.size())
        templ.get_default_flags(subopt)
        if args.count() > 2:
            with open(args.get_arg(2)) as f:
                FastaReader(f, find="Flags=suboptimal region",
                            head_tail=False).read_into(subopt)
        return subopt

    if not optflag:
        if ucwflag:
            UnconstrainedNearOptimal(ali_params).enumerate(dpm, alignments)
        elif kscwflag:
            KSConstrainedNearOptimal(ali_params, read_flags()).enumerate(
                dpm, alignments)
        elif crcwflag:
            CRConstrainedNearOptimal(ali_params, read_flags()).enumerate(
                dpm, alignments)
        else:
            ConstrainedNearOptimal(ali_params, read_flags()).enumerate(
                dpm, alignments)

    alignments.assign_identity()
    t2 = time.process_time()

    if app_params.output_format == OutputFormat.FASTA:
        FastaWriter(sys.stdout, app_params.line_length).write_set(alignments)
    elif app_params.output_format == OutputFormat.PIR:
        PIRWriter(sys.stdout, app_params.line_length).write_set(alignments)
    else:
        HMAPWriter(sys.stdout, ali_params.submatrix_fn,
                   app_params.line_length).write_set(alignments)

    print(f"\ntime for alignment was (sec) {t2 - t1:g}", file=sys.stderr)
    print(f"total cpu time was (sec) {t2 - t0:g}\n", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
