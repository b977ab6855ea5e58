"""``nalign`` — HMAP profile-profile alignment (nalign.cpp).

query.prof x template.prof -> optimal + near-optimal alignments with
LogisticNormal significance; cw (default), -ucw, or -opt enumeration;
FASTA / PIR / HMAP output.
"""

from __future__ import annotations

import sys
import time

from ..core.alignment import AlignmentSet
from ..core.dp import DPMatrix
from ..core.enumerators import (ConstrainedNearOptimal, Optimal,
                                UnconstrainedNearOptimal)
from ..io.fasta import FastaReader, FastaWriter
from ..io.pir import PIRWriter
from ..scoring.hmap_eval import HMAPaliEval
from ..seq.hmap import HMAPSequence, LogisticNormal
from ..seq.sflags import SuboptFlags
from ..utils.params import (ApplicationParams, Argv, HMAPaliParams,
                            OutputFormat, RCfile, apply_layers)
from ._tools import run_tool


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

    ali_params = HMAPaliParams()
    app_params = ApplicationParams()
    rc = RCfile()
    top = RCfile(topfile) if topfile else None
    apply_layers([ali_params, app_params], rc, top, args)

    if args.count() not in (2, 3):
        _usage()
        return 0

    print("Reading in query profile", file=sys.stderr)
    query = HMAPSequence.from_file(args.get_arg(0))
    print("Reading in template profile", file=sys.stderr)
    templ = HMAPSequence.from_file(args.get_arg(1))

    ge = HMAPaliEval(ali_params)
    ln = LogisticNormal(query.evd1_field, query.evd2_field,
                        templ.evd1_field, templ.evd2_field)
    dpm = DPMatrix(query, templ, ge, "fwd", ali_params.align_type)

    t1 = time.process_time()
    opt = Optimal(ali_params.align_type)
    alignments = AlignmentSet(dpm, opt)
    print("Added optimal alignment to alignment set.", file=sys.stderr)

    if not optflag:
        if not ucwflag:
            print("Now adding constrained suboptimal alignments.", file=sys.stderr)
            subopt = SuboptFlags(True, templ.size())
            templ.get_default_flags(subopt)
            if args.count() > 2:
                with open(args.get_arg(2)) as f:
                    r = FastaReader(f, find="Flags=suboptimal region",
                                    head_tail=False)
                    r.read_into(subopt)
            cno = ConstrainedNearOptimal(ali_params, subopt)
            cno.enumerate(dpm, alignments)
        else:
            print("Now adding unconstrained suboptimal alignments.", file=sys.stderr)
            ucw = UnconstrainedNearOptimal(ali_params)
            ucw.enumerate(dpm, alignments)

    alignments.assign_identity()
    alignments.assign_significance(ln)
    t2 = time.process_time()

    if app_params.output_format == OutputFormat.FASTA:
        FastaWriter(sys.stdout, app_params.line_length).write_set(alignments)
    elif app_params.output_format == OutputFormat.PIR:
        PIRWriter(sys.stdout, app_params.line_length).write_set(alignments)
    else:
        from ..io.hmapio import HMAPWriter
        HMAPWriter(sys.stdout, ali_params.submatrix_fn,
                   app_params.line_length).write_set(alignments)

    print(file=sys.stderr)
    print(f"time for alignment was (sec) {t2 - t1:g}", file=sys.stderr)
    print(f"total cpu time was (sec) {t2 - t0:g}", file=sys.stderr)
    print(file=sys.stderr)
    return 0


def _usage() -> None:
    print("Usage: nalign query.prof template.prof [template.flag]",
          file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
