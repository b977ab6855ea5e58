"""``gnoali`` — HMAP query vs SMAP template via GnoaliEval (gnoali.cpp).

The reference's gnoali target does not compile as shipped (gnoali.cpp's
include of the renamed hmapalib.h); this implementation follows its source
flow: Optimal + cw with all-true default flags, LogisticNormal significance.
"""

from __future__ import annotations

import sys
import time

from ..core.alignment import AlignmentSet
from ..core.dp import DPMatrix
from ..core.enumerators import ConstrainedNearOptimal, Optimal
from ..io.fasta import FastaReader, FastaWriter
from ..io.hmapio import HMAPWriter
from ..io.pir import PIRWriter
from ..scoring.gnoali_eval import GnoaliEval, GnoaliParams
from ..seq.hmap import HMAPSequence, LogisticNormal
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
        print("Usage: gnoali query.prof template.prof [template.flag]",
              file=sys.stderr)
        return 0
    topfile = ""
    if args.get_switch("-top", erase=False):
        topfile = args.get_switch_arg("-top", 1)
    optflag = args.get_switch("-opt")

    ali_params = GnoaliParams()
    app_params = ApplicationParams()
    rc = RCfile()
    top = RCfile(topfile) if topfile else None
    apply_layers([ali_params, app_params], rc, top, args)

    if args.count() not in (2, 3):
        print("Usage: gnoali query.prof template.prof [template.flag]",
              file=sys.stderr)
        return 0

    query = HMAPSequence.from_file(args.get_arg(0))
    templ = SMAPSequence.from_file(args.get_arg(1),
                                   verbose=app_params.verbosity, gn2=False)

    ge = GnoaliEval(ali_params)
    ln = LogisticNormal(query.evd1_field, query.evd2_field,
                        templ.evd1_field, templ.evd2_field)
    dpm = DPMatrix(query, templ, ge, "fwd")

    t1 = time.process_time()
    alignments = AlignmentSet(dpm, Optimal())
    if not optflag:
        subopt = SuboptFlags(True, templ.size())
        if args.count() > 2:
            with open(args.get_arg(2)) as f:
                FastaReader(f, find="Flags=suboptimal region",
                            head_tail=False).read_into(subopt)
        ConstrainedNearOptimal(ali_params, subopt).enumerate(dpm, alignments)

    alignments.assign_identity()
    alignments.assign_significance(ln)
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
    print("GNOALI GNOAL. GNOA.. GNO... GN.... G.....", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
