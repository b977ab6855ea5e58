"""``aaa`` — plain amino-acid alignment with a substitution matrix
(aa_ali.cpp).  Reads one FASTA file containing the template then the query,
builds the DP matrix (printed to stdout like the reference), emits the
optimal alignment and, unless -opt, constrained near-optimal alignments.

Note: the reference constructs its SuboptFlags with swapped constructor
arguments (aa_ali.cpp:95 ``SuboptFlags subopt(templ.size(),true)``), which
yields a length-1 flag array and out-of-range reads during enumeration.  We
use an all-true flag array of the proper length instead.
"""

from __future__ import annotations

import sys
import time

from ..core.alignment import AlignmentSet
from ..core.dp import DPMatrix
from ..core.enumerators import ConstrainedNearOptimal, Optimal
from ..io.fasta import FastaReader, FastaWriter
from ..io.pir import PIRWriter
from ..scoring.aasub import AASubstitutionEval
from ..scoring.submatrix import BlosumMatrix
from ..seq.sequence import AASequence
from ..seq.sflags import SuboptFlags
from ..utils.params import (AliParams, ApplicationParams, Argv, NOaliParams,
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

    ali_params = AliParams()
    app_params = ApplicationParams()
    noa_params = NOaliParams()
    rc = RCfile()
    top = RCfile(topfile) if topfile else None
    apply_layers([ali_params, app_params, noa_params], rc, top, args)

    if args.count() != 1:
        _usage()
        return 0

    with open(args.get_arg(0)) as f:
        reader = FastaReader(f)
        templ = AASequence()
        print("Reading in query profile", file=sys.stderr)
        reader.read_into(templ)
        query = AASequence()
        print("Reading in template profile", file=sys.stderr)
        reader.read_into(query)

    blosum = BlosumMatrix(ali_params.submatrix_fn)
    ge = AASubstitutionEval(ali_params, blosum)
    dpm = DPMatrix(query, templ, ge, "fwd", ali_params.align_type)
    sys.stdout.write(dpm.dump_matrix())
    sys.stdout.write("\n")

    t1 = time.process_time()
    opt = Optimal(ali_params.align_type)
    alignments = AlignmentSet(dpm, opt)

    if not optflag:
        subopt = SuboptFlags(True, templ.size())
        cno = ConstrainedNearOptimal(noa_params, subopt)
        cno.enumerate(dpm, alignments)

    alignments.assign_identity()
    t2 = time.process_time()

    if app_params.output_format == OutputFormat.FASTA:
        FastaWriter(sys.stdout, app_params.line_length).write_set(alignments)
    elif app_params.output_format == OutputFormat.PIR:
        PIRWriter(sys.stdout, app_params.line_length).write_set(alignments)
    else:
        print("Cannot use this format!", file=sys.stderr)
        return -1

    print(f"time for alignment was (sec) {t2 - t1:g}")
    print(f"total cpu time was (sec) {t2 - t0:g}")
    print()
    return 0


def _usage() -> None:
    print("Usage: aaa fasta_seqs", file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
