"""``S4_align`` / ``S4_align_gn2`` — SSSS fragment-graph enumeration
(S4_align.cpp / S4_align_gn2.cpp).

Args: template SMAP profile first, query HMAP profile second (the reference
reads the template from argv slot 0 despite its usage text).  S4_align uses
Hmap2Eval; S4_align_gn2 uses Gn2Eval.
"""

from __future__ import annotations

import sys

from ..core.alignment import AlignmentSet
from ..core.dp import DPMatrix
from ..core.enumerators import Optimal
from ..scoring.gn2_eval import Gn2Eval, Gn2Params
from ..scoring.hmap2_eval import Hmap2Eval
from ..seq.hmap import HMAPSequence
from ..ssss.engine import SSSS
from ..structure.smap import SMAPSequence
from ..utils.params import ApplicationParams, Argv, RCfile, apply_layers
from ._tools import run_tool


def main(argv=None, use_gn2: bool = False) -> int:
    return run_tool(_run, argv, use_gn2)


def _run(argv, use_gn2: bool) -> int:
    args = Argv(argv)
    if args.dohelp or args.count() < 2:
        print("Usage: S4_align templ.prof query.prof "
              "[--max_returned N --max_searched S --min_cov F --min_CO F "
              "--max_in_betw_shift N --ali_mode 0|1 --max_cluster_size F "
              "--str_ali native.fasta]", file=sys.stderr)
        return 0
    topfile = ""
    if args.get_switch("-top", erase=False):
        topfile = args.get_switch_arg("-top", 1)

    ali_params = Gn2Params()
    app_params = ApplicationParams()
    rc = RCfile()
    top = RCfile(topfile) if topfile else None
    apply_layers([ali_params, app_params], rc, top, args)

    print("Reading in query profile", file=sys.stderr)
    query = HMAPSequence.from_file(args.get_arg(1))
    print("Reading in template profile", file=sys.stderr)
    # S4 links against the gn2 library's SMAPSequence (hmap2_eval.h:17 ->
    # gn2_eval.h:17 -> gn2lib_seq.h), not gnoali's
    templ = SMAPSequence.from_file(args.get_arg(0),
                                   verbose=app_params.verbosity, gn2=True)

    num_returned = args.get_int("max_returned", 1000)
    num_searched = args.get_int("max_searched", 1000000)
    min_cov = args.get_float("min_cov", 0.4)
    min_CO = args.get_float("min_CO", 0.8)
    # S4_align.cpp:67 defaults to -1; S4_align_gn2.cpp:67 defaults to 2
    max_in_betw_shift = args.get_int("max_in_betw_shift",
                                     2 if use_gn2 else -1)
    ali_mode = args.get_int("ali_mode", 1)
    max_cluster_size = args.get_float("max_cluster_size", 0.0)
    native_ali_fn = args.get_str("str_ali", "")
    tracking = 1 if native_ali_fn else 0
    # opt-in: working version of the reference's dead cluster_alignments
    # (skel_set.cpp:625-683); uses max_cluster_size as the UPGMA cut
    cluster = args.get_int("cluster", 0) == 1

    ev = Gn2Eval(ali_params) if use_gn2 else Hmap2Eval(ali_params)
    dpm_fwd = DPMatrix(query, templ, ev, "fwd")

    alignments = AlignmentSet(dpm_fwd, Optimal())
    alignments.clear()

    s_four = SSSS(ali_params, ev, dpm_fwd, num_returned, num_searched,
                  min_cov, min_CO, max_in_betw_shift, ali_mode,
                  max_cluster_size, tracking, native_ali_fn,
                  cluster=cluster)
    s_four.enumerate(dpm_fwd, alignments)
    print("Done enumerating suboptimal alignments", file=sys.stderr)
    return 0


def main_gn2(argv=None) -> int:
    return main(argv, use_gn2=True)


if __name__ == "__main__":
    sys.exit(main(use_gn2="gn2" in sys.argv[0]))
