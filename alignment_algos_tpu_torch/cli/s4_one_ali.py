"""``S4_one_ali`` — interactive fragment-by-fragment alignment builder
(S4_one_ali.cpp:19-150, driving the commented-out
``SSSS::choose_fragments_for_ali`` at ssss.h:433-504).

The reference tool does not compile (its ``akalib.h`` evaluator was never
shipped, and the SSSS driver body is commented out); this is a *working*
equivalent built on the same fragment graph the S4 tools use:

* present every valid N-terminal starting fragment, numbered;
* the user picks one; then at each step the current fragment's outgoing
  connections are listed and one is chosen, until the C-terminal cap;
* the finished skeleton is printed, and — beyond what the reference
  sketched — rendered into a complete PIR alignment with DP-filled loops
  (the ``output_pir_ali`` path, ssss.h:567-802).

Choices come from ``--choices "1,2,1"`` (scripted / non-interactive),
``--best`` (always take the highest connection score), or stdin prompts.
Evaluator: Hmap2Eval by default (the shipped S4_align score), Gn2Eval with
``--gn2 1`` — the reference's AKaliEval cannot be reconstructed.

Args follow S4_one_ali.cpp:50-70: query.prof first, template second (note
this is the *opposite* order from S4_align.cpp).
"""

from __future__ import annotations

import sys

from ..core.alignment import AlignmentSet
from ..core.dp import DPMatrix
from ..scoring.gn2_eval import Gn2Eval, Gn2Params
from ..scoring.hmap2_eval import Hmap2Eval
from ..seq.hmap import HMAPSequence
from ..ssss.defs import HELIX, STRAND
from ..ssss.engine import SSSS
from ..ssss.skel_ali import SkelAli
from ..ssss.skel_set import SkelSet
from ..structure.smap import SMAPSequence
from ..utils.params import ApplicationParams, Argv, RCfile, apply_layers
from ._tools import run_tool

_SS_NAME = {HELIX: "helix", STRAND: "strand"}


def _frag_lines(frag, str_data) -> list[str]:
    """Describe one fragment: geometry plus its aligned segment."""
    sse = str_data.sses[frag.sse_id - 1] if 1 <= frag.sse_id <= len(
        str_data.sses) else None
    kind = _SS_NAME.get(sse.ss_type, "?") if sse else "cap"
    head = (f"SSE {frag.sse_id} ({kind})  "
            f"t {frag.core_t0()}-{frag.core_t1()}  "
            f"q {frag.core_q0()}-{frag.core_q1()}  "
            f"shift {frag.qt():+d}  score {frag.ss():.3f}  "
            f"z {frag.zs():.3f}")
    t_str = str_data.templ_seq[frag.core_t0():frag.core_t1() + 1]
    q_str = str_data.query_seq[frag.core_q0():frag.core_q1() + 1]
    return [head, f"  T: {t_str}", f"  Q: {q_str}"]


def _print_skel(skel: SkelAli, str_data, os_) -> None:
    print(f"Skeleton: score {skel.get_score():.3f}, "
          f"{skel.get_num_aligned()} aligned residues, "
          f"SSE_CO {skel.get_contact_order():.3f}", file=os_)
    for i in range(skel.num_connections()):
        frag = skel.get_frag(skel.get_connection(i).next_frag)
        if frag.frag_is_C_terminal:
            continue
        for line in _frag_lines(frag, str_data):
            print("  " + line, file=os_)


class _Chooser:
    """Yield 1-based selections: scripted list -> --best -> stdin."""

    def __init__(self, scripted: list[int], best: bool) -> None:
        self.scripted = list(scripted)
        self.best = best

    def pick(self, n_options: int, scores: list[float]) -> int:
        if self.scripted:
            choice = self.scripted.pop(0)
            if not 1 <= choice <= n_options:
                raise ValueError(f"choice {choice} out of range 1..{n_options}")
            return choice
        if self.best:
            return 1 + max(range(n_options), key=lambda i: scores[i])
        while True:
            print(f"Select a fragment [1-{n_options}]: ",
                  end="", file=sys.stderr, flush=True)
            line = sys.stdin.readline()
            if not line:
                raise ValueError("stdin closed before a choice was made")
            try:
                choice = int(line.strip())
            except ValueError:
                continue
            if 1 <= choice <= n_options:
                return choice


def main(argv=None) -> int:
    return run_tool(_run, argv)


def _run(argv) -> int:
    args = Argv(argv)
    if args.dohelp or args.count() < 2:
        print("Usage: S4_one_ali query.prof template.prof "
              "[num_kept max_search min_cov min_CO ali_mode max_avg_shift] "
              "[--choices 1,2,1 | --best 1] [--gn2 1] [-top file]",
              file=sys.stderr)
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
    query = HMAPSequence.from_file(args.get_arg(0))
    print("Reading in template profile", file=sys.stderr)
    templ = SMAPSequence.from_file(args.get_arg(1),
                                   verbose=app_params.verbosity, gn2=True)

    def _pos(i: int, cast, default):
        return cast(args.get_arg(i)) if args.count() > i else default

    num_kept = _pos(2, int, 1)
    num_searched = _pos(3, int, 1000)
    min_cov = _pos(4, float, 0.4)
    min_CO = _pos(5, float, 0.8)
    ali_mode = _pos(6, int, 1)
    max_avg_shift = _pos(7, float, 0.0)

    scripted = [int(c) for c in args.get_str("choices", "").split(",") if c]
    chooser = _Chooser(scripted, args.get_int("best", 0) == 1)
    use_gn2 = args.get_int("gn2", 0) == 1

    ev = Gn2Eval(ali_params) if use_gn2 else Hmap2Eval(ali_params)
    dpm_fwd = DPMatrix(query, templ, ev, "fwd")

    s_four = SSSS(ali_params, ev, dpm_fwd, num_kept, num_searched,
                  min_cov, min_CO, 2, ali_mode, max_avg_shift)
    s_four.fill_frag_matrix()
    s_four.Main_Frag_Selector.find_N_terminal_connections(s_four.All_Frags)

    builder = SkelSet(int(s_four.min_ali_residues), min_CO, num_kept,
                      max_avg_shift * s_four.templ_len, s_four.All_Frags,
                      s_four.Str, s_four.Strand_Eval)

    if not builder.Start_Skels:
        print("No valid starting fragments.", file=sys.stderr)
        return -1

    print("\nPossible starting fragments:", file=sys.stderr)
    start_scores = []
    for i, sa in enumerate(builder.Start_Skels, start=1):
        frag = builder.get_frag(sa.get_connection(0).next_frag)
        start_scores.append(sa.get_connection(0).connection_score)
        print(f"{i})", file=sys.stderr)
        for line in _frag_lines(frag, s_four.Str):
            print(line, file=sys.stderr)

    choice = chooser.pick(len(builder.Start_Skels), start_scores)
    one_skel = builder.Start_Skels[choice - 1].copy()
    print("\nYou have chosen to start with:", file=sys.stderr)
    _print_skel(one_skel, s_four.Str, sys.stderr)

    while True:
        curr = one_skel.get_last_connection()
        frag = builder.get_frag(curr.next_frag)
        if frag.num_next() == 0:  # only true for the C-terminal cap
            break
        print("\nYour next choices are:", file=sys.stderr)
        scores = []
        for i in range(frag.num_next()):
            fc = frag.get_next(i)
            nxt = builder.get_frag(fc.next_frag)
            scores.append(fc.connection_score + nxt.ss())
            print(f"{i + 1})", file=sys.stderr)
            for line in _frag_lines(nxt, s_four.Str):
                print(line, file=sys.stderr)
        choice = chooser.pick(frag.num_next(), scores)
        one_skel.add_connection(frag.get_next(choice - 1))
        print("\nYou now have:", file=sys.stderr)
        _print_skel(one_skel, s_four.Str, sys.stderr)

    print("\nFinal skeleton alignment:", file=sys.stderr)
    _print_skel(one_skel, s_four.Str, sys.stderr)

    # Beyond the reference sketch: render the finished skeleton to a full
    # PIR alignment with DP loop fill (ssss.h:567-802 path).
    out = AlignmentSet(dpm_fwd, None)
    s_four.output_pir_ali(one_skel, 1, dpm_fwd, out, sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
