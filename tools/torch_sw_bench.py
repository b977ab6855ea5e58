#!/usr/bin/env python3
"""K1, K2 and the decode at the FASTA main path's shapes on one NVIDIA GPU.

    python3 tools/torch_sw_bench.py [--root DIR] [--reps 5]

CUDA-event times (mean of ``--reps`` launches after a warm-up) of
``sw_affine_scores`` (K1) on one 512-residue query against 5120 templates
padded to 512, and of ``sw_affine_tb`` (K2) on the top 10 of them, at the
gaps 4.73/0.34 and 11/1, on ``chip_smoke.py``'s seeded library: through
the wrappers as the main path calls them (``k1_ms``, ``k2_ms``: input
checks with one host sync, output allocation, launch) and the launch alone
on preallocated outputs (``k1_kernel_ms``, ``k2_kernel_ms``); and the
decode of K2's codes into paths, ``decode_local_tracebacks_device`` with
its pull and host path extraction (``decode_ms``), which any version of
the port has, so that two versions' decodes compare.

``--root DIR`` imports the port from another checkout, for example the
parent commit unpacked with ``git archive``, so that two versions are timed
on one card in turns (parent, change, change, parent), each in its own
process.  Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_sw_bench: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from alignment_algos_tpu_torch.cli import screen as cli
    from alignment_algos_tpu_torch.ops import _build
    from alignment_algos_tpu_torch.ops import swaffine as sw

    dev = torch.device("cuda")
    built = _build.load()
    res = {"root": root, "card": cs.card_line(), "nvcc_s": built.seconds,
           "k1_ms": {}, "k2_ms": {}, "k1_kernel_ms": {}, "k2_kernel_ms": {},
           "decode_ms": {}}
    blosum = os.path.join(root, "tests", "data", "BLOSUM62")
    with tempfile.TemporaryDirectory() as d:
        qfa, lfa, _ = cs.make_fastas(d)
        inp = cli.read_inputs(qfa, lfa, blosum)
    q, t, table = inp.q_codes, inp.t_codes, inp.table
    for gi, ge in cs.GAPS:
        key = f"{gi}/{ge}"
        qd, td, tab, gap = sw.to_device(q, t, table, gi, ge, dev)
        res["k1_ms"][key] = cs.cuda_ms(
            lambda: sw.sw_affine_scores(qd, td, tab, gap), args.reps)
        out = sw.sw_affine_scores(qd, td, tab, gap)
        res["k1_kernel_ms"][key] = cs.cuda_ms(
            lambda: sw._launch("sw_scores_launch", qd, td, tab, gap,
                               *td.shape, out), args.reps)
        hits = np.broadcast_to(q, (cs.TOP_K, len(q)))
        qh, th, tab, gap = sw.to_device(hits, t[:cs.TOP_K], table, gi, ge,
                                        dev)
        res["k2_ms"][key] = cs.cuda_ms(
            lambda: sw.sw_affine_tb(qh, th, tab, gap), args.reps)
        outs = sw.sw_affine_tb(qh, th, tab, gap)
        res["k2_kernel_ms"][key] = cs.cuda_ms(
            lambda: sw._launch("sw_tb_launch", qh, th, tab, gap, *th.shape,
                               *outs), args.reps)
        res["decode_ms"][key] = cs.cuda_ms(
            lambda: sw.decode_local_tracebacks_device(
                *outs, len(q), th.shape[0], nb=cs.TOP_K), args.reps)
    res["k1_shape_q_t_b"] = [len(q), *td.shape]
    res["k2_shape_q_t_b"] = [len(q), *th.shape]
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
