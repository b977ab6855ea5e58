#!/usr/bin/env python3
"""K3, the exact general-gap DP, on the ``--profiles 1`` screen's inputs on
one NVIDIA GPU.

    python3 tools/torch_k3_bench.py [--root DIR] [--reps 5]

Builds ``chip_smoke.py``'s seeded library (one 256-residue query profile
against 1024 template profiles of 128-384 residues, 253 length buckets)
and its similarity stacks (K5 and K6, once, outside the timed region),
then prints CUDA-event times (mean of ``--reps`` runs after a warm-up):

- ``screen_k3_ms``: K3's part of one screen as the checkout's
  ``screen_hmap_device`` runs it: one ragged launch over the whole library
  where the checkout has ``dp_scores.dp_general_ragged``, else one
  ``dp_general`` launch per bucket on cost tables built beforehand;
- ``screen_ms``: the whole ``screen_hmap_device`` call (K5, K6, K3 and the
  score pull), by the host clock to a synchronize;
- with the ragged wrapper, also ``screen_k3_launch_ms`` (that launch
  alone, its descriptors built once), ``table_one_launch_ms`` (the table
  form of the same library in one launch: the costs read from tables
  instead of built in the kernel) and ``table_per_bucket_ms`` (the table
  form, one launch per bucket), which split the redesign's steps apart.

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
import time


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
        print("torch_k3_bench: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from alignment_algos_tpu_torch.cli import screen as cli
    from alignment_algos_tpu_torch.ops import _build
    from alignment_algos_tpu_torch.ops import dp_scores as ds
    from alignment_algos_tpu_torch.ops import hmap_device as hd

    dev = torch.device("cuda")
    built = _build.load()
    res = {"root": root, "card": cs.card_line(), "nvcc_s": built.seconds,
           "ptxas": [line.strip() for line in built.log.splitlines()
                     if "dp_general" in line or "registers" in line]}
    with tempfile.TemporaryDirectory() as d:
        qfn, lib_dir, _, _ = cs.make_profile_library(d)
        query, templates, _ = cli.read_profiles(qfn, lib_dir)
    params = hd.HMAPaliParams()
    ev = hd.HMAPaliEval(params)
    library = hd.DeviceLibrary(templates, ev, device=dev)
    qt = hd.query_tensors(query, dev)
    tables = [hd.bucket_tables(qt, b, params)
              for b in library.buckets.values()]
    res["buckets"] = len(tables)

    def per_bucket():
        for tabs in tables:
            ds.dp_general(*tabs)

    if hasattr(ds, "dp_general_ragged"):
        buckets = hd.screen_buckets(qt, library, params)
        flags = hd.ragged_flags(params)
        res["screen_k3_ms"] = cs.cuda_ms(
            lambda: ds.dp_general_ragged(buckets, **flags), args.reps)
        # the same launch alone, its descriptors built once
        scratch = torch.empty((sum(b[0].numel() for b in buckets),),
                              dtype=torch.float32, device=dev)
        vec_pairs = ds._ragged_descriptors(buckets, scratch)
        vec_out = torch.empty((len(vec_pairs),), dtype=torch.float32,
                              device=dev)
        res["screen_k3_launch_ms"] = cs.cuda_ms(
            lambda: ds._launch(vec_pairs, vec_out, vec=True, local=False,
                               **flags), args.reps)
        # the table form of the whole library in one launch
        H = [torch.empty_like(tabs[0]) for tabs in tables]
        pairs = np.concatenate([ds._descriptors(
            tuple(tabs[0].shape), [ds._addr(x) for x in
                                   (tabs[0], h, *tabs[1:])])
            for tabs, h in zip(tables, H)])
        pairs["slot"] = np.arange(len(pairs))
        out = torch.empty((len(pairs),), dtype=torch.float32, device=dev)
        res["table_one_launch_ms"] = cs.cuda_ms(
            lambda: ds._launch(pairs, out, vec=False, local=False),
            args.reps)
        ref = ds.dp_general_ragged(buckets, **flags)
        torch.cuda.synchronize()
        assert cs.same_bits(out, ref), "table form != vector form"
        res["table_per_bucket_ms"] = cs.cuda_ms(per_bucket, args.reps)
    else:
        res["screen_k3_ms"] = cs.cuda_ms(per_bucket, args.reps)
    hd.screen_hmap_device(query, templates, params, library=library,
                          device=dev)
    walls = []
    for _ in range(args.reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hd.screen_hmap_device(query, templates, params, library=library,
                              device=dev)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    res["screen_ms"] = [w * 1e3 for w in walls]
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
