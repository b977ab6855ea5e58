#!/usr/bin/env python3
"""K3, the exact general-gap DP, K5, the raw similarity, and K6, the
z-norm, on the ``--profiles 1`` screen's inputs on one NVIDIA GPU.

    python3 tools/torch_k3_bench.py [--root DIR] [--reps 5]

Builds ``chip_smoke.py``'s seeded library (one 256-residue query profile
against 1024 template profiles of 128-384 residues, 253 length buckets)
and its similarity stacks (K5 and K6, once, outside the timed region),
then prints CUDA-event times (mean of ``--reps`` runs after a warm-up):

- ``screen_k3_ms``: K3's part of one screen as the checkout's
  ``screen_hmap_device`` runs it: one ragged launch over the whole library
  where the checkout has ``dp_scores.dp_general_ragged``, else one
  ``dp_general`` launch per bucket on cost tables built beforehand;
- ``screen_k5_ms``: K5's part of one screen as the checkout runs it: one
  ``hmap_sim_ragged`` launch over every bucket where the checkout has it,
  else one ``hmap_sim`` launch per bucket (``k5_launches`` says which);
  ``screen_k5_device_ms``, the device time of its kernels in one such run
  (``torch.profiler``: 253 host launches outrun their kernels);
- ``screen_k6_ms``: K6's part of one screen as the checkout runs it: one
  ``hmap_znorm_ragged`` launch over every bucket's K5 output where the
  checkout has it, else one ``hmap_znorm`` launch per bucket
  (``k6_launches`` says which);
- ``screen_ms``: the whole ``screen_hmap_device`` call (K5, K6, K3 and the
  score pull), by the host clock to a synchronize;
- with the ragged wrapper, also ``screen_k3_launch_ms`` (that launch
  alone, its descriptors built once), ``table_one_launch_ms`` (the table
  form of the same library in one launch: the costs read from tables
  instead of built in the kernel) and ``table_per_bucket_ms`` (the table
  form, one launch per bucket), which split the redesign's steps apart.

``--oversized T`` times, instead, the route of a template past K3's
shared-memory cap: the seeded 256-residue query against one template of T
residues (T + 2 above ``dp_scores.vec_max_t2``), its bucket built by
``screen_buckets``, then per run (``--reps``) the host costs
(``hmap_device._k7_costs``: S pulled, the T+2 x T+2 deletion table), K7's
tables built and copied (``dp_engine.device_tables``), the K7 launch
(CUDA events), the pull of H, PQ and PT, the whole ``_scores_k7`` and the
whole ``screen_hmap_device`` (host clock to a synchronize), and, where
the checkout has ``dp_engine.launch_plan``, K7's mode and cluster size.

``--k7`` times, instead, K7 alone at the alignment tools' shapes as
``chip_smoke.py``'s phase 6 builds them: nalign's 386 x 404 HMAP pair and
a Gn2-style 182 x 224 pair (CUDA events, ``--reps`` launches after a
warm-up, three times each), with the launch plan where the checkout has
one.

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


def oversized(length: int, reps: int, dev) -> dict:
    """The ``--oversized`` times (see the module's doc), in seconds."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from alignment_algos_tpu_torch.cli import screen as cli
    from alignment_algos_tpu_torch.ops import dp_engine as de
    from alignment_algos_tpu_torch.ops import dp_scores as ds
    from alignment_algos_tpu_torch.ops import hmap_device as hd

    rng = np.random.default_rng(cs.SEED + 5)
    with tempfile.TemporaryDirectory() as d:
        qfn, lib = os.path.join(d, "q.prof"), os.path.join(d, "lib")
        os.makedirs(lib)
        for fn, name, n in ((qfn, "query", cs.Q_PROF),
                            (os.path.join(lib, "long.prof"), "long", length)):
            with open(fn, "w") as f:
                f.write(cs._profile_text(name, cs._residues(rng, n)))
        query, templates, _ = cli.read_profiles(qfn, lib)
    params = hd.HMAPaliParams()
    library = hd.DeviceLibrary(templates, hd.HMAPaliEval(params), device=dev)
    qt = hd.query_tensors(query, dev)
    bucket, = hd.screen_buckets(qt, library, params)
    q2, t2 = bucket[0].shape[1:]
    cap = ds.vec_max_t2(dev)
    assert t2 > cap, (t2, cap)
    res = {"oversized": f"1x{q2}x{t2}", "k3_vec_max_t2": cap,
           "costs_s": [], "tables_copy_s": [], "k7_launch_ms": [],
           "pull_s": [], "scores_k7_s": [], "screen_s": []}

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    bounds = dict(q0=0, q1=q2 - 1, t0=0, t1=t2 - 1)
    for _ in range(reps):
        costs, s = wall(lambda: hd._k7_costs(bucket, params))
        res["costs_s"].append(s)
        tensors, s = wall(lambda: de.device_tables(costs, **bounds,
                                                   device=dev))
        res["tables_copy_s"].append(s)
        del costs
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = de.dp_forward_tb(*tensors, **bounds, local=False)
        stop.record()
        torch.cuda.synchronize()
        res["k7_launch_ms"].append(start.elapsed_time(stop))
        (H, _, _), s = wall(lambda: [x.cpu().numpy() for x in out])
        res["pull_s"].append(s)
        del tensors, out
        score, s = wall(lambda: hd._scores_k7(bucket, params, dev))
        res["scores_k7_s"].append(s)
        assert np.isfinite(score).all() and score[0] == H[0, -1, -1]
        (scores, _), s = wall(lambda: hd.screen_hmap_device(
            query, templates, params, library=library, device=dev))
        res["screen_s"].append(s)
        assert scores.view(np.uint32)[0] == score.view(np.uint32)[0]
    res["score"] = float(score[0])
    res.update(_plan(de, dev, q2, t2))
    return res


def _plan(de, dev, q2: int, t2: int) -> dict:
    """K7's launch plan for a whole q2 x t2 build, where the checkout has
    one (one block per pair before it)."""
    if not hasattr(de, "launch_plan"):
        return {}
    plan = de.launch_plan(dev, q2, t2, 0, q2 - 1, 0, t2 - 1)
    return {f"k7_{q2}x{t2}_mode": plan.mode,
            f"k7_{q2}x{t2}_cluster": plan.cluster}


def k7_tools(reps: int, dev) -> dict:
    """The ``--k7`` times (see the module's doc), in milliseconds."""
    import numpy as np
    import chip_smoke as cs
    from alignment_algos_tpu_torch.ops import dp_engine as de

    with tempfile.TemporaryDirectory() as d:
        na = cs.nalign_costs(d, cs.make_nalign_pair(d))
    gn2 = cs.k7_costs(de, np.random.default_rng(cs.SEED + 4), 182, 224, "gn2")
    res = {}
    for c in (na, gn2):
        q2, t2 = c.q_size, c.t_size
        b = dict(q0=0, q1=q2 - 1, t0=0, t1=t2 - 1)
        tabs = de.device_tables([c], **b, device=dev)
        res[f"k7_1x{q2}x{t2}_ms"] = [
            cs.cuda_ms(lambda: de.dp_forward_tb(*tabs, **b), reps)
            for _ in range(3)]
        res.update(_plan(de, dev, q2, t2))
    return res


def device_ms(fn, name: str) -> float:
    """Device milliseconds of the kernels whose name holds ``name`` in one
    run of ``fn`` (``torch.profiler``), after a warm-up run."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and name in e.key]
    if not events:
        raise RuntimeError(f"the profiler recorded no {name} kernel")
    return sum(e.self_device_time_total for e in events) / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--oversized", type=int, default=0, metavar="T")
    ap.add_argument("--k7", action="store_true")
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
                     if "dp_general" in line or "znorm" in line
                     or "hmap_sim" in line
                     or "dp_tb" in line or "registers" in line]}
    if args.oversized or args.k7:
        res.update(oversized(args.oversized, args.reps, dev)
                   if args.oversized else k7_tools(args.reps, dev))
        print(json.dumps(res))
        return 0
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

    alpha = float(np.float32(params.alpha))
    shift = float(-np.float32(params.zero_shift))
    q3 = (qt["aa"], qt["zsse"], qt["conf"])
    stacks = [(b["aa"], b["zsse"], b["conf"])
              for b in library.buckets.values()]
    if hasattr(hd, "hmap_sim_ragged"):
        res["k5_launches"] = 1

        def k5():
            return hd.hmap_sim_ragged(*q3, stacks, alpha)
    else:
        res["k5_launches"] = len(stacks)

        def k5():
            return [hd.hmap_sim(*q3, *st, alpha) for st in stacks]
    res["screen_k5_ms"] = cs.cuda_ms(k5, args.reps)
    res["screen_k5_device_ms"] = [device_ms(k5, "hmap_sim_kernel")
                                  for _ in range(3)]
    raws = k5()
    if hasattr(hd, "hmap_znorm_ragged"):
        res["k6_launches"] = 1
        res["screen_k6_ms"] = cs.cuda_ms(
            lambda: hd.hmap_znorm_ragged(raws, shift), args.reps)
    else:
        res["k6_launches"] = len(raws)
        res["screen_k6_ms"] = cs.cuda_ms(
            lambda: [hd.hmap_znorm(S, shift) for S in raws], args.reps)
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
