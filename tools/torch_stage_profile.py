#!/usr/bin/env python3
"""Stage breakdown and device idle share of the port's ``aat_screen`` on
one NVIDIA GPU, at ``chip_smoke.py``'s sizes.

    python3 tools/torch_stage_profile.py [--path fasta|profiles]
                                         [--repeats 4] [--trace DIR]

``--path fasta`` (the default): one 512-residue query against 5120
templates of 64-512 residues, padded to 512.

1. Replays the CLI's stages one by one, with ``torch.cuda.synchronize()``
   after each, ``--repeats`` times at both gap settings (the first repeat
   is cold): FASTA read + encoding, host -> device, K1, top-k, K2, the
   decode (K8, then the records' pull and the host path extraction; the
   two together as ``decode``), ``area_matrix``, UPGMA.
2. Runs the whole CLI once more under ``torch.profiler`` at each gap
   setting and reports wall, device-busy seconds (the union of the
   device-side events' intervals: kernels, copies, fills), idle share,
   device event count and the largest device entries; with ``--trace DIR``
   also writes a Chrome trace per run there (tens of MB each).
3. Times the plain PyTorch screen (``screen_library_host``) on the card.

``--path profiles``: ``aat_screen --profiles 1``, one 256-residue query
profile against 1024 template profiles of 128-384 residues.

1. Replays the stages ``--repeats`` times, synchronizing after each:
   profile parsing, the library's host packing and copy to the device,
   K5 once over the whole library (one ragged launch), K6 once over it
   (one ragged launch), K3 once over it (one ragged launch, its costs
   built in the kernel), the score pull and the top-k.
2. Runs the whole CLI once under ``torch.profiler`` (as above).

Prints one JSON object with every number and the card's name and power
limit.  Needs one GPU; run from the repository root.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def sync() -> float:
    torch.cuda.synchronize()
    return time.perf_counter()


def replay(qfa, lfa, blosum, gi, ge, dev):
    """One pass over the CLI's stages; returns {stage: seconds}."""
    from alignment_algos_tpu_torch.analysis.ali_dist import (ResPair,
                                                             area_matrix)
    from alignment_algos_tpu_torch.analysis.upgma import UPGMAClusterer
    from alignment_algos_tpu_torch.cli import screen as cli
    from alignment_algos_tpu_torch.ops import swaffine as sw

    st = {}
    t0 = sync()
    inp = cli.read_inputs(qfa, lfa, blosum)
    q, t, table, pad = inp.q_codes, inp.t_codes, inp.table, inp.pad_code
    t1 = sync()
    st["read + encode"] = t1 - t0
    qd, td, tab, gap = sw.to_device(q, t, table, gi, ge, dev)
    t2 = sync()
    st["to_device"] = t2 - t1
    scores = sw.sw_affine_scores(qd, td, tab, gap)
    t3 = sync()
    st["K1"] = t3 - t2
    order = torch.sort(-scores, stable=True).indices[:cs.TOP_K]
    idx = order.cpu().numpy()
    t4 = sync()
    st["top-k + pull"] = t4 - t3
    hits = t[idx]
    k2_in = sw.to_device(np.broadcast_to(q, (len(idx), len(q))), hits,
                         table, gi, ge, dev)
    t5 = sync()
    st["K2 to_device"] = t5 - t4
    tb, m, dat = sw.sw_affine_tb(*k2_in)
    t6 = sync()
    st["K2"] = t6 - t5
    # decode_local_tracebacks_device's two steps, timed apart
    _, rec_i, rec_j = sw.sw_decode(tb, m, dat, q=len(q), t=t.shape[1],
                                   b=len(idx))
    t6k = sync()
    st["K8"] = t6k - t6
    paths = sw._paths(rec_i.cpu().numpy(), rec_j.cpu().numpy(), len(idx))
    t7 = sync()
    st["pull + paths"] = t7 - t6k
    st["decode"] = t7 - t6
    tl = (hits != pad).sum(axis=1)
    vrps = [[ResPair(0, 0)] + [ResPair(a + 1, b + 1) for a, b in p]
            + [ResPair(len(q) + 1, int(tl[n]) + 1)]
            for n, p in enumerate(paths)]
    dist = np.asarray(area_matrix(vrps), np.float64) / len(q)
    t8 = sync()
    st["area_matrix"] = t8 - t7
    c = UPGMAClusterer(dist)
    c.cluster()
    c.find_clusters_under_threshold(8.0)
    t9 = sync()
    st["UPGMA"] = t9 - t8
    st["total"] = t9 - t0
    st["longest path (matches)"] = max(len(p) for p in paths)
    return st


def replay_profiles(qfn, lib_dir, dev):
    """One pass over ``--profiles 1``'s stages; returns {stage: seconds}
    (K5, K6 and K3 one launch each)."""
    from alignment_algos_tpu_torch.cli import screen as cli
    from alignment_algos_tpu_torch.ops import dp_scores as ds
    from alignment_algos_tpu_torch.ops import hmap_device as hd

    t0 = sync()
    query, templates, _ = cli.read_profiles(qfn, lib_dir)
    t1 = sync()
    st = {"parse profiles": t1 - t0}
    params = hd.HMAPaliParams()
    library = hd.DeviceLibrary(templates, hd.HMAPaliEval(params), device=dev)
    qt = hd.query_tensors(query, dev)
    t2 = sync()
    st["library pack + to_device"] = t2 - t1
    alpha = float(np.float32(params.alpha))
    shift = float(-np.float32(params.zero_shift))
    bs = list(library.buckets.values())
    raws = hd.hmap_sim_ragged(qt["aa"], qt["zsse"], qt["conf"],
                              [(b["aa"], b["zsse"], b["conf"]) for b in bs],
                              alpha)
    t3 = sync()
    st["K5"] = t3 - t2
    Ss = hd.hmap_znorm_ragged(raws, shift)
    buckets = [(S, b["D"], b["A"], b["B"], None) for S, b in zip(Ss, bs)]
    t4 = sync()
    st["K6"] = t4 - t3
    out = ds.dp_general_ragged(buckets, **hd.ragged_flags(params))
    t5 = sync()
    st["K3"] = t5 - t4
    scores = np.zeros(len(templates), np.float32)
    scores[[i for b in bs for i in b["idx"]]] = out.cpu().numpy()
    t6 = sync()
    st["pull"] = t6 - t5
    np.lexsort((np.arange(len(scores)), -scores))[:cs.TOP_K]
    t7 = sync()
    st["top-k"] = t7 - t6
    st["total"] = t7 - t0
    st["buckets"] = len(library.buckets)
    return st


def _union_us(spans) -> float:
    """Total length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(spans):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy


def profiled_run(argv, trace_path=None):
    """One CLI run under torch.profiler; wall, device busy, top entries.

    Only device-side events count: a CPU op's self device time repeats
    the time of the kernels it launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from alignment_algos_tpu_torch.cli import screen as cli
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = cs.run_cli(cli.main, argv)
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev_events:
        raise RuntimeError("the profiler recorded no device events")
    busy_s = _union_us((e.time_range.start, e.time_range.end)
                       for e in dev_events) / 1e6
    top = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: -e.self_device_time_total)
    if trace_path:
        prof.export_chrome_trace(trace_path)
    return {"wall_s": wall, "device_busy_s": busy_s,
            "idle_share": 1.0 - busy_s / wall,
            "device_events": len(dev_events),
            "top_device_ms": [[e.key[:60], e.count,
                               e.self_device_time_total / 1e3]
                              for e in top[:6]],
            "trace": trace_path}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", choices=("fasta", "profiles"),
                    default="fasta")
    ap.add_argument("--repeats", type=int, default=4)
    ap.add_argument("--trace", default="",
                    help="directory for Chrome traces (default: none)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_stage_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from alignment_algos_tpu_torch.cli import screen as cli
    from alignment_algos_tpu_torch.ops import _build
    from alignment_algos_tpu_torch.parallel import screen as ps

    os.environ["AAT_TORCH_DEVICE"] = "cuda"
    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
    dev = torch.device("cuda")
    _build.load()
    blosum = os.path.join(ROOT, "tests", "data", "BLOSUM62")
    res = {"card": cs.card_line(), "stages": {}, "profiled": {}}
    if args.path == "profiles":
        with tempfile.TemporaryDirectory() as d:
            qfn, lib_dir, _, _ = cs.make_profile_library(d)
            res["stages"]["--profiles 1"] = [
                replay_profiles(qfn, lib_dir, dev)
                for _ in range(args.repeats)]
            argv = [qfn, lib_dir, "--profiles", "1", "--top_k",
                    str(cs.TOP_K)]
            res["profiled"]["--profiles 1"] = profiled_run(
                argv, args.trace and os.path.join(args.trace,
                                                  "trace_profiles.json"))
        print(json.dumps(res, indent=1))
        return 0
    with tempfile.TemporaryDirectory() as d:
        qfa, lfa, _ = cs.make_fastas(d)
        for gi, ge in cs.GAPS:
            res["stages"][f"{gi}/{ge}"] = [
                replay(qfa, lfa, blosum, gi, ge, dev)
                for _ in range(args.repeats)]
        for gi, ge in cs.GAPS:
            argv = [qfa, lfa, "--SUB_MATRIX", blosum, "--top_k",
                    str(cs.TOP_K), "--gap_init", str(gi), "--gap_extn",
                    str(ge)]
            cs.run_cli(cli.main, argv)           # warm
            res["profiled"][f"{gi}/{ge}"] = profiled_run(
                argv, args.trace and os.path.join(args.trace,
                                                  f"trace_{gi}_{ge}.json"))
        inp = cli.read_inputs(qfa, lfa, blosum)
        gi, ge = cs.GAPS[0]
        t0 = sync()
        ps.screen_library_host(inp.q_codes, inp.t_codes, inp.table, gi, ge,
                               k=cs.TOP_K, device=dev)
        res[f"plain screen_library_host on the card, {gi}/{ge}, s"] = (
            sync() - t0)
    print(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
