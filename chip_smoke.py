#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit; exits non-zero without a card.
2. Builds the port's kernels (alignment_algos_tpu_torch/ops/csrc) with nvcc
   and prints the build time and ptxas's register/shared-memory/spill lines.
3. Holds each kernel against its plain PyTorch version on the card with
   ``torch.equal`` (tolerance 0): small odd shapes, K1 at 512 x 5120 lanes,
   K2 at 512 x 512 x 10, at gaps 4.73/0.34 and 11/1; K1 and K2 at the edges
   of their row stripes and query chunks (Q = 1, 511, 513 and 1031, odd T,
   B = 1, 33 and 5120, one query per lane and one shared, pad-walled
   lanes); K1 also against the numpy Gotoh oracle on 2 lanes (one query
   chunk and three), and ``screen_library``'s top-k through K1 against
   ``screen_library_host`` (plain version on the card, ranked by
   ``np.lexsort``).  K8 (the traceback decode) on K2's output at 512 x
   512 x 10 and at the stripe and chunk edges, at both gap settings,
   in both its modes (windowed and one thread a lane) against its plain
   version (``torch.equal``) and its paths against the numpy decode, and
   at 512 x 512 x 1024 (``--top_k 1024``), each mode timed at both
   sizes.
4. Drives the FASTA main path, ``aat_screen`` (the port's
   ``cli/screen.py``), at a deployment's size: one 512-residue query
   against 5120 templates of 64-512 residues padded to 512 with the pad
   wall (1.34e9 cells per screen), generated from a seed with 8 planted
   homologs.  A small run of the same CLI first builds the host code's
   native libraries, outside the timed runs and the launch counts.  Runs
   (a) default gaps, (b) --gap_init 11 --gap_extn 1, (c) (a) with --ckpt
   and --chunk_size 1024; checks the homologs rank 1-8 and share a cluster,
   (c) equals (a), K1, K2 and K8 launched in every run, and JAX never
   imported.
5. The exact profile path.  Fails unless the host libm ``expf`` loaded
   (the port's ``native`` raises without it).  Generates one
   256-residue query profile and 1024 template profiles of 128-384
   residues from the seed, 8 of them planted homologs (the query's residues
   20-236 with 30% of their rows redrawn, between random flanks).  Holds
   K3 (scores and full-H modes, global and local, HMAP vec_d tables and
   full-D tables with a C term, odd shapes and full-size buckets) against
   its plain version and against the numpy ``dp_ref`` engine on 2 pairs,
   K5 and K6 (each one launch over every bucket, as the screen runs them)
   against their plain versions on the whole library, K6 also on odd
   shapes (a 1 x 1 region, 1 x 698, past 2^17 elements, a first element
   of -0.0, a constant region), normalize on and off, and K5 + K6 against
   the host ``HMAPaliEval.build_costs`` S for 16 templates, all with
   tolerance 0.
   Then ``aat_screen --profiles 1`` over the 1024 templates (the homologs
   must rank 1-8; K3, K5 and K6 must launch), the same CLI on the first 64
   templates on the card and with ``AAT_TORCH_DEVICE=cpu`` (byte-equal
   stdout), and ``--smap 1`` on the repository's SMAP fixtures on the card
   and on the CPU (byte-equal stdout).  The screen launches K3 once, over
   the whole library (its ragged wrapper, the costs built in the kernel
   from the gap vectors), K5 once and K6 once: the run fails on other
   counts.  A last screen has a 7,300-residue template, past K3's
   shared-memory cap: K7 must score its bucket and every score must equal
   host ``build_costs`` + ``dp_ref``.  K3, K5 and K6 are held against
   their plain versions bit for bit (an int32 view, NaN at the same
   places).  Times K3 on the whole library (beside its
   bound), on a full bucket and on a 64-pair 258 x 258 batch (each as a
   ragged launch and in the table form), K5 and K6 on the whole library
   (through the wrapper and the launch alone) and on a full bucket, each
   against its plain version, and as K5's yardstick ``torch.bmm`` of the
   profile dot products at the largest bucket (not the same function).
6. The exact DP builds behind the alignment tools.  Holds K7 (H as
   float32 bits, PQ and PT) against its plain version on odd shapes, three
   sub-rectangles, a bounded 130 x 97 build, a 386 x 404 pair (its
   resident mode) and 12 x 7,302 (its streamed mode), on random, Gn2-style,
   integer-tie and |S|-near-1e8 costs, global and local; and against the
   numpy ``dp_ref`` engine on 2 real-size pairs, nalign's HMAP pair and a
   Gn2-style pair of path B's size (forward, and reverse with
   ``bug_compat`` on and off), all with tolerance 0.  Times K7 and its
   plain version on the 386 x 404 pair and at 182 x 224, with the mode and
   cluster size of each launch (K7's row carries the 386 x 404 pair's; its
   chain floor, worked out from the rows, is logged).  Then drives the
   port's tools on the card, each byte-equal to the same tool with
   ``AAT_DP_BACKEND=numpy``: path A, ``nalign`` on a 384-residue query
   profile against a 402-residue homolog template generated from the seed
   (cw, -ucw, -opt, -opt local); path B, ``gn2 -crcw`` with the production
   overrides and ``gn2 -opt`` on the repository's 180 x 222 real-protein
   fixture (K7 once per DP build: the first and one per round); and
   ``S4_align`` on the 51-residue SMAP fixture, after one small run of
   ``nalign`` and ``S4_align`` that builds the shared enumerators' native
   libraries outside the timed runs.  Each run's wall is split
   into its DP builds (cost model, engine) and the rest (enumeration,
   output).
7. The scale-out layer (``parallel/screen``, ``parallel/distributed``),
   every result compared at tolerance 0.  BASELINE config 2: 100
   sequences of 256 residues from the seed, all against all through
   ``screen_grid`` on a (1, 1) mesh of the card (K1 in its per-lane form);
   every row equals that query's ``screen_library`` scores, every top k
   ``screen_library_host``; a (2, 2) mesh naming cuda:0 four times gives
   the same three arrays.  Phase 4's library on a 4-entry mesh of cuda:0
   at both gap settings equals the ``mesh=None`` screen;
   ``launch_local_screen`` at that size, a gloo group of two ranks on the
   card and a one-process NCCL group (``reps=2``), gives every rank the
   one-process result.  ``screen_profiles`` over phase 5's first 64
   templates on a 2-entry mesh of cuda:0 (host costs, K3 per shard) equals
   the ``mesh=None`` screen as float32 bits; phase 5's past-cap library
   through the host-build route (an ``HMAPaliEval`` subclass) launches K3
   for the buckets it holds and K7 for the 7,300-residue one, every score
   equal to ``dp_ref``.  Logs the walls, K1's per-lane launch alone at
   the grid's shape, and the launches, which the kernels' line adds to
   K1's, K3's and K7's.
8. Checks that no module of the JAX package (``alignment_algos_tpu``) nor
   ``jax`` was loaded, then prints the kernels' JSON line (each kernel's
   launches on its path, error, time, plain time, and its bound: the larger
   of its bytes over the card's memory rate and its operations over the
   card's rate for their type, at the SM clock ``nvidia-smi`` reports), the
   card line, and as the last line ``{"ok": true, "device": {...}}``.

Any failed phase ends the run with a non-zero exit code.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 2024
Q_LEN, N_LIB, T_MIN, T_MAX = 512, 5120, 64, 512
N_HOMOLOGS, TOP_K, CHUNK = 8, 10, 1024
GAPS = [(4.73, 0.34), (11.0, 1.0)]
AA = "ARNDCQEGHILKMFPSTWYV"
# K8's modes, and the lanes of its second timed shape (--top_k 1024)
K8_MODES, K8_WIDE = ("windowed", "lane"), 1024
K1_SRC = K2_SRC = "alignment_algos_tpu_torch/ops/csrc/sw_gotoh.cu"
K8_SRC = "alignment_algos_tpu_torch/ops/csrc/sw_decode.cu"
LAYOUT_SRC = "alignment_algos_tpu_torch/ops/csrc/layout.cu"
K3_SRC = "alignment_algos_tpu_torch/ops/csrc/dp_general.cu"
K56_SRC = "alignment_algos_tpu_torch/ops/csrc/hmap_device.cu"
K7_SRC = "alignment_algos_tpu_torch/ops/csrc/dp_traceback.cu"
# the exact profile screen
Q_PROF, N_PROF, TP_MIN, TP_MAX = 256, 1024, 128, 384
HOM_CORE, HOM_REDRAW, N_SAME = (20, 237), 0.3, 64
# the alignment tools: nalign's query x homolog pair (the template is the
# query's residues 20-363, 30% of their rows redrawn, between 31- and
# 27-residue random flanks); gn2's production overrides (HMAPRC)
NA_Q, NA_T, NA_CORE, NA_LEFT = 384, 402, (20, 364), 31
GN2_PRODUCTION = ["--NUM_SUBOPT", "1000", "--DELTA_RATIO", "0.20",
                  "--MAX_OVERLAP", "0.05", "--FINAL_OVERLAP", "0.30",
                  "--ALIGN_MODE", "4"]
# K1 and K2 stripe and chunk edges: (Q, T, B); a warp holds 32 x R query
# rows (R = 16 from Q = 257 on), a longer query runs in chunks of 512
SW_EDGES = [(1, 1, 1), (511, 45, 33), (513, 39, 33), (1031, 77, 33),
            (40, 37, 5120)]
# K6's odd shapes (n, q2, t2): a 1 x 1 region, 1 x 698, past 2^17 region
# elements, then a bucket whose first element is -0.0 and a constant region
K6_EDGES = [(2, 3, 3), (1, 3, 700), (1, 300, 450), (3, 5, 6), (2, 6, 9)]
# a screen past K3's shared-memory cap (t2 7,200): a 30-residue query
# against ordinary templates and one of 7,300 residues
BIG_Q, BIG_TEMPLATES = 30, (40, 61, 90, 61, 7300)
# K7's checks against its plain version (n, q2, t2, bounds or None for the
# whole matrix): odd shapes, sub-rectangles, a bounded build, nalign's size
# (resident: D and Cm in shared memory) and 12 x 7,302 (streamed)
K7_SHAPES = [(1, 9, 7, None), (3, 13, 21, None), (2, 41, 33, None),
             (1, 16, 15, (2, 10, 3, 12)), (1, 16, 15, (1, 14, 1, 13)),
             (1, 16, 15, (4, 7, 2, 9)), (2, 130, 97, (7, 120, 11, 90)),
             (1, 386, 404, None), (1, 12, 7302, None)]
# K7's chain floor, worked out and not measured: per row one cluster
# barrier and one round of distributed-shared stores, an assumed 0.3-0.5 us
K7_ROW_US = (0.3, 0.5)
# the scale-out layer: BASELINE config 2's all-vs-all (GRID_N sequences of
# GRID_LEN residues); entries of cuda:0 in the sharded library screen and
# in the sharded profile screen
GRID_N, GRID_LEN, LIB_SHARDS, PROF_SHARDS = 100, 256, 4, 2
# published H100 SXM rates: HBM bytes per second; float32 and float64
# lanes per SM, each one operation per clock
HBM_BYTES_PER_S = 3.35e12
F32_LANES, F64_LANES = 128, 64


def log(*a):
    print(*a, flush=True)


@functools.lru_cache(maxsize=None)
def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return float(out.strip().splitlines()[0].split()[0]) * 1e6


def bound(nbytes: float, ops32: float, ops64: float = 0.0) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the card's rate for their type
    (float32 and float64 pipes run side by side)."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    hz = max_sm_clock_hz()
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(ops32 / (sms * F32_LANES * hz), ops64 / (sms * F64_LANES * hz))
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops_f32": ops32, "ops_f64": ops64,
            "sm_clock_hz": hz, "sms": sms}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def make_fastas(d: str):
    """Query + library FASTA from SEED; returns (paths, homolog names).

    The homologs descend from one ancestor, query[40:480] with 30% point
    mutations between two random flanks; each homolog adds 5% more, so
    their alignments follow one diagonal and they cluster together."""
    rng = np.random.default_rng(SEED)

    def rseq(n):
        return "".join(AA[i] for i in rng.integers(0, 20, n))

    def mutate(s, frac):
        s = list(s)
        for p in rng.choice(len(s), int(len(s) * frac), replace=False):
            s[p] = AA[rng.integers(0, 20)]
        return "".join(s)

    query = rseq(Q_LEN)
    ancestor = rseq(20) + mutate(query[40:480], 0.3) + rseq(20)
    slots = sorted(rng.choice(N_LIB, N_HOMOLOGS, replace=False).tolist())
    lines, homologs = [], []
    for n in range(N_LIB):
        if n in slots:
            s = mutate(ancestor, 0.05)
            homologs.append(f"hom_{n:04d}")
            lines.append(f">hom_{n:04d}\n{s}\n")
        else:
            lines.append(f">tmpl_{n:04d}\n"
                         f"{rseq(int(rng.integers(T_MIN, T_MAX + 1)))}\n")
    qfa, lfa = os.path.join(d, "query.fa"), os.path.join(d, "lib.fa")
    with open(qfa, "w") as f:
        f.write(f">query\n{query}\n")
    with open(lfa, "w") as f:
        f.write("".join(lines))
    return qfa, lfa, homologs


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` runs (CUDA events),
    after one warm-up run."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max().item())


def check_kernels(sw, q, t, table, pad, dev):
    """Phase 3: every comparison with tolerance 0; returns per-kernel
    (max_abs_err, ms, plain_ms) and the tb bytes K8's timed decode
    reads."""
    import torch
    from alignment_algos_tpu_torch.parallel import screen as ps
    err = {"k1": 0.0, "k2": 0.0, "k8": 0.0}

    def k1_vs_plain(qc, tc, tab, gap, got=None):
        if got is None:
            got = sw.sw_affine_scores(qc, tc, tab, gap)
        want = sw.sw_affine_scores_plain(sw.skewed_similarity(qc, tc, tab),
                                         gap, q=qc.shape[0], t=tc.shape[0])
        torch.cuda.synchronize()
        assert torch.equal(got, want), "K1 != plain"
        err["k1"] = max(err["k1"], max_abs(got, want))

    def k2_vs_plain(qc, tc, tab, gap):
        got = sw.sw_affine_tb(qc, tc, tab, gap)
        want = sw.sw_affine_tb_plain(sw.skewed_similarity(qc, tc, tab), gap,
                                     q=qc.shape[0], t=tc.shape[0])
        torch.cuda.synchronize()
        for g, w, name in zip(got, want, ("tb", "m", "dat")):
            assert g.shape == w.shape and torch.equal(g, w), f"K2 {name}"
            err["k2"] = max(err["k2"], max_abs(g, w))
        return got

    def k8_vs_plain_and_numpy(tb, m, dat, nq, nt):
        """K8 in both its modes against the plain version and the numpy
        decode."""
        b = m.shape[1]
        want = sw.decode_tb_plain(tb, m, dat, q=nq, t=nt, b=b)
        scores, paths = sw.decode_local_tracebacks(
            tb.cpu().numpy(), m.cpu().numpy(), dat.cpu().numpy(), nq, nt)
        for mode in K8_MODES:
            got = sw.sw_decode(tb, m, dat, q=nq, t=nt, b=b, plan=sw.k8_plan(
                nq, nt, b, *tb.shape, mode=mode))
            torch.cuda.synchronize()
            for g, w, name in zip(got, want, ("scores", "rec_i", "rec_j")):
                assert g.shape == w.shape and torch.equal(g, w), \
                    f"K8 ({mode}) {name}"
                err["k8"] = max(err["k8"], max_abs(g, w))
            np.testing.assert_array_equal(got[0].cpu().numpy(), scores)
            assert sw._paths(got[1].cpu().numpy(), got[2].cpu().numpy(),
                             b) == paths, f"K8 ({mode}) paths != numpy decode"

    rng = np.random.default_rng(SEED + 1)
    for gi, ge in GAPS:
        for nq, nt, b in ((13, 29, 5), (29, 13, 4), (16, 16, 3)):
            qc = rng.integers(0, 20, (b, nq))
            tc = rng.integers(0, 20, (b, nt))
            tc[0] = pad                 # an all-wall lane scores 0
            tc[1, nt // 2:] = pad
            for qarg in (qc[0], qc):
                args = sw.to_device(qarg, tc, table, gi, ge, dev)
                k1_vs_plain(*args)
            k2_vs_plain(*sw.to_device(qc, tc, table, gi, ge, dev))
        log(f"small odd shapes: K1 and K2 equal plain at gaps {gi}/{ge}")
        for nq, nt, b in SW_EDGES:
            qc = rng.integers(0, 20, (b, nq))
            tc = rng.integers(0, 20, (b, nt))
            if b >= 3:
                tc[0] = pad
                tc[1, nt // 2:] = pad
            for qarg in (qc[0], qc):
                args = sw.to_device(qarg, tc, table, gi, ge, dev)
                k1_vs_plain(*args)
                k8_vs_plain_and_numpy(*k2_vs_plain(*args), nq, nt)
        log(f"stripe and chunk edges {SW_EDGES} (Q, T, B): K1 and K2 equal "
            f"plain, shared query and one per lane, and K8 on K2's codes "
            f"(both modes) equals plain and the numpy decode, gaps {gi}/{ge}")

        n = sw.transpose_codes.launches
        qd, td, tab, gap = sw.to_device(q, t, table, gi, ge, dev)
        assert sw.transpose_codes.launches == n + 1
        for g, w in zip((qd, td, tab, gap),
                        sw.to_device(q, t, table, gi, ge, "cpu")):
            assert torch.equal(g.cpu(), w), "card layout != host layout"
        log(f"to_device's layout on the card (one transpose launch) equals "
            f"the host route's at {td.shape[1]} x {td.shape[0]}")
        full = sw.sw_affine_scores(qd, td, tab, gap)
        for lo in range(0, td.shape[1], CHUNK):
            k1_vs_plain(qd, td[:, lo:lo + CHUNK], tab, gap,
                        got=full[lo:lo + CHUNK])
        log(f"K1 equals plain at {Q_LEN} x {td.shape[1]} lanes "
            f"({CHUNK}-lane chunks), gaps {gi}/{ge}")
        top = ps.screen_library(q, t, table, gi, ge, k=TOP_K, device=dev)
        top_plain = ps.screen_library_host(q, t, table, gi, ge, k=TOP_K,
                                           device=dev)
        for a, b in zip(top, top_plain):
            np.testing.assert_array_equal(a, b)
        log(f"screen_library top-{TOP_K} through K1 equals "
            f"screen_library_host (plain, lexsort), gaps {gi}/{ge}")
        hits = np.broadcast_to(q, (TOP_K, Q_LEN))
        k2_args = sw.to_device(hits, t[:TOP_K], table, gi, ge, dev)
        k8_vs_plain_and_numpy(*k2_vs_plain(*k2_args), Q_LEN, t.shape[1])
        log(f"K2 equals plain at {Q_LEN} x {t.shape[1]} x {TOP_K}, and K8 "
            f"on its codes (both modes) equals plain and the numpy decode, "
            f"gaps {gi}/{ge}")

        # the numpy oracle, in float32 throughout, on 2 lanes: the main
        # path's, and three query chunks (1031 rows)
        lanes = [0, int(np.argmax((t != pad).sum(axis=1)))]
        long_q = rng.integers(0, 20, 1031)
        for qq, tt in ((q, t[lanes]), (long_q, t[lanes, :61])):
            s = table[qq[None, :, None], tt[:, None, :]]
            want = sw.sw_affine_reference(s, np.float32(gi), np.float32(ge))
            got = sw.sw_affine_scores(
                *sw.to_device(qq, tt, table, gi, ge, dev)).cpu().numpy()
            np.testing.assert_array_equal(got, want)
            err["k1"] = max(err["k1"], float(np.abs(got - want).max()))
        log(f"K1 equals the numpy oracle on lanes {lanes} at "
            f"{Q_LEN} x {T_MAX} and 1031 x 61, gaps {gi}/{ge}")

    # times at the main path's shapes, default gaps
    gi, ge = GAPS[0]
    qd, td, tab, gap = sw.to_device(q, t, table, gi, ge, dev)
    k1_ms = cuda_ms(lambda: sw.sw_affine_scores(qd, td, tab, gap), 3)

    # the plain version over all lanes at once (its skewed input is 10.7 GB
    # here; the 1024-lane chunks above only bound the comparison's memory)
    k1_plain_ms = cuda_ms(lambda: sw.sw_affine_scores_plain(
        sw.skewed_similarity(qd, td, tab), gap, q=Q_LEN, t=td.shape[0]), 1)
    qh, th, tab, gap = sw.to_device(np.broadcast_to(q, (TOP_K, Q_LEN)),
                                    t[:TOP_K], table, gi, ge, dev)
    k2_ms = cuda_ms(lambda: sw.sw_affine_tb(qh, th, tab, gap), 3)
    k2_plain_ms = cuda_ms(lambda: sw.sw_affine_tb_plain(
        sw.skewed_similarity(qh, th, tab), gap, q=Q_LEN, t=th.shape[0]), 1)
    # K8 on K2's codes of the main path's hits, as the screen decodes them,
    # in its plan's mode and beside it in the other; then at --top_k's
    # K8_WIDE lanes, checked and timed likewise
    tb, m, dat = sw.sw_affine_tb(qh, th, tab, gap)
    dec = dict(q=Q_LEN, t=th.shape[0], b=TOP_K)
    k8_ms = cuda_ms(lambda: sw.sw_decode(tb, m, dat, **dec), 5)
    k8_plain_ms = cuda_ms(lambda: sw.decode_tb_plain(tb, m, dat, **dec), 1)
    k8_extra = k8_modes_ms(sw, tb, m, dat, dec, "")
    walks = k8_walks(tb, m, dat, Q_LEN, TOP_K, *sw.K8_WINDOW)
    k8_extra.update(walk_steps=walks["steps"], walk_windows=walks["windows"])
    qw, tw, tab, gap = sw.to_device(np.broadcast_to(q, (K8_WIDE, Q_LEN)),
                                    t[:K8_WIDE], table, gi, ge, dev)
    wide = sw.sw_affine_tb(qw, tw, tab, gap)
    k8_vs_plain_and_numpy(*wide, Q_LEN, tw.shape[0])
    k8_extra.update(k8_modes_ms(sw, *wide, dict(q=Q_LEN, t=tw.shape[0],
                                                 b=K8_WIDE), f"_{K8_WIDE}"))
    log(f"K8 at {Q_LEN} x {th.shape[0]} x {TOP_K} and x {K8_WIDE} lanes, "
        f"each mode: {json.dumps(k8_extra)}")
    return ({"k1": (err["k1"], k1_ms, k1_plain_ms),
             "k2": (err["k2"], k2_ms, k2_plain_ms),
             "k8": (err["k8"], k8_ms, k8_plain_ms)},
            sum(walks["steps"]), k8_extra)


def time_layout(sw, t, dev):
    """The (B, T) -> (T, B) layout of the library's codes ``t`` as
    ``to_device`` writes it on the card: ``transpose_i32_kernel``'s launch
    alone on a preallocated output, checked against numpy, beside the host
    route's numpy transpose (host clock) and PyTorch's own transpose copy
    on the card, ``x.t().contiguous()`` (a yardstick; not on any path).
    Returns (max_abs_err, ms, plain_ms) and library_ms."""
    import torch
    b, n = t.shape
    src = torch.from_numpy(np.ascontiguousarray(t, dtype=np.int32)).to(dev)
    out = torch.empty((n, b), dtype=torch.int32, device=dev)
    lib = sw._build.load().lib
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        sw._build.check(lib.transpose_i32_launch(
            src.data_ptr(), out.data_ptr(), b, n, stream),
            "transpose_i32_launch")

    ms = cuda_ms(launch, 20)
    assert torch.equal(out.cpu(), torch.from_numpy(t.T.astype(np.int32)))
    library_ms = cuda_ms(lambda: src.t().contiguous(), 20)
    assert torch.equal(src.t().contiguous(), out)
    t0 = time.perf_counter()
    for _ in range(5):
        np.array(np.asarray(t, dtype=np.int32).T, order="C")
    plain_ms = (time.perf_counter() - t0) / 5 * 1e3
    log(f"layout: transpose_i32_kernel {ms:.4f} ms launch alone at {b} x {n}"
        f", equal to numpy's; the host route's numpy transpose "
        f"{plain_ms:.3f} ms; x.t().contiguous() on the card {library_ms:.4f}"
        f" ms")
    return (0.0, ms, plain_ms), library_ms


def k8_modes_ms(sw, tb, m, dat, dec: dict, tag: str) -> dict:
    """K8's plan mode at ``dec``'s shape and each mode's launch alone on
    preallocated outputs (mean of 5: at 10 lanes the wrapper's host work
    outlasts the kernel)."""
    import torch
    shape = (dec["q"], dec["t"], dec["b"], *tb.shape)
    out = {f"mode{tag}": sw.k8_plan(*shape).mode}
    scores, rec_i, rec_j = sw.sw_decode(tb, m, dat, **dec)
    for mode in K8_MODES:
        plan = sw.k8_plan(*shape, mode=mode)
        out[f"{mode}_launch_ms{tag}"] = cuda_ms(lambda: sw._decode_launch(
            tb, m, dat, scores, rec_i, rec_j, **dec, plan=plan), 5)
    torch.cuda.synchronize()
    return out


def k8_walks(tb, m, dat, q: int, b: int, dw: int, iw: int) -> dict:
    """Each lane's walk as K8's windowed mode takes it, replayed on the
    host: its steps (one code read each, so their sum is the tb bytes the
    decode reads: K8's bound counts what this run's data needs) and the
    windows (dw x iw, anchored at the walk's cell whenever it leaves the
    last) it loads."""
    tb, m, dat = (x.cpu().numpy() for x in (tb, m, dat))
    steps, windows = [], []
    for lane in range(b):
        bi = int(np.argmax(m[:q, lane]))
        n = w = 0
        if m[bi, lane] > 0.0:
            i, j, state, wd, wi = bi, int(dat[bi, lane]) - bi, 0, -1, -1
            while i >= 0 and j >= 0:
                if not (wd - dw < i + j <= wd and wi - iw < i <= wi):
                    wd, wi, w = i + j, i, w + 1
                c = int(tb[i + j, i, lane])
                n += 1
                if state == 0 and c & 3 == 0:
                    break
                if state == 0 and c & 3 == 1:
                    i, j = i - 1, j - 1
                elif state == 1 or (state == 0 and c & 3 == 2):
                    state, j = (1 if c & 4 else 0), j - 1
                else:
                    state, i = (2 if c & 8 else 0), i - 1
        steps.append(n)
        windows.append(w)
    return {"steps": steps, "windows": windows}


def run_cli(main, argv, *args, errors=None):
    """stdout and wall seconds of one tool run (``main(argv, *args)``),
    which must return 0; its stderr goes to the list ``errors`` if given."""
    import torch
    out, errs = io.StringIO(), io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(errs):
        rc = main(argv, *args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"{main.__module__} {argv} rc={rc}: "
                           f"{errs.getvalue()}")
    if errors is not None:
        errors.append(errs.getvalue())
    return out.getvalue(), wall


def rows_of(out: str):
    return [l.split("\t") for l in out.splitlines()
            if l and not l.startswith("#") and "\t" in l]

# ------------------------------------------------- the exact profile screen

def _residues(rng, n: int):
    """n residues drawn with tools/make_profiles.make_profile's recipe (a
    copy, vectorized): (one-letter code, profile, gap line, SSE line)."""
    states = []
    while len(states) < n:
        states.extend([int(rng.integers(0, 3))] * int(rng.integers(3, 9)))
    states = np.asarray(states[:n])
    rows = np.arange(n)
    olc = rng.integers(0, 20, n)
    prof = rng.dirichlet(np.full(20, 0.3), size=n) * 100.0 * 0.4
    prof[rows, olc] += 60.0
    gap = np.column_stack([rng.uniform(2.0, 6.0, n), rng.uniform(0.1, 0.6, n),
                           rng.uniform(0.0, 1.0, (n, 2))])
    base = rng.dirichlet(np.ones(3), size=n) * 0.3
    base[rows, states] += 0.7
    base /= base.sum(axis=1, keepdims=True)
    sse = np.column_stack([base, rng.uniform(0.3, 0.99, n),
                           rng.uniform(0.0, 1.0, (n, 2))])
    return [(AA[o], " ".join(["%.2f"] * 20) % tuple(p),
             "%.3f %.3f 0.000 0.000 %.3f %.3f" % tuple(g),
             " ".join(["%.3f"] * 6) % tuple(e))
            for o, p, g, e in zip(olc, prof, gap, sse)]


def _profile_text(name: str, rows) -> str:
    lines = [f"ID : {name}", "DE : synthetic", "SR : none", "EVD: 20 6",
             f"LEN: {len(rows)}"]
    for i, (olc, prof, gap, sse) in enumerate(rows, start=1):
        lines += [f"{i:4d} {olc} {prof}", f"   -   {gap}", f"   *   {sse}"]
    return "\n".join(lines + ["//"]) + "\n"


def make_profile_library(d: str, n_lib: int = N_PROF, q_len: int = Q_PROF,
                         t_min: int = TP_MIN, t_max: int = TP_MAX):
    """Query profile + a directory of template profiles from SEED; returns
    (query path, library dir, file names in library order, homolog files).

    Each homolog is the query's residues 20-236 with 30% of those rows
    redrawn, between random flanks of 5-40 residues."""
    rng = np.random.default_rng(SEED)
    qrows = _residues(rng, q_len)
    qfn, lib = os.path.join(d, "query.prof"), os.path.join(d, "lib")
    os.makedirs(lib)
    with open(qfn, "w") as f:
        f.write(_profile_text("query", qrows))
    slots = set(rng.choice(n_lib, N_HOMOLOGS, replace=False).tolist())
    files, homologs = [], []
    for n in range(n_lib):
        if n in slots:
            core = list(qrows[HOM_CORE[0]:HOM_CORE[1]])
            redraw = rng.choice(len(core), int(len(core) * HOM_REDRAW),
                                replace=False)
            for r, row in zip(redraw, _residues(rng, len(redraw))):
                core[r] = row
            rows = (_residues(rng, int(rng.integers(5, 41))) + core
                    + _residues(rng, int(rng.integers(5, 41))))
        else:
            rows = _residues(rng, int(rng.integers(t_min, t_max + 1)))
        fn = os.path.join(lib, f"t{n:04d}.prof")
        with open(fn, "w") as f:
            f.write(_profile_text(f"t{n:04d}", rows))
        files.append(fn)
        if n in slots:
            homologs.append(fn)
    return qfn, lib, files, homologs


def same(a, b) -> bool:
    """Tolerance 0: equal values, NaN at the same places."""
    import torch
    na, nb = torch.isnan(a), torch.isnan(b)
    return (a.shape == b.shape and torch.equal(na, nb)
            and torch.equal(torch.where(na, 0.0, a), torch.where(nb, 0.0, b)))


def same_bits(a, b) -> bool:
    """Tolerance 0 as float32 bits: NaN at the same places, every other
    value equal as int32 (so -0.0 != +0.0: a reordered max shows)."""
    import torch
    na, nb = torch.isnan(a), torch.isnan(b)
    return (a.shape == b.shape and torch.equal(na, nb)
            and torch.equal(torch.where(na, 0.0, a).view(torch.int32),
                            torch.where(nb, 0.0, b).view(torch.int32)))


def k3_work(shapes) -> tuple:
    """K3's bytes and float32 operations on the vector form for buckets of
    (n, q2, t2): S and the four cost vectors read once, one score written;
    a subtract and a max per gap candidate (both kinds, the triangles the
    recurrence scans), six operations per interior cell."""
    nbytes = ops = 0.0
    for n, q2, t2 in shapes:
        ia, ib = q2 - 3, t2 - 3              # interior rows and columns
        nbytes += 4 * n * (q2 * t2 + 4 * t2 + 1)
        ops += n * ia * ib * (ia + ib - 2) + 6 * n * ia * ib
    return nbytes, ops


def random_stack(rng, n, q2, t2) -> np.ndarray:
    """A random similarity stack (n, q2, t2) with zero borders."""
    S = (rng.standard_normal((n, q2, t2)) * 2.0).astype(np.float32)
    S[:, [0, -1], :] = 0.0
    S[:, :, [0, -1]] = 0.0
    return S


def random_dp_inputs(rng, n, q2, t2, dev, *, vec_d: bool):
    """Per-pair K3 data from random numbers, on ``dev``: S with zero
    borders, HMAP-style gap vectors (n, 2, t2) or a Gn2-style full D, A, B
    and a C term."""
    import torch
    S = random_stack(rng, n, q2, t2)
    gi = rng.uniform(0.5, 5.0, (n, t2)).astype(np.float32)
    ge = rng.uniform(0.05, 1.0, (n, t2)).astype(np.float32)
    D = (np.stack([gi, ge], axis=1) if vec_d else
         rng.uniform(0.0, 9.0, (n, t2, t2)).astype(np.float32))
    A = np.minimum(gi, np.roll(gi, 1, axis=1))
    B = np.minimum(ge, np.roll(ge, 1, axis=1))
    C = rng.normal(0.0, 1.0, (n, t2)).astype(np.float32)
    return [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            for x in (S, D, A, B, C)]


def random_dp_tables(ds, rng, n, q2, t2, dev, *, vec_d: bool):
    """K3's table-form inputs from :func:`random_dp_inputs`: the gap
    vectors rebuilt into D on the device (SEMI_LOCAL: zeroed overhangs and
    ins_zero flags), or the full D with the C term."""
    return ds.prepare_tables(*random_dp_inputs(rng, n, q2, t2, dev,
                                               vec_d=vec_d),
                             zero_head=vec_d, zero_tail=vec_d, off=2,
                             has_c=not vec_d, vec_d=vec_d, del_free=vec_d)


def check_profile_kernels(dev, qfn, lib_dir, homologs, cli):
    """Phase 5's kernel checks, all with tolerance 0; returns per-kernel
    (max_abs_err, ms, plain_ms) and extra timings."""
    import torch
    from alignment_algos_tpu_torch.ops import dp_pallas as dpp
    from alignment_algos_tpu_torch.ops import dp_scores as ds
    from alignment_algos_tpu_torch.ops import hmap_device as hd

    err = {"k3": 0.0, "k5": 0.0, "k6": 0.0}
    rng = np.random.default_rng(SEED + 2)

    def k3_vs_plain(tabs, tag):
        for local in (False, True):
            for full_h in (False, True):
                got = ds.dp_general(*tabs, local=local, full_h=full_h)
                want = ds.dp_general_plain(*tabs, local=local, full_h=full_h)
                torch.cuda.synchronize()
                assert same_bits(got, want), f"K3 != plain: {tag} " \
                    f"local={local} full_h={full_h}"
                err["k3"] = max(err["k3"], max_abs(got, want))

    # (2, 802, 770): past the TPU kernels' VMEM cap; the port has no cliff
    for n, q2, t2 in ((1, 3, 3), (3, 9, 7), (9, 13, 21), (1, 40, 33),
                      (3, 31, 60), (2, 802, 770)):
        for vec_d in (True, False):
            k3_vs_plain(random_dp_tables(ds, rng, n, q2, t2, dev,
                                         vec_d=vec_d),
                        f"random {'vec_d' if vec_d else 'full D + C'} "
                        f"{n}x{q2}x{t2}")
    log("K3 equals plain on odd shapes (n = 1, 3, 9) and at 2 x 802 x 770, "
        "vec_d and full D + C, global and local, scores and full H")

    query, templates, files = cli.read_profiles(qfn, lib_dir)
    params = hd.HMAPaliParams()
    ev = hd.HMAPaliEval(params)
    library = hd.DeviceLibrary(templates, ev, device=dev)
    qt = hd.query_tensors(query, dev)
    # full-size buckets: the fullest near 258, the longest, the fullest
    near = min(library.buckets, key=lambda t2: (abs(t2 - 258),
                                                -len(library.buckets[t2]
                                                     ["idx"])))
    longest = max(library.buckets)
    fullest = max(library.buckets, key=lambda t2: len(library.buckets[t2]
                                                      ["idx"]))
    for t2 in dict.fromkeys((near, longest, fullest)):
        b = library.buckets[t2]
        k3_vs_plain(hd.bucket_tables(qt, b, params),
                    f"HMAP bucket {len(b['idx'])}x{query.size()}x{t2}")
        log(f"K3 equals plain on the HMAP bucket t2={t2} "
            f"({len(b['idx'])} pairs, q2={query.size()})")

    # the main path's K3 input: the whole library in one ragged launch, the
    # costs built in the kernel from the gap vectors; the plain version
    # (per bucket, the tables then the row loop) timed on its one run
    buckets = hd.screen_buckets(qt, library, params)
    flags = hd.ragged_flags(params)
    got = ds.dp_general_ragged(buckets, **flags)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    want = ds.dp_general_ragged_plain(buckets, **flags)
    stop.record()
    torch.cuda.synchronize()
    screen_plain_ms = start.elapsed_time(stop)
    assert same_bits(got, want), "K3 != plain on the whole library"
    err["k3"] = max(err["k3"], max_abs(got, want))
    screen_shapes = [tuple(S.shape) for S, *_ in buckets]
    screen_scores, n_pairs = got, len(got)
    log(f"K3 equals plain bit for bit on the whole library in one ragged "
        f"launch ({n_pairs} pairs, {len(buckets)} buckets, t2 "
        f"{min(s[2] for s in screen_shapes)}-"
        f"{max(s[2] for s in screen_shapes)})")

    # the independent engine: dp_ref (numpy / its native build) on 2
    # pairs, a homolog and the longest template
    pair = [files.index(homologs[0]),
            int(np.argmax([t.size() for t in templates]))]
    costs = [ev.build_costs(query, templates[i]) for i in pair]
    for c in costs:
        want = dpp.forward_h_reference([c])
        got = dpp.forward_h_batched([c], device=dev)
        np.testing.assert_array_equal(got, want)
        sc = ds.forward_scores_batch([c], device=dev)
        np.testing.assert_array_equal(sc, want[:, -1, -1])
        err["k3"] = max(err["k3"], float(np.abs(got - want).max()))
    log(f"K3 equals dp_ref on 2 pairs (q2 x t2 = "
        f"{', '.join(f'{c.q_size}x{c.t_size}' for c in costs)})")

    alpha = float(np.float32(params.alpha))
    shift = float(-np.float32(params.zero_shift))
    # K5 as the main path launches it: once over every bucket; the plain
    # version (per bucket) timed on its one run
    q3 = (qt["aa"], qt["zsse"], qt["conf"])
    stacks = [(b["aa"], b["zsse"], b["conf"])
              for b in library.buckets.values()]
    raws = hd.hmap_sim_ragged(*q3, stacks, alpha)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    want = hd.hmap_sim_ragged_plain(*q3, stacks, alpha)
    stop.record()
    torch.cuda.synchronize()
    k5_plain_ms = start.elapsed_time(stop)
    for g, w in zip(raws, want):
        assert same_bits(g, w), f"K5 != plain at {tuple(g.shape)}"
        err["k5"] = max(err["k5"], max_abs(g, w))
    del want
    log(f"K5 equals plain as float32 bits on the whole library in one "
        f"launch ({sum(S.shape[0] for S in raws)} pairs, {len(raws)} "
        f"buckets)")

    # K6 as the main path launches it: once over every bucket's K5 output;
    # the plain version (every chain in one loop) timed on its one run
    def k6_vs_plain(Ss, tag):
        for normalize in (True, False):
            got = hd.hmap_znorm_ragged(Ss, shift, normalize=normalize)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            want = hd.hmap_znorm_ragged_plain(Ss, shift, normalize=normalize)
            stop.record()
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert same_bits(g, w), f"K6 != plain: {tag} " \
                    f"{tuple(g.shape)} normalize={normalize}"
                err["k6"] = max(err["k6"], max_abs(g, w))
            if normalize:
                plain_ms = start.elapsed_time(stop)
        return plain_ms

    k6_plain_ms = k6_vs_plain(raws, "the whole library")
    log(f"K6 equals plain as float32 bits on the whole library in one "
        f"launch ({sum(S.shape[0] for S in raws)} pairs, {len(raws)} "
        f"buckets), normalize on and off")
    edge = [random_stack(rng, *shape) for shape in K6_EDGES]
    edge[3][:, 1, 1] = -0.0
    edge[3][1, 1:-1, 1:-1] = -0.0
    edge[4][:, 1:-1, 1:-1] = np.float32(1.7)
    edge = [torch.from_numpy(x).to(dev) for x in edge]
    k6_vs_plain(edge, "odd shapes")
    for S in edge:
        k6_vs_plain([S], "odd shapes, alone")
    log(f"K6 equals plain as float32 bits on odd shapes {K6_EDGES} (a 1 x 1 "
        f"region, 1 x 698, past 2^17 elements, a first element of -0.0, a "
        f"constant region), together and alone, normalize on and off")

    host_checked = 0
    for t2, b in library.buckets.items():
        S = hd.build_similarity_device(
            qt["aa"], qt["zsse"], qt["conf"], b["aa"], b["zsse"], b["conf"],
            alpha, shift).cpu().numpy()
        for j, idx in enumerate(b["idx"]):
            host = ev.build_costs(query, templates[idx]).S
            assert (S[j].view(np.uint32) == host.view(np.uint32)).all(), \
                f"producer S != host build_costs S for {files[idx]}"
            host_checked += 1
        if host_checked >= 16:
            break
    log(f"K5 + K6 S equals host HMAPaliEval.build_costs S bit for bit on "
        f"{host_checked} templates")

    # times: the whole-screen ragged launch; one full bucket and a 64-pair
    # 258 x 258 batch, each as a ragged launch and in the table form; K5 + K6
    k3_ms = cuda_ms(lambda: ds.dp_general_ragged(buckets, **flags), 5)
    # the launch alone, its descriptors built once (the wrapper's checks
    # and descriptors take a few ms of host time per call)
    scratch = torch.empty((sum(S.numel() for S, *_ in buckets),),
                          dtype=torch.float32, device=dev)
    pairs = ds._ragged_descriptors(buckets, scratch)
    scores = torch.empty((len(pairs),), dtype=torch.float32, device=dev)
    times = {"launch_ms": cuda_ms(lambda: ds._launch(
        pairs, scores, vec=True, local=False, **flags), 5)}
    assert same_bits(scores, screen_scores), \
        "K3 launch alone != the wrapper's"
    b = library.buckets[near]
    one = [bk for bk, t2 in zip(buckets, library.buckets) if t2 == near]
    tabs = hd.bucket_tables(qt, b, params)
    times.update({
        "bucket_ragged_ms": cuda_ms(
            lambda: ds.dp_general_ragged(one, **flags), 5),
        "bucket_table_ms": cuda_ms(lambda: ds.dp_general(*tabs), 5),
        "bucket_plain_ms": cuda_ms(lambda: ds.dp_general_plain(*tabs), 1)})
    # 64 pairs of 258 x 258, SEMI_LOCAL's flags (the screen's)
    S, G, A, B, C = random_dp_inputs(rng, 64, 258, 258, dev, vec_d=True)
    big = [(S, G, A, B, None)]
    big_tabs = ds.prepare_tables(S, G, A, B, C, has_c=False, vec_d=True,
                                 **flags)
    times.update({
        "64x258x258_ragged_ms": cuda_ms(
            lambda: ds.dp_general_ragged(big, **flags), 3),
        "64x258x258_table_ms": cuda_ms(lambda: ds.dp_general(*big_tabs), 3),
        "64x258x258_plain_ms": cuda_ms(
            lambda: ds.dp_general_plain(*big_tabs), 1)})
    # K5: the whole library in one launch, through the wrapper and as the
    # launch alone (its descriptors on the card, made once); the full
    # bucket alone; beside it torch.bmm of the profile dot products at the
    # largest bucket, a yardstick and not the same function (another sum
    # order, and no SSE term, expf or borders), TF32 off
    k5_ms = cuda_ms(lambda: hd.hmap_sim_ragged(*q3, stacks, alpha), 5)
    k5_times = {"screen_launch_ms": k5_launch_ms(q3, stacks, alpha)}
    args = (*q3, b["aa"], b["zsse"], b["conf"], alpha)
    raw = hd.hmap_sim(*args)
    k5_times.update({
        "bucket_ms": cuda_ms(lambda: hd.hmap_sim(*args), 5),
        "bucket_plain_ms": cuda_ms(lambda: hd.hmap_sim_plain(*args), 1)})
    wide = max(library.buckets.values(), key=lambda x: x["aa"].shape[0]
               * x["aa"].shape[1])
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        qa = qt["aa"].expand(wide["aa"].shape[0], -1, -1)
        ta = wide["aa"].transpose(1, 2)
        k5_times["yardstick_bmm_ms"] = cuda_ms(lambda: torch.bmm(qa, ta), 5)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    k5_times["yardstick"] = (
        f"torch.bmm (n, q2, 20) x (n, 20, t2) at the largest bucket "
        f"{wide['aa'].shape[0]}x{query.size()}x{wide['aa'].shape[1]}, "
        f"TF32 off: not the same function (another sum order; no SSE term, "
        f"expf, nan_to_num or borders)")
    # K6: the whole library in one launch and the timed bucket alone,
    # through the wrapper and as the launch alone (its descriptors built
    # once; normalize=False runs the apply pass alone)
    k6_ms = cuda_ms(lambda: hd.hmap_znorm_ragged(raws, shift), 5)
    k6_times = {
        "screen_launch_ms": k6_launch_ms(raws, shift, True),
        "screen_apply_only_launch_ms": k6_launch_ms(raws, shift, False),
        "bucket_ms": cuda_ms(lambda: hd.hmap_znorm(raw, shift), 5),
        "bucket_launch_ms": k6_launch_ms([raw], shift, True),
        "bucket_plain_ms": cuda_ms(lambda: hd.hmap_znorm_plain(raw, shift),
                                   1)}
    shape = f"{len(b['idx'])}x{query.size()}x{near}"
    screen_bound = bound(*k3_work(screen_shapes))
    log(f"K3 whole screen ({n_pairs} pairs, one launch): {k3_ms:.3f} ms "
        f"through the wrapper, {times['launch_ms']:.3f} ms the launch alone, "
        f"bound {screen_bound['bound_ms']:.3f} ms "
        f"({screen_bound['bound_by']}), plain {screen_plain_ms:.3f} ms")
    log(f"K3 on the bucket {shape}: ragged {times['bucket_ragged_ms']:.3f} "
        f"ms, table form {times['bucket_table_ms']:.3f} ms, plain "
        f"{times['bucket_plain_ms']:.3f} ms; on 64x258x258: ragged "
        f"{times['64x258x258_ragged_ms']:.3f} ms, table form "
        f"{times['64x258x258_table_ms']:.3f} ms, plain "
        f"{times['64x258x258_plain_ms']:.3f} ms")
    log(f"K5 whole screen ({n_pairs} pairs, one launch): {k5_ms:.3f} ms "
        f"through the wrapper, {k5_times['screen_launch_ms']:.3f} ms the "
        f"launch alone, plain {k5_plain_ms:.3f} ms; on {shape}: "
        f"{k5_times['bucket_ms']:.3f} ms, plain "
        f"{k5_times['bucket_plain_ms']:.3f} ms; yardstick "
        f"{k5_times['yardstick_bmm_ms']:.3f} ms ({k5_times['yardstick']})")
    log(f"K6 whole screen ({n_pairs} pairs, one launch): {k6_ms:.3f} ms "
        f"through the wrapper, {k6_times['screen_launch_ms']:.3f} ms the "
        f"launch alone (its apply pass alone "
        f"{k6_times['screen_apply_only_launch_ms']:.3f} ms), plain "
        f"{k6_plain_ms:.3f} ms; on {shape}: {k6_times['bucket_ms']:.3f} ms "
        f"through the wrapper, {k6_times['bucket_launch_ms']:.3f} ms the "
        f"launch alone, plain {k6_times['bucket_plain_ms']:.3f} ms")
    return ({"k3": (err["k3"], k3_ms, screen_plain_ms),
             "k5": (err["k5"], k5_ms, k5_plain_ms),
             "k6": (err["k6"], k6_ms, k6_plain_ms)},
            {"bucket": shape, "dims": (len(b["idx"]), query.size(), near),
             "screen_shapes": screen_shapes,
             "screen": f"{n_pairs} pairs in {len(buckets)} buckets, "
                       f"q2={query.size()}",
             "k3_times": times, "k5_times": k5_times, "k6_times": k6_times})


def k5_launch_ms(q3, stacks, alpha: float) -> float:
    """K5's launch alone over ``stacks`` (its plan, the descriptors on the
    card, made once by the wrapper's own steps), mean of 5; its output must
    equal the wrapper's as float32 bits."""
    import torch
    from alignment_algos_tpu_torch.ops import hmap_device as hd

    plan = hd._sim_plan(*q3, stacks)
    ms = cuda_ms(lambda: hd._sim_launch(plan, alpha), 5)
    want = hd.hmap_sim_ragged(*q3, stacks, alpha)
    torch.cuda.synchronize()
    assert all(same_bits(o, w) for o, w in zip(plan.outs, want)), \
        "K5 launch alone != the wrapper's"
    return ms


def k6_launch_ms(Ss, shift: float, normalize: bool) -> float:
    """K6's launch alone over the stacks ``Ss`` (its plan, the descriptors
    on the card, made once by the wrapper's own steps), mean of 5; its
    output must equal the wrapper's as float32 bits."""
    import torch
    from alignment_algos_tpu_torch.ops import hmap_device as hd

    plan = hd._znorm_plan(Ss)
    ms = cuda_ms(lambda: hd._znorm_launch(plan, shift, normalize), 5)
    want = hd.hmap_znorm_ragged(Ss, shift, normalize=normalize)
    torch.cuda.synchronize()
    assert all(same_bits(o, w) for o, w in zip(plan.outs, want)), \
        "K6 launch alone != the wrapper's"
    return ms


def run_profile_screens(cli, d, qfn, lib_dir, files, homologs, card):
    """Phase 5's CLI runs; returns the K3/K5/K6 launch counts of the
    1024-template ``--profiles 1`` run (each set to 0 just before it).  K3
    has two wrappers, the ragged one (the screen's) and the table form's
    (``--smap 1``); its count is their sum."""
    from alignment_algos_tpu_torch.ops import dp_scores as ds
    from alignment_algos_tpu_torch.ops import hmap_device as hd

    def k3_launches():
        return ds.dp_general_ragged.launches + ds.dp_general.launches

    counters = (ds.dp_general_ragged, ds.dp_general, hd.hmap_sim_ragged,
                hd.hmap_znorm_ragged)
    query, templates, _ = cli.read_profiles(qfn, lib_dir)
    q2 = query.size()
    evals = sum(q2 * t.size() * (q2 + t.size()) for t in templates)
    n_buckets = len({t.size() for t in templates})
    for fn in counters:
        fn.launches = 0
    out, wall = run_cli(cli.main, [qfn, lib_dir, "--profiles", "1",
                                   "--top_k", str(TOP_K)])
    launches = {"k3": k3_launches(), "k5": hd.hmap_sim_ragged.launches,
                "k6": hd.hmap_znorm_ragged.launches}
    # one launch each per screen: K3 (the ragged one), K5, K6
    assert (ds.dp_general_ragged.launches, ds.dp_general.launches) == (1, 0), \
        launches
    assert launches["k5"] == 1 and launches["k6"] == 1, launches
    rows = rows_of(out)
    assert len(rows) == TOP_K, out
    assert {r[3] for r in rows[:N_HOMOLOGS]} == set(homologs), rows
    log(f"--profiles 1: {len(templates)} templates, {n_buckets} length "
        f"buckets, wall "
        f"{wall:.3f} s, {evals / wall:.4g} candidate evaluations/s "
        f"({evals} evaluations; K3 +{launches['k3']}, K5 +{launches['k5']}, "
        f"K6 +{launches['k6']} launches) on {card}")
    log("  top hits: " + ", ".join(f"{os.path.basename(r[3])}={r[1]}"
                                  for r in rows))

    # the first N_SAME templates, on the card and on the CPU
    lst = os.path.join(d, "first.txt")
    with open(lst, "w") as f:
        f.write("".join(fn + "\n" for fn in files[:N_SAME]))
    smaps = os.path.join(d, "smaps.txt")
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "data")
    with open(smaps, "w") as f:
        f.write("".join(os.path.join(data, fn) + "\n"
                        for fn in ("templ_smap.prof", "templ_big.prof")))
    for tag, argv in (
            (f"--profiles 1, first {N_SAME}",
             [qfn, lst, "--profiles", "1", "--top_k", str(TOP_K)]),
            ("--smap 1, the SMAP fixtures",
             [os.path.join(data, "query30.prof"), smaps, "--smap", "1",
              "--top_k", "2"])):
        before = k3_launches()
        gpu, gpu_wall = run_cli(cli.main, argv)
        assert k3_launches() > before, f"{tag}: K3 never launched"
        device = os.environ["AAT_TORCH_DEVICE"]
        os.environ["AAT_TORCH_DEVICE"] = "cpu"
        try:
            cpu, cpu_wall = run_cli(cli.main, argv)
        finally:
            os.environ["AAT_TORCH_DEVICE"] = device
        assert gpu == cpu, f"{tag}: CUDA and CPU stdout differ"
        assert len(rows_of(gpu)) >= 2, gpu
        log(f"{tag}: CUDA stdout byte-equal to AAT_TORCH_DEVICE=cpu "
            f"(card {gpu_wall:.3f} s, host CPU {cpu_wall:.3f} s)")
    return launches, {"profiles_wall_s": wall, "candidate_evals": evals,
                      "evals_per_s": evals / wall}


def run_big_template_screen(cli, d, dev, card):
    """``--profiles 1`` past K3's shared-memory cap: a BIG_Q-residue query
    profile against BIG_TEMPLATES (one of 7,300 residues) from the seed.
    K3 scores the buckets it holds in one launch and K7 the long one; the
    run fails on other counts.  Every score, through ``screen_profiles``,
    equals the host ``HMAPaliEval.build_costs`` + ``dp_ref`` as float32
    bits, and the CLI prints those scores in that order.  Returns the
    run's record and (query, templates, those scores) for phase 7."""
    from alignment_algos_tpu_torch.ops import dp_engine as de
    from alignment_algos_tpu_torch.ops import dp_pallas as dpp
    from alignment_algos_tpu_torch.ops import dp_scores as ds
    from alignment_algos_tpu_torch.ops import hmap_device as hd
    from alignment_algos_tpu_torch.parallel.screen import screen_profiles

    rng = np.random.default_rng(SEED + 4)
    qfn, lib = os.path.join(d, "big_query.prof"), os.path.join(d, "big_lib")
    os.makedirs(lib)
    with open(qfn, "w") as f:
        f.write(_profile_text("big_query", _residues(rng, BIG_Q)))
    for n, length in enumerate(BIG_TEMPLATES):
        with open(os.path.join(lib, f"b{n}.prof"), "w") as f:
            f.write(_profile_text(f"b{n}", _residues(rng, length)))
    cap = ds.vec_max_t2(dev)
    assert max(BIG_TEMPLATES) + 2 > cap >= 2 + sorted(BIG_TEMPLATES)[-2], cap
    counters = (ds.dp_general_ragged, ds.dp_general, hd.hmap_sim_ragged,
                hd.hmap_znorm_ragged, de.dp_forward_tb)
    for fn in counters:
        fn.launches = 0
    k = len(BIG_TEMPLATES)
    out, wall = run_cli(cli.main, [qfn, lib, "--profiles", "1", "--top_k",
                                   str(k)])
    got = tuple(fn.launches for fn in counters)
    # K3, K5 and K6 once, K7 for the long bucket
    assert got == (1, 0, 1, 1, 1), got
    query, templates, _ = cli.read_profiles(qfn, lib)
    params = hd.HMAPaliParams()
    ev = hd.HMAPaliEval(params)
    t0 = time.perf_counter()
    want = np.asarray([dpp.forward_h_reference([ev.build_costs(query, t)])
                       [0, -1, -1] for t in templates], np.float32)
    ref_s = time.perf_counter() - t0
    scores, order = screen_profiles(
        query, templates, lambda a, b: hd.HMAPaliEval(params), k=k,
        device=dev)
    assert (scores.view(np.uint32) == want.view(np.uint32)).all(), \
        (scores, want)
    rows = rows_of(out)
    assert [int(r[2]) for r in rows] == list(order), rows
    assert [r[1] for r in rows] == [f"{want[i]:g}" for i in order], rows
    log(f"--profiles 1 past K3's cap (t2 {cap}): a {BIG_Q}-residue query vs "
        f"templates of {BIG_TEMPLATES} residues: wall {wall:.3f} s (K3 "
        f"+{got[0]}, K5 +{got[2]}, K6 +{got[3]}, K7 +{got[4]} launches); "
        f"every score equals dp_ref as float32 bits (host build_costs + "
        f"dp_ref {ref_s:.3f} s) on {card}")
    return {"big_template_wall_s": wall, "big_template_dp_ref_s": ref_s,
            "k3_vec_max_t2": cap}, (query, templates, want)


# -------------------------------------- the exact DP builds behind the tools

def make_nalign_pair(d: str):
    """nalign's query profile and homolog template profile from SEED."""
    rng = np.random.default_rng(SEED + 3)
    qrows = _residues(rng, NA_Q)
    core = list(qrows[NA_CORE[0]:NA_CORE[1]])
    redraw = rng.choice(len(core), int(len(core) * HOM_REDRAW),
                        replace=False)
    for r, row in zip(redraw, _residues(rng, len(redraw))):
        core[r] = row
    trows = (_residues(rng, NA_LEFT) + core
             + _residues(rng, NA_T - NA_LEFT - len(core)))
    paths = []
    for name, rows in (("na_query", qrows), ("na_templ", trows)):
        paths.append(os.path.join(d, f"{name}.prof"))
        with open(paths[-1], "w") as f:
            f.write(_profile_text(name, rows))
    return paths


def k7_costs(de, rng, q2, t2, kind: str):
    """A cost model (``de.DPCosts``) from random data: ``affine`` (D from
    gap vectors with SEMI_LOCAL's free overhangs, ins_zero flags), ``gn2``
    (a full random D, a C term, distance offset 1), ``ties`` (integer S and
    costs) or ``big`` (S near 1e8, where an ulp exceeds the cost
    differences)."""
    f32 = np.float32
    S = (rng.standard_normal((q2, t2)) * 2.0).astype(f32)
    S[[0, -1], :] = 0.0
    S[:, [0, -1]] = 0.0
    gi = rng.uniform(0.5, 5.0, t2).astype(f32)
    ge = rng.uniform(0.05, 1.0, t2).astype(f32)
    dist = np.subtract.outer(np.arange(t2), np.arange(t2)).T     # j - k
    D = (np.minimum.outer(gi, gi) + np.minimum.outer(ge, ge)
         * (dist.astype(f32) - f32(2.0))).astype(f32)
    D[dist < 2] = 0.0
    D[0, :] = 0.0
    D[:, -1] = 0.0
    A, B = np.minimum(gi, np.roll(gi, 1)), np.minimum(ge, np.roll(ge, 1))
    if kind == "gn2":
        D = rng.uniform(0.0, 9.0, (t2, t2)).astype(f32)
        D[dist < 2] = 0.0
        return de.DPCosts(S=S, D=D, A=A, B=B, ins_zero_head_q=False,
                          ins_zero_tail_q=False, ins_dist_offset=1,
                          C=rng.normal(0.0, 1.0, t2).astype(f32))
    if kind == "ties":
        S[1:-1, 1:-1] = rng.integers(-2, 3, (q2 - 2, t2 - 2))
        D, A, B = np.round(D), np.round(A), np.zeros_like(B)
    if kind == "big":
        S[1:-1, 1:-1] = f32(1.0e8) + S[1:-1, 1:-1] * f32(3)
    return de.DPCosts(S=S, D=D, A=A, B=B, ins_zero_head_q=kind == "affine",
                      ins_zero_tail_q=kind == "affine")


def same_results(got, want, tag: str) -> None:
    """H as float32 bits (an int32 view), PQ and PT equal."""
    np.testing.assert_array_equal(got.H.view(np.int32), want.H.view(np.int32),
                                  err_msg=f"{tag}: H bits")
    for name in ("PQ", "PT"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=f"{tag}: {name}")


def nalign_costs(d: str, na_files):
    """The cost model nalign builds for its pair (default HMAP
    parameters)."""
    from alignment_algos_tpu_torch.cli import screen as cli
    from alignment_algos_tpu_torch.ops import hmap_device as hd

    lst = os.path.join(d, "na_templ.txt")
    with open(lst, "w") as f:
        f.write(na_files[1] + "\n")
    query, (templ,), _ = cli.read_profiles(na_files[0], lst)
    return hd.HMAPaliEval(hd.HMAPaliParams()).build_costs(query, templ)


def check_k7(dev, d, na_files, card):
    """Phase 6's kernel checks, all with tolerance 0; returns K7's
    (max_abs_err, ms, plain_ms) and the shape timed."""
    import torch
    from alignment_algos_tpu_torch.core import dp as tdp
    from alignment_algos_tpu_torch.ops import dp_engine as de

    err = 0.0
    rng = np.random.default_rng(SEED + 4)

    def vs_plain(costs, bounds, local, tag):
        nonlocal err
        q0, q1, t0, t1 = bounds
        b = dict(q0=q0, q1=q1, t0=t0, t1=t1, local=local)
        tabs = de.device_tables(costs, q0, q1, t0, t1, device=dev)
        got = de.dp_forward_tb(*tabs, **b)
        want = de.dp_forward_tb_plain(*tabs, **b)
        torch.cuda.synchronize()
        assert same_bits(got[0], want[0]), f"K7 != plain (H bits): {tag}"
        for g, w, name in zip(got[1:], want[1:], ("PQ", "PT")):
            assert torch.equal(g, w), f"K7 != plain ({name}): {tag}"
        err = max(err, max_abs(got[0], want[0]))
        return de.launch_plan(dev, tabs[0].shape[1], tabs[0].shape[2], q0,
                              q1, t0, t1).mode

    modes = set()
    for n, q2, t2, bounds in K7_SHAPES:
        for kind in ("affine", "gn2", "ties", "big"):
            costs = [k7_costs(de, rng, q2, t2, kind) for _ in range(n)]
            for local in (False, True):
                modes.add(vs_plain(costs, bounds or (0, q2 - 1, 0, t2 - 1),
                                   local, f"{kind} {n}x{q2}x{t2} {bounds} "
                                          f"local={local}"))
    assert modes == {"resident", "streamed"}, modes
    log("K7 equals plain (H as float32 bits, PQ, PT) on odd shapes, three "
        "sub-rectangles, 130 x 97 bounded, 386 x 404 and 12 x 7302 "
        "(streamed); affine, gn2 (C term), integer ties and |S| near 1e8; "
        "global and local")

    # the independent engine (dp_ref, numpy / native) on 2 pairs: nalign's
    # HMAP pair and a Gn2-style pair of path B's size; forward global and
    # local, reverse with bug_compat on and off
    na = nalign_costs(d, na_files)
    pairs = (na, k7_costs(de, rng, 182, 224, "gn2"))
    for c in pairs:
        bounds = (0, c.q_size - 1, 0, c.t_size - 1)
        tag = f"{c.q_size}x{c.t_size}"
        for direction, local, bug_compat in (("fwd", False, True),
                                             ("fwd", True, True),
                                             ("rev", False, True),
                                             ("rev", False, False)):
            same_results(
                tdp.build(c, *bounds, direction, local, bug_compat,
                          device=dev),
                tdp.build(c, *bounds, direction, local, bug_compat),
                f"K7 vs dp_ref {tag} {direction} local={local} "
                f"bug_compat={bug_compat}")
    c = k7_costs(de, np.random.default_rng(5), 10, 10, "affine")
    c.S[5, 1] += np.float32(200.0)          # a closing-cell insertion wins
    for bug_compat in (True, False):
        got = tdp.build(c, 0, 9, 0, 9, "rev", False, bug_compat, device=dev)
        same_results(got, tdp.build(c, 0, 9, 0, 9, "rev", False, bug_compat),
                     f"K7 vs dp_ref 10x10 rev bug_compat={bug_compat}")
        assert got.PT[0, 0] == (8 if bug_compat else 1), got.PT[0, 0]
    log(f"K7 equals dp_ref on the pairs "
        f"{', '.join(f'{c.q_size}x{c.t_size}' for c in pairs)} (HMAP, "
        f"Gn2-style): forward global and local, reverse with bug_compat on "
        f"and off")

    # times at path A's pair (HMAP costs) and at path B's size (Gn2-style)
    times, plans = [], []
    for c in pairs:
        q2, t2 = c.q_size, c.t_size
        tabs = de.device_tables([c], 0, q2 - 1, 0, t2 - 1, device=dev)
        b = dict(q0=0, q1=q2 - 1, t0=0, t1=t2 - 1)
        plans.append(de.launch_plan(dev, q2, t2, **b))
        times.append((cuda_ms(lambda: de.dp_forward_tb(*tabs, **b), 20),
                      cuda_ms(lambda: de.dp_forward_tb_plain(*tabs, **b), 2)))
        log(f"K7 {times[-1][0]:.3f} ms vs plain {times[-1][1]:.3f} ms at one "
            f"{q2} x {t2} pair ({plans[-1].mode}, a cluster of "
            f"{plans[-1].cluster} blocks, {plans[-1].smem_bytes} bytes of "
            f"shared memory each) on {card}")
    assert all(p.cluster > 1 for p in plans), plans
    extra = {"shape": f"1x{na.q_size}x{na.t_size}",
             "dims": (1, na.q_size, na.t_size),
             "mode": plans[0].mode, "cluster": plans[0].cluster,
             "ms_1x182x224": times[1][0], "plain_ms_1x182x224": times[1][1],
             "mode_1x182x224": plans[1].mode}
    return (err, *times[0]), extra


def build_split(d, na_files, dev):
    """Seconds of one nalign DP build on the card, split into the host cost
    build and the K7 build (tables, launch, pull)."""
    import torch
    from alignment_algos_tpu_torch.core import dp as tdp

    t0 = time.perf_counter()
    c = nalign_costs(d, na_files)
    t1 = time.perf_counter()
    tdp.build(c, 0, c.q_size - 1, 0, c.t_size - 1, device=dev)
    torch.cuda.synchronize()
    return t1 - t0, time.perf_counter() - t1


@contextlib.contextmanager
def dp_build_timer(tdp):
    """Host seconds spent inside the port's ``DPMatrix`` builds while the
    block runs: ``build`` (the evaluator's cost model plus the engine) and
    ``engine`` (``core.dp.build``: K7's tables, launch and pull, or
    ``dp_ref``).  The rest of a tool's wall is enumeration and output."""
    spent = {"build": 0.0, "engine": 0.0}
    build, engine = tdp.DPMatrix._build, tdp.build

    def timed(fn, key):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[key] += time.perf_counter() - t0
        return run

    tdp.DPMatrix._build, tdp.build = timed(build, "build"), timed(engine,
                                                                 "engine")
    try:
        yield spent
    finally:
        tdp.DPMatrix._build, tdp.build = build, engine


def run_dp_paths(d, na_files, card):
    """Phase 6's tool runs: each on the card with K7's count set to 0 just
    before it, then on the host oracle (``AAT_DP_BACKEND=numpy``), stdout
    byte-equal.  Returns K7's launches summed over the runs and per-run
    records."""
    from alignment_algos_tpu_torch.cli import gn2, nalign, s4_align
    from alignment_algos_tpu_torch.core import dp as tdp
    from alignment_algos_tpu_torch.ops import dp_engine as de

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "data")
    real = [os.path.join(data, "query_real.prof"),
            os.path.join(data, "templ_real.prof")]
    runs = [
        ("A nalign cw", nalign.main, list(na_files), ()),
        ("A nalign -ucw", nalign.main, [*na_files, "-ucw", "--DELTA_RATIO",
                                        "0.05", "--NUM_SUBOPT", "30"], ()),
        ("A nalign -opt", nalign.main, [*na_files, "-opt"], ()),
        ("A nalign -opt local", nalign.main,
         [*na_files, "-opt", "--ALIGN_MODE", "3"], ()),
        ("B gn2 -crcw production", gn2.main,
         real + ["-crcw", *GN2_PRODUCTION, "--OUTPUT_FORMAT", "2"], ()),
        ("B gn2 -opt", gn2.main, real + ["-opt"], ()),
        ("S4_align", s4_align.main,
         [os.path.join(data, "templ_big.prof"),
          os.path.join(data, "query_big.prof"), "--max_returned", "3"],
         (False,)),
    ]
    # host set-up outside the timed runs: the shared enumerators build
    # their native libraries (cw/ucw, SSSS search) at first use
    inputs = os.path.join(data, os.pardir, "golden", "inputs")
    run_cli(nalign.main, [os.path.join(inputs, "qA.prof"),
                          os.path.join(inputs, "tA.prof")])
    run_cli(s4_align.main, [os.path.join(data, "templ_smap.prof"),
                            os.path.join(data, "query30.prof"),
                            "--max_returned", "1"], False)
    tdp.set_backend("auto")
    total, records = 0, []
    for tag, main, argv, extra in runs:
        errors = []
        de.dp_forward_tb.launches = 0
        with dp_build_timer(tdp) as card_s:
            out, wall = run_cli(main, argv, *extra, errors=errors)
        launches = de.dp_forward_tb.launches
        assert launches >= 1, f"{tag}: K7 never launched"
        if "-crcw" in argv:
            rounds = sum(l.startswith("ROUND ")
                         for l in errors[0].splitlines())
            assert launches == 1 + rounds >= 2, (launches, rounds)
        tdp.set_backend("numpy")
        try:
            with dp_build_timer(tdp) as host_s:
                want, host_wall = run_cli(main, argv, *extra)
        finally:
            tdp.set_backend("auto")
        assert out == want, f"{tag}: stdout differs from AAT_DP_BACKEND=numpy"
        assert out.strip(), f"{tag}: empty stdout"
        total += launches
        records.append({"run": tag, "wall_s": wall, "k7_launches": launches,
                        "dp_build_s": card_s["build"],
                        "dp_engine_s": card_s["engine"],
                        "host_oracle_wall_s": host_wall,
                        "host_oracle_dp_build_s": host_s["build"],
                        "host_oracle_dp_engine_s": host_s["engine"],
                        "stdout_bytes": len(out)})
        log(f"{tag}: wall {wall:.3f} s on the card (K7 +{launches} "
            f"launches; DP builds {card_s['build']:.3f} s, of which the "
            f"engine {card_s['engine']:.3f} s), {host_wall:.3f} s on "
            f"AAT_DP_BACKEND=numpy (builds {host_s['build']:.3f} s, engine "
            f"{host_s['engine']:.3f} s); stdout byte-equal ({len(out)} bytes) "
            f"on {card}")
    return total, records


# ------------------------------------------------------- the scale-out layer

def same_np(a, b) -> bool:
    """Equal shapes and values, float32 compared as bits."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float32 or b.dtype == np.float32:
        a = np.ascontiguousarray(a, np.float32).view(np.int32)
        b = np.ascontiguousarray(b, np.float32).view(np.int32)
    return a.shape == b.shape and bool((a == b).all())


def timed(fn):
    """fn's result and its wall seconds, from a synchronize to one."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def run_grid(cli, d, blosum, card) -> tuple:
    """BASELINE config 2: GRID_N sequences of GRID_LEN residues from the
    seed, all against all through ``screen_grid`` on a (1, 1) mesh of the
    card, K1's count set to 0 just before and read just after.  Every row
    equals that query's ``screen_library`` scores (k = every template) and
    its top k ``screen_library_host`` (the plain version on the card,
    ``np.lexsort``); each sequence ranks itself first; a (2, 2) mesh
    naming cuda:0 four times gives the same three arrays.  Returns K1's
    launches and the record."""
    import torch
    from alignment_algos_tpu_torch.ops import swaffine as sw
    from alignment_algos_tpu_torch.parallel import screen as ps

    rng = np.random.default_rng(SEED + 7)
    fa = os.path.join(d, "grid.fa")
    with open(fa, "w") as f:
        f.write("".join(f">g{n:03d}\n"
                        + "".join(AA[i] for i in rng.integers(0, 20, GRID_LEN))
                        + "\n" for n in range(GRID_N)))
    g = cli.read_inputs(fa, fa, blosum)
    codes, table = g.t_codes, g.table
    assert codes.shape == (GRID_N, GRID_LEN), codes.shape
    cuda0 = torch.device("cuda", 0)
    gi, ge = GAPS[0]
    sw.sw_affine_scores.launches = 0
    got, wall = timed(lambda: ps.screen_grid(
        codes, codes, table, gi, ge, k=TOP_K,
        mesh=ps.grid_mesh((1, 1), device=cuda0)))
    k1 = sw.sw_affine_scores.launches
    assert k1 >= 1, "screen_grid never launched K1"
    scores, ts, ti = got
    assert scores.shape == (GRID_N, GRID_N) and ti.shape == (GRID_N, TOP_K)
    assert np.isfinite(scores).all()
    assert (ti[:, 0] == np.arange(GRID_N)).all(), ti[:, 0]
    t0 = time.perf_counter()
    for r in range(GRID_N):
        s, i = ps.screen_library(codes[r], codes, table, gi, ge, k=GRID_N,
                                 device=cuda0)
        row = np.empty(GRID_N, np.float32)
        row[i] = s
        assert same_np(scores[r], row), f"grid row {r} != screen_library"
    one_by_one = time.perf_counter() - t0
    for r in range(GRID_N):
        hs, hi = ps.screen_library_host(codes[r], codes, table, gi, ge,
                                        k=TOP_K, device=cuda0)
        assert same_np(ts[r], hs) and (ti[r] == hi).all(), \
            f"grid row {r}: top k != screen_library_host"
    four = ps.Mesh(np.full((2, 2), cuda0, dtype=object), ("qb", "lib"))
    got4, wall4 = timed(lambda: ps.screen_grid(codes, codes, table, gi, ge,
                                               k=TOP_K, mesh=four))
    assert all(same_np(a, b) for a, b in zip(got, got4)), \
        "the (2, 2) mesh of cuda:0 differs from the (1, 1) mesh"
    # K1's per-lane launch at the grid's shape alone, outside the count
    q, t, tab, gap = sw.to_device(codes, codes, table, gi, ge, cuda0)
    lanes_q = q.repeat_interleave(GRID_N, dim=1).contiguous()
    lanes_t = t.repeat(1, GRID_N).contiguous()
    k1_ms = cuda_ms(lambda: sw.sw_affine_scores(lanes_q, lanes_t, tab, gap),
                    5)
    cells = GRID_N * GRID_N * GRID_LEN * GRID_LEN
    a = table.shape[0]
    bd = bound(4 * (2 * GRID_LEN * GRID_N * GRID_N + a * a + 2
                    + GRID_N * GRID_N), 11 * cells)
    log(f"grid (BASELINE config 2, {GRID_N} x {GRID_N} x {GRID_LEN} x "
        f"{GRID_LEN}, {cells} cells): screen_grid on a (1, 1) mesh "
        f"{wall:.4f} s, {cells / wall:.4g} cells/s (K1 +{k1} launches); "
        f"on a (2, 2) mesh of cuda:0 {wall4:.4f} s; the {GRID_N} queries "
        f"one by one through screen_library (k = {GRID_N}) {one_by_one:.4f} "
        f"s; K1 per-lane launch alone {k1_ms:.4f} ms (bound "
        f"{bd['bound_ms']:.4f} ms by {bd['bound_by']}); every row equals "
        f"screen_library, every top k screen_library_host, on {card}")
    return k1, {"grid_wall_s": wall, "grid_cells": cells,
                "grid_cells_per_s": cells / wall, "grid_k1_launches": k1,
                "grid_2x2_wall_s": wall4, "grid_one_by_one_s": one_by_one,
                "grid_k1_launch_ms": k1_ms,
                "grid_k1_bound_ms": bd["bound_ms"]}


def run_sharded_library(inp, homologs, card) -> tuple:
    """Phase 4's screen (512 x 5120) over a LIB_SHARDS-entry mesh of
    cuda:0 at both gap settings (K1's count set to 0 just before each and
    read just after), bit-equal to the ``mesh=None`` screen, the homologs
    first; then ``launch_local_screen`` at the same size, a gloo group of
    two ranks on the card and a one-process NCCL group, each rank's result
    bit-equal to the one-process screen.  Returns K1's launches and the
    record."""
    import torch
    from alignment_algos_tpu_torch.ops import swaffine as sw
    from alignment_algos_tpu_torch.parallel import screen as ps
    from alignment_algos_tpu_torch.parallel.distributed import (
        launch_local_screen)

    cuda0 = torch.device("cuda", 0)
    q, t, table = inp.q_codes, inp.t_codes, inp.table
    hom = sorted(inp.names.index(h) for h in homologs)
    mesh = ps.Mesh([cuda0] * LIB_SHARDS, ("dp",))
    k1, rec, ref = 0, {}, {}
    for gi, ge in GAPS:
        sw.sw_affine_scores.launches = 0
        (s4, i4), w4 = timed(lambda: ps.screen_library(
            q, t, table, gi, ge, k=TOP_K, mesh=mesh))
        n = sw.sw_affine_scores.launches
        assert n == LIB_SHARDS, f"{LIB_SHARDS} shards, K1 +{n}"
        k1 += n
        (s1, i1), w1 = timed(lambda: ps.screen_library(
            q, t, table, gi, ge, k=TOP_K, device=cuda0))
        assert same_np(s4, s1) and (i4 == i1).all(), \
            f"gaps {gi}/{ge}: the sharded screen differs from one device"
        assert sorted(i4[:N_HOMOLOGS].tolist()) == hom, i4
        ref[(gi, ge)] = (s1, i1)
        rec[f"sharded_{gi}_{ge}"] = {"mesh_wall_s": w4, "one_wall_s": w1}
        log(f"sharded library {N_LIB} x {Q_LEN} at {gi}/{ge}: "
            f"{LIB_SHARDS}-entry mesh of cuda:0 {w4:.4f} s (K1 +{n}), "
            f"mesh=None {w1:.4f} s; bit-equal, homologs 1-{N_HOMOLOGS}, on "
            f"{card}")
    gi, ge = GAPS[0]
    s1, i1 = ref[(gi, ge)]
    for tag, kw in (("gloo, 2 ranks x 1 entry on cuda:0",
                     dict(backend="gloo", num_processes=2,
                          devices_per_process=1)),
                    ("NCCL, 1 rank x 2 entries",
                     dict(num_processes=1, devices_per_process=2))):
        (res, walls), wall = timed(lambda: launch_local_screen(
            q, t, table, gi, ge, TOP_K, timeout=300.0, reps=2,
            return_walls=True, device="cuda", **kw))
        assert len(res) == kw["num_processes"]
        for s, i in res:
            assert same_np(s, s1) and (i == i1).all(), \
                f"{tag}: a rank's result differs from one process"
        rec[f"processes: {tag}"] = {"warm_walls_s": walls,
                                    "launch_wall_s": wall}
        log(f"launch_local_screen ({tag}) at {gi}/{ge}: every rank "
            f"bit-equal to one process; warm screen walls "
            f"{', '.join(f'{w:.4f}' for w in walls)} s, launch {wall:.2f} s "
            f"(rank start-up included) on {card}")
    return k1, rec


def run_sharded_profiles(cli, qfn, files, big, card) -> tuple:
    """``screen_profiles`` over phase 5's first N_SAME templates on a
    PROF_SHARDS-entry mesh of cuda:0 (the host cost build, K3 per shard of
    each bucket; its count set to 0 just before and read just after),
    bit-equal to the ``mesh=None`` screen (the device similarity route);
    then ROADMAP C6, phase 5's past-cap library through the host-build route (an
    ``HMAPaliEval`` subclass): K3 for the buckets it holds, K7 for the
    7,300-residue one, every score equal to host ``build_costs`` +
    ``dp_ref``.  Returns K3's and K7's launches and the record."""
    import torch
    from alignment_algos_tpu_torch.ops import dp_engine as de
    from alignment_algos_tpu_torch.ops import dp_scores as ds
    from alignment_algos_tpu_torch.ops import hmap_device as hd
    from alignment_algos_tpu_torch.parallel import screen as ps

    def k3():
        return ds.dp_general_ragged.launches + ds.dp_general.launches

    cuda0 = torch.device("cuda", 0)
    lst = os.path.join(os.path.dirname(qfn), "first_sharded.txt")
    with open(lst, "w") as f:
        f.write("".join(fn + "\n" for fn in files[:N_SAME]))
    query, templates, _ = cli.read_profiles(qfn, lst)
    params = hd.HMAPaliParams()
    factory = lambda a, b: hd.HMAPaliEval(params)        # noqa: E731
    (want, want_o), w1 = timed(lambda: ps.screen_profiles(
        query, templates, factory, k=TOP_K, device=cuda0))
    ds.dp_general_ragged.launches = ds.dp_general.launches = 0
    mesh = ps.Mesh([cuda0] * PROF_SHARDS, ("dp",))
    (got, got_o), w2 = timed(lambda: ps.screen_profiles(
        query, templates, factory, k=TOP_K, device=cuda0, mesh=mesh))
    n3 = k3()
    buckets = len({t.size() for t in templates})
    assert n3 >= buckets, (n3, buckets)
    assert same_np(got, want) and (np.asarray(got_o) == want_o).all(), \
        "the sharded profile screen differs from the mesh=None screen"
    log(f"sharded profile screen, first {N_SAME} templates ({buckets} "
        f"buckets): {PROF_SHARDS}-entry mesh of cuda:0 (host costs, K3 "
        f"+{n3}) {w2:.3f} s, mesh=None (K5, K6, K3) {w1:.3f} s; bit-equal "
        f"(int32 view) on {card}")

    class Subclass(hd.HMAPaliEval):
        """Takes the host-build route (not exactly HMAPaliEval)."""

    bq, bt, bwant = big
    counters = (ds.dp_general_ragged, ds.dp_general, de.dp_forward_tb)
    for fn in counters:
        fn.launches = 0
    (scores, _), wc = timed(lambda: ps.screen_profiles(
        bq, bt, lambda a, b: Subclass(params), k=len(bt), device=cuda0))
    n_big = tuple(fn.launches for fn in counters)
    # one K3 launch per bucket under the cap: every length but 7,300
    short = len(set(BIG_TEMPLATES)) - 1
    assert n_big == (short, 0, 1), n_big
    assert same_np(scores, bwant), (scores, bwant)
    log(f"ROADMAP C6, the host-build route past K3's cap ({BIG_TEMPLATES}): K3 "
        f"+{n_big[0]} (one per bucket it holds), K7 +{n_big[2]} for the "
        f"long bucket, {wc:.3f} s; every score equals dp_ref as float32 "
        f"bits, on {card}")
    return n3 + n_big[0], n_big[2], {
        "profiles_sharded_wall_s": w2, "profiles_one_wall_s": w1,
        "profiles_sharded_k3_launches": n3, "c6_wall_s": wc,
        "c6_k3_k7_launches": [n_big[0], n_big[2]]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from alignment_algos_tpu_torch.cli import screen as cli
    from alignment_algos_tpu_torch.ops import _build, expf
    from alignment_algos_tpu_torch.ops import swaffine as sw

    os.environ["AAT_TORCH_DEVICE"] = "cuda"
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card} | torch.cuda.get_device_name(0) = {kind} | "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    built = _build.load()
    log(f"build: nvcc {built.seconds:.2f} s -> {built.path}")
    for line in built.log.splitlines():
        if any(w in line for w in ("registers", "spill", "smem", "Compiling")):
            log("  " + line.strip())
    # the profile path's host code (gap vectors, the plain expf) must call
    # glibc's expf; without its library the shared code uses np.exp
    assert expf.host_libm_loaded(), "host libm expf library did not load"
    log("host libm expf loaded (alignment_algos_tpu_torch.native)")

    blosum = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "data", "BLOSUM62")
    with tempfile.TemporaryDirectory() as d:
        qfa, lfa, homologs = make_fastas(d)
        inp = cli.read_inputs(qfa, lfa, blosum)
        q, t, table, pad = inp.q_codes, inp.t_codes, inp.table, inp.pad_code
        assert t.shape == (N_LIB, T_MAX), t.shape
        timing, k8_reads, k8_extra = check_kernels(sw, q, t, table, pad,
                                                   dev)
        timing["layout"], layout_library_ms = time_layout(sw, t, dev)
        layout_bytes = 2 * 4 * t.size   # each element read once, written once

        # host set-up outside the timed runs: the alignment-distance code
        # builds its native library at first use
        wq, wl = os.path.join(d, "warm_q.fa"), os.path.join(d, "warm_l.fa")
        with open(wq, "w") as f:
            f.write(">q\nHEAGAWGHEEHEAGAWGHEE\n")
        with open(wl, "w") as f:
            f.write(">a\nHEAGAWGHEEHEAGAWGHEE\n>b\nPAWHEAEPAWHEAEPAW\n")
        run_cli(cli.main, [wq, wl, "--SUB_MATRIX", blosum, "--top_k", "2"])

        cells = Q_LEN * T_MAX * N_LIB
        base = [qfa, lfa, "--SUB_MATRIX", blosum, "--top_k", str(TOP_K)]
        runs = {
            "a (default gaps 4.73/0.34)": base,
            "b (--gap_init 11 --gap_extn 1)": base + ["--gap_init", "11",
                                                     "--gap_extn", "1"],
            "c (a with --ckpt, --chunk_size 1024)": base + [
                "--ckpt", os.path.join(d, "state.npz"),
                "--chunk_size", str(CHUNK)],
        }
        # the transpose: the library's codes (one launch a checkpoint
        # chunk) and the hits' queries and templates for K2
        layouts = dict(zip(runs, (3, 3, -(-N_LIB // CHUNK) + 2)))
        counters = (sw.sw_affine_scores, sw.sw_affine_tb, sw.sw_decode,
                    sw.transpose_codes)
        for fn in counters:
            fn.launches = 0
        outs = {}
        for name, argv in runs.items():
            before = [fn.launches for fn in counters]
            out, wall = run_cli(cli.main, argv)
            after = [fn.launches for fn in counters]
            assert all(a > b for a, b in zip(after, before)), \
                f"run {name}: kernel launches {before} -> {after}"
            assert after[3] - before[3] == layouts[name], \
                f"run {name}: transpose launches {before[3]} -> {after[3]}"
            rows = rows_of(out)
            assert len(rows) == TOP_K, out
            assert {r[3] for r in rows[:N_HOMOLOGS]} == set(homologs), rows
            clusters = [l for l in out.splitlines()
                        if l.startswith("cluster ")]
            assert any(all(h in l for h in homologs) for l in clusters), \
                clusters
            outs[name] = out
            log(f"run {name}: wall {wall:.3f} s, {cells / wall:.4g} cells/s "
                f"({cells} cells; K1 +{after[0] - before[0]}, "
                f"K2 +{after[1] - before[1]}, K8 +{after[2] - before[2]}, "
                f"transpose +{after[3] - before[3]} launches) on {card}")
            log("  top hits: " + ", ".join(f"{r[3]}={r[1]}" for r in rows))
        a, c = list(outs.values())[0], list(outs.values())[2]
        assert rows_of(a) == rows_of(c), "checkpointed run differs from (a)"
        launches = dict(zip(("k1", "k2", "k8", "layout"),
                            (fn.launches for fn in counters)))

        # phase 5: the exact profile screen
        t0 = time.perf_counter()
        qfn, lib_dir, files, hom_files = make_profile_library(d)
        log(f"profiles: 1 query ({Q_PROF} residues) + {N_PROF} templates "
            f"({TP_MIN}-{TP_MAX} residues, {N_HOMOLOGS} homologs) written in "
            f"{time.perf_counter() - t0:.2f} s")
        prof_timing, prof_extra = check_profile_kernels(dev, qfn, lib_dir,
                                                        hom_files, cli)
        timing.update(prof_timing)
        prof_launches, prof_run = run_profile_screens(
            cli, d, qfn, lib_dir, files, hom_files, card)
        launches.update(prof_launches)
        big_run, big = run_big_template_screen(cli, d, dev, card)
        prof_run.update(big_run)

        # phase 6: the exact DP builds behind the alignment tools
        na_files = make_nalign_pair(d)
        timing["k7"], k7_extra = check_k7(dev, d, na_files, card)
        costs_s, k7_build_s = build_split(d, na_files, dev)
        log(f"nalign DP build at {k7_extra['shape']}: host costs "
            f"{costs_s:.3f} s, K7 build (tables, launch, pull) "
            f"{k7_build_s:.3f} s on {card}")
        launches["k7"], dp_runs = run_dp_paths(d, na_files, card)

        # phase 7: the scale-out layer
        t7 = time.perf_counter()
        k1_grid, scale_out = run_grid(cli, d, blosum, card)
        k1_lib, rec = run_sharded_library(inp, homologs, card)
        scale_out.update(rec)
        k3_prof, k7_prof, rec = run_sharded_profiles(cli, qfn, files, big,
                                                     card)
        scale_out.update(rec)
        launches["k1"] += k1_grid + k1_lib
        launches["k3"] += k3_prof
        launches["k7"] += k7_prof
        scale_out["phase_s"] = time.perf_counter() - t7
        log(f"phase 7 (the scale-out layer): {scale_out['phase_s']:.1f} s")
    assert "jax" not in sys.modules, "the port imported jax"
    ref = sorted(m for m in sys.modules if m == "alignment_algos_tpu"
                 or m.startswith("alignment_algos_tpu."))
    assert not ref, f"the port loaded the JAX package: {ref}"
    log("no module of jax or of the JAX package (alignment_algos_tpu) was "
        "loaded")

    for k, (e, ms, pms) in timing.items():
        log(f"{k}: kernel {ms:.3f} ms, plain {pms:.3f} ms, max_abs_err {e} "
            f"on {card}")
    # each kernel's bound at the shape it was timed at; no single PyTorch
    # call computes any of these functions (dependent DP recurrences, a
    # serial chain the parity contract fixes, a traceback walk), so
    # library_ms is null; the layout's is x.t().contiguous() (time_layout)
    a = table.shape[0]
    cells = Q_LEN * T_MAX * N_LIB
    k1_bound = bound(4 * (Q_LEN + T_MAX * N_LIB + a * a + 2 + N_LIB),
                     11 * cells)
    cells = Q_LEN * T_MAX * TOP_K
    k2_bound = bound(4 * (Q_LEN * TOP_K + T_MAX * TOP_K + a * a + 2)
                     + (Q_LEN + T_MAX - 1) * Q_LEN * TOP_K
                     + 8 * Q_LEN * TOP_K, 16 * cells)
    # K3: the main path's launch, the whole library
    k3_bound = bound(*k3_work(prof_extra["screen_shapes"]))
    # K5: the main path's launch, the whole library: the query's and each
    # template's rows read once, S written once; per interior cell 23
    # multiply-adds, the division, three multiplies and the float64 expf
    shapes = prof_extra["screen_shapes"]
    ka, ks = 20, 3                           # profile and SSE widths
    inner = sum(n * (q2 - 2) * (t2 - 2) for n, q2, t2 in shapes)
    q2 = shapes[0][1]
    k5_bound = bound(4 * (q2 * (ka + ks + 1)
                          + sum(n * t2 * (ka + ks + 1) + n * q2 * t2
                                for n, _, t2 in shapes)),
                     (2 * ka + 2 * ks + 5) * inner, 10 * inner)
    # K6: the main path's launch, the whole library: each pair's region
    # read once (nothing else of S is needed), the output written once; a
    # multiply and two adds per region element (stats), a subtract, a
    # divide and an add (apply).  Its chain floor, worked out from the
    # shapes (the longest region's adds at an assumed 4 cycles each), is
    # logged and not a field of the kernels line
    inner6 = sum(n * (q2 - 2) * (t2 - 2) for n, q2, t2 in shapes)
    k6_bound = bound(4 * (inner6 + sum(n * q2 * t2 for n, q2, t2 in shapes)),
                     6 * inner6)
    k6_chain_ms = 4 * max((q2 - 2) * (t2 - 2) for _, q2, t2 in shapes) \
        / k6_bound["sm_clock_hz"] * 1e3
    log(f"k6: chain floor {k6_chain_ms:.6f} ms, worked out from the shapes "
        f"(the longest region, an assumed 4 cycles an add), not measured")
    n, q2, t2 = k7_extra["dims"]
    ia, ib = q2 - 3, t2 - 3
    cand = n * ia * ib * (ia + ib - 2) / 2
    k7_bound = bound(4 * n * (2 * q2 * t2 + t2 * t2 + 2 * q2)
                     + 12 * n * q2 * t2, 3 * cand + 4 * n * ia * ib)
    log(f"k7: chain floor {ia * K7_ROW_US[0] / 1e3:.6f}-"
        f"{ia * K7_ROW_US[1] / 1e3:.6f} ms at {k7_extra['shape']}, worked out "
        f"({ia} rows at an assumed {K7_ROW_US[0]}-{K7_ROW_US[1]} us per "
        f"cluster barrier and distributed-shared push), not measured")
    # K8: the codes the walks read, m[:Q] and one dat entry per lane, the
    # scores and the records; its first-maximum scan compares Q x B floats
    steps = Q_LEN + T_MAX + 2
    k8_bound = bound(k8_reads + 4 * (Q_LEN * TOP_K + TOP_K) + 4 * TOP_K
                     + 8 * steps * TOP_K, Q_LEN * TOP_K)
    layout_bound = bound(layout_bytes, 0)
    bounds = {"k1": k1_bound, "k2": k2_bound, "k3": k3_bound,
              "k5": k5_bound, "k6": k6_bound, "k7": k7_bound,
              "k8": k8_bound, "layout": layout_bound}
    for k, bd in bounds.items():
        log(f"{k}: bound {bd['bound_ms']:.6f} ms by {bd['bound_by']} "
            f"({bd['bytes']:.4g} bytes, {bd['ops_f32']:.4g} float32 and "
            f"{bd['ops_f64']:.4g} float64 operations, {bd['sms']} SMs at "
            f"{bd['sm_clock_hz'] / 1e6:.0f} MHz)")

    def row(k):
        bd = bounds[k]
        return {"launches": launches[k], "max_abs_err": timing[k][0],
                "ms": timing[k][1], "plain_ms": timing[k][2],
                "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"],
                "library_ms": None}

    kernels = [
        {"name": "sw_scores_kernel (K1)", "route": "cuda", "source": K1_SRC,
         "replaces": "alignment_algos_tpu/ops/swscan.py:66",
         "also_replaces": ["alignment_algos_tpu/ops/swstrip.py:49",
                           "alignment_algos_tpu/ops/swaffine.py:56"],
         **row("k1"), "shape": f"{Q_LEN}x{T_MAX}x{N_LIB}"},
        {"name": "sw_tb_kernel (K2)", "route": "cuda", "source": K2_SRC,
         "replaces": "alignment_algos_tpu/ops/swaffine.py:178",
         **row("k2"), "shape": f"{Q_LEN}x{T_MAX}x{TOP_K}"},
        {"name": "dp_general_kernel (K3)", "route": "cuda", "source": K3_SRC,
         "replaces": "alignment_algos_tpu/ops/dp_scores.py:62",
         "also_replaces": ["alignment_algos_tpu/ops/dp_pallas.py:67"],
         **row("k3"), "shape": prof_extra["screen"],
         "bucket": prof_extra["bucket"], **prof_extra["k3_times"]},
        {"name": "hmap_sim_kernel (K5)", "route": "cuda", "source": K56_SRC,
         "replaces": "alignment_algos_tpu/ops/hmap_device.py:137",
         **row("k5"), "shape": prof_extra["screen"],
         "bucket": prof_extra["bucket"], **prof_extra["k5_times"]},
        {"name": "hmap_znorm_kernel (K6)", "route": "cuda", "source": K56_SRC,
         "replaces": "alignment_algos_tpu/ops/hmap_device.py:172",
         **row("k6"), "shape": prof_extra["screen"],
         "bucket": prof_extra["bucket"],
         **prof_extra["k6_times"]},
        {"name": "dp_tb_kernel (K7)", "route": "cuda", "source": K7_SRC,
         "replaces": "alignment_algos_tpu/ops/dp_engine.py:37",
         "also_replaces": ["alignment_algos_tpu/ops/dp_engine.py:210"],
         **row("k7"), **k7_extra},
        {"name": "sw_decode_kernel (K8)", "route": "cuda", "source": K8_SRC,
         "replaces": "alignment_algos_tpu/ops/swaffine.py:387",
         **row("k8"), "shape": f"{Q_LEN}x{T_MAX}x{TOP_K}",
         "walk_reads": k8_reads, **k8_extra},
        {"name": "transpose_i32_kernel (layout)", "route": "cuda",
         "source": LAYOUT_SRC, "replaces": None,
         **row("layout"), "library_ms": layout_library_ms,
         "shape": f"{N_LIB}x{T_MAX}"},
    ]
    log(json.dumps({"profiles_run": prof_run}))
    log(json.dumps({"dp_runs": dp_runs, "nalign_build_split_s": {
        "host_costs": costs_s, "k7_build": k7_build_s}}))
    log(json.dumps({"scale_out": scale_out}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
