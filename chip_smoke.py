#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit; exits non-zero without a card.
2. Builds the port's kernels (alignment_algos_tpu_torch/ops/csrc) with nvcc
   and prints the build time and ptxas's register/shared-memory/spill lines.
3. Holds each kernel against its plain PyTorch version on the card with
   ``torch.equal`` (tolerance 0): small odd shapes, K1 at 512 x 5120 lanes,
   K2 at 512 x 512 x 10, at gaps 4.73/0.34 and 11/1; K1 also against the
   numpy Gotoh oracle on 2 lanes, and ``screen_library``'s top-k through K1
   against ``screen_library_host`` (plain version on the card, ranked by
   ``np.lexsort``).
4. Drives the main path, ``aat_screen`` (the port's ``cli/screen.py``), at a
   deployment's size: one 512-residue query against 5120 templates of
   64-512 residues padded to 512 with the pad wall (1.34e9 cells per
   screen), generated from a seed with 8 planted homologs.  A small run of
   the same CLI first builds the host code's native libraries, outside the
   timed runs and the launch counts.  Runs (a) default
   gaps, (b) --gap_init 11 --gap_extn 1, (c) (a) with --ckpt and
   --chunk_size 1024; checks the homologs rank 1-8 and share a cluster,
   (c) equals (a), both kernels launched in every run, and JAX never
   imported.
5. Prints the kernels' JSON line, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.

Any failed phase ends the run with a non-zero exit code.
"""

from __future__ import annotations

import contextlib
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
K1_SRC = K2_SRC = "alignment_algos_tpu_torch/ops/csrc/sw_gotoh.cu"


def log(*a):
    print(*a, flush=True)


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
    (max_abs_err, ms, plain_ms)."""
    import torch
    from alignment_algos_tpu_torch.parallel import screen as ps
    err = {"k1": 0.0, "k2": 0.0}

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

        qd, td, tab, gap = sw.to_device(q, t, table, gi, ge, dev)
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
        k2_vs_plain(*k2_args)
        log(f"K2 equals plain at {Q_LEN} x {t.shape[1]} x {TOP_K}, "
            f"gaps {gi}/{ge}")

        # the numpy oracle, in float32 throughout, on 2 lanes
        lanes = [0, int(np.argmax((t != pad).sum(axis=1)))]
        s = table[q[None, :, None], t[lanes][:, None, :]]
        want = sw.sw_affine_reference(s, np.float32(gi), np.float32(ge))
        got = sw.sw_affine_scores(qd, td[:, lanes].contiguous(), tab, gap)
        np.testing.assert_array_equal(got.cpu().numpy(), want)
        err["k1"] = max(err["k1"], float(np.abs(got.cpu().numpy()
                                                - want).max()))
        log(f"K1 equals the numpy oracle on lanes {lanes}, gaps {gi}/{ge}")

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
    return {"k1": (err["k1"], k1_ms, k1_plain_ms),
            "k2": (err["k2"], k2_ms, k2_plain_ms)}


def run_cli(main, argv):
    import torch
    out, errs = io.StringIO(), io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(errs):
        rc = main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"aat_screen {argv} rc={rc}: {errs.getvalue()}")
    return out.getvalue(), wall


def rows_of(out: str):
    return [l.split("\t") for l in out.splitlines()
            if l and not l.startswith("#") and "\t" in l]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from alignment_algos_tpu_torch.cli import screen as cli
    from alignment_algos_tpu_torch.ops import _build
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

    blosum = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "data", "BLOSUM62")
    with tempfile.TemporaryDirectory() as d:
        qfa, lfa, homologs = make_fastas(d)
        inp = cli.read_inputs(qfa, lfa, blosum)
        q, t, table, pad = inp.q_codes, inp.t_codes, inp.table, inp.pad_code
        assert t.shape == (N_LIB, T_MAX), t.shape
        timing = check_kernels(sw, q, t, table, pad, dev)

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
        sw.sw_affine_scores.launches = 0
        sw.sw_affine_tb.launches = 0
        outs = {}
        for name, argv in runs.items():
            before = (sw.sw_affine_scores.launches, sw.sw_affine_tb.launches)
            out, wall = run_cli(cli.main, argv)
            after = (sw.sw_affine_scores.launches, sw.sw_affine_tb.launches)
            assert after[0] > before[0] and after[1] > before[1], \
                f"run {name}: kernel launches {before} -> {after}"
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
                f"K2 +{after[1] - before[1]} launches) on {card}")
            log("  top hits: " + ", ".join(f"{r[3]}={r[1]}" for r in rows))
        a, c = list(outs.values())[0], list(outs.values())[2]
        assert rows_of(a) == rows_of(c), "checkpointed run differs from (a)"
        launches = {"k1": sw.sw_affine_scores.launches,
                    "k2": sw.sw_affine_tb.launches}
    assert "jax" not in sys.modules, "the port imported jax"

    for k, (e, ms, pms) in timing.items():
        log(f"{k}: kernel {ms:.3f} ms, plain {pms:.3f} ms, max_abs_err {e} "
            f"on {card}")
    kernels = [
        {"name": "sw_scores_kernel (K1)", "route": "cuda", "source": K1_SRC,
         "replaces": "alignment_algos_tpu/ops/swscan.py:66",
         "also_replaces": ["alignment_algos_tpu/ops/swstrip.py:49",
                           "alignment_algos_tpu/ops/swaffine.py:56"],
         "launches": launches["k1"], "max_abs_err": timing["k1"][0],
         "ms": timing["k1"][1], "plain_ms": timing["k1"][2]},
        {"name": "sw_tb_kernel (K2)", "route": "cuda", "source": K2_SRC,
         "replaces": "alignment_algos_tpu/ops/swaffine.py:178",
         "launches": launches["k2"], "max_abs_err": timing["k2"][0],
         "ms": timing["k2"][1], "plain_ms": timing["k2"][2]},
    ]
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
