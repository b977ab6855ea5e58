#!/usr/bin/env python3
"""K1, K2, K8 and the decode at the FASTA main path's shapes on one NVIDIA
GPU.

    python3 tools/torch_sw_bench.py [--root DIR] [--reps 5] [--layout B T]

CUDA-event times (mean of ``--reps`` launches after a warm-up) of
``sw_affine_scores`` (K1) on one 512-residue query against 5120 templates
padded to 512, and of ``sw_affine_tb`` (K2) on the top 10 of them, at the
gaps 4.73/0.34 and 11/1, on ``chip_smoke.py``'s seeded library: through
the wrappers as the main path calls them (``k1_ms``, ``k2_ms``: input
checks with one host sync, output allocation, launch) and the launch alone
on preallocated outputs (``k1_kernel_ms``, ``k2_kernel_ms``); and the
decode of K2's codes into paths, ``decode_local_tracebacks_device`` with
its pull and host path extraction (``decode_ms``), which any version of
the port has, so that two versions' decodes compare; and K8 alone
(``sw_decode`` through its wrapper, in the checkout's default mode) on
K2's codes of 10 lanes (``k8_ms``) and of 1024 (``k8_1024_ms``,
``--top_k 1024``), and its launch alone on preallocated outputs
(``k8_kernel_ms``, ``k8_1024_kernel_ms``); where the checkout has
``swaffine.k8_plan``, also each of K8's modes, the launch alone, at 10,
64, 256, 512, 1024 and 2048 lanes beside the plan's choice
(``k8_modes_ms``),
each of the 10 lanes' walk steps and windows (``k8_walks``, replayed on
the host by ``chip_smoke.k8_walks``), and the windowed mode's launch
alone on steered walks of known steps and windows (``k8_steered``), which
split its time into a cost a step and a cost a window.

``layout`` times the library's copy and layout on seeded (B, T) int32
codes (``--layout``, default 71,200 x 4,132, the FASTA cells' padded
library, 1.18 GB; ``--layout 0 0`` skips it): ``to_device_s``, host
seconds of three ``to_device`` calls, each ending in a synchronize, and
``peak_bytes`` over one, in any version of the port; where the checkout has
``swaffine.transpose_codes``, ``kernel_ms``, the launch of
``transpose_i32_kernel`` alone on a preallocated output, beside
``library_ms``, PyTorch's ``x.t().contiguous()`` on the card (a
yardstick), and ``bound_ms``, each element read once and written once at
3.35 TB/s.

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

WIDE = 1024                # K8's second shape: --top_k 1024 lanes
SWEEP = (10, 64, 256, 512, 1024, 2048)  # lanes at which K8's modes are timed
# steered walks of K8's windowed mode: (kind, start row = start column);
# every lane of 10 walks the same cells (see k8_steered)
STEERED = (("diag", 511), ("diag", 255), ("e", 511), ("f", 511))


def k8_launch(sw, _build, tb, m, dat, dec: dict, plan=None):
    """K8's launch alone on preallocated outputs (a ctypes call, no checks
    or allocation), in ``plan``'s mode where the checkout's launcher takes
    one (default: the checkout's ``k8_plan``); checked once to return 0."""
    import torch
    lib = _build.load().lib
    b = dec["b"]
    scores = torch.empty((b,), dtype=torch.float32, device=tb.device)
    rec = torch.empty((2, dec["q"] + dec["t"] + 2, b), dtype=torch.int32,
                      device=tb.device)
    extra = ()
    if len(_build.SIGNATURES["sw_decode_launch"]) == 17:
        plan = plan or sw.k8_plan(dec["q"], dec["t"], b, *tb.shape)
        extra = (int(plan.mode == "windowed"), plan.dw, plan.iw)

    def launch():
        return lib.sw_decode_launch(
            tb.data_ptr(), m.data_ptr(), dat.data_ptr(), scores.data_ptr(),
            rec[0].data_ptr(), rec[1].data_ptr(), dec["q"], dec["t"], b,
            *tb.shape, m.shape[1], *extra,
            torch.cuda.current_stream().cuda_stream)

    assert launch() == 0
    return launch


def k8_steered(kind: str, start: int, q: int, t: int, b: int, dev):
    """Inputs that steer every walk from (start, start): ``diag`` all
    matches (d falls 2 a step, i 1: a 64 x 32 window each 32 steps),
    ``e`` an E gap never closed (d falls 1: a window each 64 steps), ``f``
    an F gap (d and i fall 1: a window each 32 steps)."""
    import torch
    code = {"diag": 1, "e": 2 | 4, "f": 3 | 8}[kind]
    tb = torch.full((q + t - 1, q, b), code, dtype=torch.int8, device=dev)
    m = torch.ones((q, b), device=dev)
    m[start] = 2.0
    dat = torch.zeros((q, b), dtype=torch.int32, device=dev)
    dat[start] = 2 * start
    return tb, m, dat


def time_layout(sw, _build, cs, dev, b: int, t: int, reps: int) -> dict:
    """``to_device`` of seeded (b, t) codes and, where the checkout has it,
    the transpose kernel alone beside ``x.t().contiguous()``."""
    import time
    import numpy as np
    import torch
    codes = np.random.default_rng(b * t).integers(0, 21, (b, t),
                                                  dtype=np.int32)
    q, table = np.zeros(64, np.int32), np.zeros((21, 21), np.float32)
    res = {"shape_b_t": [b, t], "to_device_s": []}
    for _ in range(3):
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        td = sw.to_device(q, codes, table, 12.0, 1.0, dev)[1]
        torch.cuda.synchronize()
        res["to_device_s"].append(time.perf_counter() - t0)
        res["peak_bytes"] = torch.cuda.max_memory_allocated() - base
        res["equal"] = bool(np.array_equal(td.cpu().numpy(), codes.T))
        del td
    src = torch.from_numpy(codes).to(dev)
    res["library_ms"] = cs.cuda_ms(lambda: src.t().contiguous(), reps)
    res["bound_ms"] = 8 * b * t / cs.HBM_BYTES_PER_S * 1e3
    if hasattr(sw, "transpose_codes"):
        out = torch.empty((t, b), dtype=torch.int32, device=dev)
        lib = _build.load().lib
        stream = torch.cuda.current_stream().cuda_stream
        res["kernel_ms"] = cs.cuda_ms(lambda: lib.transpose_i32_launch(
            src.data_ptr(), out.data_ptr(), b, t, stream), reps)
        res["kernel_equal"] = bool(torch.equal(out, src.t()))
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--layout", type=int, nargs=2, default=(71200, 4132),
                    metavar=("B", "T"))
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
           "decode_ms": {}, "k8_ms": {}, "k8_1024_ms": {}, "k8_modes_ms": {}}
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
        res["k8_modes_ms"][key] = {}
        for b in SWEEP:
            tb, m, dat = sw.sw_affine_tb(*sw.to_device(
                np.broadcast_to(q, (b, len(q))), t[:b], table, gi, ge, dev))
            dec = dict(q=len(q), t=t.shape[1], b=b)
            name = {cs.TOP_K: "k8", WIDE: "k8_1024"}.get(b)
            if name:
                res[f"{name}_ms"][key] = cs.cuda_ms(
                    lambda: sw.sw_decode(tb, m, dat, **dec), args.reps)
                res.setdefault(f"{name}_kernel_ms", {})[key] = cs.cuda_ms(
                    k8_launch(sw, _build, tb, m, dat, dec), args.reps)
            if hasattr(sw, "k8_plan"):
                shape = (len(q), t.shape[1], b, *tb.shape)
                res["k8_modes_ms"][key][b] = {"plan": sw.k8_plan(*shape).mode}
                if b == cs.TOP_K:
                    res.setdefault("k8_walks", {})[key] = cs.k8_walks(
                        tb, m, dat, len(q), b, *sw.K8_WINDOW)
                for mode in ("windowed", "lane"):
                    res["k8_modes_ms"][key][b][mode] = cs.cuda_ms(
                        k8_launch(sw, _build, tb, m, dat, dec,
                                  sw.k8_plan(*shape, mode=mode)), args.reps)
            del tb, m, dat
    if hasattr(sw, "k8_plan"):
        res["k8_steered"] = {}
        q_, t_ = len(q), t.shape[1]
        for kind, start in STEERED:
            tb, m, dat = k8_steered(kind, start, q_, t_, cs.TOP_K, dev)
            dec = dict(q=q_, t=t_, b=cs.TOP_K)
            walks = cs.k8_walks(tb, m, dat, q_, 1, *sw.K8_WINDOW)
            res["k8_steered"][f"{kind}_{start}"] = {
                "steps": walks["steps"][0], "windows": walks["windows"][0],
                "ms": cs.cuda_ms(k8_launch(sw, _build, tb, m, dat, dec),
                                 args.reps)}
    res["k1_shape_q_t_b"] = [len(q), *td.shape]
    res["k2_shape_q_t_b"] = [len(q), *th.shape]
    del qd, td, qh, th, outs
    if min(args.layout) > 0:
        res["layout"] = time_layout(sw, _build, cs, dev, *args.layout,
                                    args.reps)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
