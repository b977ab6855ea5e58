"""One ``aat_screen`` run under ``AAT_TRACE_DIR``, read in its Chrome trace
by the program's ``aat.`` ranges.

    python3 tools/torch_span_trace.py [--out DIR] -- QUERY LIBRARY [ARGS...]

runs the port's ``aat_screen`` with the arguments after ``--`` on the card
in a fresh process once to build and warm up, then once more with
``AAT_TRACE_DIR`` (``--out``, else a temporary directory), and prints one
JSON line read from that run's trace, inside its ``aat.aat_screen`` range:
the device's busy and idle seconds; the idle seconds by the innermost
``aat.`` range the host was in (a gap that spans several ranges is split
at their edges); the device time by the innermost range that launched it;
and how many kernels, copies and memsets lie inside a device-side
``aat.`` range of another name than the range that launched them
(``misplaced``; 0 is right).  Needs a card.
"""

from __future__ import annotations

import argparse
import bisect
import glob
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREFIX = "aat."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(intervals) -> list:
    """Sorted, merged [start, end] intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(ranges, t):
    """The name of the shortest range [s, e] holding t, or None."""
    best = None
    for name, s, e in ranges:
        if s <= t <= e and (best is None or e - s < best[2] - best[1]):
            best = (name, s, e)
    return best[0] if best else None


def summarize(events: list) -> dict:
    """The summary this tool prints, from a Chrome trace's events (times
    in microseconds, read as seconds)."""
    host, gpu_ranges, device, launch_at = [], [], [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        s, e_end = e["ts"] / 1e6, (e["ts"] + e.get("dur", 0)) / 1e6
        cat, name = e.get("cat", ""), e.get("name", "")
        corr = (e.get("args") or {}).get("correlation")
        if name.startswith(PREFIX):
            (gpu_ranges if cat.startswith("gpu") else host).append(
                (name[len(PREFIX):], s, e_end))
        elif cat in DEVICE_CATS:
            device.append((name, s, e_end, corr))
        elif cat == "cuda_runtime" and corr is not None:
            launch_at[corr] = s
    roots = [(s, e) for n, s, e in host if n == "aat_screen"]
    if not roots:
        raise SystemExit("the trace holds no aat.aat_screen range")
    w0, w1 = roots[-1]
    inside = [d for d in device if d[2] > w0 and d[1] < w1]
    busy = _union([[max(s, w0), min(e, w1)] for _, s, e, _ in inside])
    edges = sorted({t for _, s, e in host for t in (s, e) if w0 < t < w1})
    idle, t = {}, w0
    for s, e in busy + [[w1, w1]]:
        if s > t:
            cut = [t, *edges[bisect.bisect_right(edges, t):
                             bisect.bisect_left(edges, s)], s]
            for a, b in zip(cut, cut[1:]):
                label = _innermost(host, (a + b) / 2) or "none"
                idle[label] = idle.get(label, 0.0) + (b - a)
        t = max(t, e)
    by_range, misplaced, unmatched = {}, 0, 0
    for name, s, e, corr in inside:
        launched = (_innermost(host, launch_at[corr])
                    if corr in launch_at else None)
        if launched is None:
            unmatched += 1
            continue
        by_range[launched] = by_range.get(launched, 0.0) + (e - s)
        shown = _innermost(gpu_ranges, (s + e) / 2)
        misplaced += shown is not None and shown != launched
    busy_s = sum(e - s for s, e in busy)
    return {"screen_s": w1 - w0, "busy_s": busy_s,
            "idle_s": (w1 - w0) - busy_s,
            "idle_by_range": dict(sorted(idle.items(),
                                         key=lambda kv: -kv[1])),
            "device_by_range": dict(sorted(by_range.items(),
                                           key=lambda kv: -kv[1])),
            "device_ops": len(inside), "misplaced": misplaced,
            "unmatched": unmatched}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tools/torch_span_trace.py")
    p.add_argument("--out", default="")
    p.add_argument("screen", nargs=argparse.REMAINDER,
                   help="aat_screen's arguments, after --")
    args = p.parse_args(argv)
    screen = args.screen[1:] if args.screen[:1] == ["--"] else args.screen
    if not screen:
        p.error("give aat_screen's arguments after --")

    import torch

    cmd = [sys.executable, "-m", "alignment_algos_tpu_torch.cli.screen",
           *screen]
    env = dict(os.environ, AAT_TORCH_DEVICE="cuda",
               PYTHONPATH=os.pathsep.join(
                   [ROOT, os.environ.get("PYTHONPATH", "")]))
    env.pop("AAT_TRACE_DIR", None)
    with tempfile.TemporaryDirectory(prefix="aat_span_trace_") as work:
        subprocess.run(cmd, env=env, check=True,
                       stdout=subprocess.DEVNULL)
        logdir = args.out or work
        before = set(glob.glob(os.path.join(logdir, "*.pt.trace.json")))
        subprocess.run(cmd, env=dict(env, AAT_TRACE_DIR=logdir),
                       check=True, stdout=subprocess.DEVNULL)
        new, = (set(glob.glob(os.path.join(logdir, "*.pt.trace.json")))
                - before)
        with open(new) as f:
            events = json.load(f)["traceEvents"]
    out = {"argv": screen, "device": torch.cuda.get_device_name(0),
           "trace": new, **summarize(events)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
