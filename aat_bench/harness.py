"""One run of one cell: set-up, the measured window, the reference check
and the metrics.

The window is a closed loop with one caller: the entry's screens run back
to back, each query of the mix in turn from the first, until the window's
seconds have passed; the screen that crosses the end completes, and the
window is the time up to its end, so a rate is all the work of the window
over all its time.

A run has the cards its cell asks for (``cards``): the program's session
and the reference check take the first; every card is synchronized, its
peak memory read and its use in the window counted.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field

import torch

from aat_bench import cards as cards_
from aat_bench import cell as cells
from aat_bench import trace

# loading any of these in the measured process refuses the run
FORBIDDEN = ("jax", "jaxlib", "flax", "alignment_algos_tpu")


@dataclass
class Screen:
    index: int
    rc: int
    work: dict
    out: str = ""


@dataclass
class Run:
    """What a metric reader reads."""
    inputs: dict
    setup_s: float
    window_s: float
    screens: list
    spans: list = field(default_factory=list)
    device: dict | None = None

    def span_mean_s(self, name: str):
        """A span's seconds per completed screen, or None without it."""
        got = [s.seconds for s in self.spans if s.name == name]
        return sum(got) / len(self.screens) if got and self.screens else None


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def metric_modules(specs: list, bench_dir: str) -> dict:
    return {m["name"]: cells.load_module("metrics", m["name"], bench_dir)
            for m in specs}


def run_cell(c: cells.Cell, seed: int, seconds: float, traced: bool,
             cards: list, t0: float, *, root: str = cells.ROOT,
             bench_dir: str = cells.BENCH_DIR, config: dict | None = None,
             traffic: dict | None = None, control: bool = False) -> dict:
    """Run the cell once on ``cards`` (the run's devices, the first the
    session's) and return its result (the JSON object the run prints, with
    ``checks`` last).  ``config`` / ``traffic`` replace the cell's (the CPU
    rehearsal's small sizes); ``control`` puts the entry's control in the
    program's place."""
    device = cards[0]
    config = config or c.config
    traffic = traffic or c.traffic
    specs = c.per_layer if traced else c.end_to_end
    readers = metric_modules(specs, bench_dir)
    workdir = tempfile.mkdtemp(prefix="aat_bench_")
    try:
        gen = cells.load_module("generators", config["generator"], bench_dir)
        inputs = gen.make(config, seed, workdir)
        entry = cells.load_module("entries", traffic["entry"], bench_dir)
        kind = entry.Control if control else entry.Session
        session = kind(config, traffic, inputs, root, device)
        session.screen(session.warmup_index())
        cards_.sync(cards)
        cards_.reset_peaks(cards)
        setup_s = time.perf_counter() - t0

        spans = prof = None
        if traced:
            targets = {}
            for mod in readers.values():
                probes = getattr(mod, "PROBES", {})
                for name, target in getattr(mod, "SPANS", {}).items():
                    if targets.get(name, (target,))[0] != target:
                        raise ValueError(f"span {name} has two targets")
                    targets[name] = (target, probes.get(name))
            spans = trace.Spans(targets, cards)
            spans.install()
            prof = torch.profiler.profile(activities=_activities(device))
            prof.start()
        screens = []
        before = cards_.allocations(cards)
        try:
            with torch.profiler.record_function(trace.PREFIX + trace.WINDOW):
                w0 = time.perf_counter()
                i = 0
                while True:
                    with torch.profiler.record_function(trace.PREFIX
                                                        + "screen"):
                        rc, out = _screen(session, i)
                        cards_.sync(cards)
                    s1 = time.perf_counter()
                    screens.append(Screen(i, rc, session.work(i), out))
                    i += 1
                    if s1 - w0 >= seconds:
                        break
            window_s = s1 - w0
            after = cards_.allocations(cards)
        finally:
            if traced:
                prof.stop()
                spans.restore()
        index = [d.index or 0 for d in cards]
        summary = None
        if traced:
            summary = trace.summarize(prof, spans.records, index)
            before = [0.0] * len(cards)
            after = [summary["busy_by_card"][i] for i in index]
        used = cards_.used(cards, before, after)
        peaks = cards_.peaks(cards)
        found = forbidden_modules()
        if found:
            raise ForbiddenModules(found)
        session.release()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        c0 = time.perf_counter()
        checks = entry.check(session, [(s.index, s.rc, s.out)
                                       for s in screens], seed, device)
        check_s = time.perf_counter() - c0

        run = Run(inputs, setup_s, window_s, screens,
                  spans.records if traced else [], summary)
        metrics = {}
        for m in specs:
            value = readers[m["name"]].read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev = {"platform": "gpu" if device.type == "cuda" else device.type,
               "kind": _kind(device), "count": int(used),
               "memory_peak_bytes": max(peaks),
               "cards": [{"index": i, "kind": _kind(d),
                          "memory_peak_bytes": p}
                         for d, i, p in zip(cards, index, peaks)]}
        result = {"correct": all(v <= lim for _, v, lim in checks),
                  "attempted": len(screens),
                  "failed": sum(s.rc != 0 for s in screens),
                  "metrics": metrics, "device": dev}
        if traced:
            for card in dev["cards"]:
                card["busy_s"] = summary["busy_by_card"][card["index"]]
            dev["busy_s"] = summary["busy_s"]
            dev["window_s"] = summary["window_s"]
            result["breakdown"] = {"device_ops": summary["device_ops"],
                                   "idle_gaps": summary["idle_gaps"]}
            result["span_device_s"] = _span_table(spans.records, summary)
        result["seconds"] = {"setup": setup_s, "window": window_s,
                             "check": check_s}
        result["checks"] = {n: {"value": float(v), "limit": float(lim)}
                            for n, v, lim in checks}
        return result
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


class ForbiddenModules(RuntimeError):
    def __init__(self, found):
        super().__init__("loaded in the measured process: " + ", ".join(found))


def _screen(session, i: int):
    try:
        return session.screen(i)
    except Exception:
        traceback.print_exc()
        return -2, ""


def _kind(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)


def _activities(device: torch.device) -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _span_table(records, summary) -> dict:
    """Per span: calls, host seconds and device seconds, beside the
    profiler's device seconds by kernel name (so a reader of the result
    can hold a span's device time against its kernel's)."""
    out = {}
    for s in records:
        row = out.setdefault(s.name, {"calls": 0, "host_s": 0.0,
                                      "device_s": 0.0})
        row["calls"] += 1
        row["host_s"] += s.seconds
        row["device_s"] += s.device_s
    out["kernels"] = {n: v for n, v in sorted(
        summary["device_by_name"].items(), key=lambda kv: -kv[1])[:6]}
    return out
