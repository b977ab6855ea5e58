"""Profiling hooks on ``torch.profiler`` (counterpart of
``alignment_algos_tpu/utils/profiling.py``).

Usage:
    with profiling.maybe_trace():          # no-op unless AAT_TRACE_DIR set
        scores = engine(...)

    with profiling.annotate("sw_affine"):  # named region in the trace
        ...

    rate = profiling.cups(cells, seconds)  # cell updates / second

Set ``AAT_TRACE_DIR=/tmp/trace`` to write a Chrome trace (host ops, and
the card's kernels where a card is present) viewable in Perfetto; every
tool of the port also traces its whole process then
(``utils.torchenv.maybe_start_trace``).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

ENV = "AAT_TRACE_DIR"


def profiler() -> "torch.profiler.profile":
    """A profiler of host activity, and of the card's when one is
    present."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    # one cycle; acc_events keeps some torch versions from warning at start
    # that a new cycle drops the last one's events
    return torch.profiler.profile(activities=acts, acc_events=True)


def export(prof, logdir: str, tag: str) -> str:
    """Write ``prof``'s Chrome trace into ``logdir`` (made if missing) as
    ``aat_<tag>_<pid>_<ns>.pt.trace.json``; returns its path."""
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"aat_{tag}_{os.getpid()}_"
                                f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def maybe_trace(logdir: str | None = None):
    """A trace of the block if a directory is given or AAT_TRACE_DIR is
    set (yields the directory), else nothing (yields None)."""
    logdir = logdir or os.environ.get(ENV, "")
    if not logdir:
        yield None
        return
    with profiler() as prof:
        yield logdir
    export(prof, logdir, "block")


def annotate(name: str):
    """Named region that shows up on the trace timeline."""
    return torch.profiler.record_function(name)


def cups(cells: int, seconds: float) -> float:
    """Cell updates per second — the DP throughput metric (BASELINE.md)."""
    return cells / seconds if seconds > 0 else float("inf")


class Stopwatch:
    """Reference-style wall-clock pair with a CUPS readout for DP engines.

    Given a CUDA device it reads CUDA events recorded on that device's
    current stream, so :meth:`seconds` waits for and includes the work
    queued there; otherwise it reads the host clock."""

    def __init__(self, device: torch.device | None = None) -> None:
        self.device = None if device is None else torch.device(device)
        if self.device is not None and self.device.type == "cuda":
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record(torch.cuda.current_stream(self.device))
        else:
            self._start = None
            self.t0 = time.perf_counter()

    def seconds(self) -> float:
        if self._start is None:
            return time.perf_counter() - self.t0
        stop = torch.cuda.Event(enable_timing=True)
        stop.record(torch.cuda.current_stream(self.device))
        stop.synchronize()
        return self._start.elapsed_time(stop) / 1e3

    def cups(self, cells: int) -> float:
        return cups(cells, self.seconds())
