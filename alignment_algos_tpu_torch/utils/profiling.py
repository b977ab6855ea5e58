"""The port's tracing: spans and counters inside the program, on
``torch.profiler``.

A span names one stage of the program's work where it happens::

    with profiling.span("fasta.encode"):
        codes = encode_library(seqs, index, pad_code)
        profiling.count("residues", n)     # onto the innermost open span

Spans record only while a ``torch.profiler`` session records in the
process: a benchmark's traced window, or a run under ``AAT_TRACE_DIR``,
where every tool of the port traces its whole process
(``utils.torchenv.maybe_start_trace``) and writes a Chrome trace viewable
in Perfetto.  Off, :func:`span` returns one shared object that does
nothing, and :func:`count` returns at once.  On, a span opens the range
``aat.<name>`` in the profiler, on the device trace's own timeline and
clock, and keeps a :class:`Record` in memory (:func:`records`) with its
host clock (``time.perf_counter``), its parent and its counts.  A span
never synchronizes the device: a kernel belongs to the range that
launched it, and its device time is the profiler's to attribute.

A counter's value is one the code has at hand (a shape, a size); one that
takes work to compute is computed only under :func:`recording`.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from dataclasses import dataclass, field

import torch

ENV = "AAT_TRACE_DIR"
PREFIX = "aat."


@dataclass
class Record:
    """One span: ``parent`` is the id of the span open around it on its
    thread (None for a root); ``end`` is None while it is open."""
    name: str
    id: int
    parent: int | None
    start: float
    end: float | None = None
    counts: dict = field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return self.end - self.start


_records: list[Record] = []
_ids = itertools.count()
_local = threading.local()      # .open: this thread's open spans


def recording() -> bool:
    """Whether a ``torch.profiler`` session records in this process."""
    return torch.autograd._profiler_enabled()


class _Off:
    """The span while nothing records: enters and exits, nothing more."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("record", "_range")

    def __init__(self, name: str, counts: dict):
        self.record = Record(name, next(_ids), None, 0.0, counts=counts)
        self._range = torch.profiler.record_function(PREFIX + name)

    def __enter__(self):
        stack = _open()
        if stack:
            self.record.parent = stack[-1].id
        stack.append(self.record)
        _records.append(self.record)
        self.record.start = time.perf_counter()
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        self.record.end = time.perf_counter()
        _open().pop()
        return False


def _open() -> list:
    stack = getattr(_local, "open", None)
    if stack is None:
        stack = _local.open = []
    return stack


def span(name: str, **counts):
    """A context manager over one stage named ``name``, with ``counts``
    to start its counters; see the module docstring."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _On(name, counts)


def count(key: str, n) -> None:
    """Add ``n`` to counter ``key`` of the innermost open span; nothing
    while nothing records."""
    if not torch.autograd._profiler_enabled():
        return
    stack = getattr(_local, "open", None)
    if stack:
        counts = stack[-1].counts
        counts[key] = counts.get(key, 0) + n


def records() -> list[Record]:
    """Every span kept so far in this process, in the order they opened
    (open ones with ``end`` None); nothing is drained."""
    return list(_records)


def profiler() -> "torch.profiler.profile":
    """A profiler of host activity, and of the card's when one is
    present."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    # one cycle; acc_events keeps some torch versions from warning at start
    # that a new cycle drops the last one's events
    return torch.profiler.profile(activities=acts, acc_events=True)


def export(prof, logdir: str) -> str:
    """Write ``prof``'s Chrome trace into ``logdir`` (made if missing) as
    ``aat_process_<pid>_<ns>.pt.trace.json``; returns its path."""
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"aat_process_{os.getpid()}_"
                                f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path
