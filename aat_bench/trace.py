"""The traced run's spans and its device trace.

A span is the benchmark's own wrapper around a function of the program,
put at the module attribute its caller looks up, for the traced run only
and restored after it.  It synchronizes every card of the run before it
starts and before it ends, so the device work launched inside it also ends
inside it on every card, and it marks itself in the profiler
(``aat_bench.<span>``), so that its device time is the profiler's device
activity within its interval, summed over the cards (card-seconds).

The device summary reads ``torch.profiler``'s events kept in memory,
grouped by the card each ran on (``device_index``): a card's busy time is
the union of its kernels', copies' and memsets' intervals in the window,
and the run's busy time is the mean over its cards; each card's idle gaps
are labelled by the span the host was in, and summed over the cards.
"""

from __future__ import annotations

import functools
import importlib
import time
from dataclasses import dataclass, field

import torch

from aat_bench import cards as cards_

PREFIX = "aat_bench."


@dataclass
class Span:
    name: str
    start: float            # host clock, s
    end: float
    info: dict = field(default_factory=dict)
    device_s: float = 0.0   # device time inside it, from the profiler

    @property
    def seconds(self) -> float:
        return self.end - self.start


class Spans:
    """Wrappers for ``targets``: span name -> ("module:attr", probe or
    None); a probe maps the call's (args, kwargs) to a dict kept with the
    span (sizes only: it runs no device work).  ``cards``: the run's."""

    def __init__(self, targets: dict, cards: list):
        self.targets = targets
        self.cards = cards
        self.records: list[Span] = []
        self._saved = []

    def _wrap(self, name, fn, probe):
        # functools.wraps also copies the function's attributes, such as
        # the launch counters the program keeps on its kernel wrappers
        @functools.wraps(fn)
        def span(*args, **kwargs):
            info = probe(args, kwargs) if probe else {}
            cards_.sync(self.cards)
            t0 = time.perf_counter()
            with torch.profiler.record_function(PREFIX + name):
                out = fn(*args, **kwargs)
                cards_.sync(self.cards)
            self.records.append(Span(name, t0, time.perf_counter(), info))
            return out
        return span

    def install(self) -> None:
        for name, (target, probe) in self.targets.items():
            mod_name, attr = target.split(":")
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(name, fn, probe))

    def restore(self) -> None:
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved = []


def _union(intervals):
    """Sorted, merged [start, end] intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(merged, s, e) -> float:
    return sum(max(0.0, min(e, b) - max(s, a)) for a, b in merged)


WINDOW = "window"


def summarize(prof, spans: list[Span], cards: list = (0,)) -> dict:
    """Device busy and window seconds, the top device operations, the idle
    gaps by span, and each span's device time (set on ``spans`` in
    order).  ``cards``: the run's cards as the profiler indexes them.
    ``busy_s`` is the mean over the cards, ``busy_by_card`` each card's; a
    span's device time, the device operations and the idle gaps are sums
    over the cards."""
    from torch.autograd import DeviceType

    marks, device = [], []
    for e in prof.events():
        start, end = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.name.startswith(PREFIX):
            if e.device_type == DeviceType.CPU:
                marks.append((e.name[len(PREFIX):], start, end))
        elif e.device_type == DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            device.append((e.device_index, e.name, start, end))
    win = [(s, e) for n, s, e in marks if n == WINDOW]
    if not win:
        raise RuntimeError("the profiler holds no window mark")
    w0, w1 = win[0]
    device = [(c, n, max(s, w0), min(e, w1)) for c, n, s, e in device
              if e > w0 and s < w1]
    strange = sorted({c for c, _, _, _ in device} - set(cards))
    if strange:
        raise RuntimeError(f"device work on card(s) {strange}, outside the "
                           f"run's {list(cards)}")
    busy = {k: _union([[s, e] for c, _, s, e in device if c == k])
            for k in cards}
    by_name = {}
    for _, n, s, e in device:
        by_name[n] = by_name.get(n, 0.0) + (e - s)

    marked = [m for m in marks if m[0] != WINDOW]
    counts = {}
    for name, s, e in marked:
        k = counts.get(name, 0)
        counts[name] = k + 1
        mine = [sp for sp in spans if sp.name == name]
        if k < len(mine):
            mine[k].device_s = sum(_overlap(busy[c], s, e) for c in cards)

    # each card's idle gaps, each labelled by the innermost span the host
    # was in, summed over the cards
    idle = {}
    for c in cards:
        gaps, t = [], w0
        for s, e in busy[c] + [[w1, w1]]:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        for s, e in gaps:
            mid = (s + e) / 2
            inside = [(ms, name) for name, ms, me in marked
                      if ms <= mid <= me]
            label = max(inside)[1] if inside else "between screens"
            idle[label] = idle.get(label, 0.0) + (e - s)
    busy_by_card = {c: sum(e - s for s, e in busy[c]) for c in cards}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": w1 - w0,
            "busy_s": sum(busy_by_card.values()) / len(cards),
            "busy_by_card": busy_by_card,
            "device_ops": [[n, v] for n, v in top],
            "idle_gaps": [[n, v] for n, v in
                          sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
            "device_by_name": by_name}
