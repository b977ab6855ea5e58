"""The program's own spans and counters (``utils.profiling`` of the port),
as the per-layer metrics read them.

The program keeps a record of every span while a ``torch.profiler``
session records, and a traced run's profiler records over the window
alone.  So the window's screens are the last ``len(run.screens)``
``aat_screen`` roots among the program's records; records of earlier
screens in the same process (another run, a test) come before them.  A
program that keeps no records, or fewer roots than screens, gives
nothing, and every reader here then returns None.
"""

from __future__ import annotations

import importlib

ROOT = "aat_screen"
PROGRAM = "alignment_algos_tpu_torch.utils.profiling"


def _records():
    try:
        profiling = importlib.import_module(PROGRAM)
    except ImportError:
        return None
    records = getattr(profiling, "records", None)
    return records() if records is not None else None


def screens(run):
    """Per window screen, every closed span under its root as (record,
    names of its ancestors below the root); None without them."""
    recs = _records()
    if not recs or not run.screens:
        return None
    closed = [r for r in recs if r.end is not None]
    roots = [r for r in closed if r.name == ROOT and r.parent is None]
    if len(roots) < len(run.screens):
        return None
    kids = {}
    for r in closed:
        kids.setdefault(r.parent, []).append(r)
    out = []
    for root in roots[len(roots) - len(run.screens):]:
        spans, todo = [], [(k, ()) for k in kids.get(root.id, [])]
        while todo:
            r, above = todo.pop()
            spans.append((r, above))
            todo += [(k, above + (r.name,)) for k in kids.get(r.id, [])]
        out.append(spans)
    return out


def named(screen, name: str, under: str | None = None) -> list:
    """The records of one screen named ``name``, those beneath a span
    named ``under`` only, if given."""
    return [r for r, above in screen
            if r.name == name and (under is None or under in above)]


def mean_s(run, name: str, under: str | None = None):
    """Seconds of the spans ``name`` per window screen, or None."""
    got = screens(run)
    if got is None:
        return None
    recs = [r for s in got for r in named(s, name, under)]
    if not recs:
        return None
    return sum(r.seconds for r in recs) / len(got)


def rate(run, name: str, key: str, under: str | None = None):
    """Counter ``key`` of the spans ``name`` over their seconds, summed
    over the window's screens, or None."""
    got = screens(run)
    if got is None:
        return None
    recs = [r for s in got for r in named(s, name, under)]
    n = sum(r.counts.get(key, 0) for r in recs)
    seconds = sum(r.seconds for r in recs)
    return n / seconds if n and seconds > 0 else None
