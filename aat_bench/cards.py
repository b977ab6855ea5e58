"""The cards of a run: which ones the process sees, waiting for all of
them, and what each one did in the window.

A cell asks for ``chips`` cards.  :func:`narrow` cuts
``CUDA_VISIBLE_DEVICES`` to that many before torch is imported: the
program's mesh takes every visible card, so a one-card cell stays on one
card of a larger machine and a four-card cell sees four.  A card counts as
used when the window allocated on it (:func:`allocations`, untraced) or
the profiler saw device work on it (``trace.summarize``, traced); a run
that used fewer cards than its cell asks for gives no result.

torch is imported inside the functions, so that :func:`narrow` can run
before it is.
"""

from __future__ import annotations

import os

ENV = "CUDA_VISIBLE_DEVICES"

# the allocator's count of allocation requests, cumulative
ALLOCATED = "allocation.all.allocated"


def visible(value: str | None, chips: int) -> str:
    """``CUDA_VISIBLE_DEVICES`` for a cell of ``chips`` cards, given its
    value (None: unset): its first ``chips`` entries (indices or UUIDs), or
    ``0..chips-1`` where it is unset.  A shorter list stays as it is, and
    the run then refuses for want of cards."""
    if value is None:
        return ",".join(str(i) for i in range(chips))
    return ",".join(value.split(",")[:chips])


def narrow(chips: int, environ=os.environ) -> None:
    environ[ENV] = visible(environ.get(ENV), chips)


def sync(cards: list) -> None:
    """Wait for the work queued on every card of the run."""
    import torch

    for d in cards:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def reset_peaks(cards: list) -> None:
    import torch

    for d in cards:
        if d.type == "cuda":
            torch.cuda.reset_peak_memory_stats(d)


def peaks(cards: list) -> list:
    """Each card's peak of allocated bytes since :func:`reset_peaks`."""
    import torch

    return [int(torch.cuda.max_memory_allocated(d)) if d.type == "cuda"
            else 0 for d in cards]


def allocations(cards: list) -> list:
    """Each card's count of allocations so far (0 off a card)."""
    import torch

    return [int(torch.cuda.memory_stats(d).get(ALLOCATED, 0))
            if d.type == "cuda" else 0 for d in cards]


def used(cards: list, before: list, after: list) -> int:
    """The cards whose reading rose from ``before`` to ``after``: the
    allocation counts at the window's start and end, or 0 and the busy
    seconds of the trace.  The host, where a rehearsal runs, counts as
    used."""
    return sum(d.type != "cuda" or a > b
               for d, b, a in zip(cards, before, after))
