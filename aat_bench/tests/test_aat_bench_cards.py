"""The run's cards: ``CUDA_VISIBLE_DEVICES`` cut to a cell's ``chips``,
the count of cards a window used, and every card waited for."""

import sys
import types

import pytest
import torch

from aat_bench import cards, trace

CUDA = [torch.device("cuda", i) for i in range(4)]


@pytest.mark.parametrize("value,chips,want", [
    (None, 1, "0"),                              # unset
    (None, 4, "0,1,2,3"),
    ("3", 4, "3"),                               # shorter: kept, refused
    ("", 1, ""),
    ("0,1,2,3", 4, "0,1,2,3"),                   # equal
    ("4,5,6,7,0,1", 4, "4,5,6,7"),               # longer: the first
    ("5,2", 1, "5"),
    ("GPU-8a1b,GPU-77c0,GPU-0e2f", 2, "GPU-8a1b,GPU-77c0"),   # UUIDs
])
def test_visible_cards(value, chips, want):
    assert cards.visible(value, chips) == want
    env = {} if value is None else {cards.ENV: value}
    cards.narrow(chips, env)
    assert env == {cards.ENV: want}


def test_used_counts_cards_whose_reading_rose():
    # allocation counts at the window's start and end
    assert cards.used(CUDA, [5, 5, 5, 5], [9, 5, 7, 5]) == 2
    assert cards.used(CUDA, [5, 5, 5, 5], [9, 6, 7, 8]) == 4
    assert cards.used(CUDA[:1], [3], [3]) == 0
    # traced: from 0 to each card's busy seconds
    assert cards.used(CUDA, [0.0] * 4, [1.5, 0.0, 0.2, 0.0]) == 2
    # a rehearsal's host counts as used
    assert cards.used([torch.device("cpu")], [0], [0]) == 1


def test_every_card_is_waited_for(monkeypatch):
    """A span synchronizes each card of the run before it starts and
    before it ends."""
    log = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: log.append(d.index))
    prog = types.ModuleType("aat_bench_fake_program")
    prog.work = lambda x: log.append("work") or x + 1
    monkeypatch.setitem(sys.modules, prog.__name__, prog)
    spans = trace.Spans({"w": (prog.__name__ + ":work", None)}, CUDA)
    spans.install()
    try:
        assert prog.work(1) == 2
    finally:
        spans.restore()
    assert log == [0, 1, 2, 3, "work", 0, 1, 2, 3]
    assert [s.name for s in spans.records] == ["w"]
    log.clear()
    cards.sync(CUDA[:2] + [torch.device("cpu")])
    assert log == [0, 1]
