"""The metric arithmetic: rates over all the work and all the window, the
K1 and K3 bounds against worked values, the device summary."""

import types

import pytest

from aat_bench import cell as cells
from aat_bench import harness, trace, yardstick


def _run(screens, window_s, spans=(), device=None, inputs=None):
    return harness.Run(inputs=inputs or {}, setup_s=7.5,
                       window_s=window_s, screens=list(screens),
                       spans=list(spans), device=device)


def _screen(i, work):
    return harness.Screen(i, 0, work)


def _reader(name):
    return cells.load_module("metrics", name)


def test_search_gcups_is_all_cells_over_the_window():
    run = _run([_screen(0, {"cells": 3e9}), _screen(1, {"cells": 5e9})], 4.0)
    assert _reader("search_gcups").read(run) == pytest.approx(2.0)
    assert _reader("search_gcups").read(_run([_screen(0, {})], 4.0)) is None


def test_profile_rate_is_all_templates_over_the_window():
    run = _run([_screen(i, {"templates": 350}) for i in range(3)], 5.0)
    assert _reader("profile_templates_per_s").read(run) == pytest.approx(210)


def test_setup_s():
    assert _reader("setup_s").read(_run([], 1.0)) == 7.5


def test_span_mean_is_per_completed_screen():
    spans = [trace.Span("fasta.read_encode", 0.0, 0.5, {}),
             trace.Span("fasta.read_encode", 1.0, 1.3, {})]
    run = _run([_screen(0, {}), _screen(1, {})], 2.0, spans)
    assert _reader("fasta.read_encode_s").read(run) == pytest.approx(0.4)
    assert _reader("fasta.cluster_s").read(run) is None


def test_k1_bound_worked_value():
    # 1,000 x 6.4e6 real cells: 7.04e10 operations over 3.345e13 /s =
    # 2.1048 ms; the bytes (2.57e7) take 7.7 us, so operations bound it
    nbytes, ops = yardstick.k1_work(1000, 6_400_000, 17_800, 25)
    assert nbytes == 4.0 * (6_400_000 + 1000 + 625 + 2 + 17_800)
    assert ops == 11 * 1000 * 6_400_000
    assert yardstick.least_s(nbytes, ops) == pytest.approx(
        7.04e10 / (132 * 128 * 1.98e9))
    span = trace.Span("k1", 0, 1, {"q": 1000, "n": 17_800, "a": 25},
                      device_s=0.1)
    run = _run([_screen(0, {})], 1.0, [span],
               inputs={"templates": 17_800, "residues": 6_400_000})
    assert _reader("k1_roofline").read(run) == pytest.approx(
        100 * 7.04e10 / (132 * 128 * 1.98e9) / 0.1)


def test_k3_bound_worked_value():
    # one pair of 100 x 100 rows (q2 = t2 = 102): 99 x 99 interior cells,
    # 99 x 99 x 196 gap candidates plus 6 per cell
    nbytes, ops = yardstick.k3_work([(1, 102, 102)])
    assert ops == 99 * 99 * 196 + 6 * 99 * 99
    assert nbytes == 4 * (102 * 102 + 4 * 102 + 1)
    span = trace.Span("k3", 0, 1, {"shapes": [(1, 102, 102)]},
                      device_s=1e-3)
    run = _run([_screen(0, {})], 1.0, [span])
    assert _reader("k3_roofline").read(run) == pytest.approx(
        100 * ops / yardstick.F32_OPS_PER_S / 1e-3)


def _event(name, start_us, end_us, cuda, card=0):
    from torch.autograd import DeviceType
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start_us,
                                                    end=end_us),
        device_type=DeviceType.CUDA if cuda else DeviceType.CPU,
        device_index=card, is_user_annotation=False)


def test_summary_busy_idle_and_span_device_time():
    events = [_event("aat_bench.window", 0, 10e6, False),
              _event("aat_bench.k1", 1e6, 4e6, False),
              _event("kernel_a", 2e6, 3e6, True),
              _event("kernel_a", 2.5e6, 3.5e6, True),   # overlaps: union
              _event("memcpy", 8e6, 9e6, True)]
    prof = types.SimpleNamespace(events=lambda: events)
    span = trace.Span("k1", 0, 1, {})
    s = trace.summarize(prof, [span])
    assert s["window_s"] == pytest.approx(10.0)
    assert s["busy_s"] == pytest.approx(2.5)
    assert span.device_s == pytest.approx(1.5)
    assert s["device_ops"][0] == ["kernel_a", pytest.approx(2.0)]
    # a gap takes the label of the span its middle falls in
    idle = dict(s["idle_gaps"])
    assert idle["k1"] == pytest.approx(2.0)          # 0-2 s
    assert idle["between screens"] == pytest.approx(5.5)
    run = _run([], 10.0, device=s)
    assert _reader("device_idle_pct.fasta").read(run) == pytest.approx(75.0)


FOUR_CARDS = [_event("aat_bench.window", 0, 10e6, False),
              _event("aat_bench.k1", 1e6, 4e6, False),
              _event("kernel_a", 2e6, 3e6, True, card=0),
              _event("kernel_a", 2.5e6, 3.5e6, True, card=1),
              _event("memcpy", 8.5e6, 9.5e6, True, card=2)]


def test_summary_per_card():
    """Four cards, the last idle: busy is each card's union and their
    mean, a span's device time and the idle gaps are sums over the
    cards."""
    prof = types.SimpleNamespace(events=lambda: FOUR_CARDS)
    span = trace.Span("k1", 0, 1, {})
    s = trace.summarize(prof, [span], [0, 1, 2, 3])
    assert s["busy_by_card"] == {0: pytest.approx(1.0), 1: pytest.approx(1.0),
                                 2: pytest.approx(1.0), 3: 0.0}
    assert s["busy_s"] == pytest.approx(0.75)
    # card 0's 2-3 s and card 1's 2.5-3.5 s, both inside 1-4 s
    assert span.device_s == pytest.approx(2.0)
    assert dict(s["device_ops"]) == {"kernel_a": pytest.approx(2.0),
                                     "memcpy": pytest.approx(1.0)}
    idle = dict(s["idle_gaps"])
    # cards 0 and 1 wait 2 and 2.5 s inside k1; the rest of 40
    # card-seconds, less 3 busy, between screens
    assert idle["k1"] == pytest.approx(4.5)
    assert idle["between screens"] == pytest.approx(32.5)
    run = _run([], 10.0, device=s)
    assert _reader("device_idle_pct.fasta").read(run) == pytest.approx(92.5)


def test_summary_of_one_card_reads_only_its_own():
    """Device work on a card the run does not have is refused, not
    counted as the run's."""
    prof = types.SimpleNamespace(events=lambda: FOUR_CARDS)
    with pytest.raises(RuntimeError, match=r"card\(s\) \[1, 2\]"):
        trace.summarize(prof, [], [0])
