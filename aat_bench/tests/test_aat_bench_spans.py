"""The readers of the program's own spans and counters, against worked
values from planted records: the window's screens are the last roots, and
records an earlier run left in the process are skipped."""

import pytest

from aat_bench import cell as cells
from aat_bench import harness
from alignment_algos_tpu_torch.utils import profiling
from alignment_algos_tpu_torch.utils.profiling import Record


def _reader(name):
    return cells.load_module("metrics", name)


class _Plant:
    """Records laid out as spans: ``add(name, seconds, parent, **counts)``
    opens and closes one after the last."""

    def __init__(self):
        self.recs, self.t = [], 100.0

    def add(self, name, seconds, parent=None, **counts):
        r = Record(name, len(self.recs), parent, self.t, self.t + seconds,
                   counts)
        self.recs.append(r)
        self.t += seconds
        return r.id


def _fasta_screen(p, scale):
    root = p.add("aat_screen", 10.0)
    ri = p.add("fasta.read_inputs", 3.0, root)
    p.add("fasta.read", 0.5 * scale, ri)
    p.add("fasta.encode", 2.0 * scale, ri, templates=3, residues=900,
          codes=3 * 400)
    lib = p.add("screen.library", 4.0, root)
    td = p.add("to_device", 3.0, lib)
    p.add("to_device.layout", 1.5 * scale, td)
    p.add("to_device.copy", 0.5 * scale, td, h2d_bytes=2e9)
    p.add("k1", 1.0, lib, q=100, cells=100 * 400 * 3)
    cl = p.add("cluster", 1.0, root)
    td = p.add("to_device", 0.1, cl)
    # the hits' copy is not the library's
    p.add("to_device.layout", 7.0, td)
    p.add("to_device.copy", 7.0, td, h2d_bytes=1.0)


def _profile_screen(p, scale):
    root = p.add("aat_screen", 5.0)
    p.add("profile.read", 2.0 * scale, root, files=5, rows=60_000)
    hs = p.add("hmap.screen", 1.0, root)
    p.add("hmap.pack", 0.25 * scale, hs, templates=700)
    p.add("open", 1.0)          # a span still open: end None
    p.recs[-1].end = None


def _run(screens):
    return harness.Run(inputs={}, setup_s=1.0, window_s=30.0,
                       screens=[harness.Screen(i, 0, {})
                                for i in range(screens)])


@pytest.fixture
def fasta(monkeypatch):
    p = _Plant()
    _fasta_screen(p, 100.0)     # an earlier run's screen: skipped
    _fasta_screen(p, 1.0)
    _fasta_screen(p, 2.0)
    monkeypatch.setattr(profiling, "records", lambda: list(p.recs))
    return _run(2)


@pytest.fixture
def profile(monkeypatch):
    p = _Plant()
    _profile_screen(p, 100.0)
    _profile_screen(p, 1.0)
    _profile_screen(p, 3.0)
    monkeypatch.setattr(profiling, "records", lambda: list(p.recs))
    return _run(2)


def test_fasta_seconds_per_window_screen(fasta):
    assert _reader("fasta.parse_s").read(fasta) == pytest.approx(0.75)
    assert _reader("fasta.encode_s").read(fasta) == pytest.approx(3.0)
    # under screen.library only: the hits' layout is not counted
    assert _reader("fasta.layout_s").read(fasta) == pytest.approx(2.25)


def test_fasta_copy_rate_over_the_library_copies(fasta):
    # 2 x 2e9 bytes in 0.5 + 1.0 s
    assert _reader("fasta.h2d_gbps").read(fasta) == pytest.approx(4e9 / 1.5
                                                                   / 1e9)


def test_k1_padding_share(fasta):
    # each screen: 100 x 900 needed of 100 x 400 x 3 launched
    assert _reader("k1.pad_pct").read(fasta) == pytest.approx(25.0)


def test_profile_rows_rate_and_pack_seconds(profile):
    # 2 x 60,000 rows in 2 + 6 s; the pack 0.25 and 0.75 s
    assert _reader("profile.rows_per_s").read(profile) == pytest.approx(
        15_000)
    assert _reader("profile.pack_s").read(profile) == pytest.approx(0.5)


NEW = ["fasta.parse_s", "fasta.encode_s", "fasta.layout_s",
       "fasta.h2d_gbps", "k1.pad_pct", "profile.rows_per_s",
       "profile.pack_s"]


@pytest.mark.parametrize("name", NEW)
def test_nothing_read_without_the_programs_records(name, monkeypatch, fasta):
    """A program without ``records`` (the parent of the spans), or with
    fewer roots than the window's screens, gives no reading and no
    error."""
    planted = profiling.records
    monkeypatch.delattr(profiling, "records")
    assert _reader(name).read(fasta) is None
    monkeypatch.setattr(profiling, "records", lambda: [], raising=False)
    assert _reader(name).read(fasta) is None
    monkeypatch.setattr(profiling, "records", planted)
    fasta.screens *= 4
    assert _reader(name).read(fasta) is None
