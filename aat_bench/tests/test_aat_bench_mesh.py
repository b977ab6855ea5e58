"""The four-card Swiss-Prot cell: its configuration is the generator's, it
resolves with four cards and rehearses on the CPU, and the readers of the
mesh's spans (``mesh.feed_s``, ``mesh.drain_s``) read worked sums from
planted records, the real program's spans when the screen takes a mesh,
and nothing where the program keeps no mesh spans."""

import json
import os

import pytest
import torch

from aat_bench import cell as cells
from aat_bench import harness, recipes, rehearse
from alignment_algos_tpu_torch.utils import profiling
from alignment_algos_tpu_torch.utils.profiling import Record

CELL = "swissprot_1of2.cudasw_long_4card"
MESH = ["mesh.feed_s", "mesh.drain_s"]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("AAT_TORCH_DEVICE", "cpu")


def _reader(name):
    return cells.load_module("metrics", name)


def test_the_cell_is_four_cards_of_the_long_mix():
    bench = cells.load_bench()
    c = cells.find(bench, CELL)
    assert c.chips == 4
    assert c.traffic == cells.find(bench, "swissprot_1of8.cudasw_long").traffic
    names = {m["name"] for m in c.per_layer}
    assert set(MESH) <= names
    # the mesh's metrics are read in this cell alone
    for w in bench["workloads"]:
        if w["name"] != CELL:
            got = {m["name"] for m in cells.find(bench, w["name"]).per_layer}
            assert not got & set(MESH)


def test_the_configuration_is_four_one_card_shards():
    with open(os.path.join(cells.BENCH_DIR, "configs",
                           "swissprot_1of2.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(cells.BENCH_DIR, "configs",
                           "swissprot_1of8.json")) as f:
        one = json.load(f)
    lens = recipes.lengths(cfg)
    assert len(lens) == cfg["n_templates"] == 4 * one["n_templates"]
    assert int(lens.max()) == cfg["longest_template"] == 4938
    assert int(lens.sum()) == cfg["total_residues"] == 102_527_816
    changed = {k for k in cfg if cfg[k] != one.get(k)}
    # the source names the multi-GPU deployment, so it is not the one-card one
    assert changed == {"name", "source", "deployment", "n_templates",
                       "reduced", "longest_template", "total_residues"}
    assert set(cfg["reduced"]) == {"n_templates"}


def test_traced_rehearsal_is_correct():
    """On the CPU the CLI takes no mesh, so the mesh's metrics are not read
    there; the FASTA path's are."""
    r = rehearse.rehearse(CELL, 2**33 + 5, 0.5, traced=True)
    assert r["correct"], r
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert {"fasta.parse_s", "fasta.encode_s", "k1.pad_pct"} <= set(
        r["metrics_read"])
    assert not set(MESH) & set(r["metrics_read"])


def test_traced_rehearsal_on_a_mesh_reads_the_mesh(monkeypatch):
    """With the CLI's mesh set to four CPU entries, the rehearsal reads the
    program's mesh spans through the harness, and stays correct."""
    from alignment_algos_tpu_torch.cli import screen as cli
    from alignment_algos_tpu_torch.parallel import screen
    monkeypatch.setattr(cli, "_mesh", lambda device: screen.default_mesh(
        4, device=device))
    r = rehearse.rehearse(CELL, 17, 0.5, traced=True)
    assert r["correct"], r
    assert set(MESH) <= set(r["metrics_read"])


class _Plant:
    def __init__(self):
        self.recs, self.t = [], 100.0

    def add(self, name, seconds, parent=None, **counts):
        r = Record(name, len(self.recs), parent, self.t, self.t + seconds,
                   counts)
        self.recs.append(r)
        self.t += seconds
        return r.id


def _mesh_screen(p, scale, cards=4):
    root = p.add("aat_screen", 10.0, cards=cards)
    lib = p.add("screen.library", 5.0, root)
    for card in range(cards):
        sh = p.add("mesh.shard", 0.25 * scale, lib, card=card,
                   templates=100)
        p.add("to_device", 0.1, sh)
        p.add("k1", 0.1, sh, q=10, cells=10 * 50 * 100)
    dr = p.add("mesh.drain", 0.5 * scale, lib)
    p.add("screen.topk", 0.4, dr)
    p.add("mesh.merge", 0.01, dr)
    # a mesh.shard outside a library screen (a process group's) is not
    # the screen's feed
    p.add("mesh.shard", 9.0, root)


def _one_device_screen(p):
    root = p.add("aat_screen", 10.0, cards=1)
    lib = p.add("screen.library", 5.0, root)
    p.add("to_device", 1.0, lib)
    p.add("k1", 1.0, lib)
    p.add("screen.topk", 1.0, lib)


def _run(screens):
    return harness.Run(inputs={}, setup_s=1.0, window_s=30.0,
                       screens=[harness.Screen(i, 0, {})
                                for i in range(screens)])


def test_mesh_seconds_per_window_screen(monkeypatch):
    p = _Plant()
    _mesh_screen(p, 100.0)      # an earlier run's screen: skipped
    _mesh_screen(p, 1.0)
    _mesh_screen(p, 3.0)
    monkeypatch.setattr(profiling, "records", lambda: list(p.recs))
    run = _run(2)
    # four shards of 0.25 and of 0.75 s; drains of 0.5 and 1.5 s
    assert _reader("mesh.feed_s").read(run) == pytest.approx(2.0)
    assert _reader("mesh.drain_s").read(run) == pytest.approx(1.0)


@pytest.mark.parametrize("name", MESH)
def test_nothing_read_without_the_mesh_spans(name, monkeypatch):
    """The one-device screen, a program without ``records`` or with fewer
    roots than the window's screens: no reading and no error."""
    p = _Plant()
    _one_device_screen(p)
    _one_device_screen(p)
    monkeypatch.setattr(profiling, "records", lambda: list(p.recs))
    run = _run(2)
    assert _reader(name).read(run) is None
    monkeypatch.delattr(profiling, "records")
    assert _reader(name).read(run) is None
    q = _Plant()
    _mesh_screen(q, 1.0)
    monkeypatch.setattr(profiling, "records", lambda: list(q.recs),
                        raising=False)
    assert _reader(name).read(run) is None
