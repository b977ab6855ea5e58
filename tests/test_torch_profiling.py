"""The port's tracing (``utils/profiling``, on ``torch.profiler``): spans
and counters that record only under a recording profiler, nest through
their parents and match the profiler's own ``aat.`` ranges; the span tree
an ``aat_screen`` call leaves in FASTA and ``--profiles 1`` mode; and the
whole-process trace a port tool writes under ``AAT_TRACE_DIR``
(``utils.torchenv.maybe_start_trace``) in a fresh interpreter that never
imports jax."""

from __future__ import annotations

import ast
import contextlib
import glob
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from alignment_algos_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
BLOSUM = os.path.join(DATA, "BLOSUM62")
AA = "ARNDCQEGHILKMFPSTWYV"


def _traces(logdir: str) -> list:
    return sorted(glob.glob(os.path.join(logdir, "*.pt.trace.json")))


def _profiler():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _refuse(*args, **kwargs):
    raise AssertionError("called while no span should call it")


def _new(before: int) -> list:
    return profiling.records()[before:]


def _edges(recs) -> set:
    """(name, parent's name) of every record; a root's parent is None."""
    by_id = {r.id: r for r in recs}
    return {(r.name, by_id[r.parent].name if r.parent in by_id else None)
            for r in recs}


def _one(recs, name):
    got = [r for r in recs if r.name == name]
    assert len(got) == 1, (name, [r.name for r in recs])
    return got[0]


def test_span_off_records_nothing_and_opens_no_range(monkeypatch):
    assert not profiling.recording()
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", _refuse)
    before = len(profiling.records())
    a, b = profiling.span("off.a", n=1), profiling.span("off.b")
    assert a is b
    with a:
        with b:
            profiling.count("n", 3)
    assert len(profiling.records()) == before
    monkeypatch.undo()
    with _profiler() as prof:
        pass
    assert not [e for e in prof.events() if e.name.startswith("aat.")]


def test_spans_nest_through_parent_and_counts_stay_on_their_span(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", _refuse)
    before = len(profiling.records())
    with _profiler():
        with profiling.span("outer", preset=1):
            profiling.count("n", 2)
            with profiling.span("inner"):
                profiling.count("n", 5)
                profiling.count("m", 1)
            profiling.count("n", 1)
        with pytest.raises(ValueError):
            with profiling.span("raises"):
                raise ValueError
        with profiling.span("after"):
            pass
    outer, inner, raises, after = _new(before)
    assert [r.name for r in (outer, inner, raises, after)] == [
        "outer", "inner", "raises", "after"]
    assert outer.parent is None and inner.parent == outer.id
    assert raises.parent is None and after.parent is None
    assert outer.counts == {"preset": 1, "n": 3}
    assert inner.counts == {"n": 5, "m": 1}
    assert raises.end is not None and after.counts == {}
    assert outer.start <= inner.start <= inner.end <= outer.end
    # records() hands out what it kept and keeps it
    assert profiling.records()[before:] == [outer, inner, raises, after]


def test_every_record_is_a_profiler_range_of_the_same_nesting():
    before = len(profiling.records())
    with _profiler() as prof:
        with profiling.span("a"):
            time.sleep(0.004)
            with profiling.span("a.b"):
                torch.ones(64).cumsum(0)
                time.sleep(0.003)
            with profiling.span("a.c"):
                time.sleep(0.002)
        with profiling.span("d"):
            time.sleep(0.001)
    recs = _new(before)
    events = sorted((e for e in prof.events() if e.name.startswith("aat.")),
                    key=lambda e: e.time_range.start)
    assert [e.name for e in events] == ["aat." + r.name for r in recs]

    def enclosing(i):
        e = events[i]
        around = [j for j, o in enumerate(events) if j != i
                  and o.time_range.start <= e.time_range.start
                  and e.time_range.end <= o.time_range.end]
        return max(around, key=lambda j: events[j].time_range.start,
                   default=None)

    index = {r.id: i for i, r in enumerate(recs)}
    for i, r in enumerate(recs):
        assert enclosing(i) == index.get(r.parent), r.name
        assert abs(events[i].time_range.elapsed_us() / 1e6
                   - r.seconds) < 1e-3, r.name


@pytest.fixture(scope="module")
def fastas(tmp_path_factory):
    rng = np.random.default_rng(11)
    d = tmp_path_factory.mktemp("span_fastas")

    def rseq(n):
        return "".join(AA[i] for i in rng.integers(0, 20, n))

    q = rseq(60)
    (d / "q.fa").write_text(f">query\n{q}\n")
    lib = [rseq(int(n)) for n in rng.integers(30, 90, 12)]
    lib[3] = lib[3][:5] + q[5:50] + lib[3][50:]
    (d / "lib.fa").write_text("".join(f">t{i}\n{s}\n"
                                      for i, s in enumerate(lib)))
    return str(d / "q.fa"), str(d / "lib.fa"), len(q), lib


@pytest.fixture(scope="module")
def profile_lib(tmp_path_factory):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_profiles import make_profile
    rng = np.random.default_rng(5)
    d = tmp_path_factory.mktemp("span_profiles")
    (d / "lib").mkdir()
    (d / "q.prof").write_text(make_profile(rng, "qry", 40))
    for i, n in enumerate((40, 40, 52, 40)):
        (d / "lib" / f"t{i}.prof").write_text(make_profile(rng, f"t{i}", n))
    return str(d / "q.prof"), str(d / "lib")


def _screen(argv, traced: bool):
    from alignment_algos_tpu_torch.cli import screen
    out = io.StringIO()
    with contextlib.ExitStack() as stack:
        if traced:
            stack.enter_context(_profiler())
        with contextlib.redirect_stdout(out):
            rc = screen.main(list(argv))
    assert rc == 0
    return out.getvalue()


def _fasta_argv(fastas):
    return [fastas[0], fastas[1], "--SUB_MATRIX", BLOSUM, "--top_k", "4"]


def _profile_argv(profile_lib):
    return [profile_lib[0], profile_lib[1], "--profiles", "1", "--top_k",
            "3"]


FASTA_TREE = {
    ("aat_screen", None),
    ("fasta.read_inputs", "aat_screen"), ("fasta.read", "fasta.read_inputs"),
    ("fasta.encode", "fasta.read_inputs"),
    ("screen.library", "aat_screen"), ("to_device", "screen.library"),
    ("to_device.layout", "to_device"), ("to_device.copy", "to_device"),
    ("k1", "screen.library"), ("k1.check", "k1"),
    ("screen.topk", "screen.library"),
    ("cluster", "aat_screen"), ("to_device", "cluster"), ("k2", "cluster"),
    ("k8", "cluster"), ("cluster.paths", "cluster"),
    ("cluster.area", "cluster"), ("cluster.upgma", "cluster")}


def test_fasta_screen_leaves_its_span_tree(fastas, monkeypatch):
    monkeypatch.setenv("AAT_TORCH_DEVICE", "cpu")
    before = len(profiling.records())
    _screen(_fasta_argv(fastas), traced=True)
    recs = _new(before)
    assert _edges(recs) == FASTA_TREE
    qlen, lib = fastas[2], fastas[3]
    n, tmax = len(lib), max(map(len, lib))
    assert _one(recs, "fasta.encode").counts == {
        "residues": sum(map(len, lib))}
    assert _one(recs, "k1").counts == {"q": qlen, "cells": qlen * tmax * n}
    # one device, no mesh
    assert _one(recs, "aat_screen").counts == {"cards": 1}
    # no other span counts anything; no card, so no bytes copied to one
    assert all(not r.counts for r in recs
               if r.name not in ("aat_screen", "fasta.encode", "k1")), recs


MESH_TREE = {
    ("screen.library", None), ("mesh.shard", "screen.library"),
    ("to_device", "mesh.shard"), ("to_device.layout", "to_device"),
    ("to_device.copy", "to_device"), ("k1", "mesh.shard"),
    ("k1.check", "k1"), ("mesh.drain", "screen.library"),
    ("screen.topk", "mesh.drain"), ("mesh.merge", "mesh.drain")}


def _mesh_inputs():
    rng = np.random.default_rng(8)
    q = rng.integers(0, 20, 30).astype(np.int32)
    lib = np.full((23, 48), 20, np.int32)
    for r, m in enumerate(rng.integers(12, 48, 23)):
        lib[r, :m] = rng.integers(0, 20, m)
    table = np.full((21, 21), -1.0e4, np.float32)
    table[:20, :20] = rng.integers(-4, 11, (20, 20))
    return q, lib, table


def test_mesh_screen_spans_each_shard_and_the_drain(monkeypatch):
    """On a mesh of four CPU entries: one ``mesh.shard`` a shard (the
    feed: its copy and K1), counting its entry and its templates, then one
    ``mesh.drain`` holding the pull and the host merge; no span
    synchronizes."""
    from alignment_algos_tpu_torch.parallel import screen
    monkeypatch.setattr(torch.cuda, "synchronize", _refuse)
    q, lib, table = _mesh_inputs()
    before = len(profiling.records())
    with _profiler():
        got = screen.screen_library(q, lib, table, 11.0, 1.0, k=5,
                                    mesh=screen.default_mesh(4, device="cpu"))
    recs = _new(before)
    assert _edges(recs) == MESH_TREE
    shards = [r for r in recs if r.name == "mesh.shard"]
    assert [r.counts["card"] for r in shards] == [0, 1, 2, 3]
    assert sum(r.counts["templates"] for r in shards) == len(lib)
    assert [r.counts["templates"] for r in shards] == [
        hi - lo for lo, hi in screen.shard_bounds(len(lib), 4)]
    drain, merge = _one(recs, "mesh.drain"), _one(recs, "mesh.merge")
    assert merge.parent == drain.id
    assert drain.start >= max(r.end for r in shards)
    assert not drain.counts and not merge.counts
    # the one-device screen keeps its own spans, and no mesh span
    before = len(profiling.records())
    with _profiler():
        one = screen.screen_library(q, lib, table, 11.0, 1.0, k=5,
                                    device="cpu")
    assert _edges(_new(before)) == {
        ("screen.library", None), ("to_device", "screen.library"),
        ("to_device.layout", "to_device"), ("to_device.copy", "to_device"),
        ("k1", "screen.library"), ("k1.check", "k1"),
        ("screen.topk", "screen.library")}
    for a, b in zip(got, one):
        np.testing.assert_array_equal(a, b)


def test_mesh_screen_records_nothing_off_the_profiler(monkeypatch):
    from alignment_algos_tpu_torch.parallel import screen
    q, lib, table = _mesh_inputs()
    before = len(profiling.records())
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", _refuse)
    screen.screen_library(q, lib, table, 11.0, 1.0, k=5,
                          mesh=screen.default_mesh(4, device="cpu"))
    assert len(profiling.records()) == before


def test_profile_screen_counts_its_rows(profile_lib, monkeypatch):
    monkeypatch.setenv("AAT_TORCH_DEVICE", "cpu")
    before = len(profiling.records())
    _screen(_profile_argv(profile_lib), traced=True)
    recs = _new(before)
    assert _edges(recs) == {
        ("aat_screen", None), ("profile.read", "aat_screen"),
        ("hmap.screen", "aat_screen"), ("hmap.pack", "hmap.screen"),
        ("hmap.copy", "hmap.screen"), ("hmap.query", "hmap.screen"),
        ("k5", "hmap.screen"), ("k6", "hmap.screen"), ("k3", "hmap.screen"),
        ("hmap.pull", "hmap.screen")}
    from alignment_algos_tpu_torch.seq.hmap import HMAPSequence
    rows = sum(HMAPSequence.from_file(fn).size() for fn in [
        profile_lib[0], *glob.glob(os.path.join(profile_lib[1], "*.prof"))])
    assert _one(recs, "profile.read").counts == {"rows": rows}
    assert all(not r.counts for r in recs if r.name != "profile.read")
    # one pack and one copy of the whole library, however many buckets
    names = [r.name for r in recs]
    assert (names.count("hmap.pack"), names.count("hmap.copy")) == (1, 1)


@pytest.mark.parametrize("mode", ["fasta", "profiles"])
def test_screen_prints_the_same_with_and_without_a_profiler(
        mode, fastas, profile_lib, monkeypatch):
    monkeypatch.setenv("AAT_TORCH_DEVICE", "cpu")
    argv = (_fasta_argv(fastas) if mode == "fasta"
            else _profile_argv(profile_lib))
    plain = _screen(argv, traced=False)
    assert "# rank" in plain
    assert _screen(argv, traced=True) == plain


def _run_fresh(code: str, args: list, logdir: str):
    env = dict(os.environ, AAT_TORCH_DEVICE="cpu", AAT_TRACE_DIR=logdir,
               HOME="/tmp/nonexistent-home",
               PYTHONPATH=os.pathsep.join([ROOT,
                                           os.environ.get("PYTHONPATH", "")]))
    code += ("print('LOADED', sorted(m for m in sys.modules if m == 'jax'\n"
             "      or m.startswith(('jax.', 'jaxlib', "
             "'alignment_algos_tpu.'))\n"
             "      or m == 'alignment_algos_tpu'))\n"
             "sys.exit(rc)\n")
    proc = subprocess.run([sys.executable, "-c", code, *args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    out, _, loaded = proc.stdout.rpartition("LOADED ")
    assert ast.literal_eval(loaded.strip()) == []
    files = _traces(logdir)
    assert len(files) == 1 and "_process_" in files[0], files
    with open(files[0]) as f:
        return out, json.load(f)["traceEvents"]


def test_tool_trace_in_a_fresh_process(tmp_path):
    """A port tool run with AAT_TRACE_DIR writes its whole-process trace at
    exit, with the tool's output unchanged, and loads no jax."""
    # a PIR batch of one alignment against itself as the native one
    pir = tmp_path / "one.pir"
    pir.write_text(">P1;templ\nstructure:templ\nHEAGAWGHEE*\n"
                   ">P1;query\nsequence:query\nHEAGAWGHEE*\n")
    nat = tmp_path / "native.fa"
    nat.write_text("> t\nHEAGAWGHEE\n> q\nHEAGAWGHEE\n")
    out, events = _run_fresh(
        "import sys\n"
        "from alignment_algos_tpu_torch.cli import get_area_diffs\n"
        "rc = get_area_diffs.main(sys.argv[1:])\n",
        [str(pir), str(nat)], str(tmp_path / "trace"))
    assert "Rank of closest:" in out
    assert events


def test_screen_trace_in_a_fresh_process_holds_its_spans(fastas, tmp_path):
    """``aat_screen`` under AAT_TRACE_DIR: the whole-process trace holds
    the program's ranges, ``aat.aat_screen`` around the others."""
    out, events = _run_fresh(
        "import sys\n"
        "from alignment_algos_tpu_torch.cli import screen\n"
        "rc = screen.main(sys.argv[1:])\n",
        _fasta_argv(fastas), str(tmp_path / "trace"))
    assert "cluster 1:" in out
    ranges = {e["name"]: e for e in events
              if e.get("name", "").startswith("aat.")}
    assert {"aat." + name for name, _ in FASTA_TREE} == set(ranges)
    root, k1 = ranges["aat.aat_screen"], ranges["aat.k1"]
    assert root["ts"] <= k1["ts"]
    assert k1["ts"] + k1["dur"] <= root["ts"] + root["dur"]


def test_span_trace_tool_splits_idle_by_range_and_checks_kernels():
    """``tools/torch_span_trace.summarize`` on a planted trace: a gap that
    crosses two ranges is split at their edge, a kernel counts for the
    range that launched it, and one drawn under another device-side range
    counts as misplaced."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from torch_span_trace import summarize

    def x(name, ts, dur, cat, corr=None):
        e = {"ph": "X", "name": name, "ts": ts * 1e6, "dur": dur * 1e6,
             "cat": cat}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    events = [x("aat.aat_screen", 0, 10, "user_annotation"),
              x("aat.read", 0, 4, "user_annotation"),
              x("aat.k1", 4, 5, "user_annotation"),
              x("cudaLaunchKernel", 4.5, 0.1, "cuda_runtime", 1),
              x("cudaLaunchKernel", 5.5, 0.1, "cuda_runtime", 2),
              x("aat.k1", 5, 3, "gpu_user_annotation"),
              x("sw_scores_kernel", 5, 2, "kernel", 1),
              x("aat.read", 7.5, 1, "gpu_user_annotation"),
              x("other_kernel", 7.5, 1, "kernel", 2)]
    s = summarize(events)
    assert s["busy_s"] == pytest.approx(3.0)
    # idle 0-5 (4 s in read, 1 s in k1), 7-7.5 (k1), 8.5-10 (0.5 s in k1,
    # then 1 s in the root alone)
    assert s["idle_by_range"] == pytest.approx(
        {"read": 4.0, "k1": 2.0, "aat_screen": 1.0})
    assert s["device_by_range"] == pytest.approx({"k1": 3.0})
    assert (s["misplaced"], s["unmatched"], s["device_ops"]) == (1, 0, 2)
