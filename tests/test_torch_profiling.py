"""The port's profiling hooks (``utils/profiling``, on ``torch.profiler``)
mirroring tests/test_profiling.py, and the whole-process trace a port
tool writes under ``AAT_TRACE_DIR`` (``utils.torchenv.maybe_start_trace``)
in a fresh interpreter that never imports jax."""

from __future__ import annotations

import ast
import glob
import json
import os
import subprocess
import sys

import torch

from alignment_algos_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")


def _traces(logdir: str) -> list:
    return sorted(glob.glob(os.path.join(logdir, "*.pt.trace.json")))


def test_trace_writes_artifacts(tmp_path):
    logdir = str(tmp_path / "trace")
    with profiling.maybe_trace(logdir) as d:
        assert d == logdir
        with profiling.annotate("unit_region"):
            x = torch.sum(torch.arange(128.0) * 2)
    assert float(x) == 16256.0
    files = _traces(logdir)
    assert len(files) == 1, files
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "unit_region" in names


def test_trace_noop_without_dir(monkeypatch, tmp_path):
    monkeypatch.delenv("AAT_TRACE_DIR", raising=False)
    with profiling.maybe_trace() as d:
        assert d is None


def test_cups_math_and_stopwatch():
    assert profiling.cups(1000, 0.5) == 2000.0
    assert profiling.cups(1, 0.0) == float("inf")
    for sw in (profiling.Stopwatch(), profiling.Stopwatch("cpu")):
        rate = sw.cups(10 ** 6)
        # the rate is cells over the stopwatch's own elapsed reading
        assert 0 < sw.seconds() < 5.0
        assert rate > 0


def test_tool_trace_in_a_fresh_process(tmp_path):
    """A port tool run with AAT_TRACE_DIR writes its whole-process trace at
    exit, with the tool's output unchanged, and loads no jax."""
    logdir = str(tmp_path / "trace")
    code = ("import sys\n"
            "from alignment_algos_tpu_torch.cli import get_area_diffs\n"
            "rc = get_area_diffs.main(sys.argv[1:])\n"
            "print('LOADED', sorted(m for m in sys.modules if m == 'jax'\n"
            "      or m.startswith(('jax.', 'jaxlib', 'alignment_algos_tpu.'))"
            "\n      or m == 'alignment_algos_tpu'))\n"
            "sys.exit(rc)\n")
    # a PIR batch of one alignment against itself as the native one
    pir = tmp_path / "one.pir"
    pir.write_text(">P1;templ\nstructure:templ\nHEAGAWGHEE*\n"
                   ">P1;query\nsequence:query\nHEAGAWGHEE*\n")
    nat = tmp_path / "native.fa"
    nat.write_text("> t\nHEAGAWGHEE\n> q\nHEAGAWGHEE\n")
    env = dict(os.environ, AAT_TORCH_DEVICE="cpu", AAT_TRACE_DIR=logdir,
               HOME="/tmp/nonexistent-home",
               PYTHONPATH=os.pathsep.join([ROOT,
                                           os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", code, str(pir), str(nat)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    out, _, loaded = proc.stdout.rpartition("LOADED ")
    assert ast.literal_eval(loaded.strip()) == []
    assert "Rank of closest:" in out
    files = _traces(logdir)
    assert len(files) == 1 and "_process_" in files[0], files
    with open(files[0]) as f:
        assert json.load(f)["traceEvents"]
