"""The harness on the CPU at small sizes: each cell's run agrees with the
reference, the control and planted faults come out not correct, a cell
added as files is found, and the run command refuses without a card."""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from aat_bench import calibrate
from aat_bench import cell as cells
from aat_bench import harness, rehearse

CELLS = [w["name"] for w in cells.load_bench()["workloads"]]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("AAT_TORCH_DEVICE", "cpu")


@pytest.mark.parametrize("workload", CELLS)
def test_rehearsal_agrees_with_the_reference(workload):
    r = rehearse.rehearse(workload, 2**32 + 11, 0.5, traced=False)
    assert r["correct"], r
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert "setup_s" in r["metrics_read"]


@pytest.mark.parametrize("workload", CELLS)
def test_traced_rehearsal_reads_the_spans(workload):
    r = rehearse.rehearse(workload, 5, 0.5, traced=True)
    assert r["correct"], r
    c = cells.find(cells.load_bench(), workload)
    spans = [m["name"] for m in c.per_layer
             if m["name"].endswith("_s")]
    assert set(spans) <= set(r["metrics_read"])


def _small(workload):
    c = cells.find(cells.load_bench(), workload)
    gen = cells.load_module("generators", c.config["generator"])
    return c, *gen.small(c.config, c.traffic)


def _fails(checks, names):
    return any(checks[n]["value"] > checks[n]["limit"] for n in names)


def test_profile_control_fails():
    """The bfloat16 reference in the program's place, judged by the run's
    own comparison, is not correct."""
    r = rehearse.rehearse("scope40_1of16.hmap_profiles", 21, 0.5,
                          traced=False, control=True)
    assert not r["correct"]
    assert _fails(r["checks"], ["score_gap", "rank_gap"]), r["checks"]


def test_fasta_control_fails():
    """The bfloat16 reference in the program's place misranks hits once
    scores pass bfloat16's exact integers (256); a query of 1,200 against
    long templates gets there."""
    c, cfg, tr = _small("swissprot_1of8.cudasw_long")
    cfg = {**cfg, "lengths": {**cfg["lengths"], "median": 300, "max": 900},
           "n_templates": 16, "query_lengths": [1200]}
    tr = {**tr, "queries": [1200], "check": {**tr["check"], "sample": 1}}
    r = harness.run_cell(c, 23, 0.0, False, [torch.device("cpu")],
                         time.perf_counter(), config=cfg, traffic=tr,
                         control=True)
    assert not r["correct"]
    assert _fails(r["checks"], ["hit_mismatch"]), r["checks"]


def test_control_readings_match_the_run():
    """The calibration's control readings are the run's comparison."""
    c, cfg, tr = _small("scope40_1of16.hmap_profiles")
    got = calibrate.readings(c, 21, torch.device("cpu"), True, cfg, tr)
    assert got["kind"] == "control"
    assert set(got["readings"]) == set(tr["check"]["limits"])
    lim = tr["check"]["limits"]
    assert any(v > lim[n] for n, v in got["readings"].items())


def test_a_nan_score_is_not_correct():
    """A printed score that is not a number reads as an infinite gap."""
    entry = cells.load_module("entries", "aat_screen_profiles")
    ref = np.array([5.0, 3.0, 1.0])
    nan = float("nan")
    assert entry.gaps([(0, nan), (1, 3.0)], ref) == (np.inf, 0.0)
    assert entry.gaps([(0, 5.0), (1, 3.0)], ref) == (0.0, 0.0)
    assert entry.gaps([(0, 5.0)], np.array([nan, 3.0])) == (np.inf, np.inf)


def _half_left_out(fn):
    def broken(*args, **kwargs):
        out = fn(*args, **kwargs).clone()
        out[len(out) // 2:] = 0
        return out
    return broken


def _one_altered(fn):
    def broken(*args, **kwargs):
        out = fn(*args, **kwargs).clone()
        out[int(out.argmax())] += 3
        return out
    return broken


def _no_distance(fn):
    def broken(vrps):
        import numpy as np
        return np.zeros((len(vrps), len(vrps)), np.float32)
    return broken


def _nan_at_best(fn):
    def broken(*args, **kwargs):
        out = fn(*args, **kwargs).clone()
        out[int(out.argmax())] = float("nan")
        return out
    return broken


def _every_other_call(fn):
    calls = []

    def broken(*args, **kwargs):
        calls.append(1)
        out = fn(*args, **kwargs)
        return _one_altered(lambda: out)() if len(calls) % 2 else out
    return broken


FAULTS = [("swissprot_1of8.cudasw_short", "ops.swaffine", "sw_affine_scores",
           _half_left_out, ["hit_mismatch"]),
          ("swissprot_1of8.cudasw_short", "ops.swaffine", "sw_affine_scores",
           _one_altered, ["hit_mismatch"]),
          ("scope40_1of16.hmap_profiles", "ops.dp_scores", "dp_general_ragged",
           _half_left_out, ["score_gap", "rank_gap"]),
          ("scope40_1of16.hmap_profiles", "ops.dp_scores", "dp_general_ragged",
           _one_altered, ["score_gap", "rank_gap"]),
          ("scope40_1of16.hmap_profiles", "ops.dp_scores", "dp_general_ragged",
           _nan_at_best, ["score_gap", "rank_gap"]),
          ("swissprot_1of8.cudasw_short", "analysis.ali_dist", "area_matrix",
           _no_distance, ["cluster_mismatch"]),
          ("swissprot_1of8.cudasw_short", "ops.swaffine", "sw_affine_scores",
           _every_other_call, ["repeat_mismatch"])]


@pytest.mark.parametrize("workload,module,attr,fault,names", FAULTS)
def test_planted_fault_is_not_correct(monkeypatch, workload, module, attr,
                                      fault, names):
    import importlib
    mod = importlib.import_module("alignment_algos_tpu_torch." + module)
    monkeypatch.setattr(mod, attr, fault(getattr(mod, attr)))
    # long enough for a query to come round again (9 queries a cycle)
    r = rehearse.rehearse(workload, 31, 4.0, traced=False)
    assert not r["correct"]
    assert _fails(r["checks"], names), r["checks"]


def _add_cell(tmp_path, chips):
    """A copy of the benchmark with the cell ``tiny_lib.two`` of ``chips``
    cards added as files, its metric ``screens_done`` with it: (root,
    bench_dir)."""
    root = tmp_path / "checkout"
    bench_dir = root / "aat_bench"
    shutil.copytree(cells.BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = cells.load_bench()
    cfg = json.load(open(bench_dir / "configs" / "swissprot_1of8.json"))
    cfg["name"] = "tiny_lib"
    (bench_dir / "configs" / "tiny_lib.json").write_text(json.dumps(cfg))
    tr = json.load(open(bench_dir / "traffic" / "cudasw_short.json"))
    tr["queries"] = [144, 375]
    (bench_dir / "traffic" / "two_queries.json").write_text(json.dumps(tr))
    (bench_dir / "metrics" / "screens_done.py").write_text(
        "def read(run):\n    return float(len(run.screens))\n")
    bench["configs"].append({**bench["configs"][0], "name": "tiny_lib",
                             "file": "aat_bench/configs/tiny_lib.json"})
    bench["workloads"].append({"name": "tiny_lib.two", "config": "tiny_lib",
                               "traffic": "two_queries", "chips": chips,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "screens_done", "unit": "screens",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, bench_dir


def test_a_cell_added_as_files_is_found(tmp_path):
    """A new configuration, mix and metric, added as files in a copy; no
    file that was there is edited."""
    root, bench_dir = _add_cell(tmp_path, 1)
    r = rehearse.rehearse("tiny_lib.two", 3, 0.2, traced=False,
                          root=str(root), bench_dir=str(bench_dir))
    assert r["correct"]
    assert "screens_done" in r["metrics_read"]


def test_a_four_card_cell_added_as_files_is_found(tmp_path):
    """A cell on four cards, added as files alone, resolves with its
    ``chips`` and rehearses on the CPU like any other."""
    root, bench_dir = _add_cell(tmp_path, 4)
    c = cells.find(cells.load_bench(str(root)), "tiny_lib.two", str(root),
                   str(bench_dir))
    assert c.chips == 4
    r = rehearse.rehearse("tiny_lib.two", 3, 0.2, traced=True,
                          root=str(root), bench_dir=str(bench_dir))
    assert r["correct"]
    assert r["attempted"] >= 1 and r["failed"] == 0


def test_run_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the refusal is for a machine "
                    "without one")
    p = subprocess.run([sys.executable, "-m", "aat_bench.run", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=cells.ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_run_refuses_without_the_program(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's files
    gives no result."""
    shutil.copytree(cells.BENCH_DIR, tmp_path / "aat_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(cells.ROOT, "BENCHMARK.json"), tmp_path)
    p = subprocess.run([sys.executable, "-m", "aat_bench.run", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
