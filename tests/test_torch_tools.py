"""The port's alignment tools (``alignment_algos_tpu_torch/cli``) against
the compiled reference's goldens and the JAX package's tools.

``nalign`` and ``aaa`` are byte-equal to ``tests/golden`` (the compiled
reference's output); ``gn2``, ``nalign2``, ``gnoali``, ``S4_align`` and
``S4_one_ali`` are byte-equal to the reference tool run in the same
process on the host oracle (``core.dp.set_backend("numpy")``).  The port's
builds of 40 or more reach K7's plain version here (``AAT_TORCH_DEVICE=cpu``).
Each package reads the input files with its own classes.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from alignment_algos_tpu.cli import gn2 as rgn2
from alignment_algos_tpu.cli import gnoali as rgnoali
from alignment_algos_tpu.cli import nalign2 as rnalign2
from alignment_algos_tpu.cli import s4_align as rs4
from alignment_algos_tpu.cli import s4_one_ali as rs4one
from alignment_algos_tpu.core import dp as rdp
from alignment_algos_tpu_torch.cli import (aaa, gn2, gnoali, nalign, nalign2,
                                           s4_align, s4_one_ali)
from alignment_algos_tpu_torch.core import dp as tdp
from alignment_algos_tpu_torch.ops import dp_engine
from alignment_algos_tpu_torch.scoring import gn2_eval as tgn2_eval
from alignment_algos_tpu_torch.seq import hmap as thmap
from alignment_algos_tpu_torch.structure import smap as tsmap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
GOLD = os.path.join(ROOT, "tests", "golden")
INP = os.path.join(GOLD, "inputs")
BLOSUM = os.path.join(DATA, "BLOSUM62")


@pytest.fixture(autouse=True)
def host_env(monkeypatch):
    """No ~/.hmaprc (tests/test_parity.py does the same); the port on the
    CPU."""
    monkeypatch.setenv("HOME", "/tmp/nonexistent-home")
    monkeypatch.setenv("AAT_TORCH_DEVICE", "cpu")


def capture(main, argv, *args):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv, *args)
    assert rc == 0, err.getvalue()
    return out.getvalue()


@pytest.fixture
def k7_builds(monkeypatch):
    """Records the (rows, cols) of every build that reaches K7's
    wrapper."""
    seen = []
    wrapped = dp_engine.dp_forward_tb

    def spy(S, *a, **k):
        seen.append(tuple(S.shape[1:]))
        return wrapped(S, *a, **k)

    monkeypatch.setattr(dp_engine, "dp_forward_tb", spy)
    return seen


# tests/test_parity.py:102-119
NALIGN_CASES = {
    "nalign_opt": ["qA.prof", "tA.prof", "-opt"],
    "nalign_cw_default": ["qA.prof", "tA.prof",
                          "--DELTA_RATIO", "0.1", "--NUM_SUBOPT", "30"],
    "nalign_cw_flags": ["qA.prof", "tA.prof", "tA.flag",
                        "--DELTA_RATIO", "0.1", "--NUM_SUBOPT", "30"],
    "nalign_ucw": ["qA.prof", "tA.prof", "-ucw",
                   "--DELTA_RATIO", "0.05", "--NUM_SUBOPT", "30"],
    "nalign_B_opt": ["qB.prof", "tB.prof", "-opt"],
    "nalign_B_cw": ["qB.prof", "tB.prof",
                    "--DELTA_RATIO", "0.08", "--NUM_SUBOPT", "25"],
    "nalign_mode0": ["qA.prof", "tA.prof", "-opt", "--ALIGN_MODE", "0"],
    "nalign_mode1": ["qA.prof", "tA.prof", "-opt", "--ALIGN_MODE", "1"],
    "nalign_mode2": ["qA.prof", "tA.prof", "-opt", "--ALIGN_MODE", "2"],
    "nalign_pir": ["qA.prof", "tA.prof", "-opt", "--OUTPUT_FORMAT", "1"],
    "nalign_hmap": ["qA.prof", "tA.prof", "-opt", "--OUTPUT_FORMAT", "0",
                    "--SUB_MATRIX", BLOSUM],
}


def gold(name: str) -> str:
    with open(os.path.join(GOLD, name + ".out")) as f:
        return f.read()


@pytest.mark.parametrize("name", sorted(NALIGN_CASES))
def test_nalign_matches_reference_golden(name, k7_builds):
    argv = [os.path.join(INP, a) if a.endswith((".prof", ".flag")) else a
            for a in NALIGN_CASES[name]]
    assert capture(nalign.main, argv) == gold(name)
    assert k7_builds and all(max(s) >= tdp.AUTO_MIN_SIZE for s in k7_builds)


@pytest.mark.parametrize("pair,mode,tag", [(0, 1, "cw"), (1, 3, "opt"),
                                           (2, 4, "cw"), (3, 0, "opt")])
def test_aaa_matches_reference_golden(pair, mode, tag, k7_builds):
    argv = [os.path.join(INP, f"aaa_pair{pair}.fa"), "--SUB_MATRIX", BLOSUM,
            "--ALIGN_MODE", str(mode), "--DELTA_RATIO", "0.25",
            "--NUM_SUBOPT", "20"] + (["-opt"] if tag == "opt" else [])
    out = capture(aaa.main, argv)
    # the timing lines vary run to run (tests/test_parity.py:40-43)
    out = "\n".join(l for l in out.splitlines()
                    if not l.startswith(("time for alignment",
                                         "total cpu time"))) + "\n"
    assert out == gold(f"aaa_p{pair}_m{mode}_{tag}")
    # the default gaps 4.73/0.34 fail dp_affine's exactness gate, so pairs
    # of 40 or more reach K7; pair 0 is shorter and stays on dp_ref
    assert bool(k7_builds) == (pair != 0)


REAL = [os.path.join(DATA, "query_real.prof"),
        os.path.join(DATA, "templ_real.prof")]
BIG_S4 = [os.path.join(DATA, "templ_big.prof"),
          os.path.join(DATA, "query_big.prof")]
TOOL_CASES = {
    "gn2_default": (gn2.main, rgn2.main, REAL, ()),
    "gn2_crcw": (gn2.main, rgn2.main, REAL + ["-crcw"], ()),
    "gn2_crcw_rounds3": (gn2.main, rgn2.main,
                         REAL + ["-crcw", "--ROUNDS", "3"], ()),
    "gn2_opt_hmap": (gn2.main, rgn2.main,
                     REAL + ["-opt", "--OUTPUT_FORMAT", "0"], ()),
    "nalign2_crcw": (nalign2.main, rnalign2.main, REAL + ["-crcw"], ()),
    "gnoali": (gnoali.main, rgnoali.main, REAL, ()),
    "s4_align": (s4_align.main, rs4.main, BIG_S4 + ["--max_returned", "3"],
                 (False,)),
    "s4_align_gn2": (s4_align.main, rs4.main,
                     BIG_S4 + ["--max_returned", "2"], (True,)),
    "s4_one_ali": (s4_one_ali.main, rs4one.main,
                   BIG_S4[::-1] + ["--best", "1"], ()),
}


@pytest.fixture
def reference_on_host():
    """The reference tools on the host oracle, restored afterwards."""
    before = rdp._BACKEND
    rdp.set_backend("numpy")
    yield
    rdp.set_backend(before)


@pytest.mark.parametrize("case", sorted(TOOL_CASES))
def test_tool_byte_equal_to_reference(case, k7_builds, reference_on_host):
    port_main, ref_main, argv, extra = TOOL_CASES[case]
    got = capture(port_main, argv, *extra)
    assert k7_builds, "no build reached K7"
    want = capture(ref_main, argv, *extra)
    assert got == want and got.strip()


def test_gn2_crcw_rebuilds_once_per_round(k7_builds):
    """-crcw: the first build, then one K7 build per round's
    ``dpm.reevaluate()`` (gn2.py:142-147)."""
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err):
        assert gn2.main(REAL + ["-crcw", "--ROUNDS", "3"]) == 0
    rounds = sum(l.startswith("ROUND ") for l in err.getvalue().splitlines())
    assert rounds >= 1 and len(k7_builds) == 1 + rounds


def test_dpmatrix_matches_reference_dpmatrix():
    """The port's DPMatrix (K7's plain version) against the reference's
    (the JAX engine) on the real-scale gn2 pair, each on its own package's
    sequences and evaluator: forward, reevaluate, reverse and a
    sub-rectangle."""
    from alignment_algos_tpu.scoring.gn2_eval import Gn2Eval, Gn2Params
    from alignment_algos_tpu.seq.hmap import HMAPSequence
    from alignment_algos_tpu.structure.smap import SMAPSequence
    r_args = (HMAPSequence.from_file(REAL[0]),
              SMAPSequence.from_file(REAL[1], gn2=True), Gn2Eval(Gn2Params()))
    t_args = (thmap.HMAPSequence.from_file(REAL[0]),
              tsmap.SMAPSequence.from_file(REAL[1], gn2=True),
              tgn2_eval.Gn2Eval(tgn2_eval.Gn2Params()))
    for kw in ({}, {"direction": tdp.REV},
               {"sub_bounds": (30, 41, 120, 160)}):
        mine = tdp.DPMatrix(*t_args, **kw)
        ref = rdp.DPMatrix(*r_args, **kw)
        for name in ("H", "PQ", "PT"):
            np.testing.assert_array_equal(getattr(mine.res, name),
                                          getattr(ref.res, name))
    mine.reevaluate()
    np.testing.assert_array_equal(mine.res.PQ, ref.res.PQ)
    assert mine.get_cell(100, 91) == ref.get_cell(100, 91)


def test_backend_routing(monkeypatch, k7_builds):
    """auto: K7 from a side of 40; torch: always; numpy: never; any other
    name raises."""
    query = thmap.HMAPSequence.from_file(os.path.join(DATA, "query30.prof"))
    templ = tsmap.SMAPSequence.from_file(
        os.path.join(DATA, "templ_smap.prof"), gn2=True)
    ev = tgn2_eval.Gn2Eval(tgn2_eval.Gn2Params())
    monkeypatch.setattr(tdp, "_backend", "auto")
    small = tdp.DPMatrix(query, templ, ev)
    assert max(small.costs.S.shape) < tdp.AUTO_MIN_SIZE and k7_builds == []
    tdp.set_backend("torch")
    on_k7 = tdp.DPMatrix(query, templ, ev)
    assert k7_builds == [small.costs.S.shape]
    for name in ("H", "PQ", "PT"):
        np.testing.assert_array_equal(getattr(on_k7.res, name),
                                      getattr(small.res, name))
    tdp.set_backend("numpy")
    tdp.DPMatrix(query, templ, ev)
    assert len(k7_builds) == 1
    with pytest.raises(ValueError):
        tdp.set_backend("jax")
    monkeypatch.setattr(tdp, "_backend", "jax")
    with pytest.raises(ValueError):
        tdp.DPMatrix(query, templ, ev)


def test_cli_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setenv("AAT_TORCH_DEVICE", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = nalign.main([os.path.join(INP, "qA.prof"),
                          os.path.join(INP, "tA.prof"), "-opt"])
    assert rc != 0 and out.getvalue() == ""
    assert "AAT_TORCH_DEVICE" in err.getvalue()



# ------------------------------------------------ the host-only tools

@pytest.fixture(scope="module")
def shift_inputs(tmp_path_factory):
    """tests/test_cli_tools.py:63-95's inputs: a PIR batch of suboptimal
    alignments from ``aaa`` and the first of them as the native gapped
    FASTA alignment."""
    from alignment_algos_tpu_torch.io.pir import read_pir
    d = tmp_path_factory.mktemp("shifts")
    fa = d / "seqs.fa"
    fa.write_text("> templ\nHEAGAWGHEEHEAGAWGHEE\n> query\n"
                  "PAWHEAEPAWHEAE\n\n")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HOME", "/tmp/nonexistent-home")
        mp.setenv("AAT_TORCH_DEVICE", "cpu")
        out = capture(aaa.main, [str(fa), "--SUB_MATRIX", BLOSUM,
                                 "--ALIGN_MODE", "1", "--OUTPUT_FORMAT", "1",
                                 "--DELTA_RATIO", "0.3", "--NUM_SUBOPT",
                                 "6"])
    pir = d / "batch.pir"
    pir.write_text(out[out.index("#start"):out.rindex("#end") + 4] + "\n")
    with open(pir) as f:
        first = read_pir(f)
    t = first.get_templ_string("^HEAGAWGHEEHEAGAWGHEE$")[1:-1]
    q = first.get_query_string("^PAWHEAEPAWHEAE$")[1:-1]
    nat = d / "native.fa"
    nat.write_text(f"> t\n{t}\n> q\n{q}\n")
    return str(pir), str(nat)


@pytest.fixture(scope="module")
def cn_acc_alignment(tmp_path_factory):
    """tests/test_cli_tools.py:42-60's ungapped overlay of the SMAP
    fixture and query30."""
    smap = tsmap.SMAPSequence.from_file(
        os.path.join(DATA, "templ_smap.prof"), gn2=False)
    hmap = thmap.HMAPSequence.from_file(os.path.join(DATA, "query30.prof"))
    t, q = smap.get_string()[1:-1], hmap.get_string()[1:-1]
    width = max(len(t), len(q))
    fa = tmp_path_factory.mktemp("cn_acc") / "ali.fa"
    fa.write_text(f"> t\n{t.ljust(width, '-')}\n> q\n{q.ljust(width, '-')}"
                  "\n\n")
    return str(fa)


@pytest.mark.parametrize("tool", ["test_0", "cn_acc_analys", "get_shifts",
                                  "get_area_diffs"])
def test_host_tool_byte_equal_to_jax(tool, shift_inputs, cn_acc_alignment):
    import importlib
    port = importlib.import_module(f"alignment_algos_tpu_torch.cli.{tool}")
    ref = importlib.import_module(f"alignment_algos_tpu.cli.{tool}")
    argv = {
        "test_0": ["--GAP_INIT_PENALTY", "9.5", "-a", "x", "foo"],
        "cn_acc_analys": [cn_acc_alignment,
                          os.path.join(DATA, "templ_smap.prof"),
                          os.path.join(DATA, "query30.prof")],
        "get_shifts": list(shift_inputs),
        "get_area_diffs": list(shift_inputs),
    }[tool]
    got = capture(port.main, list(argv))
    assert got == capture(ref.main, list(argv))
    assert len(got.splitlines()) >= 6
    if tool == "get_shifts":
        assert "Cummulative statistics" in got


def test_host_tools_refuse_cuda_without_a_card(shift_inputs, monkeypatch):
    from alignment_algos_tpu_torch.cli import get_shifts
    monkeypatch.setenv("AAT_TORCH_DEVICE", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = get_shifts.main(list(shift_inputs))
    assert rc != 0 and out.getvalue() == ""


# tests/test_kmedoid_oracle.py's cases: (matrix seed, points, clusterer
# seed, k, mode, argument)
KMEDOID_CASES = [
    (0, 15, 1, 2, "sa", 0.5), (0, 15, 12345, 3, "sa", 0.3),
    (0, 15, 7, 2, "fgc", 5), (0, 15, 99, 4, "fgc", 3),
    (1, 24, 42, 5, "fgc", 10), (1, 24, 8, 3, "sa", 0.8),
    (2, 40, 17, 4, "sa", 0.6), (2, 40, 2026, 6, "fgc", 6),
    (3, 9, 555, 2, "sa", 2.0),
]


def _kmedoids_output(mod, d, seed, k, mode, arg) -> str:
    """tests/test_kmedoid_oracle.py's rendering of one clustering."""
    km = mod.KMedoidClusterer(mod.ClusterSet(np.tril(d)), k, seed=seed)
    res = (km.simulated_annealing(arg) if mode == "sa"
           else km.find_good_clustering(int(arg)))
    return "\n".join(
        f"{r[0]}:" + ("" if len(r) == 1 else " " + " ".join(map(str, r[1:])))
        for r in res) + "\n"


@pytest.mark.parametrize("mseed,n,seed,k,mode,arg", KMEDOID_CASES)
def test_kmedoids_equal_jax(mseed, n, seed, k, mode, arg):
    from alignment_algos_tpu.analysis import kmedoids as rkm
    from alignment_algos_tpu_torch.analysis import kmedoids as tkm
    rng = np.random.default_rng(mseed)
    centers = rng.uniform(0, 8, (3, 2))
    pts = np.concatenate([rng.normal(c, 0.4, (n // 3 + 1, 2))
                          for c in centers])[:n]
    d = np.linalg.norm(pts[:, None] - pts[None, :], axis=-1).astype(
        np.float32)
    got = _kmedoids_output(tkm, d, seed, k, mode, arg)
    assert got == _kmedoids_output(rkm, d, seed, k, mode, arg)
    assert got.strip()


def test_glibc_rand_replica():
    """utils/crand against the host glibc outputs of
    tests/test_kmedoid_oracle.py."""
    from alignment_algos_tpu_torch.utils.crand import GlibcRandom
    golden = {1: [1804289383, 846930886, 1681692777],
              12345: [383100999, 858300821, 357768173],
              999999999: [1477763614, 681512474, 778291828]}
    for seed, want in golden.items():
        g = GlibcRandom(seed)
        assert [g.rand() for _ in range(3)] == want
