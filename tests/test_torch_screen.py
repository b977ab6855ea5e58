"""The port's library screen, checkpointed screen and ``aat_screen`` CLI
against the JAX package: equal indices and scores (ties included), and
byte-equal CLI output (FASTA, --profiles 1 and --smap 1 modes) on the
tests/test_screen_cli.py fixture recipes.  (The subprocess runs that show
the port loads neither jax nor the JAX package are in
tests/test_torch_isolation.py.)"""

import io
import os
import sys

import numpy as np
import pytest
import torch

from alignment_algos_tpu.parallel import screen as jscreen
from alignment_algos_tpu_torch.parallel import screen
from alignment_algos_tpu_torch.parallel.checkpoint import (
    screen_library_checkpointed)

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOSUM = os.path.join(ROOT, "tests", "data", "BLOSUM62")
AA = "ARNDCQEGHILKMFPSTWYV"


@pytest.fixture(scope="module")
def library():
    """A pad-walled library with duplicate templates (score ties)."""
    rng = np.random.default_rng(0)
    q = rng.integers(0, 20, 48).astype(np.int32)
    lib = rng.integers(0, 20, (37, 56)).astype(np.int32)
    for r, n in enumerate(rng.integers(20, 56, 37)):
        lib[r, n:] = 20
    lib = np.concatenate([lib[:5], lib[:5], lib[5:]], axis=0)
    table = np.full((21, 21), -1.0e4, np.float32)
    table[:20, :20] = rng.integers(-4, 11, (20, 20))
    return q, lib, table


@pytest.mark.parametrize("k", [12, 42])                # 42: every template
@pytest.mark.parametrize("gi,ge", [(11.0, 1.0), (4.73, 0.34)])
def test_screen_library_equals_jax(library, gi, ge, k):
    q, lib, table = library
    s, i = screen.screen_library(q, lib, table, gi, ge, k=k, device=CPU)
    assert s.dtype == np.float32 and i.dtype == np.int32 and len(i) == k
    s_mesh, i_mesh = jscreen.screen_library(
        q, lib, table, gi, ge, k=k, mesh=jscreen.default_mesh(8))
    s_host, i_host = jscreen.screen_library_host(q, lib, table, gi, ge, k=k)
    for js, ji in ((s_mesh, i_mesh), (s_host, i_host)):
        np.testing.assert_array_equal(i, ji)
        np.testing.assert_array_equal(s, js)
    if k == len(lib):   # the duplicated templates tie; lower index first
        pos = {int(x): n for n, x in enumerate(i)}
        for r in range(5):
            assert pos[r] < pos[r + 5] and s[pos[r]] == s[pos[r + 5]]
    s_ref, i_ref = screen.screen_library_host(q, lib, table, gi, ge, k=k)
    np.testing.assert_array_equal(i_ref, i)
    np.testing.assert_array_equal(s_ref, s)


def test_checkpointed_screen_resumes_to_direct(library, tmp_path):
    q, lib, table = library
    ck = str(tmp_path / "state.npz")
    s, i, done = screen_library_checkpointed(
        q, lib, table, 4.73, 0.34, k=9, chunk_size=8, ckpt_path=ck,
        max_chunks=2, device=CPU)
    assert not done
    s, i, done = screen_library_checkpointed(
        q, lib, table, 4.73, 0.34, k=9, chunk_size=8, ckpt_path=ck,
        device=CPU)
    assert done
    s_ref, i_ref = screen.screen_library(q, lib, table, 4.73, 0.34, k=9,
                                         device=CPU)
    np.testing.assert_array_equal(i, i_ref)
    np.testing.assert_array_equal(s, s_ref)
    with pytest.raises(ValueError):
        screen_library_checkpointed(q, lib, table, 4.73, 0.34, k=5,
                                    chunk_size=8, ckpt_path=ck, device=CPU)


@pytest.fixture(scope="module")
def fastas(tmp_path_factory):
    """The tests/test_screen_cli.py fixture recipe."""
    rng = np.random.default_rng(7)
    d = tmp_path_factory.mktemp("torch_screen")

    def rseq(n):
        return "".join(AA[i] for i in rng.integers(0, 20, n))

    q = rseq(80)
    qfa = d / "query.fa"
    qfa.write_text(f">query1\n{q}\n")
    lfa = d / "lib.fa"
    lines = []
    for i in range(30):
        n = int(rng.integers(50, 120))
        s = rseq(n)
        if i % 5 == 0 and n > 60:
            s = s[:10] + q[10:60] + s[60:]
        lines.append(f">tmpl_{i:02d}\n{s}\n")
    lfa.write_text("".join(lines))
    return str(qfa), str(lfa)


def _capture(main, argv):
    out, err = io.StringIO(), io.StringIO()
    old = sys.stdout, sys.stderr
    sys.stdout, sys.stderr = out, err
    try:
        rc = main(argv)
    finally:
        sys.stdout, sys.stderr = old
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("extra", [
    [],                                         # default gaps 4.73 / 0.34
    ["--gap_init", "11", "--gap_extn", "1"],
    ["--top_k", "8"],
    ["--top_k", "5", "--ckpt", "CKPT", "--chunk_size", "7"],
], ids=["default", "gaps_11_1", "top_k_8", "ckpt"])
def test_cli_stdout_byte_equal_to_jax(fastas, extra, tmp_path, monkeypatch):
    from alignment_algos_tpu.cli import screen as jcli
    from alignment_algos_tpu_torch.cli import screen as tcli
    monkeypatch.setenv("AAT_TORCH_DEVICE", "cpu")
    argv = [*fastas, "--SUB_MATRIX", BLOSUM, *extra]
    outs = []
    for name, main in (("jax", jcli.main), ("torch", tcli.main)):
        args = [str(tmp_path / f"{name}.npz") if a == "CKPT" else a
                for a in argv]
        rc, out, err = _capture(main, args)
        assert rc == 0, err
        outs.append(out)
    assert outs[0] == outs[1]
    assert "cluster 1:" in outs[1]


@pytest.fixture(scope="module")
def profile_lib(tmp_path_factory):
    """The tests/test_screen_cli.py profile fixture recipe: a 40-residue
    query and four templates (two lengths, so two buckets)."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_profiles import make_profile
    rng = np.random.default_rng(5)
    d = tmp_path_factory.mktemp("torch_profiles")
    (d / "lib").mkdir()
    (d / "q.prof").write_text(make_profile(rng, "qry", 40))
    for i, n in enumerate((40, 40, 52, 40)):
        (d / "lib" / f"t{i}.prof").write_text(make_profile(rng, f"t{i}", n))
    smaps = d / "smaps.txt"
    smaps.write_text("".join(os.path.join(ROOT, "tests", "data", f) + "\n"
                             for f in ("templ_smap.prof", "templ_big.prof")))
    return str(d / "q.prof"), str(d / "lib"), str(smaps)


def _profile_argv(profile_lib, mode):
    qfn, lib, smaps = profile_lib
    if mode == "smap":
        return [os.path.join(ROOT, "tests", "data", "query30.prof"), smaps,
                "--smap", "1", "--top_k", "2"]
    argv = [qfn, lib, "--profiles", "1", "--top_k", "4"]
    return argv + (["--CORE_MATCH_WEIGHT", "2.5"] if mode == "cmw" else [])


@pytest.mark.parametrize("mode", ["profiles", "cmw", "smap"],
                         ids=["profiles", "profiles_core_match_weight_2.5",
                              "smap"])
def test_cli_profile_modes_byte_equal_to_jax(profile_lib, mode, monkeypatch):
    """--profiles 1 (HMAP producer + K3's plain version) and --smap 1
    (Gn2Eval host costs + K3's plain version): stdout byte-equal to the JAX
    tool (host costs + the XLA scan engine on the CPU)."""
    from alignment_algos_tpu.cli import screen as jcli
    from alignment_algos_tpu_torch.cli import screen as tcli
    monkeypatch.setenv("AAT_TORCH_DEVICE", "cpu")
    argv = _profile_argv(profile_lib, mode)
    outs = []
    for main in (jcli.main, tcli.main):
        rc, out, err = _capture(main, argv)
        assert rc == 0, err
        outs.append(out)
    assert outs[0] == outs[1]
    assert len([l for l in outs[1].splitlines() if "\t" in l
                and not l.startswith("#")]) == (2 if mode == "smap" else 4)


def test_cli_refuses_cuda_without_a_card(fastas, monkeypatch):
    from alignment_algos_tpu_torch.cli import screen as tcli
    monkeypatch.setenv("AAT_TORCH_DEVICE", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = _capture(tcli.main, [*fastas, "--SUB_MATRIX", BLOSUM])
    assert rc != 0 and out == "" and "AAT_TORCH_DEVICE" in err


def _scaled_gaps(base):
    """A subclass of the evaluator class ``base`` that keeps its
    ``build_costs`` but scales its gap vectors by a factor that its
    ``__init__`` takes from the template (1, 2 or 3 by its size)."""

    class ScaledGaps(base):
        def __init__(self, params, templ):
            super().__init__(params)
            self.scale = np.float32(1 + templ.size() % 3)

        def _gap_vectors(self, templ):
            gi, ge = super()._gap_vectors(templ)
            return gi * self.scale, ge * self.scale

    return ScaledGaps


def _count_device_screens(monkeypatch):
    from alignment_algos_tpu_torch.ops import hmap_device
    calls = []
    real = hmap_device.screen_hmap_device
    monkeypatch.setattr(hmap_device, "screen_hmap_device",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def test_screen_profiles_routes_evaluator_subclasses_per_pair(monkeypatch):
    """An ``HMAPaliEval`` subclass with per-template state takes the host
    per-pair build (K3's plain version here), equal to per-pair ``core/dp``
    builds and to the JAX package's ``screen_profiles`` on the CPU; the
    device route, which reuses the first template's evaluator, would not
    be."""
    from alignment_algos_tpu.parallel.screen import screen_profiles as jsp
    from alignment_algos_tpu.scoring.hmap_eval import HMAPaliEval
    from alignment_algos_tpu.seq.hmap import HMAPSequence
    from alignment_algos_tpu.utils.params import HMAPaliParams
    from alignment_algos_tpu_torch.core import dp as tdp
    from alignment_algos_tpu_torch.ops import hmap_device
    from alignment_algos_tpu_torch.scoring.hmap_eval import (
        HMAPaliEval as THMAPaliEval)
    from alignment_algos_tpu_torch.seq.hmap import (
        HMAPSequence as THMAPSequence)
    from alignment_algos_tpu_torch.utils.params import (
        HMAPaliParams as THMAPaliParams)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_profiles import make_profile

    monkeypatch.setenv("AAT_TORCH_DEVICE", "cpu")
    rng = np.random.default_rng(12)
    texts = [make_profile(rng, f"s{i}", n)
             for i, n in enumerate((34, 28, 29, 30, 29, 28))]
    jq, *jts = [HMAPSequence.from_stream(io.StringIO(t)) for t in texts]
    q, *ts = [THMAPSequence.from_stream(io.StringIO(t)) for t in texts]
    assert {t.size() % 3 for t in ts} == {0, 1, 2}
    params, jparams = THMAPaliParams(), HMAPaliParams()
    mine, theirs = _scaled_gaps(THMAPaliEval), _scaled_gaps(HMAPaliEval)

    calls = _count_device_screens(monkeypatch)
    scores, order = screen.screen_profiles(
        q, ts, lambda a, b: mine(params, b), k=4, device=CPU)
    assert calls == []
    per_pair = np.array(
        [tdp.DPMatrix(q, t, mine(params, t)).res.H[-1, -1] for t in ts],
        np.float32)
    np.testing.assert_array_equal(scores.view(np.uint32),
                                  per_pair.view(np.uint32))
    j_scores, j_order = jsp(jq, jts, lambda a, b: theirs(jparams, b), k=4)
    np.testing.assert_array_equal(scores.view(np.uint32),
                                  np.asarray(j_scores).view(np.uint32))
    np.testing.assert_array_equal(order, j_order)
    wrong, _ = hmap_device.screen_hmap_device(
        q, ts, params, k=4, ev=mine(params, ts[0]), device=CPU)
    assert not np.array_equal(wrong, scores)


@pytest.mark.parametrize("evaluator", ["HMAPaliEval", "Hmap2Eval"])
def test_screen_profiles_routes_standard_evaluators_to_the_device(
        evaluator, monkeypatch):
    """Evaluators of exactly ``HMAPaliEval`` or ``Hmap2Eval`` still build
    the similarity through ``hmap_device`` (one call per screen)."""
    from alignment_algos_tpu_torch.scoring.gn2_eval import Gn2Params
    from alignment_algos_tpu_torch.scoring.hmap2_eval import Hmap2Eval
    from alignment_algos_tpu_torch.scoring.hmap_eval import HMAPaliEval
    from alignment_algos_tpu_torch.seq.hmap import HMAPSequence
    from alignment_algos_tpu_torch.structure.smap import SMAPSequence
    from alignment_algos_tpu_torch.utils.params import HMAPaliParams

    data = os.path.join(ROOT, "tests", "data")
    query = HMAPSequence.from_file(os.path.join(data, "query30.prof"))
    if evaluator == "Hmap2Eval":
        ts = [SMAPSequence.from_file(os.path.join(data, fn), gn2=True)
              for fn in ("templ_smap.prof", "templ_big.prof")]
        params = Gn2Params()
        factory = lambda a, b: Hmap2Eval(params)          # noqa: E731
    else:
        ts = [HMAPSequence.from_file(os.path.join(data, fn))
              for fn in ("query_big.prof", "query30.prof")]
        params = HMAPaliParams()
        factory = lambda a, b: HMAPaliEval(params)        # noqa: E731
    calls = _count_device_screens(monkeypatch)
    scores, _ = screen.screen_profiles(query, ts, factory, k=2, device=CPU)
    assert calls == [1] and scores.shape == (2,)


def _index():
    from alignment_algos_tpu_torch.cli import screen as tcli
    from alignment_algos_tpu_torch.scoring.submatrix import BlosumMatrix
    bl = BlosumMatrix(BLOSUM)
    return {c: i for i, c in enumerate(bl.alphabet)}, tcli.padded_table(bl)[1]


def test_read_inputs_encoding_equals_jax(fastas):
    """The byte-table encode of the query and the library equals the JAX
    tool's dict encode (cli/screen.py:62-67,133) on the fixture recipe."""
    from alignment_algos_tpu.cli import screen as jcli
    from alignment_algos_tpu_torch.cli import screen as tcli
    qfa, lfa = fastas
    inp = tcli.read_inputs(qfa, lfa, BLOSUM)
    index, pad = _index()
    qseq = jcli.read_fasta_plain(qfa)[0][1]
    want_q = np.asarray([index[c] for c in qseq.upper()], dtype=np.int32)
    want_t = jcli.encode_library([s for _, s in jcli.read_fasta_plain(lfa)],
                                 index, pad)
    for got, want in ((inp.q_codes, want_q), (inp.t_codes, want_t)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert inp.pad_code == pad and (inp.t_codes == pad).any()


@pytest.mark.parametrize("seqs", [
    ["heagawghee", "PAWheaE", "w", "HEAGAWGHEEPAWHEAE"],   # lower case
    ["W"],                                                 # 1 residue
    ["A", "", "bzx*"],                                     # empty, B Z X *
    ["HEıAG", "AAA"],                   # dotless i: upper() gives I
], ids=["lower_case", "one_residue", "empty_and_ambiguity", "dotless_i"])
def test_byte_table_encode_equals_jax(seqs):
    from alignment_algos_tpu.cli import screen as jcli
    from alignment_algos_tpu_torch.cli import screen as tcli
    index, pad = _index()
    got = tcli.encode_library(seqs, index, pad)
    want = jcli.encode_library(seqs, index, pad)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    for s in seqs:                           # the query's encoding
        np.testing.assert_array_equal(
            tcli.encode_library([s], index, pad)[0],
            np.asarray([index[c] for c in s.upper()], dtype=np.int32))


@pytest.mark.parametrize("seqs", [
    ["HEAG", "HEJAG", "AOA"],                # J first: outside BLOSUM62
    ["HEAG", "café"],                   # non-ASCII
    ["AßA"],                            # upper() lengthens the row
    ["AA\0A"],                               # a NUL byte
], ids=["unknown_residue", "non_ascii", "longer_upper", "nul"])
def test_byte_table_encode_raises_as_jax(seqs):
    from alignment_algos_tpu.cli import screen as jcli
    from alignment_algos_tpu_torch.cli import screen as tcli
    index, pad = _index()
    errors = []
    for encode in (jcli.encode_library, tcli.encode_library):
        with pytest.raises(Exception) as e:
            encode(seqs, index, pad)
        errors.append((type(e.value), e.value.args))
    assert errors[0] == errors[1]
    assert errors[0][0] is (ValueError if "ß" in seqs[0] else KeyError)
