"""The port stands alone beside the JAX package.

1. No module of ``alignment_algos_tpu_torch/``, nor ``chip_smoke.py`` nor
   the port's chip tools, imports ``jax`` or anything of
   ``alignment_algos_tpu`` (an AST scan of every file).
2. The port's CLIs run in a subprocess (``nalign``, ``aat_screen`` in FASTA
   mode and with ``--profiles 1``), and a rank of its multi-process screen
   (``parallel/distributed``), load neither ``jax`` nor any
   ``alignment_algos_tpu`` module.
3. The port's copies of the JAX package's host layers do not drift: each
   file of ``COPIES`` is byte-equal to the JAX package's file at the same
   path, and in each file of ``DIFFERS`` only the named top-level
   definitions (and methods) differ; every other one is the same AST.
"""

import ast
import glob
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "alignment_algos_tpu_torch")
REF = os.path.join(ROOT, "alignment_algos_tpu")
DATA = os.path.join(ROOT, "tests", "data")
INP = os.path.join(ROOT, "tests", "golden", "inputs")
BLOSUM = os.path.join(DATA, "BLOSUM62")
AA = "ARNDCQEGHILKMFPSTWYV"

# ------------------------------------------------------------ 1. AST scan

SCANNED = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
    os.path.join(PORT, "**", "*.py"), recursive=True)) + [
    "chip_smoke.py", "tools/torch_k3_bench.py",
    "tools/torch_span_trace.py", "tools/torch_sw_bench.py"]


def _absolute_imports(path: str) -> list[str]:
    with open(path) as f:
        tree = ast.parse(f.read())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module)
    return out


@pytest.mark.parametrize("rel", SCANNED)
def test_no_import_of_jax_or_the_jax_package(rel):
    bad = [m for m in _absolute_imports(os.path.join(ROOT, rel))
           if m.split(".")[0] in ("jax", "jaxlib", "alignment_algos_tpu")]
    assert not bad, f"{rel} imports {bad}"


# ----------------------------------------------------- 2. subprocess CLIs

def _loaded_modules(module: str, argv: list[str]) -> tuple[str, list]:
    """stdout of ``alignment_algos_tpu_torch.<module>.main(argv)`` (a CLI
    under ``cli.``, or the distributed worker's ``_worker_main``) in a
    fresh interpreter on the CPU, and the jax / JAX-package modules it
    loaded."""
    mod, _, fn = (f"cli.{module}" if "." not in module
                  else module).partition(":")
    code = ("import sys\n"
            f"from alignment_algos_tpu_torch.{mod} import "
            f"{fn or 'main'} as main\n"
            f"rc = main({argv!r})\n"
            "print('LOADED', sorted(m for m in sys.modules if m == 'jax'\n"
            "      or m.startswith(('jax.', 'jaxlib', 'alignment_algos_tpu.'))\n"
            "      or m == 'alignment_algos_tpu'))\n"
            "sys.exit(rc)\n")
    env = dict(os.environ, AAT_TORCH_DEVICE="cpu",
               HOME="/tmp/nonexistent-home",
               PYTHONPATH=os.pathsep.join(
                   [ROOT, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out, _, loaded = proc.stdout.rpartition("LOADED ")
    return out, ast.literal_eval(loaded.strip())


def test_nalign_subprocess_never_imports_jax():
    out, loaded = _loaded_modules("nalign", [
        os.path.join(INP, "qA.prof"), os.path.join(INP, "tA.prof"), "-opt"])
    with open(os.path.join(ROOT, "tests", "golden", "nalign_opt.out")) as f:
        assert out == f.read()
    assert loaded == []


@pytest.fixture(scope="module")
def fastas(tmp_path_factory):
    """The tests/test_screen_cli.py fixture recipe."""
    rng = np.random.default_rng(7)
    d = tmp_path_factory.mktemp("isolation_fasta")

    def rseq(n):
        return "".join(AA[i] for i in rng.integers(0, 20, n))

    q = rseq(80)
    (d / "query.fa").write_text(f">query1\n{q}\n")
    lines = []
    for i in range(30):
        n = int(rng.integers(50, 120))
        s = rseq(n)
        if i % 5 == 0 and n > 60:
            s = s[:10] + q[10:60] + s[60:]
        lines.append(f">tmpl_{i:02d}\n{s}\n")
    (d / "lib.fa").write_text("".join(lines))
    return str(d / "query.fa"), str(d / "lib.fa")


def test_cli_subprocess_never_imports_jax(fastas):
    out, loaded = _loaded_modules("screen",
                                  [*fastas, "--SUB_MATRIX", BLOSUM])
    assert "# rank\tscore\tindex\tname" in out and "cluster 1:" in out
    assert loaded == []


def test_cli_profiles_subprocess_never_imports_jax(tmp_path):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_profiles import make_profile
    rng = np.random.default_rng(5)
    (tmp_path / "lib").mkdir()
    (tmp_path / "q.prof").write_text(make_profile(rng, "qry", 40))
    for i, n in enumerate((40, 40, 52, 40)):
        (tmp_path / "lib" / f"t{i}.prof").write_text(
            make_profile(rng, f"t{i}", n))
    out, loaded = _loaded_modules("screen", [
        str(tmp_path / "q.prof"), str(tmp_path / "lib"), "--profiles", "1",
        "--top_k", "4"])
    assert "# rank\tscore\tindex\tfile" in out
    assert loaded == []


def test_distributed_worker_subprocess_never_imports_jax(tmp_path):
    """One rank (a one-process gloo group over two mesh entries) runs the
    worker's entry point and gives the one-process screen's result."""
    import json

    from alignment_algos_tpu_torch.parallel import distributed, screen
    rng = np.random.default_rng(3)
    q = rng.integers(0, 20, 24).astype(np.int32)
    lib = rng.integers(0, 20, (8, 24)).astype(np.int32)
    table = rng.integers(-4, 11, (20, 20)).astype(np.float32)
    np.savez(tmp_path / "in.npz", q_codes=q, t_codes=lib, table=table)
    spec = {"coordinator": f"127.0.0.1:{distributed.free_port()}",
            "backend": "gloo", "num_processes": 1, "devices_per_process": 2,
            "data": str(tmp_path / "in.npz"), "gi": 11.0, "ge": 1.0, "k": 4,
            "reps": 1}
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    out = str(tmp_path / "out.npz")
    _, loaded = _loaded_modules(
        "parallel.distributed:_worker_main",
        [str(tmp_path / "spec.json"), out, "0"])
    assert loaded == []
    want_s, want_i = screen.screen_library(q, lib, table, 11.0, 1.0, k=4,
                                           device="cpu")
    with np.load(out) as z:
        np.testing.assert_array_equal(z["idx"], want_i)
        np.testing.assert_array_equal(z["scores"], want_s)


# ------------------------------------------------------------- 3. drift

COPIES = [
    *(f"seq/{m}.py" for m in ("__init__", "hmap", "sequence", "sflags")),
    *(f"scoring/{m}.py" for m in ("__init__", "aasub", "base", "gn2_eval",
                                  "gnoali_eval", "hmap2_eval", "hmap_eval",
                                  "submatrix")),
    *(f"io/{m}.py" for m in ("__init__", "fasta", "gstrings", "hmapio",
                             "pir")),
    *(f"structure/{m}.py" for m in ("__init__", "geometry", "pdb", "smap")),
    *(f"ssss/{m}.py" for m in ("__init__", "ali_frag", "defs", "engine",
                               "frag_matrix", "frag_set", "native_search",
                               "skel_ali", "skel_set", "strand_eval")),
    "analysis/__init__.py", "analysis/ali_dist.py", "analysis/shift.py",
    "analysis/kmedoids.py",
    "core/__init__.py", "core/alignment.py",
    *(f"core/enumerators/{m}.py" for m in ("__init__", "crcw", "cw", "kscw",
                                           "native", "nativedelegate",
                                           "optimal", "ucw")),
    "ops/__init__.py", "ops/dp_ref.py", "ops/dp_affine.py",
    *(f"utils/{m}.py" for m in ("__init__", "params", "hmath", "cxxsort",
                                "crand")),
    *(f"native/{f}" for f in ("exactmath.c", "alidist.cpp", "dpref.cpp",
                              "enumerate.cpp", "ssss_search.cpp")),
    "cli/__init__.py", "cli/s4_align_gn2.py", "cli/test_0.py",
    "parallel/__init__.py",
]

# the tools' one difference: main runs _run through cli/_tools.run_tool
# (the port's device check) where the reference sets up JAX's platform
_TOOL = ({"imports", "main"}, set())
# file -> (top-level names that differ or are gone, names the port adds)
DIFFERS = {
    # backend "torch" (K7) where the reference has "jax": BACKENDS,
    # _backend, _use_device and AUTO_MIN_SIZE for _BACKEND, _use_jax and
    # _AUTO_MIN_SIZE; build(), one build on K7 or dp_ref; DPMatrix._build
    # routes through it, and takes dp_affine only where _affine_h_exact
    # also bounds H's magnitude (the reference's gate does not: past 2^24
    # its H, PQ and PT differ from dp_ref's, a reference fault shown by
    # tests/test_torch_dp_engine.py); the docstring and imports say so
    "core/dp.py": ({"__doc__", "imports", "_BACKEND", "_AUTO_MIN_SIZE",
                    "set_backend", "_use_jax", "DPMatrix._build"},
                   {"BACKENDS", "AUTO_MIN_SIZE", "_backend", "_use_device",
                    "build", "_affine_h_exact"}),
    "cli/aaa.py": _TOOL,
    "cli/gn2.py": _TOOL,
    "cli/gnoali.py": _TOOL,
    "cli/nalign.py": _TOOL,
    "cli/nalign2.py": _TOOL,
    "cli/s4_align.py": _TOOL,
    "cli/s4_one_ali.py": _TOOL,
    # get_shifts and get_area_diffs: their body nested in main, so that it
    # runs through run_tool
    "cli/get_shifts.py": _TOOL,
    "cli/get_area_diffs.py": _TOOL,
    "cli/cn_acc_analys.py": _TOOL,
    # without upgma_linkage_matrix_jax, the module's only JAX code
    "analysis/upgma.py": ({"upgma_linkage_matrix_jax"}, set()),
    # libraries build into build/ (build_native, imports), the libm
    # functions raise when exactmath.c does not build (_load, _vec_f32)
    # instead of returning numpy's results, and the wrappers nothing
    # reaches (erfcf, exp64, log64, erfc64, _vec_f64) are gone
    "native/__init__.py": ({"__doc__", "imports", "build_native", "_load",
                            "_vec_f32", "_vec_f64", "expf", "logf", "sqrtf",
                            "erfcf", "exp64", "log64", "erfc64"}, set()),
}

# the port's own modules at the JAX package's paths (no copies)
OWN = {"__init__.py", "cli/screen.py", "parallel/screen.py",
       "parallel/checkpoint.py", "parallel/distributed.py",
       "utils/profiling.py", "ops/swaffine.py", "ops/swscan.py",
       "ops/dp_scores.py", "ops/dp_pallas.py", "ops/dp_engine.py",
       "ops/hmap_device.py"}


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_byte_equal_to_the_jax_package(rel):
    assert _read(os.path.join(PORT, rel)) == _read(os.path.join(REF, rel)), \
        f"{rel} drifted from alignment_algos_tpu/{rel}"


def _units(path: str) -> dict:
    """Top-level definitions of a module by name (class methods as
    ``Class.method``), each as its AST without positions; the module
    docstring as ``__doc__`` and every import together as ``imports``."""
    with open(path) as f:
        body = ast.parse(f.read()).body
    units = {}
    if (body and isinstance(body[0], ast.Expr)
            and isinstance(body[0].value, ast.Constant)):
        units["__doc__"] = body[0].value.value
        body = body[1:]
    imports = []
    for node in body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            imports.append(ast.dump(node))
        elif isinstance(node, ast.ClassDef):
            rest = []
            for item in node.body:
                if isinstance(item, ast.FunctionDef):
                    units[f"{node.name}.{item.name}"] = ast.dump(item)
                else:
                    rest.append(ast.dump(item))
            units[node.name] = (
                tuple(ast.dump(d) for d in node.decorator_list),
                tuple(ast.dump(b) for b in node.bases), tuple(rest))
        elif isinstance(node, ast.FunctionDef):
            units[node.name] = ast.dump(node)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            units[",".join(ast.unparse(t) for t in targets)] = ast.dump(node)
        else:
            units[ast.unparse(node)] = ast.dump(node)
    units["imports"] = tuple(sorted(imports))
    return units


@pytest.mark.parametrize("rel", sorted(DIFFERS))
def test_copy_differs_only_where_named(rel):
    differs, adds = DIFFERS[rel]
    ref = _units(os.path.join(REF, rel))
    port = _units(os.path.join(PORT, rel))
    for name, dump in ref.items():
        if name in differs:
            assert port.get(name) != dump, \
                f"{rel}: {name} is the reference's again; drop it from DIFFERS"
        else:
            assert port.get(name) == dump, \
                f"{rel}: {name} drifted from alignment_algos_tpu/{rel}"
    assert set(port) - set(ref) == adds, rel


def test_every_counterpart_is_classified():
    """Each port file at a path the JAX package also has is a copy, a copy
    with named differences, or one of the port's own modules."""
    known = set(COPIES) | set(DIFFERS) | OWN
    assert len(known) == len(COPIES) + len(DIFFERS) + len(OWN)
    found = set()
    for path in glob.glob(os.path.join(PORT, "**", "*"), recursive=True):
        rel = os.path.relpath(path, PORT)
        if (path.endswith((".py", ".c", ".cpp"))
                and os.path.exists(os.path.join(REF, rel))):
            found.add(rel)
    assert found == known


def test_native_libm_raises_when_exactmath_does_not_build(monkeypatch):
    """The port's expf never falls back to numpy's exp."""
    from alignment_algos_tpu_torch import native
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "build_native", lambda *a, **k: None)
    with pytest.raises(RuntimeError, match="exactmath"):
        native.expf(np.ones(3, np.float32))
    monkeypatch.undo()
    got = native.expf(np.array([0.0, 1.0], np.float32))
    assert got[0] == 1.0 and got[1] == np.float32(np.e)
    assert os.path.dirname(native._load()._name) == os.path.join(ROOT,
                                                                 "build")


def test_native_engines_build_into_the_checkouts_build_dir():
    """The copied engines' libraries come from build/, never from the JAX
    package's native/ directory (where a compiler is missing they fall back
    to their exact Python paths)."""
    from alignment_algos_tpu_torch.analysis import ali_dist
    from alignment_algos_tpu_torch.core.enumerators import native as enum
    from alignment_algos_tpu_torch.ops import dp_ref
    from alignment_algos_tpu_torch.ssss import native_search
    libs = [ali_dist._load_native(), dp_ref._load_native(),
            native_search._load(), enum.load()]
    for lib in libs:
        if lib is not None:
            assert os.path.dirname(lib._name) == os.path.join(ROOT, "build")
