"""Nothing under aat_bench imports jax or the JAX package, and the
reference imports nothing of the program (top-level names compared
whole: the port's name begins with the JAX package's)."""

import ast
import os

import pytest

from aat_bench import cell as cells

FORBIDDEN = {"jax", "jaxlib", "flax", "alignment_algos_tpu"}
PROGRAM = "alignment_algos_tpu_torch"


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(_sources(cells.BENCH_DIR)))
def test_no_jax(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources(
    os.path.join(cells.BENCH_DIR, "reference"))))
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in set(_imports(path))


def test_program_name_compared_whole():
    assert PROGRAM.split(".")[0] not in FORBIDDEN
