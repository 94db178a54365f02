"""No module of the benchmark imports JAX or the JAX package, and the
plain reference imports nothing of the program.  Top-level names (before
the first dot) are compared whole: the program's name begins with the JAX
package's."""

from __future__ import annotations

import ast

import pytest

from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "advanced_hpc_lbm_tpu"}
PROGRAM = "advanced_hpc_lbm_tpu_torch"


def imported(path) -> set[str]:
    """Top-level names of every module that ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], (ast.Constant, ast.JoinedStr))):
            arg = node.args[0]
            text = arg.value if isinstance(arg, ast.Constant) else "".join(
                v.value for v in arg.values if isinstance(v, ast.Constant))
            names.add(text.split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_independent_of_the_program(path):
    names = imported(path)
    assert PROGRAM not in names
    assert names <= {"__future__", "dataclasses", "numpy", "torch", "portbench"}


def test_names_are_compared_whole(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import advanced_hpc_lbm_tpu_torch.ops\nfrom advanced_hpc_lbm_tpu.x import y\n")
    assert imported(src) == {PROGRAM, "advanced_hpc_lbm_tpu"}
    assert imported(src) & FORBIDDEN == {"advanced_hpc_lbm_tpu"}


def test_the_harness_does_import_the_program():
    assert PROGRAM in imported(BENCH / "harness.py")
