"""What the benchmark may load: no JAX and no JAX package anywhere under
``perfbench/`` (whole top-level names: ``repro_torch`` is not ``repro``),
nothing of the program in the reference, and no path under
``benchmarks/``."""

from __future__ import annotations

import ast
import pathlib

import pytest

HERE = pathlib.Path(__file__).resolve().parent
FILES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
#: the JAX package's benchmark folder, spelt so this file holds no such path
OLD_BENCH = "bench" + "marks"


def top_level_imports(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_the_guard_compares_whole_names(tmp_path):
    p = tmp_path / "probe.py"
    p.write_text("import repro_torch.models\nfrom repro.core import x\n"
                 "import jaxtyping\n")
    assert top_level_imports(p) & FORBIDDEN == {"repro"}


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    """Plain numpy and PyTorch; its own modules by relative import."""
    assert top_level_imports(path) <= {"__future__", "dataclasses", "numpy",
                                       "torch"}


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_path_under_benchmarks(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert not node.value.startswith(OLD_BENCH), node.value
            assert f"/{OLD_BENCH}/" not in node.value, node.value
