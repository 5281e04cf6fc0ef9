"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
reference imports nothing of the program. Top-level module names are
compared whole: `sfa3d_tpu_torch` begins with `sfa3d_tpu`."""

import ast
from pathlib import Path

import pytest

from perfbench.harness import guard

BENCH = Path(__file__).resolve().parents[1]


def imported_tops(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def sources():
    return sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", sources(), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not set(imported_tops(path)) & set(guard.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = set(imported_tops(path))
    assert "sfa3d_tpu_torch" not in tops and not tops & set(guard.FORBIDDEN)


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_loaded(["sfa3d_tpu_torch", "sfa3d_tpu_torch.ops", "jaxtyping", "flaxen"]) == []
    assert guard.forbidden_loaded(["sfa3d_tpu.ops.bev", "jax.numpy", "numpy"]) == ["jax", "sfa3d_tpu"]
