"""What the benchmark may import. No module under `cardbench/` imports JAX
or the JAX package (`repro`); each import's top-level name, the part before
the first dot, is compared whole, since the port's name `repro_torch`
begins with `repro`. Nothing under `cardbench/reference/` imports the port
either: the reference takes nothing from the program."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", None)) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_there_are_sources():
    assert len(SOURCES) > 10


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_or_jax_package(path):
    assert not top_level_imports(path) & BANNED


@pytest.mark.parametrize("path", [p for p in SOURCES
                                  if "reference" in p.parts], ids=lambda p: str(
    p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & (BANNED | {"repro_torch", "harness"})


def test_whole_names_are_compared(tmp_path):
    allowed = tmp_path / "allowed.py"
    allowed.write_text("import repro_torch\nfrom repro_torch.core import bcd\n")
    banned = tmp_path / "banned.py"
    banned.write_text("from repro.core import bcd\n")
    assert not top_level_imports(allowed) & BANNED
    assert top_level_imports(banned) & BANNED == {"repro"}
