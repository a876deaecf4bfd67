"""What the benchmark imports, by the top-level name of each module compared
whole: nothing of JAX or of the JAX package anywhere; nothing of the
program in the references, which are the yardstick the program is held
to."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "orbax", "optax", "makani_tpu"}
PROGRAM = "makani_tpu_torch"
SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.relative_to(HERE).parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                names.add(arg.value.split(".")[0])
    return names


def test_sources_found():
    assert any(p.name == "run.py" for p in SOURCES)
    assert any(p.parent.name == "reference" for p in SOURCES)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in SOURCES if p.parent.name == "reference"],
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in top_level_imports(path)
    assert "makani_tpu_torch" not in path.read_text()


def test_whole_name_comparison():
    assert PROGRAM.split(".")[0] not in FORBIDDEN
    assert "makani_tpu" in FORBIDDEN
