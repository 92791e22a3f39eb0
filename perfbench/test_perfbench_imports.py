"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the port (top-level names compared
whole: ``repro_torch`` is the port, ``repro`` the JAX package)."""
import ast
import pathlib

import pytest

BENCH = pathlib.Path(__file__).resolve().parent
BANNED = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & BANNED


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = top_level_imports(path)
    assert "repro_torch" not in names and "perfbench" not in names


@pytest.mark.parametrize("path", sorted((BENCH / "arch").glob("*.py")),
                         ids=lambda p: p.name)
def test_architectures_import_nothing_of_the_port(path):
    """An architecture's module holds the reference's forward."""
    assert "repro_torch" not in top_level_imports(path)


def test_guard_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.models\nfrom repro.core import x\n"
                 "import jaxtyping\n")
    assert top_level_imports(f) & BANNED == {"repro"}
