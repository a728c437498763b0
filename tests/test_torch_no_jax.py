"""The port and its chip smoke import neither JAX nor the JAX package."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    for lineno, mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), \
            f"{path.relative_to(ROOT)}:{lineno} imports {mod}"


def test_the_port_has_modules():
    assert len(FILES) > 10
    assert (ROOT / "chip_smoke.py").is_file()
    port = ROOT / "src" / "repro_torch"
    assert port / "serve" / "node_engine.py" in FILES
    assert port / "serve" / "__init__.py" in FILES
    assert port / "serve" / "engine.py" in FILES
    assert port / "kernels" / "flash_attention.py" in FILES
