"""The port stands alone: no module of ``aliby_tpu_torch`` and not
``chip_smoke.py`` imports ``jax``, ``flax`` or any module of ``aliby_tpu``."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "aliby_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "aliby_tpu")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__"):
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value)


def test_files_found():
    assert len(FILES) >= 15


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_flax_or_reference_imports(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {name}"
