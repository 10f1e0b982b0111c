"""The port stands alone: no module of ``aliby_tpu_torch`` and not
``chip_smoke.py`` imports ``jax``, ``flax`` or any module of ``aliby_tpu``;
and none imports ``pyarrow``, ``yaml``, ``PIL``, ``imageio``, ``pandas`` or
``h5py`` when it is imported (the GPU hosts of the port have none of them:
the functions that write or read parquet, read or write yaml, decode TIFFs,
make data frames or open HDF5 files import them inside). The native TIFF
decoder and the JPEG-XL codec neither compile nor load a library when they
are imported."""

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
    scanned = {str(p.relative_to(ROOT)) for p in FILES}
    for module in ("models/training.py", "models/unet.py", "models/weights.py",
                   "utils/profiling.py", "postprocess/cells.py", "postprocess/signal.py",
                   "postprocess/indexing.py", "postprocess/progress.py", "logparse/grammar.py",
                   "logparse/swainlab.py", "logparse/metadata.py", "io/h5compat.py",
                   "native/__init__.py", "io/jxl.py", "parallel/mesh.py",
                   "parallel/spatial.py", "parallel/dryrun.py", "external_data.py"):
        assert f"aliby_tpu_torch/{module}" in scanned, module


def _import_time_nodes(nodes):
    """The statements that run when the module is imported: everything but
    the bodies of functions."""
    for node in nodes:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        yield node
        yield from _import_time_nodes(ast.iter_child_nodes(node))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_flax_or_reference_imports(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {name}"


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_level_pyarrow(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in _import_time_nodes(tree.body):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
        for name in names:
            assert name.split(".")[0] != "pyarrow", (
                f"{path.relative_to(ROOT)}:{node.lineno} imports {name} at import time")


HOST_ONLY = ("pyarrow", "yaml", "PIL", "imageio", "pandas", "h5py")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_level_yaml_pil_or_imageio(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in _import_time_nodes(tree.body):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
        for name in names:
            assert name.split(".")[0] not in HOST_ONLY, (
                f"{path.relative_to(ROOT)}:{node.lineno} imports {name} at import time")


def test_native_and_jxl_build_and_load_nothing_at_import():
    """In a fresh interpreter, importing ``native`` and ``io.jxl`` starts no
    process and loads neither library (torch, imported with them, loads its
    own)."""
    import subprocess
    import sys

    code = """
import ctypes, subprocess, sys
calls = []
for mod, name in ((subprocess, "run"), (subprocess, "Popen"), (ctypes, "CDLL")):
    real = getattr(mod, name)
    setattr(mod, name, lambda *a, _n=name, _r=real, **k: (calls.append((_n, str(a[:1]))),
                                                           _r(*a, **k))[1])
sys.path.insert(0, sys.argv[1])
from aliby_tpu_torch import native
from aliby_tpu_torch.io import jxl
ours = [c for c in calls if c[0] != "CDLL" or "aliby_host" in c[1] or "jxl" in c[1]]
assert not ours, ours
assert native._lib is None and not native._tried and native.decodes == 0
assert jxl._lib.cache_info().currsize == 0
"""
    proc = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
