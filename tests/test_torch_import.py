"""The port stands alone: importing ``wildgs_slam_tpu_torch`` and every one of
its submodules loads no ``jax``, no ``flax`` and nothing of the JAX package,
and no port source file or ``chip_smoke.py`` names one in an import."""

import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "wildgs_slam_tpu_torch"
FORBIDDEN = ("jax", "flax", "wildgs_slam_tpu")

_PROBE = """
import importlib, pkgutil, sys
import wildgs_slam_tpu_torch as port
for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(m.name)
bad = sorted(k for k in sys.modules
             if any(k == f or k.startswith(f + ".") for f in %r))
print("LOADED", bad)
""" % (FORBIDDEN,)


def _forbidden(name: str) -> bool:
    # exact name or dotted prefix: wildgs_slam_tpu_torch itself starts with
    # the string "wildgs_slam_tpu" but is not the JAX package
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_import_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_name_no_jax_module():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for rel in ONE_SEMANTICS:    # the multi-device modules among them
        assert PORT / rel in files, rel
    for path in files:
        bad = [m for m in _imports(path) if _forbidden(m)]
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
        assert "importlib.import_module(\"jax" not in path.read_text()


# the modules that compute what the JAX package computes without cv2, scipy
# or matplotlib: one semantics everywhere, so neither an import of those nor
# a fallback on ImportError
ONE_SEMANTICS = ("slam/depth_fill.py", "slam/mapper.py", "gui/file_gui.py",
                 "gui/html_viewer.py", "utils/png.py", "ops/lie.py",
                 "native/__init__.py", "utils/plot_utils.py",
                 "parallel/collectives.py", "parallel/mesh.py",
                 "parallel/sharded_raster.py", "parallel/sharded_dba.py",
                 "parallel/sharded_track.py")


def test_one_semantics_modules_import_no_image_library():
    for rel in ONE_SEMANTICS:
        path = PORT / rel
        bad = [m for m in _imports(path)
               if m.split(".")[0] in ("cv2", "scipy", "matplotlib", "PIL")]
        assert not bad, f"{rel} imports {bad}"
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ExceptHandler) and node.type is not None:
                assert "ImportError" not in ast.unparse(node.type), rel


def test_port_sources_import_no_cv2_or_pil():
    """The card's machine has neither: the port decodes images with its
    native library (native/) and resamples with torch and numpy."""
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert PORT / "native" / "__init__.py" in files
    for path in files:
        bad = [m for m in _imports(path) if m.split(".")[0] in ("cv2", "PIL")]
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
