"""The port stands alone: importing ``repro_torch`` and every submodule pulls
in nothing of JAX, of the JAX package ``repro``, of ``msgpack`` (the
checkpoints carry their own codec) or of ``triton``, and needs no ``nvcc``
(the kernels build at first launch).  No import statement of the package
or of ``chip_smoke.py``, at module level or inside a function, names one of
them."""
import ast
import os
import subprocess
import sys
from pathlib import Path
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
BANNED = ("jax", "jaxlib", "repro", "msgpack", "triton")

PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules if m.split(".")[0] in %r)
print(len(names), "modules;", "leaked:", bad)
sys.exit(1 if bad else 0)
""" % (BANNED,)


def test_repro_torch_imports_no_jax_repro_or_triton():
    env = dict(os.environ, PYTHONPATH=f"{SRC}{os.pathsep}{ROOT}",
               PATH="/usr/bin:/bin")
    out = subprocess.run([sys.executable, "-c", PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "leaked: []" in out.stdout
    assert int(out.stdout.split()[0]) >= 15


def _imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_import_statement_names_jax_repro_msgpack_or_triton():
    """Every ``import`` of the package's files and of ``chip_smoke.py``,
    lazy ones inside functions included."""
    files = sorted((SRC / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported(f) if m.split(".")[0] in BANNED]
    assert bad == []


def _pins_threads(path: Path) -> bool:
    """A module-level ``pin_cpu_threads()`` call in the file."""
    return any(isinstance(n, ast.Expr) and isinstance(n.value, ast.Call)
               and getattr(n.value.func, "id", None) == "pin_cpu_threads"
               for n in ast.parse(path.read_text(), str(path)).body)


def test_every_port_test_file_pins_torch_cpu_threads():
    """Under ``pytest -n N`` each worker's torch would start one CPU thread
    per core; every ``tests/test_torch_*.py`` shares the cores out at
    import (``repro_torch.testing.pin_cpu_threads``)."""
    files = sorted((ROOT / "tests").glob("test_torch_*.py"))
    assert len(files) >= 30
    assert [f.name for f in files if not _pins_threads(f)] == []


def test_pin_cpu_threads_shares_the_cores_among_xdist_workers(monkeypatch):
    import torch

    from repro_torch.testing import pin_cpu_threads
    before = torch.get_num_threads()
    cores = os.cpu_count() or 1
    try:
        monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", "6")
        assert pin_cpu_threads() == max(1, cores // 6)
        assert torch.get_num_threads() == max(1, cores // 6)
        monkeypatch.delenv("PYTEST_XDIST_WORKER_COUNT")
        assert pin_cpu_threads() == cores
    finally:
        torch.set_num_threads(before)
