"""The port stands alone: importing ``repro_torch`` and every submodule pulls
in nothing of JAX, of the JAX package ``repro`` or of ``triton``, and needs
no ``nvcc`` (the kernels build at first launch)."""
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "triton"))
print(len(names), "modules;", "leaked:", bad)
sys.exit(1 if bad else 0)
"""


def test_repro_torch_imports_no_jax_repro_or_triton():
    env = dict(os.environ, PYTHONPATH=str(SRC), PATH="/usr/bin:/bin")
    out = subprocess.run([sys.executable, "-c", PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "leaked: []" in out.stdout
    assert int(out.stdout.split()[0]) >= 15
