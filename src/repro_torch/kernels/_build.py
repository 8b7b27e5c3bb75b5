"""Build the CUDA kernels from ``csrc/`` at first use and load them.

Each ``csrc/*.cu`` source becomes one shared library with a plain C
interface, compiled by ``nvcc`` for Hopper (``sm_90a``) and loaded with
``ctypes``.  All missing libraries are compiled together, one ``nvcc``
process per source started at once.  A library's file name carries a hash of
its source, the shared headers and the flags, so an edited source is rebuilt
and an unchanged one is reused.  ``--fmad=false`` keeps float products from
contracting into FMAs, which the kernels' bit-exactness relies on.

Libraries go to ``build/repro_torch_kernels/`` at the repository root
(``REPRO_TORCH_BUILD_DIR`` overrides).  Importing this module needs neither
``nvcc`` nor a GPU; only :func:`load` and :func:`build_all` do.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("quantize_mask_prf", "weighted_quantize_accum",
           "rotate_quantize_prf", "pack_residues", "flash_decode",
           "dp_clip", "quantize_mask", "bitagg", "jax_random", "row_sum",
           "pair_sum")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return build_dir() / f"lib{name}_{_digest(name)}.so"


def build_all(*, verbose: bool = False) -> Dict[str, str]:
    """Compile every source whose library is missing, all in parallel.

    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory and spills
    per kernel; the binary is unchanged).  Returns the compiler output of
    each source built now.
    """
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs: List = []
    for name in SOURCES:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs: Dict[str, str] = {}
    failed = []
    for name, target, tmp, proc in procs:
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built first if needed)."""
    lib = _loaded.get(name)
    if lib is None:
        if name not in SOURCES:
            raise KeyError(f"no kernel source {name!r}; have {SOURCES}")
        if not library_path(name).exists():
            build_all()
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib
