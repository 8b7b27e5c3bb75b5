#!/usr/bin/env python3
"""How torch's CPU square roots round on this host, against numpy's (IEEE,
correctly rounded), and ``prf.sqrt_f32`` (the port's f32 root).

    PYTHONPATH=src python3 tools/sqrt_rounding.py [--exhaustive]

Prints torch's CPU capability, then on 2^22 values uniform in [0, 1e4)
from seed 0 the values where torch's f32 ``sqrt`` and its f64 ``sqrt``
differ from numpy's, and the first value where torch's f32 root of
22.399402618408203 (a whole-model norm of tests/test_torch_compression.py)
differs.  ``--exhaustive`` holds the f64 root rounded to f32 (the CPU side
of ``prf.sqrt_f32``) against numpy's f32 root on every non-negative finite
f32 (about 15 s with 4 threads).
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.kernels import prf  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--exhaustive", action="store_true")
    args = ap.parse_args()
    print(f"torch {torch.__version__}, CPU capability "
          f"{torch.backends.cpu.get_cpu_capability()}")
    x64 = np.random.default_rng(0).uniform(0.0, 1e4, 1 << 22)
    x32 = x64.astype(np.float32)
    f32 = torch.sqrt(torch.from_numpy(x32)).numpy()
    f64 = torch.sqrt(torch.from_numpy(x64)).numpy()
    helper = prf.sqrt_f32(torch.from_numpy(x32)).numpy()
    n = len(x32)
    print(f"torch f32 sqrt != numpy on {int((f32 != np.sqrt(x32)).sum()):,} "
          f"of {n:,}")
    print(f"torch f64 sqrt != numpy on {int((f64 != np.sqrt(x64)).sum()):,} "
          f"of {n:,}")
    print(f"prf.sqrt_f32 != numpy on "
          f"{int((helper != np.sqrt(x32)).sum()):,} of {n:,}")
    v = np.float32(22.399402618408203)
    print(f"sqrt({float(v)!r}): torch f32 "
          f"{torch.sqrt(torch.tensor(v)).item():.9g}, numpy "
          f"{float(np.sqrt(v)):.9g}, prf.sqrt_f32 "
          f"{prf.sqrt_f32(torch.tensor(v)).item():.9g}")
    if args.exhaustive:
        bad, step, top = 0, 1 << 24, 0x7F800000
        for s in range(0, top, step):
            x = np.arange(s, min(s + step, top), dtype=np.uint32
                          ).view(np.float32)
            got = torch.sqrt(torch.from_numpy(x).double()).float().numpy()
            bad += int((got.view(np.uint32)
                        != np.sqrt(x).view(np.uint32)).sum())
        print(f"f64 sqrt rounded to f32 != numpy on {bad:,} of {top:,} "
              f"non-negative finite f32")
    return 0


if __name__ == "__main__":
    sys.exit(main())
