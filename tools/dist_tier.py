#!/usr/bin/env python3
"""The aggregation tier across processes on the card, alone.

    python3 tools/dist_tier.py                  # one CUDA GPU

Runs ``chip_smoke.py``'s phase 2f (the one-process tier at qwen2-1.5b
widths, 2 layers, 4 leaves x 2 slots; it records each run's params digest)
and then phase 2i: the same runs on gloo worlds of 2 and 4 ranks sharing
the card and an NCCL world of one rank per card, each rank's params held
against phase 2f's, with every rank's push, flush (leaf partials /
combine / the rest), combine bytes and peak memory, and the launches
summed over the ranks checked exactly.  Builds the kernels first.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA GPU")
        return 2
    from repro_torch.configs import qwen2_1_5b
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    cs.build_kernels()
    t0 = time.perf_counter()
    mp = cs.MainPath(torch, 0, qwen2_1_5b.CONFIG)
    counts, digests = {}, {}
    want = cs.tier_path(torch, mp, counts, smi, digests)
    print(f"phase 2f {time.perf_counter() - t0:.1f} s", flush=True)
    del mp
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    want = cs.dist_tier_path(torch, 0, digests, counts, smi)
    print(f"phase 2i {time.perf_counter() - t0:.1f} s", flush=True)
    for path, nonzero in want.items():
        got = {k: v["launches"] for k, v in counts[path].items()
               if v["launches"] or v["plain_calls"]}
        cs.check(got == nonzero, f"{path}: launches {got}, want {nonzero}")
    print(f"launches exact on {len(want)} runs", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
