#!/usr/bin/env python3
"""How fast the tier's root combine moves words between ranks on one host.

    python3 tools/gloo_combine.py           # one CUDA GPU

Spawns gloo worlds of 2 and 4 ranks sharing cuda:0 and an NCCL world of
one rank a card (``repro_torch.launch.dist.run``).  Each rank sums one
chunk of 2^25 int64 words (the tier's combine payload for a 2^25-element
chunk, 256 MB) in tiles, three times per way, and reports ms and GB/s a
rank: gloo with each tile copied to the host first (at 2^22 and 2^24
words a tile), gloo handed the CUDA tensor itself (it stages it on its
own; ``hierarchy.combine`` does this), and NCCL.  The words are checked
against their expected sum.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]

N = 1 << 25
REPS = 3


def _rank(rank: int, world: int, ways):
    import torch
    import torch.distributed as tdist

    from repro_torch.launch import dist
    dev = dist.current_device()
    group = tdist.group.WORLD
    base = torch.arange(N, dtype=torch.int64, device=dev) + rank
    want = (torch.arange(N, dtype=torch.int64, device=dev) * world
            + world * (world - 1) // 2)
    out = {}
    for name, tile, staged in ways:
        times = []
        for _ in range(REPS):
            x = base.clone()
            torch.cuda.synchronize()
            tdist.barrier()
            t0 = time.perf_counter()
            for s in range(0, N, tile):
                t = x[s:s + tile]
                if staged:  # an explicit host copy
                    h = t.cpu()
                    tdist.all_reduce(h, group=group)
                    t.copy_(h)
                else:
                    tdist.all_reduce(t, group=group)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if not torch.equal(x, want):
                raise AssertionError(f"{name}: wrong sum")
        out[name] = times
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA GPU")
        return 2
    from repro_torch.launch import dist
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    staged = [("staged tile 2^22", 1 << 22, True),
              ("staged tile 2^24", 1 << 24, True)]
    native = [("cuda tensor tile 2^22", 1 << 22, False)]
    worlds = [(2, "gloo", staged), (2, "gloo", native), (4, "gloo", staged),
              (4, "gloo", native),
              (torch.cuda.device_count(), "nccl",
               [("nccl tile 2^22", 1 << 22, False)])]
    for world, backend, ways in worlds:
        try:
            ranks = dist.run(_rank, world, ways, device="cuda",
                             backend=backend)
        except Exception as e:  # report a way the backend refuses
            print(f"{backend} world of {world}: failed: "
                  f"{str(e).strip().splitlines()[-1]}", flush=True)
            continue
        for name, *_ in ways:
            ms = sorted(t for r in ranks for t in r[name])
            med = ms[len(ms) // 2]
            print(f"{backend} world of {world}, {name}: median {med:.1f} ms "
                  f"over {len(ms)} (min {ms[0]:.1f}, max {ms[-1]:.1f}); "
                  f"{8 * N / med / 1e6:.2f} GB/s a rank; {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
