#!/usr/bin/env python3
"""How fast the tier's root combine (``hierarchy.combine``) runs between
ranks on one host.

    python3 tools/gloo_combine.py           # one CUDA GPU or more

Spawns gloo worlds of 2 and 4 ranks sharing cuda:0 and, with two cards or
more, an NCCL world of one rank a card (``repro_torch.launch.dist.run``).
Each rank combines one int32 partial of 2^25 words (the tier's 2^25-element
chunk, 128 MB) three times, and reports ms and GB/s of what a rank sends
(``2 (W - 1) / W`` of the partial: the exchange out, the gather back).
The words are checked against their sum mod 2^32.
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


def _words(rank: int, device):
    """Rank ``rank``'s partial, int64 words before the wrap to int32."""
    import torch
    return (torch.arange(N, dtype=torch.int64, device=device) * 2654435761
            + rank * (3 << 30))


def _rank(rank: int, world: int):
    import torch
    import torch.distributed as tdist

    from repro_torch.core import telemetry as tele
    from repro_torch.core.fl import hierarchy
    from repro_torch.kernels import prf
    from repro_torch.launch import dist
    from repro_torch.launch.mesh import make_leaf_mesh
    dev = dist.current_device()
    mesh = make_leaf_mesh(world, device=dev, group=tdist.group.WORLD)
    base = prf.to_int32(_words(rank, dev))
    want = prf.to_int32(sum(_words(r, dev) for r in range(world)))
    tel = tele.Telemetry()
    times = []
    for _ in range(REPS):
        x = base.clone()
        torch.cuda.synchronize()
        tdist.barrier()
        t0 = time.perf_counter()
        hierarchy.combine([x], mesh, tel)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if not torch.equal(x, want):
            raise AssertionError("wrong sum")
    return times


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
    worlds = [(2, "gloo"), (4, "gloo")]
    if torch.cuda.device_count() > 1:
        worlds.append((torch.cuda.device_count(), "nccl"))
    for world, backend in worlds:
        ranks = dist.run(_rank, world, device="cuda", backend=backend)
        ms = sorted(t for r in ranks for t in r)
        med = ms[len(ms) // 2]
        sent = 2 * (world - 1) * 4 * N / world
        print(f"{backend} world of {world}: median {med:.1f} ms over "
              f"{len(ms)} (min {ms[0]:.1f}, max {ms[-1]:.1f}); "
              f"{sent / med / 1e6:.2f} GB/s sent a rank; {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
