#!/usr/bin/env python3
"""Where the aggregation tier's device memory goes, stage by stage.

    python3 tools/tier_memory.py          # one CUDA GPU

Runs ``chip_smoke.py``'s phase-2f sessions (qwen2-1.5b widths at 2 layers,
4 leaves x 2 slots, bits 32, each session one arrival batch) for the flat
``AsyncServer`` and the tier in ``client`` and ``tee_stream``, both
topologies, and prints for each stage the memory allocated when it ends
and the peak allocated during it (``torch.cuda.max_memory_allocated``,
reset per stage): the server built, the stacked batch of 8, the client
encode, the landing (with session 0's flush inside), session 1's batch of
6 and its recovering flush.  Builds the kernels first.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402

GIB = 2 ** 30


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA GPU")
        return 2
    from repro_torch.configs import qwen2_1_5b
    from repro_torch.core.fl.async_fl import AsyncServer
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    cs.build_kernels()
    mp = cs.MainPath(torch, 0, qwen2_1_5b.CONFIG)
    sessions = [(list(range(8)), list(range(8))),
                (list(range(8, 14)), [0, 1, 2, 4, 5, 7])]

    for mode, topo in (("client", None), ("client", "flat"),
                       ("client", "tree"), ("tee_stream", "flat"),
                       ("tee_stream", "tree")):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        stages = []

        def stage(name):
            torch.cuda.synchronize()
            stages.append((name, torch.cuda.memory_allocated() / GIB,
                           torch.cuda.max_memory_allocated() / GIB))
            torch.cuda.reset_peak_memory_stats()

        stage("start")
        if topo is None:
            srv = AsyncServer(mp.params, cs._tier_fl(32), buffer_size=8,
                              staleness_mode="constant", mask_mode=mode,
                              device="cuda")
        else:
            srv, _ = cs._tier_server(mp, mode, topo == "tree")
        stage("server built")
        for version, (idx, slots) in enumerate(sessions):
            if topo is None:
                for i, s in zip(idx, slots):
                    d = mp.delta(i)
                    srv.push_encoded(srv.encode_push(d, version, slot=s))
                    del d
                stage(f"session {version}: {len(idx)} pushes")
                continue
            batch = cs.stacked_deltas(torch, mp, idx)
            stage(f"session {version}: stacked batch of {len(idx)}")
            if mode == "client":
                cps = srv.encode_push(batch, version, slot=slots)
                stage(f"session {version}: encode")
                srv.push_encoded(cps)
                del cps
            else:
                srv.push(batch, version, slots=slots)
            del batch
            stage(f"session {version}: land"
                  + (" + full flush" if version == 0 else ""))
        srv.flush()
        stage("recovering flush")
        del srv
        name = "flat AsyncServer" if topo is None else f"tier {topo}"
        print(f"{name} {mode} ({smi}):")
        for s, now, peak in stages:
            print(f"  {s:40s} allocated {now:6.2f} GiB, peak {peak:6.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
