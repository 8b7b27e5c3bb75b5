#!/usr/bin/env python3
"""Serve the five non-dense families on the card, alone: ``chip_smoke.py``'s
phase 2g with the K10 parts of its phases 1, 3 and 4.

    python3 tools/serve_families.py       # one CUDA GPU, ~2.5 min

Builds the kernels, holds K10 against its plain version on phase 1's
cases (the new served shapes among them), runs phase 2g (deepseek-moe-16b
at 4 layers, published capacity and drop-free; mamba2-780m; recurrentgemma-
2b; internvl2-76b at 2 layers; whisper-tiny; each through ``serve.main``
or ``serve.generate`` at full width with its gates), checks each run's K10
launches and that no plain version ran, and times K10 at phase 4's shapes
beside SDPA.  Exits non-zero on any failed gate.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA GPU")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {smi}",
          flush=True)
    with cs.Phase("build"):
        cs.build_kernels()
    with cs.Phase("K10 parity"):
        g = torch.Generator(device="cuda").manual_seed(1)
        cs.flash_decode_parity(torch, g)
    counts = {}
    with cs.Phase("phase 2g: serving the other families at full width"):
        cs.families_path(torch, 0, counts, smi)
    for run, *_, per_step in cs.FAMILY_RUNS:
        got = counts[f"serve-{run}"]
        cs.log(f"  serve-{run}: " + json.dumps(got["flash_decode"]))
        cs.check(got["flash_decode"] == {
            "launches": per_step * cs.FAMILY_STEPS, "plain_calls": 0},
                 f"serve-{run}: K10 {got['flash_decode']}")
        cs.check(all(v["launches"] == v["plain_calls"] == 0
                      for k, v in got.items() if k != "flash_decode"),
                 f"serve-{run}: another kernel ran: {got}")
    with cs.Phase("K10 device times"):
        entry = cs.flash_decode_times(
            torch, sum(v["flash_decode"]["launches"]
                       for v in counts.values()))
    print(smi, flush=True)
    print(json.dumps(entry), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
