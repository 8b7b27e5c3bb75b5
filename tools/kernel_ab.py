#!/usr/bin/env python3
"""K4 and K10 of two checkouts of the port, timed on one card in turns.

    git archive <commit> | tar -x -C build/parent      # a second checkout
    python3 tools/kernel_ab.py --parent build/parent    # one CUDA GPU

Runs parent, change, change, parent, each in its own process (each side
builds its own kernels under its own ``build/``), and prints each run's
times and a summary:
  - K4 ``rotate_quantize_prf`` at the sketch push's embedding chunk
    (233,373,696 elements) at an odd (12345) and an even (0) uniform
    offset: CUDA events around 10 back-to-back calls;
  - K10 ``flash_decode`` at the serve shape (B=8, H=12, KV=2, hd=128,
    W=2080, f32, 8 cache copies cycled so each call reads cold) and at
    decode_32k (B=128, W=32768): device time of calls queued behind a sleep
    kernel, so the host's launch cost does not count.
Each side's results are held against its own plain versions.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
EMBED = 151_936 * 1536
FD_SHAPES = (("serve", 8, 2080), ("decode_32k", 128, 32768))


def _events_ms(torch, fn, reps: int, *, queued: bool) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def worker() -> dict:
    import torch
    from repro_torch.kernels import flash_decode as kfd
    from repro_torch.kernels import secure_agg as ksa
    g = torch.Generator(device="cuda").manual_seed(0)
    res = {}
    x = torch.randn(EMBED, generator=g, device="cuda") * 2e-5
    scale = 67108862.75 / 4.0
    for u_off in (12345, 0):
        run = lambda: ksa.rotate_quantize_prf(  # noqa: E731
            x, scale, (0x1234, 0xCB01), (1, 2), u_offset=u_off)
        if not torch.equal(run(), ksa.rotate_quantize_prf_plain(
                x, scale, (0x1234, 0xCB01), (1, 2), u_offset=u_off)):
            raise AssertionError(f"K4 != plain at u_offset {u_off}")
        res[f"k4_u{u_off}_ms"] = _events_ms(torch, run, 10, queued=False)
    del x
    torch.cuda.empty_cache()
    H, KV, hd = 12, 2, 128
    for shape, B, W in FD_SHAPES:
        nbuf = 8 if shape == "serve" else 1
        q = torch.randn(B, H, hd, generator=g, device="cuda") * hd ** -0.5
        ks = [torch.randn(B, W, KV, hd, generator=g, device="cuda")
              for _ in range(nbuf)]
        vs = [torch.randn(B, W, KV, hd, generator=g, device="cuda")
              for _ in range(nbuf)]
        slot = torch.arange(W, device="cuda", dtype=torch.int32)
        got = kfd.flash_decode(q, ks[0], vs[0], slot, W - 1)
        want = kfd.flash_decode_plain(q, ks[0], vs[0], slot, W - 1)
        if not torch.allclose(got, want, rtol=2e-5, atol=2e-5):
            raise AssertionError(f"K10 != plain at {shape}")
        state = [0]

        def call():
            i = state[0] % nbuf
            state[0] += 1
            return kfd.flash_decode(q, ks[i], vs[i], slot, W - 1)
        res[f"k10_{shape}_ms"] = _events_ms(
            torch, call, 50 if nbuf > 1 else 10, queued=True)
        del q, ks, vs
        torch.cuda.empty_cache()
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path,
                    help="root of the other checkout (its src/)")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker()), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA GPU")
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    sides = {"parent": args.parent.resolve(), "change": ROOT}
    runs = []
    for name in ("parent", "change", "change", "parent"):
        env = dict(os.environ, PYTHONPATH=str(sides[name] / "src"))
        env.pop("REPRO_TORCH_BUILD_DIR", None)
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--worker"], env=env, capture_output=True,
                             text=True, cwd=sides[name])
        if out.returncode != 0:
            print(f"FAIL: {name} run:\n{out.stdout[-3000:]}"
                  f"{out.stderr[-3000:]}")
            return 1
        res = json.loads(out.stdout.strip().splitlines()[-1])
        runs.append((name, res))
        print(name, json.dumps(res), flush=True)
    for key in runs[0][1]:
        vals = {n: [r[key] for m, r in runs if m == n]
                for n in ("parent", "change")}
        print(f"{key}: parent {' / '.join(f'{v:.4f}' for v in vals['parent'])}"
              f", change {' / '.join(f'{v:.4f}' for v in vals['change'])}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
