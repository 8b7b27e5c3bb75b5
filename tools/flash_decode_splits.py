#!/usr/bin/env python3
"""Device time of the K10 flash-decode kernel against its split count.

    python3 tools/flash_decode_splits.py          # one CUDA GPU

For each shape (the serve path's B=8, W=2080; decode_32k's B=128,
W=32768; B=32, W=8192 between them; qwen2's 12 heads over 2 kv heads,
head_dim 128, f32 and bf16 K/V) and each ``TARGET_BLOCKS`` of
``repro_torch.kernels.flash_decode.splits``, prints the splits, the blocks
and the kernel's device time beside the byte bound.  The time is taken
between CUDA events around back-to-back calls queued behind a sleep kernel,
so the host's launch cost does not count; a cache smaller than the 50 MB
L2 is cycled over 8 copies, as the serve path reads each layer's cold.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from chip_smoke import FD_SHAPES, HBM_BYTES_PER_S, _cycled, _device_ms  # noqa: E402

SHAPES = FD_SHAPES[:1] + (("b32_w8192", 32, 8192),) + FD_SHAPES[1:]
TARGETS = (132, 264, 528, 1056, 2112, 4224, 8448, 16896)
H, KV, HD = 12, 2, 128


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA GPU")
        return 2
    from repro_torch.kernels import flash_decode as kfd
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    default = kfd.TARGET_BLOCKS
    g = torch.Generator(device="cuda").manual_seed(3)
    for name, B, W in SHAPES:
        nbuf = 8 if B * W * KV * HD * 8 < 50e6 else 1
        q = torch.randn(B, H, HD, generator=g, device="cuda") * HD ** -0.5
        slot = torch.arange(W, device="cuda", dtype=torch.int32)
        for dtype in (torch.float32, torch.bfloat16):
            ks = [torch.randn(B, W, KV, HD, generator=g, device="cuda")
                  .to(dtype) for _ in range(nbuf)]
            vs = [torch.randn(B, W, KV, HD, generator=g, device="cuda")
                  .to(dtype) for _ in range(nbuf)]
            bound = 2 * B * W * KV * HD * ks[0].element_size() \
                / HBM_BYTES_PER_S * 1e3
            want = kfd.flash_decode_plain(q, ks[0], vs[0], slot, W - 1)
            for target in TARGETS:
                kfd.TARGET_BLOCKS = target
                got = kfd.flash_decode(q, ks[0], vs[0], slot, W - 1)
                if not torch.allclose(got, want, rtol=2e-5, atol=2e-5):
                    print(f"FAIL: {name} {dtype} target {target} differs")
                    return 1
                call = _cycled(lambda i: kfd.flash_decode(
                    q, ks[i], vs[i], slot, W - 1), nbuf)
                ms = _device_ms(torch, call, 50 if nbuf > 1 else 10)
                nsplit, chunk = kfd.splits(B, KV, H // KV, W)
                print(f"{name} B={B} W={W} {str(dtype)[6:]} target={target}"
                      f"{' (default)' if target == default else ''}: "
                      f"{nsplit} splits of {chunk}, {nsplit * B * KV} "
                      f"blocks: {ms:.4f} ms, bound {bound:.4f} ms "
                      f"({bound / ms:.2f} of it)", flush=True)
            kfd.TARGET_BLOCKS = default
            del ks, vs
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
