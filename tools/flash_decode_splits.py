#!/usr/bin/env python3
"""Device time of the K10 flash-decode kernel against its split count.

    python3 tools/flash_decode_splits.py          # one CUDA GPU

For each shape (the serve path's B=8, W=2080; decode_32k's B=128,
W=32768; B=32, W=8192 between them; qwen2's 12 heads over 2 kv heads,
head_dim 128, f32 and bf16 K/V) prints the kernel's device time at the
split count ``repro_torch.kernels.flash_decode.splits`` chooses (whole
waves of the kernel's CTAs) and at counts around it, the CTAs and waves of
each, beside the byte bound.  The time is taken between CUDA events around
back-to-back calls queued behind a sleep kernel, so the host's launch cost
does not count; a cache smaller than the 50 MB L2 is cycled over 8 copies,
as the serve path reads each layer's cold.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from chip_smoke import FD_SHAPES, _cycled, _device_ms  # noqa: E402
from repro_torch.launch.analysis import HBM_BW  # noqa: E402

SHAPES = FD_SHAPES[:1] + (("b32_w8192", 32, 8192),) + FD_SHAPES[1:]
# split counts tried beside the wrapper's choice, as multiples of it
FACTORS = (0.25, 0.5, 1, 2, 4)
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
    choose = kfd.splits
    sms = torch.cuda.get_device_properties(0).multi_processor_count
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
                / HBM_BW * 1e3
            want = kfd.flash_decode_plain(q, ks[0], vs[0], slot, W - 1)
            per_sm = kfd.ctas_per_sm("cuda", HD, dtype == torch.bfloat16)
            default = choose(B, KV, H // KV, W, sms=sms, per_sm=per_sm)
            tried = sorted({max(1, min(int(default * f), kfd.MAX_SPLITS, W))
                            for f in FACTORS})
            for nsplit in tried:
                kfd.splits = lambda *a, _n=nsplit, **kw: _n
                got = kfd.flash_decode(q, ks[0], vs[0], slot, W - 1)
                if not torch.allclose(got, want, rtol=2e-5, atol=2e-5):
                    print(f"FAIL: {name} {dtype} {nsplit} splits differ")
                    kfd.splits = choose
                    return 1
                call = _cycled(lambda i: kfd.flash_decode(
                    q, ks[i], vs[i], slot, W - 1), nbuf)
                ms = _device_ms(torch, call, 50 if nbuf > 1 else 10)
                ctas = kfd.row_groups(B, KV, H // KV) * nsplit
                print(f"{name} B={B} W={W} {str(dtype)[6:]}: {nsplit} "
                      f"splits{' (chosen)' if nsplit == default else ''}, "
                      f"{ctas} CTAs = {ctas / (sms * per_sm):.3g} waves of "
                      f"{sms} x {per_sm}: {ms:.4f} ms, bound {bound:.4f} ms "
                      f"({bound / ms:.2f} of it)", flush=True)
            kfd.splits = choose
            del ks, vs
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
