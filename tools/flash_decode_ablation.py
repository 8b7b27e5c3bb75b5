#!/usr/bin/env python3
"""Where K10's time goes: the kernel timed with parts of it taken out.

    python3 tools/flash_decode_ablation.py        # one CUDA GPU, nvcc

Builds copies of ``csrc/flash_decode.cu`` with text cut out of the kernel
(each copy into ``build/flash_decode_ablation/``) and times each at the
serve shape (B=8, H=12, KV=2, hd=128, W=2080, f32, 8 cache copies cycled)
and at decode_32k (B=128, W=32768), at the split count the wrapper
chooses, beside the byte bound:
  full          the kernel as it ships;
  no_merge      the last CTA of a row takes its ticket and writes zeros
                instead of merging the splits;
  no_ticket     each CTA writes its partial and exits: no fence, no
                ticket, no merge;
  stream_only   as no_ticket, and the tile loop only waits for its copies:
                no scores, softmax or P.V (the ring's streaming alone).
Differences between rows are the cost of what was cut.  Only ``full``
computes the attention; it is held against the plain version.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from chip_smoke import FD_SHAPES, HBM_BYTES_PER_S, _cycled, _device_ms  # noqa: E402

H, KV, HD = 12, 2, 128
MERGE = "  if (!last) return;\n  __threadfence();\n"
TICKET = "  // the last CTA of (b, g, row group) to finish merges the splits\n"
KERNEL_END = "template <typename T, int HD>\nauto kernel_for()"
SCORE = "    // this lane's slot and its mask, loaded early"
TILE_END = "    __syncwarp();\n  }\n  cp_async_wait<0>();"


def _cut(src: str, start: str, end: str, put: str) -> str:
    a, b = src.index(start), src.index(end)
    return src[:a] + put + src[b:]


def variants(src: str) -> dict:
    zeros = ("  if (!last) return;\n"
             "  const int64_t bh0 = static_cast<int64_t>(b) * H + h0;\n"
             "  for (int i = threadIdx.x; i < nr * HD; i += kThreads)\n"
             "    out[(bh0 + i / HD) * HD + i % HD] = 0.f;\n}\n\n")
    no_ticket = _cut(src, TICKET, KERNEL_END, "}\n\n")
    stream = _cut(no_ticket, SCORE, TILE_END, "")
    stream = stream.replace(TILE_END, "  }\n  cp_async_wait<0>();", 1)
    return {"full": src, "no_merge": _cut(src, MERGE, KERNEL_END, zeros),
            "no_ticket": no_ticket, "stream_only": stream}


def build(out: Path) -> dict:
    from repro_torch.kernels import _build
    src = (_build.CSRC / "flash_decode.cu").read_text()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants(src).items():
        (out / f"{name}.cu").write_text(text)
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(out / f"{name}.so"), str(out / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log[-3000:]}")
        fn = ctypes.CDLL(str(out / f"{name}.so")).flash_decode_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int32] * 9 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA GPU")
        return 2
    from repro_torch.kernels import flash_decode as kfd
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    libs = build(ROOT / "build" / "flash_decode_ablation")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_sm = kfd.ctas_per_sm("cuda", HD, False)
    tickets = torch.zeros(1 << 16, dtype=torch.int32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(3)
    for shape, B, W in FD_SHAPES:
        nsplit = kfd.splits(B, KV, H // KV, W, sms=sms, per_sm=per_sm)
        nbuf = 8 if shape == "serve" else 1
        q = torch.randn(B, H, HD, generator=g, device="cuda") * HD ** -0.5
        ks = [torch.randn(B, W, KV, HD, generator=g, device="cuda")
              for _ in range(nbuf)]
        vs = [torch.randn(B, W, KV, HD, generator=g, device="cuda")
              for _ in range(nbuf)]
        slot = torch.arange(W, device="cuda", dtype=torch.int32)
        part_acc = torch.empty((B, H, nsplit, HD), device="cuda")
        part_ml = torch.empty((B, H, nsplit, 2), device="cuda")
        bound = 2 * B * W * KV * HD * 4 / HBM_BYTES_PER_S * 1e3
        for name, fn in libs.items():
            def call(i, fn=fn):
                out = torch.empty_like(q)
                status = fn(q.data_ptr(), ks[i].data_ptr(), vs[i].data_ptr(),
                            slot.data_ptr(), out.data_ptr(),
                            part_acc.data_ptr(), part_ml.data_ptr(),
                            tickets.data_ptr(), B, H, KV, W, HD, 0, W - 1, 0,
                            nsplit, torch.cuda.current_stream().cuda_stream)
                if status:
                    raise RuntimeError(f"{name}: CUDA error {status}")
                return out
            if name == "full":
                want = kfd.flash_decode_plain(q, ks[0], vs[0], slot, W - 1)
                if not torch.allclose(call(0), want, rtol=2e-5, atol=2e-5):
                    print(f"FAIL: full != plain at {shape}")
                    return 1
            ms = _device_ms(torch, _cycled(call, nbuf),
                            50 if nbuf > 1 else 10)
            print(f"{shape} ({nsplit} splits) {name}: {ms:.4f} ms (bound "
                  f"{bound:.4f} ms, {bound / ms:.2f} of it)", flush=True)
        del q, ks, vs, part_acc, part_ml
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
