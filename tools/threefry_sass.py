#!/usr/bin/env python3
"""Instruction counts of the PRF kernels' main loops, read from their SASS.

    python3 tools/threefry_sass.py [--out FILE]   # needs nvcc's cuobjdump
    ncu --metrics ... python3 tools/threefry_sass.py --launch   # one K1 and
        # one K2 PRF-lane launch at the main path's embedding chunk (GPU)

Builds the CUDA libraries if they are missing (``kernels/_build.py``), runs
``cuobjdump -sass`` on the libraries of K1 (``quantize_mask_prf``) and K2
(``weighted_quantize_accum``), and for every kernel instantiation prints the
largest loop (the span between a backward branch and its target) with its
instructions counted by opcode.  In K1's ``<7, false>`` loop one iteration
evaluates 16 Threefry-2x32-13 (two counters of the uniform stream and of
each of 7 mask streams); each Threefry round rotates once (``SHF``, or a
``PRMT`` byte permute for the rotations by 16 and 24), so the loop's
rotations / 13 counts the Threefry evaluations the compiler emitted, and
the integer instructions per evaluation follow.  ``--out`` also writes the
whole disassembly.  Prints whether ``ncu`` is on the path (the issue-slot
utilisation needs it).
"""
from __future__ import annotations

import argparse
import collections
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                  r"([^;]*);")
TARGET = re.compile(r"0x([0-9a-f]+)")
# integer ALU opcodes a Threefry round is built from
PRF_OPS = ("IADD3", "LOP3", "SHF", "PRMT", "IMAD", "IADD")


def functions(sass: str):
    """{function name: [(address, opcode, operands)]}."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = LINE.search(line)
        if m and name:
            out[name].append((int(m.group(1), 16), m.group(2), m.group(3)))
    return out


def largest_loop(instrs):
    """Instructions of the widest backward-branch span."""
    best = (0, 0)
    for addr, op, args in instrs:
        if op.startswith("BRA"):
            t = TARGET.search(args)
            if t and int(t.group(1), 16) < addr:
                lo = int(t.group(1), 16)
                if addr - lo > best[1] - best[0]:
                    best = (lo, addr)
    return [i for i in instrs if best[0] <= i[0] <= best[1]]


def launch_once() -> int:
    """One K1 launch (233,373,696 elements, slot 3 of an 8-slot complete
    graph) and one K2 PRF-lane launch (8 rows of that width)."""
    import torch
    from repro_torch.kernels import prf
    from repro_torch.kernels import secure_agg as ksa
    D = 151_936 * 1536
    session = ksa.SessionMeta(key_words=(0x5A5E, 0xC401), num_slots=8)
    x = torch.randn(8, D, device="cuda") * 2e-5
    u = prf.uniform_block(7, 8, 8 * D, device="cuda").reshape(8, D)
    ksa.quantize_mask_prf(x[0], 1e8, 3, (1, 2), session)
    ksa.weighted_quantize_accum(x, torch.ones(8, device="cuda"), u, 1e8,
                                session=session)
    torch.cuda.synchronize()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--launch", action="store_true",
                    help="launch K1 and K2's PRF lane once each instead")
    args = ap.parse_args()
    if args.launch:
        return launch_once()
    from repro_torch.kernels import _build
    _build.build_all()
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    dump = []
    for name in ("quantize_mask_prf", "weighted_quantize_accum"):
        sass = subprocess.run([str(tool), "-sass",
                               str(_build.library_path(name))],
                              capture_output=True, text=True,
                              check=True).stdout
        dump.append(sass)
        for fn, instrs in functions(sass).items():
            if "launch" in fn or not instrs:
                continue
            loop = largest_loop(instrs)
            ops = collections.Counter(op.split(".")[0] for _, op, _ in loop)
            rot = ops["SHF"] + ops["PRMT"]
            prf_ops = sum(ops[k] for k in PRF_OPS)
            print(f"{name}: {fn}")
            print(f"  kernel {len(instrs)} instructions; main loop "
                  f"{len(loop)} instructions, {rot} rotations "
                  f"(SHF+PRMT) = {rot / 13:.2f} Threefry-13 evaluations; "
                  f"integer ALU {prf_ops}"
                  + (f" = {prf_ops / (rot / 13):.1f} per evaluation"
                     if rot else ""))
            print("  by opcode: " + ", ".join(
                f"{k} {v}" for k, v in ops.most_common()))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(dump))
    print(f"ncu on the path: {shutil.which('ncu') or 'no'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
