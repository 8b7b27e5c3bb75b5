"""Readings that set the limits of ``correct``, on the card and at a cell's
own size: the system's numbers on many seeds in one process, the control's
(the reference in the next lower precision, put in the system's place) and
planted faults' (``faults.py``).

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--seconds 20] [--control] [--fault unchanged|half|altered]

One JSON line per seed: the compared numbers (the control's prefixed
``control.``).  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1])]

from bench import run as R  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    R.setup_environment()
    import torch

    from bench import faults
    from bench import harness as H
    from repro_torch.core.telemetry import Telemetry

    spec = H.cell_spec(args.workload)
    entry = H.load_entry(spec["traffic"]["entry"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        stack, kw = (faults.plant(args.fault, spec["traffic"]["entry"])
                     if args.fault else (None, {}))
        if stack is not None:
            stack.__enter__()
        try:
            run = entry.Cell(spec, seed, args.device,
                             Telemetry(record_spans=False), **kw)
            run.window(args.seconds)
        finally:
            if stack is not None:
                stack.__exit__(None, None, None)
        checks = run.check(spec["cell"]["limits"], control=args.control)
        del run
        if args.device == "cuda":
            torch.cuda.empty_cache()
        print(json.dumps({"seed": seed, "fault": args.fault,
                          "seconds": time.perf_counter() - t0,
                          **{k: v for k, (v, _) in checks.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
