"""Run one cell of the benchmark on the GPU and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up (weights and inputs from the seed, the
system built and warmed on every shape the window uses) counts as
``setup_s``; then the window measures for ``--seconds``.  ``--trace 0``
reports the cell's end-to-end metrics, ``--trace 1`` its per-layer metrics
(fenced spans over the window, ``torch.profiler`` over a few units after
it).  Then the outputs are checked against the plain reference; the last
lines on standard error, and the result's last key, are each compared
number beside its limit.  The last line on standard output is the result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def setup_environment(root: Path = ROOT) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    build = root / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "repro_torch_kernels")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    here = str(root / "bench")
    sys.path[:] = [p for p in sys.path if p != here]
    for p in (str(root), str(root / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def run_cell(name: str, spec: dict, seed: int, seconds: float, trace: bool,
             device) -> tuple:
    """Set-up, window, (trace,) check.  Returns (result line, checks)."""
    import torch

    from bench import harness as H
    from repro_torch.core.telemetry import Telemetry

    tel = Telemetry(record_spans=trace, fence=trace)
    entry = H.load_entry(spec["traffic"]["entry"])
    run = entry.Cell(spec, seed, device, tel)
    setup_s = time.perf_counter() - T_START
    n0 = len(tel.spans)
    res = run.window(seconds)
    window_spans = tel.spans[n0:]
    prof = run.profile() if trace else None
    cuda = str(device).startswith("cuda")
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    print(f"card: {power_limit() if cuda else device}; window "
          f"{run.window_s:.3f} s", file=sys.stderr)

    e2e, per_layer = H.metrics_for(name, H.benchmark())
    if trace:
        ctx = {"entry": spec["traffic"]["entry"], "spans": window_spans,
               "window_s": run.window_s, "profile": prof, "work": run.work(),
               "cell": run}
        metrics = H.read_layer_metrics(per_layer, ctx)
    else:
        # ``<quantity>.<group>`` is the entry's ``<quantity>``, bounded apart
        # for a group of cells whose runs spread alike
        measured = dict(res["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": float(measured[m["name"].split(".")[0]]),
                               "unit": m["unit"]} for m in e2e}
    checks = run.check(spec["cell"]["limits"])
    del run
    out = {"correct": all(v <= lim for v, lim in checks.values()),
           "attempted": res["attempted"], "failed": res["failed"],
           "metrics": metrics,
           "device": {"platform": "gpu" if cuda else str(device),
                      "kind": torch.cuda.get_device_name(0) if cuda
                      else str(device),
                      "count": spec["chips"], "memory_peak_bytes": int(peak)}}
    if trace:
        out["device"].update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        out["breakdown"] = prof["breakdown"]
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out, checks


def main(argv=None) -> int:
    args = parse_args(argv)
    setup_environment()
    import torch

    from bench import harness as H

    spec = H.cell_spec(args.workload)
    chips = spec["chips"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"needs {chips} CUDA device(s); torch.cuda.is_available()="
              f"{torch.cuda.is_available()}, device_count={have}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    out, checks = run_cell(args.workload, spec, args.seed, args.seconds,
                           bool(args.trace), "cuda")
    found = H.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for k, (v, lim) in checks.items():
        print(f"check {k} = {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
