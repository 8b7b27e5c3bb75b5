"""What every entry of the benchmark shares: the cell's files, weights and
inputs made from the seed on the device, latency statistics, the profiler's
reading and the per-layer metric readers.

A cell is named in ``BENCHMARK.json``; its files are found by name:
``configs/<config>.json`` (the model's sizes and the system's registry id),
``traffic/<traffic>.json`` (the mix's parameters and the entry that drives
it), ``workloads/<cell>.json`` (what the cell adds: its pool size, the
limits of ``correct``), ``entries/<entry>.py`` and ``metrics/<metric>.py``.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path

from bench.reference.common import flatten, unflatten  # noqa: F401

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names that no process of the benchmark may hold: the JAX
# package the system was ported from, and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path):
    return json.loads(Path(path).read_text())


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_spec(name: str, root: Path = ROOT) -> dict:
    """The cell ``name``: its BENCHMARK.json entry and the files it names."""
    bm = benchmark(root)
    cells = {w["name"]: w for w in bm["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    w = cells[name]
    config = {c["name"]: c for c in bm["configs"]}[w["config"]]
    return {"name": name, "chips": w["chips"], "workload": w,
            "model": load_json(root / config["file"]),
            "traffic": load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
            "cell": load_json(BENCH / "workloads" / f"{name}.json")}


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_entry(entry: str):
    return load_module(BENCH / "entries" / f"{entry}.py", f"bench_entry_{entry}")


def metrics_for(name: str, bm: dict) -> tuple:
    """(end-to-end, per-layer) metric entries this cell reports."""
    def mine(m):
        return "workloads" not in m or name in m["workloads"]
    return ([m for m in bm["end_to_end"] if mine(m)],
            [m for m in bm["per_layer"] if mine(m)])


def read_layer_metrics(per_layer, ctx) -> dict:
    """Each per-layer metric's reader on ``ctx``; a reader that finds
    nothing returns None and the metric is left out."""
    out = {}
    for m in per_layer:
        mod = load_module(BENCH / "metrics" / f"{m['name']}.py",
                          "bench_metric_" + m["name"].replace(".", "_"))
        v = mod.read(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def forbidden_modules() -> list:
    return sorted({k.split(".")[0] for k in sys.modules}
                  & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# The system's configuration and inputs
# ---------------------------------------------------------------------------
def port_config(model: dict):
    """The system's ``ModelConfig`` for a configuration file."""
    from repro_torch.configs import registry
    return registry.get_config(model["arch"]).with_overrides(
        **model.get("overrides", {}))


def views(flat, shapes) -> list:
    out, off = [], 0
    for s in shapes:
        n = math.prod(s)
        out.append(flat[off:off + n].view(tuple(s)))
        off += n
    return out


def make_params(paths, shapes, gen, device, std: float):
    """Weights in one normal draw of every element (f32, as the system
    serves them), ``std`` wide; norm scales 1 and biases 0.  Returns (the
    flat tensor, its leaves)."""
    import torch
    n = sum(math.prod(s) for s in shapes)
    flat = torch.randn((n,), generator=gen, device=device).mul_(std)
    leaves = views(flat, shapes)
    for path, x in zip(paths, leaves):
        if path[-1].endswith("scale"):
            x.fill_(1.0)
        elif path[-1] == "bias":
            x.zero_()
    return flat, leaves


def sync(device) -> None:
    import torch
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def percentile(xs, q: float) -> float:
    """Linear interpolation between order statistics (numpy's default)."""
    s = sorted(xs)
    if not s:
        raise ValueError("no samples")
    h = (len(s) - 1) * q
    lo = math.floor(h)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (h - lo) * (s[hi] - s[lo])


# ---------------------------------------------------------------------------
# The device trace
# ---------------------------------------------------------------------------
def profile(fn, device):
    """Run ``fn`` under ``torch.profiler`` (CPU and CUDA activity) and read
    the trace: device-busy seconds (the union of kernel, copy and set
    intervals), the traced window, device time and launches by kernel name,
    and the longest idle gaps named by the host operation under them."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    if not str(device).startswith("cuda"):
        raise RuntimeError("the device trace needs a CUDA device; this run "
                           f"is on {device}")
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        units = fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((tr.start, tr.end, e.name))
        elif tr.end > tr.start:
            host.append((tr.start, tr.end, e.name))
    if not dev:
        raise RuntimeError("torch.profiler recorded no device activity")
    dev.sort()
    busy, gaps, kernels, launches = 0.0, [], {}, {}
    cur_s, cur_e = dev[0][0], dev[0][1]
    for s, e, name in dev:
        kernels[name] = kernels.get(name, 0.0) + (e - s) * 1e-6
        launches[name] = launches.get(name, 0) + 1
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((s - cur_e, cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    gaps.sort(reverse=True)
    host.sort()
    idle = []
    for length, g0, g1 in gaps[:10]:
        mid = 0.5 * (g0 + g1)
        under = [h for h in host if h[0] <= mid <= h[1]]
        before = [h for h in host if h[1] < mid]
        # the innermost host operation (latest start) under the gap, else
        # the Python between operations, after the last one that ended
        label = (max(under)[2] if under else
                 "python after " + max(before, key=lambda h: h[1])[2]
                 if before else "python")
        idle.append([label[:160], length * 1e-6])
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy * 1e-6, "window_s": window_s, "units": units,
            "kernel_s": kernels, "launches": launches,
            "breakdown": {"device_ops": [[k[:160], v] for k, v in top],
                          "idle_gaps": idle}}


def kernel_seconds(prof: dict, substring: str) -> tuple:
    """(device seconds, launches) of kernels whose name holds ``substring``."""
    t = sum(v for k, v in prof["kernel_s"].items() if substring in k)
    n = sum(v for k, v in prof["launches"].items() if substring in k)
    return t, n
