"""The arithmetic of the stage readers: the system's stage spans inside its
aggregation engine (``push.clip``, ``push.store``, ``decode.sum``,
``decode.recover``, ...), its host Threefry tile counter
(``prf_host_tiles``), and device idle time put down to the system's spans.

A program without those spans or that counter gives the readers nothing to
read: they return None.

Idle time needs the device trace's gaps on the spans' clock, which the
run's own profile (``harness.profile``) does not keep: :func:`idle_profile`
profiles two more whole sessions itself, after the window and the run's
profile, keeps every gap between merged device-busy runs, and places the
spans recorded meanwhile on the profiler's clock through the registry's
``epoch_unix_ns`` and kineto's ``trace_start_ns``.  Each idle microsecond
goes to the spans that cover it; one line on standard error names the
innermost ones by idle ms a version.
"""
import sys

PROFILED_SESSIONS = 2


def _stage_total_ns(ctx, name: str):
    if ctx["entry"] != "agg":
        return None
    d = [s.dur_ns for s in ctx["spans"] if s.name == name]
    return sum(d) if d else None


def stage_ms_per_push(ctx, name: str):
    """ms of the window's ``name`` spans over its pushes (``bench.push``)."""
    total = _stage_total_ns(ctx, name)
    pushes = sum(1 for s in ctx["spans"] if s.name == "bench.push")
    return None if total is None or not pushes else 1e-6 * total / pushes


def stage_ms_per_version(ctx, name: str):
    """ms of the window's ``name`` spans over its versions (the system's
    ``decode`` spans)."""
    total = _stage_total_ns(ctx, name)
    versions = sum(1 for s in ctx["spans"] if s.name == "decode")
    return None if total is None or not versions else 1e-6 * total / versions


def tiles_per_unit(ctx, entry: str):
    """The process registry's ``prf_host_tiles`` over every unit the run
    has driven (set-up's, the window's and the profile's): a version of an
    ``agg`` cell, a round of a ``train`` cell.  The count is a function of
    the sizes alone, the same in every unit, so the quotient is each
    unit's count."""
    from repro_torch.core import telemetry as tele
    if ctx["entry"] != entry:
        return None
    series = [v for (n, _), v in tele.get_default().counters().items()
              if n == "prf_host_tiles"]
    if not series:
        return None
    cell = ctx["cell"]
    units = len(cell.log) if entry == "agg" else cell.round
    return sum(series) / units if units else None


# ---------------------------------------------------------------------------
# Device idle time by span
# ---------------------------------------------------------------------------
def _busy_runs(intervals):
    """Merged ``(start, end)`` runs of device intervals (any order)."""
    runs = []
    for s, e in sorted(intervals):
        if runs and s <= runs[-1][1]:
            runs[-1][1] = max(runs[-1][1], e)
        else:
            runs.append([s, e])
    return runs


def idle_gaps(intervals):
    """Every gap between merged device-busy runs, ``(start, end)``."""
    runs = _busy_runs(intervals)
    return [(a[1], b[0]) for a, b in zip(runs, runs[1:])]


def _segments(spans):
    """Elementary ``(lo, hi, covering spans innermost last)`` of a set of
    nested ``(start, end, name)`` intervals."""
    pts = sorted({p for s in spans for p in s[:2]})
    out = []
    for lo, hi in zip(pts, pts[1:]):
        cover = sorted((s for s in spans if s[0] <= lo and hi <= s[1]),
                       key=lambda s: (s[0], -s[1]))
        if cover:
            out.append((lo, hi, tuple(s[2] for s in cover)))
    return out


def idle_by_cover(gaps, spans):
    """[(idle length, names of the spans covering it, outermost first)]:
    each gap cut at the spans' boundaries."""
    segs = _segments(spans)
    out, j = [], 0
    for g0, g1 in sorted(gaps):
        while j < len(segs) and segs[j][1] <= g0:
            j += 1
        k, t = j, g0
        while t < g1:
            if k < len(segs) and segs[k][0] <= t < segs[k][1]:
                end = min(g1, segs[k][1])
                out.append((end - t, segs[k][2]))
                k += 1
            else:
                end = min(g1, segs[k][0]) if k < len(segs) else g1
                out.append((end - t, ()))
            t = end
    return out


def idle_profile(ctx):
    """Two more whole sessions under ``torch.profiler``: {"versions",
    "pushes", "idle": idle_by_cover(...) in us, "idle_us", "window_us"};
    cached in ``ctx``.  None without a device trace (``--trace 0``, the
    CPU) or without the registry's Unix epoch."""
    if "idle_profile" in ctx:
        return ctx["idle_profile"]
    ctx["idle_profile"] = None
    cell = ctx["cell"]
    tel = cell.tel
    if (ctx["entry"] != "agg" or not ctx.get("profile")
            or not tel.record_spans or not hasattr(tel, "epoch_unix_ns")):
        return None
    import torch
    from torch.profiler import ProfilerActivity, profile

    n0, v0, p0 = len(tel.spans), len(cell.log), cell.n_push
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_SESSIONS):
            cell._session()
        torch.cuda.synchronize()
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    dev = [(e.time_range.start, e.time_range.end) for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = [((tel.epoch_unix_ns + s.t0_ns - start_ns) * 1e-3,
              (tel.epoch_unix_ns + s.t0_ns + s.dur_ns - start_ns) * 1e-3,
              s.name) for s in tel.spans[n0:]]
    if not dev or not spans:
        return None
    gaps = idle_gaps(dev)
    out = {"versions": len(cell.log) - v0, "pushes": cell.n_push - p0,
           "idle": idle_by_cover(gaps, spans),
           "idle_us": sum(b - a for a, b in gaps),
           "window_us": max(e for _, e in dev) - min(s for s, _ in dev)}
    ctx["idle_profile"] = out
    _print_top(out)
    return out


def _print_top(out, top: int = 8) -> None:
    by = {}
    for length, names in out["idle"]:
        key = names[-1] if names else "(no span)"
        by[key] = by.get(key, 0.0) + length
    v = out["versions"]
    ranked = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    print(f"idle by innermost span, ms a version ({v} versions, "
          f"{out['pushes']} pushes; {out['idle_us'] * 1e-3:.3f} ms idle in "
          f"the {out['window_us'] * 1e-3:.3f} ms from the first kernel to "
          f"the last): "
          + ", ".join(f"{k} {t * 1e-3 / v:.3f}" for k, t in ranked),
          file=sys.stderr)


def idle_ms(ctx, inside: str, per: str, outside=None):
    """Device-idle ms under an ``inside`` span and under no ``outside``
    span, over the profiled sessions' ``per`` (pushes or versions)."""
    p = idle_profile(ctx)
    if p is None or not p[per]:
        return None
    t = sum(length for length, names in p["idle"]
            if inside in names and outside not in names)
    return 1e-3 * t / p[per]
