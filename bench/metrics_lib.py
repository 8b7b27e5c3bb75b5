"""The arithmetic of the per-layer readers: spans, the trace and the work
counts.  A reader file names one metric and calls one of these."""
from bench import harness as H
from bench.work import counts


def ancestors(spans):
    by_sid = {s.sid: s for s in spans}

    def chain(s):
        out = []
        while s.parent is not None and s.parent in by_sid:
            s = by_sid[s.parent]
            out.append(s.name)
        return out
    return chain


def spans_under(spans, outer: str, inner: str) -> list:
    """The ``inner`` spans that have an ``outer`` span among their
    ancestors."""
    chain = ancestors(spans)
    return [s for s in spans if s.name == inner and outer in chain(s)]


def per_round(ctx, name: str):
    """ms per round of the window spent in ``name`` spans (training)."""
    if ctx["entry"] != "train":
        return None
    rounds = sum(1 for s in ctx["spans"] if s.name == "bench.round")
    if not rounds:
        return None
    total = sum(s.dur_ns for s in ctx["spans"] if s.name == name)
    return 1e-6 * total / rounds


def idle_share(ctx, entry: str):
    prof = ctx.get("profile")
    if ctx["entry"] != entry or not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


def ingest_ms(ctx):
    """Mean self time of the window's fenced ``bench.push`` spans, with the
    nested ``decode`` spans (the filling push applies the session)
    subtracted."""
    if ctx["entry"] != "agg":
        return None
    pushes = [s for s in ctx["spans"] if s.name == "bench.push"]
    if not pushes:
        return None
    nested = spans_under(ctx["spans"], "bench.push", "decode")
    busy = sum(s.dur_ns for s in pushes) - sum(s.dur_ns for s in nested)
    return 1e-6 * busy / len(pushes)


def decode_ms(ctx):
    """Mean of the system's fenced ``decode`` spans in the window."""
    if ctx["entry"] != "agg":
        return None
    d = [s.dur_ns for s in ctx["spans"] if s.name == "decode"]
    return 1e-6 * sum(d) / len(d) if d else None


def k1_roofline(ctx):
    """Least time of the profiled pushes' K1 work (``counts.k1_work``) at
    the peaks over K1's device time, in %."""
    prof = ctx.get("profile")
    if ctx["entry"] != "agg" or not prof:
        return None
    t, _ = H.kernel_seconds(prof, "quantize_mask_prf_kernel")
    pushes = prof["units"].get("pushes", 0)
    if t <= 0 or not pushes:
        return None
    return 100.0 * pushes * counts.least_time(ctx["work"]["k1_push"]) / t


def agg_mfu(ctx):
    """Least time of the window's published versions (``version_work``)
    at the peaks over the window's time to its last publish, in %."""
    if ctx["entry"] != "agg":
        return None
    return (100.0 * ctx["cell"].versions
            * counts.least_time(ctx["work"]["version"]) / ctx["window_s"])


def ingest_mfu(ctx):
    """A push's least time (``counts.push_work``) at the peaks over the
    mean ingest time, in %: the whole push's share, which bounds what K1's
    roofline can claim for ``push_p95_ms``."""
    t = ingest_ms(ctx)
    if not t:
        return None
    return 100.0 * counts.least_time(ctx["work"]["push"]) / (1e-3 * t)
