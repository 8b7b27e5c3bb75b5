"""The arithmetic of the decoder-LM training entry's per-layer readers
(``entries/train_lm.py``): spans a round, the expert share's counters, the
trace's idle share and the round's share of the peaks.  Each reads only a
``train_lm`` run and returns None for any other, or where the system has
no such span or counter."""
from bench.work import counts

ENTRY = "train_lm"


def _counter(name: str, **labels) -> float:
    from repro_torch.core import telemetry as tele
    return tele.get_default().value(name, **labels)


def per_round(ctx, name: str):
    """ms per round of the window spent in ``name`` spans."""
    if ctx["entry"] != ENTRY:
        return None
    rounds = sum(1 for s in ctx["spans"] if s.name == "bench.round")
    spans = [s.dur_ns for s in ctx["spans"] if s.name == name]
    if not rounds or not spans:
        return None
    return 1e-6 * sum(spans) / rounds


def held_share(ctx):
    """% of the (token, slot) pairs routed to the experts held here."""
    if ctx["entry"] != ENTRY:
        return None
    held, other = _counter("moe_pairs", held=1), _counter("moe_pairs",
                                                           held=0)
    return 100.0 * held / (held + other) if held + other else None


def load_max(ctx):
    """The largest held expert's load over the mean held load, averaged
    over the layers' forward passes (weighted by their held pairs)."""
    if ctx["entry"] != ENTRY:
        return None
    held = _counter("moe_pairs", held=1)
    if not held:
        return None
    experts = ctx["cell"].model["num_local_experts"]
    return _counter("moe_held_load_max") / (held / experts)


def idle_share(ctx):
    prof = ctx.get("profile")
    if ctx["entry"] != ENTRY or not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


def round_mfu(ctx):
    """The window's rounds' least time at the peaks over the window, %."""
    if ctx["entry"] != ENTRY:
        return None
    return (100.0 * ctx["cell"].rounds
            * counts.least_time(ctx["work"]["round"]) / ctx["window_s"])
