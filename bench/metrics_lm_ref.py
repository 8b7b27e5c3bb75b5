"""The arithmetic of the ``train_lm_ref`` entry's per-layer readers:
``metrics_lm``'s (spans a round, the expert share's held pairs, the trace's
idle share, the round's share of the peaks) for a ``train_lm_ref`` run, the
held experts' largest load, the device draws a round and the sigmoid
router's moved pairs.  Each returns None for any other entry, or where the system has no
such span or counter."""
from bench import harness as H
from bench import metrics_lm

ENTRY = "train_lm_ref"


def _as_lm(ctx):
    """``ctx`` as ``metrics_lm`` reads it, or None for another entry."""
    return dict(ctx, entry=metrics_lm.ENTRY) if ctx["entry"] == ENTRY \
        else None


def per_round(ctx, name: str):
    """ms per round of the window spent in ``name`` spans."""
    lm = _as_lm(ctx)
    return None if lm is None else metrics_lm.per_round(lm, name)


def held_share(ctx):
    lm = _as_lm(ctx)
    return None if lm is None else metrics_lm.held_share(lm)


def load_max(ctx):
    """The largest held expert's load over the mean held load, averaged
    over the layers' forward passes (weighted by their held pairs)."""
    if ctx["entry"] != ENTRY:
        return None
    held = metrics_lm._counter("moe_pairs", held=1)
    if not held:
        return None
    experts = H.port_config(ctx["cell"].model).held_experts
    return metrics_lm._counter("moe_held_load_max") / (held / experts)


def prf_draws(ctx):
    """Device ``jax.random`` draws a round: the system's
    ``prf_device_draws`` over every round the run has driven (set-up's,
    the window's and the profile's), the same count each round."""
    if ctx["entry"] != ENTRY:
        return None
    from repro_torch.core import telemetry as tele
    series = [v for (n, _), v in tele.get_default().counters().items()
              if n == "prf_device_draws"]
    rounds = ctx["cell"].round
    if not series or not rounds:
        return None
    return sum(series) / rounds


def idle_share(ctx):
    lm = _as_lm(ctx)
    return None if lm is None else metrics_lm.idle_share(lm)


def round_mfu(ctx):
    lm = _as_lm(ctx)
    return None if lm is None else metrics_lm.round_mfu(lm)


def bias_moved(ctx):
    """% of the routed (token, slot) pairs whose expert the selection bias
    moved off the token's unbiased top-k: the system's ``moe_bias_moved``
    over all of ``moe_pairs``, both counted in forward passes while spans
    record."""
    if ctx["entry"] != ENTRY:
        return None
    from repro_torch.core import telemetry as tele
    counters = tele.get_default().counters()
    pairs = sum(v for (name, _), v in counters.items()
                if name == "moe_pairs")
    if ("moe_bias_moved", ()) not in counters or not pairs:
        return None
    return 100.0 * counters[("moe_bias_moved", ())] / pairs
