"""Device ``jax.random`` draws a round: the system's counter
``prf_device_draws`` (each one launch of its Threefry-20 draw kernel: a
client leaf's rounding uniforms, a leaf of the TEE noise) over every round
the run has driven (set-up's, the window's and the profile's).  The count is
a function of the sizes alone, the same in every round, so the quotient is
each round's count.  A system without the counter, or without a draw on the
card, reads nothing."""


def read(ctx):
    from repro_torch.core import telemetry as tele
    if ctx["entry"] != "train":
        return None
    series = [v for (n, _), v in tele.get_default().counters().items()
              if n == "prf_device_draws"]
    rounds = ctx["cell"].round
    if not series or not rounds:
        return None
    return sum(series) / rounds
