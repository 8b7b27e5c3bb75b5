"""KDA's sequential steps a round: the system's ``kda_chunk_steps`` (the
inter-chunk state pass's steps, one a chunk of a KDA layer's forward pass,
counted while spans record and not in the backward pass) over every round
the run has driven (set-up's, the window's and the profile's).  64 a
layer at 4096 tokens in chunks of 64.  Layer: ``models/kda.py``.
"""


def read(ctx):
    if ctx["entry"] != "train_lm_ref":
        return None
    from repro_torch.core import telemetry as tele
    steps = tele.get_default().counters().get(("kda_chunk_steps", ()))
    rounds = ctx["cell"].round
    if not steps or not rounds:
        return None
    return steps / rounds
