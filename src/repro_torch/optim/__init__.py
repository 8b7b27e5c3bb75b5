"""Optimizers (port of ``repro.optim``)."""
from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, adam, adamw, apply_updates, build_optimizer, sgd, sgd_momentum,
)
