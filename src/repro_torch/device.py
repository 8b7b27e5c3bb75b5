"""The port's device rule: entry points run on the card unless told otherwise.

Every entry point (``AsyncServer``, the ``build_*_step`` functions,
``init_params``) takes
``device=``, defaulting to ``"cuda"``.  Without a usable GPU that default
raises instead of silently running on the CPU; the CPU is used only when the
caller asks for it (``device="cpu"``, as the tests do).
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device=None) -> torch.device:
    """``device`` (default ``"cuda"``) as a ``torch.device``; raises when it
    names CUDA and no GPU is available."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the GPU by default but torch.cuda reports no "
            "usable device; pass device='cpu' to run on the CPU explicitly")
    return dev
