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


def is_abstract(t) -> bool:
    """True for a tensor without data: on the meta device, or a
    ``FakeTensor`` (or a ``DTensor`` over fake shards), as the cost harness
    (``launch.lowering``) runs the program.  Such a tensor has no values to
    read on the host and no memory to launch a kernel on."""
    if not isinstance(t, torch.Tensor):
        return False
    if type(t) is torch.Tensor and not t.is_meta:
        return False  # the common case, a real tensor: no further checks
    if t.is_meta:
        return True
    from torch._subclasses.fake_tensor import is_fake
    return is_fake(t)
