"""Carry JAX-side values into the port, so both packages compute the same thing.

Works on numpy arrays (``numpy.asarray`` of a JAX array is one), so this
module imports neither JAX nor the JAX package:

  ``params_from_numpy``      a parameter tree (nested dicts of arrays) ->
                             the port's dict of f32 tensors on ``device``;
  ``cache_from_numpy``       a decode cache of any family, stacked or per
                             layer (KV ``k``/``v``/``pos``; Mamba-2
                             ``conv``/``ssm``; RG-LRU ``h``/``conv``;
                             enc-dec ``memory``, ``self``, ``cross_k``/
                             ``cross_v``) -> the port's cache (``pos``
                             int32, the rest keeps its dtype);
  ``server_state_from_numpy`` a server-optimizer state (``step``, and
                             FedAvgM/FedAdam/FedAdagrad moments) -> tensors;
  ``fl_state_from_numpy``    a sync round's ``FLState`` (params, server
                             state, round index) -> the port's ``FLState``;
  ``key_from_numpy``         a JAX PRNG key (its 2 uint32 words) ->
                             the port's ``(k0, k1)``;
  ``client_push_from_numpy`` a JAX-side ``ClientPush`` (uint32 word rows) ->
                             the port's ``ClientPush``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core.fl import async_fl as afl
from repro_torch.core.fl import compression as comp
from repro_torch.core.fl import round as fl_round


def _tensor(x, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(x, copy=True))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(params, device="cpu"):
    """Nested dict of arrays -> nested dict of tensors (dtype kept)."""
    return T.tree_map(lambda x: _tensor(x, device), params)


def cache_from_numpy(cache, device="cpu"):
    """A JAX decode cache -> the port's (same tree and layout, every leaf
    a contiguous tensor as K10 takes it; ``pos`` is int32, the state
    leaves keep their dtype)."""
    paths, leaves = T.flatten(cache)
    return T.unflatten(paths, [
        _tensor(x, device, torch.int32 if path[-1] == "pos" else None)
        for path, x in zip(paths, leaves)])


def server_state_from_numpy(state, device="cpu"):
    """``{"step": int32 scalar, "m"/"v": trees}`` -> tensors on ``device``."""
    out = {}
    for k, v in state.items():
        if k == "step":
            out[k] = _tensor(v, device, torch.int32)
        else:
            out[k] = params_from_numpy(v, device)
    return out


def fl_state_from_numpy(state, device="cpu"):
    """A JAX-side ``FLState`` (any object with ``params``, ``opt_state`` and
    ``round_idx``) -> the port's ``round.FLState`` on ``device``."""
    return fl_round.FLState(params_from_numpy(state.params, device),
                   server_state_from_numpy(state.opt_state, device),
                   _tensor(state.round_idx, device, torch.int32))


def key_from_numpy(key):
    """A PRNG key's data (2 uint32 words) -> ``(k0, k1)`` Python ints."""
    w = np.asarray(key).astype(np.uint32).reshape(-1)
    if w.size != 2:
        raise ValueError(f"expected 2 key words, got {w.size}")
    return int(w[0]), int(w[1])


def words_from_numpy(words, device="cpu") -> torch.Tensor:
    """uint32 word stream -> int32 tensor with the same bits."""
    a = np.ascontiguousarray(np.asarray(words).astype(np.uint32))
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """The port's int32 word stream -> uint32 numpy (the same bits)."""
    return words.detach().cpu().numpy().astype(np.int32).view(np.uint32)


def client_push_from_numpy(cp, device="cpu") -> "afl.ClientPush":
    """A JAX-side ``ClientPush`` (any object with its fields) -> the port's."""
    rows = cp.row if isinstance(cp.row, tuple) else (cp.row,)
    rows = tuple(words_from_numpy(r, device) for r in rows)
    spec = getattr(cp, "compression", None)
    return afl.ClientPush(
        row=rows[0] if len(rows) == 1 else rows,
        weight=_tensor(cp.weight, device, torch.float32),
        norm=_tensor(cp.norm, device, torch.float32),
        clipped=_tensor(cp.clipped, device, torch.float32),
        staleness=cp.staleness, version=int(cp.version), slot=int(cp.slot),
        modulus=int(cp.modulus), token=int(cp.token),
        compression=comp.CompressionSpec()
        if spec is None else comp.CompressionSpec(spec.mode, spec.rate))
