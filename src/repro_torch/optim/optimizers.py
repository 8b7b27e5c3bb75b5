"""Optimizers over parameter trees (port of ``repro.optim.optimizers``).

Server-side baselines and client local optimizers.  ``update(grads, state,
params) -> (updates, state)``; :func:`apply_updates` adds the updates in f32
and casts back to each leaf's dtype.  The states are the reference's trees:
``{}`` (sgd), ``{"m"}`` (momentum), ``{"step", "m", "v"}`` (adam, adamw;
``step`` an int32 scalar), every moment an f32 tree shaped like the params.

Each op rounds as the reference's eager op does (constants are f32, no
fused multiply-add), so sgd and momentum match it bit for bit.  Adam's bias
corrections ``b ** t`` are f32 powers, which torch and XLA may round a last
bit apart; its ``sqrt`` is ``prf.sqrt_f32``, correctly rounded as
``jnp.sqrt`` is.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch import tree as T
from repro_torch.kernels import prf


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]  # (grads, state, params)


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _zeros(params):
    return T.tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                            device=x.device), params)


def sgd(lr: float) -> Optimizer:
    def init(params):
        return {}

    def update(grads, state, params):
        return T.tree_map(lambda g: g.to(torch.float32) * -lr, grads), state

    return Optimizer(init, update)


def sgd_momentum(lr: float, momentum: float = 0.9) -> Optimizer:
    def init(params):
        return {"m": _zeros(params)}

    def update(grads, state, params):
        m = T.tree_map(lambda m_, g: m_ * momentum + g.to(torch.float32),
                       state["m"], grads)
        return T.tree_map(lambda m_: m_ * -lr, m), {"m": m}

    return Optimizer(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    return _adam_impl(lr, b1, b2, eps, weight_decay=0.0)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01) -> Optimizer:
    return _adam_impl(lr, b1, b2, eps, weight_decay)


def _adam_impl(lr, b1, b2, eps, weight_decay) -> Optimizer:
    def init(params):
        dev = T.leaves(params)[0].device
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "m": _zeros(params), "v": _zeros(params)}

    def update(grads, state, params):
        t = state["step"] + 1
        tf = t.to(torch.float32)
        m = T.tree_map(lambda m_, g: m_ * b1 + g.to(torch.float32) * (1 - b1),
                       state["m"], grads)
        v = T.tree_map(lambda v_, g: v_ * b2 + torch.square(
            g.to(torch.float32)) * (1 - b2), state["v"], grads)
        c1 = 1 - torch.pow(_f32(b1, tf), tf)
        c2 = 1 - torch.pow(_f32(b2, tf), tf)

        def upd_leaf(m_, v_, p):
            u = (m_ / c1) * -lr / (prf.sqrt_f32(v_ / c2) + eps)
            if weight_decay:
                u = u - p.to(torch.float32) * (lr * weight_decay)
            return u

        return T.tree_map(upd_leaf, m, v, params), {"step": t, "m": m, "v": v}

    return Optimizer(init, update)


def build_optimizer(name: str, lr: float, **kw) -> Optimizer:
    return {"sgd": sgd, "sgd_momentum": sgd_momentum, "adam": adam,
            "adamw": adamw}[name](lr, **kw)


def apply_updates(params, updates):
    return T.tree_map(
        lambda p, u: (p.to(torch.float32) + u).to(p.dtype), params, updates)
