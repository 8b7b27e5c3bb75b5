"""Server-side optimizers: the aggregated client delta is a pseudo-gradient.

Port of ``repro.core.fl.server_opt``: FedAvg / FedAvgM / FedAdam /
FedAdagrad over dict parameter trees, with the same state layout
(``{"step", "m", "v"}``).  FedAvg at ``server_lr=1.0`` is exact; the
adaptive optimizers use ``pow``/``sqrt``/division whose last bit may differ
from XLA's.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch import tree as T
from repro_torch.kernels import prf


class ServerOpt(NamedTuple):
    init: Callable[[Any], Any]
    apply: Callable[[Any, Any, Any], Tuple[Any, Any]]  # (params, state, delta)


def _zeros_like_f32(params):
    return T.tree_map(
        lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device),
        params)


def _step0(params):
    dev = T.leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def build_server_opt(fl_cfg) -> ServerOpt:
    lr = fl_cfg.server_lr
    b1, b2, eps = fl_cfg.server_beta1, fl_cfg.server_beta2, fl_cfg.server_eps
    kind = fl_cfg.server_opt

    if kind == "fedavg":
        def init(params):
            return {"step": _step0(params)}

        def apply(params, state, delta):
            new = T.tree_map(lambda p, d: (_f32(p) + lr * _f32(d)).to(p.dtype),
                             params, delta)
            return new, {"step": state["step"] + 1}

    elif kind == "fedavgm":
        def init(params):
            return {"step": _step0(params), "m": _zeros_like_f32(params)}

        def apply(params, state, delta):
            m = T.tree_map(lambda m_, d: b1 * m_ + _f32(d), state["m"], delta)
            new = T.tree_map(lambda p, m_: (_f32(p) + lr * m_).to(p.dtype),
                             params, m)
            return new, {"step": state["step"] + 1, "m": m}

    elif kind == "fedadam":
        def init(params):
            return {"step": _step0(params), "m": _zeros_like_f32(params),
                    "v": _zeros_like_f32(params)}

        def apply(params, state, delta):
            t = state["step"] + 1
            tf = t.to(torch.float32)
            m = T.tree_map(lambda m_, d: b1 * m_ + (1 - b1) * _f32(d),
                           state["m"], delta)
            v = T.tree_map(lambda v_, d: b2 * v_ + (1 - b2) *
                           torch.square(_f32(d)), state["v"], delta)
            c1 = 1 - torch.pow(torch.full_like(tf, b1), tf)
            c2 = 1 - torch.pow(torch.full_like(tf, b2), tf)
            new = T.tree_map(
                lambda p, m_, v_: (_f32(p) + lr * (m_ / c1) /
                                   (prf.sqrt_f32(v_ / c2) + eps)).to(p.dtype),
                params, m, v)
            return new, {"step": t, "m": m, "v": v}

    elif kind == "fedadagrad":
        def init(params):
            return {"step": _step0(params), "v": _zeros_like_f32(params)}

        def apply(params, state, delta):
            v = T.tree_map(lambda v_, d: v_ + torch.square(_f32(d)),
                           state["v"], delta)
            new = T.tree_map(
                lambda p, d, v_: (_f32(p) + lr * _f32(d) /
                                  (prf.sqrt_f32(v_) + eps)).to(p.dtype),
                params, delta, v)
            return new, {"step": state["step"] + 1, "v": v}

    else:
        raise ValueError(kind)

    return ServerOpt(init, apply)
