"""Model parameters of the dense family (port of ``repro.models.model``).

The aggregation server only needs the model's parameter TREE — the deltas it
aggregates have the same leaves.  ``param_shapes`` gives the exact leaf
paths and shapes of ``build_model(cfg).init`` in the JAX package, and
``init_params`` draws random weights of those shapes with the same
per-leaf scales (normal * 1/sqrt(fan_in), zero biases, unit norm scales)
from a ``torch.Generator``.  Only the dense family is ported.

Layout (dense, ``num_layers > 1``): the layers are stacked under
``stack.scan`` with the layer axis leading, as the JAX ``vmap``-ed init
produces them::

  embedding.embed                       (vocab, d)
  final_norm.scale                      (d,)
  stack.scan.attn.{wq, wk, wv}          (L, d, heads|kv, head_dim)
  stack.scan.attn.wo                    (L, heads, head_dim, d)
  stack.scan.attn.{bq, bk, bv}          (L, heads|kv, head_dim)   qkv_bias
  stack.scan.mlp.{w_in, w_gate}         (L, d, d_ff)              w_gate: swiglu
  stack.scan.mlp.w_out                  (L, d_ff, d)
  stack.scan.{norm1, norm2}.scale       (L, d)
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch import device as _device
from repro_torch import tree as T


def _norm_shapes(cfg, lead) -> Dict:
    p = {"scale": torch.Size(lead + (cfg.d_model,))}
    if cfg.norm == "layernorm":
        p["bias"] = torch.Size(lead + (cfg.d_model,))
    return p


def _block_shapes(cfg, lead) -> Dict:
    d, h, kv, hd, f = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    attn = {"wq": (d, h, hd), "wk": (d, kv, hd), "wv": (d, kv, hd),
            "wo": (h, hd, d)}
    if cfg.qkv_bias:
        attn.update({"bq": (h, hd), "bk": (kv, hd), "bv": (kv, hd)})
    mlp = {"w_in": (d, f), "w_out": (f, d)}
    if cfg.mlp_act == "swiglu":
        mlp["w_gate"] = (d, f)
    return {
        "norm1": _norm_shapes(cfg, lead),
        "attn": {k: torch.Size(lead + v) for k, v in attn.items()},
        "norm2": _norm_shapes(cfg, lead),
        "mlp": {k: torch.Size(lead + v) for k, v in mlp.items()},
    }


def param_shapes(cfg) -> Dict:
    """Nested dict of ``torch.Size`` — the JAX init's tree, leaf for leaf."""
    if cfg.family != "dense" or cfg.block_pattern is not None:
        raise NotImplementedError(
            f"param_shapes: only the dense family is ported (got "
            f"{cfg.family!r})")
    emb = {"embed": torch.Size((cfg.vocab_size, cfg.d_model))}
    if not cfg.tie_embeddings:
        emb["unembed"] = torch.Size((cfg.d_model, cfg.vocab_size))
    if cfg.pos_emb == "learned":
        emb["pos_embed"] = torch.Size((cfg.max_seq_len, cfg.d_model))
    if cfg.num_layers > 1:
        stack = {"scan": _block_shapes(cfg, (cfg.num_layers,))}
    else:
        stack = {f"layer_{i}": _block_shapes(cfg, ())
                 for i in range(cfg.num_layers)}
    return {"embedding": emb, "stack": stack,
            "final_norm": _norm_shapes(cfg, ())}


def _init_scale(cfg, path) -> float:
    """The std of a weight leaf's normal init, 0 for zeros, -1 for ones."""
    name = path[-1]
    d, f = cfg.d_model, cfg.d_ff
    if name in ("bq", "bk", "bv", "bias"):
        return 0.0
    if name == "scale":
        return -1.0
    if name == "pos_embed":
        return 0.02
    if name in ("wq", "wk", "wv", "w_in", "w_gate", "embed", "unembed"):
        return 1.0 / math.sqrt(d)
    if name == "wo":
        return 1.0 / math.sqrt(cfg.num_heads * cfg.head_dim)
    if name == "w_out":
        return 1.0 / math.sqrt(f)
    raise KeyError(name)


def init_params(cfg, generator: torch.Generator, device=None) -> Dict:
    """Random f32 parameters of ``cfg`` on ``device`` (default the GPU).

    ``generator`` must live on ``device``.  The numbers differ from the JAX
    init (another generator); shapes, tree and scales match it.
    """
    dev = _device.resolve(device)
    paths, shapes = T.flatten(param_shapes(cfg))
    leaves = []
    for path, shape in zip(paths, shapes):
        s = _init_scale(cfg, path)
        if s == 0.0:
            leaves.append(torch.zeros(shape, dtype=torch.float32, device=dev))
        elif s < 0.0:
            leaves.append(torch.ones(shape, dtype=torch.float32, device=dev))
        else:
            leaves.append(torch.randn(shape, generator=generator,
                                      dtype=torch.float32, device=dev) * s)
    return T.unflatten(paths, leaves)
