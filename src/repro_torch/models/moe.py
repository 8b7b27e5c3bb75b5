"""Mixture-of-Experts layer: shared + routed experts, top-k, capacity dispatch.

Port of ``repro.models.moe``.  The reference's default GShard dispatch
contracts one-hot tensors of shape ``(T, k, E, C)``; at deepseek-moe-16b's
serve prefill (T = 16384, k = 6, E = 64, C = 1920) that is 48 GB of f32.
The port computes the same function with index operations:

- each ``(token, slot)`` pair's position in its expert's buffer is its rank
  among the pairs routed to that expert in the flattened token-major,
  slot-minor order (the reference's ``_positions_and_keep``), and a pair is
  kept while its position is below the capacity ``C`` — integer work,
  bit-equal to the reference's;
- the kept pairs' tokens are scattered into ``(E, C', d)`` expert buffers,
  the experts' FFNs run as one batched product, and a gather of each pair's
  output, weighted by its gate, combines them.

``onehot`` and ``gather`` are one function in the reference (identical
positions and drops), so they are one path here.  ``ragged`` has no capacity
and no drops: the same path with every pair kept.  ``C'`` is ``C`` cut to
what can be occupied: an expert takes at most one pair per token, so at
most ``T``, and where the buffers would pass ``BUFFER_ELEMS`` values the
largest expert load is read back from the device (one synchronisation).
Empty slots hold zero rows in the reference and contribute nothing.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch import tree as T
from repro_torch.kernels import prf
from repro_torch.models import layers as L

# expert buffers larger than this many values are sized to the largest
# expert load instead of the capacity (256 MB of f32)
BUFFER_ELEMS = 1 << 26


def moe_shapes(cfg, lead=()):
    d, e = cfg.d_model, cfg.num_experts
    lead = tuple(lead)
    p = {"router": torch.Size(lead + (d, e)),
         "experts": L.mlp_shapes(cfg, cfg.moe_d_ff, lead + (e,))}
    if cfg.num_shared_experts > 0:
        p["shared"] = L.mlp_shapes(cfg, cfg.moe_d_ff,
                                   lead + (cfg.num_shared_experts,))
    return p


def init_moe(key, cfg, device=None):
    """``split(key, 3)``: the router, the experts (``split`` into one key
    per expert, stacked as the reference's ``vmap`` stacks them) and the
    shared experts (likewise)."""
    d, e = cfg.d_model, cfg.num_experts
    k_router, k_experts, k_shared = prf.split(key, 3)
    p = {"router": L.normal_over(k_router, (d, e), math.sqrt(d), device),
         "experts": T.stacked(
             lambda k: L.init_mlp(k, cfg, cfg.moe_d_ff, device),
             prf.split(k_experts, e))}
    if cfg.num_shared_experts > 0:
        p["shared"] = T.stacked(
            lambda k: L.init_mlp(k, cfg, cfg.moe_d_ff, device),
            prf.split(k_shared, cfg.num_shared_experts))
    return p


def route(cfg, p, x_flat) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (gates (T,k), expert_idx (T,k) int64, aux_loss scalar).

    The top-k is a stable descending sort, so ties go to the lower expert
    index as ``jax.lax.top_k`` breaks them."""
    k = cfg.experts_per_token
    logits = (x_flat @ p["router"].to(x_flat.dtype)).float()  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[:, :k], order[:, :k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch-style load-balance loss: E * sum_e fraction_e * prob_e
    n_tok, E = probs.shape
    counts = torch.bincount(idx.reshape(-1), minlength=E).float()
    frac = counts / torch.tensor(float(n_tok * k), device=counts.device)
    aux = E * torch.sum(frac * probs.mean(0))
    return gates.to(x_flat.dtype), idx, aux


def capacity(cfg, n_tokens: int) -> int:
    E, k = cfg.num_experts, cfg.experts_per_token
    return max(int(math.ceil(k * n_tokens / E * cfg.capacity_factor)), 1)


def positions_and_keep(E: int, C: int, idx):
    """Position of each (token, slot) pair in its expert's buffer: its rank
    among the pairs routed to that expert in token-major, slot-minor order
    (a stable sort by expert id); ``keep = pos < C``.  Returns (pos (T,k),
    keep (T,k), per-expert counts (E,))."""
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=E)
    starts = torch.cumsum(counts, 0) - counts  # exclusive prefix
    ranks = torch.arange(flat.numel(), device=flat.device) - starts[flat[order]]
    pos = torch.empty_like(flat).scatter_(0, order, ranks)
    pos = pos.reshape(idx.shape)
    return pos, pos < C, counts


def _dispatch(cfg, p, x_flat, gates, idx, C: int):
    """Kept pairs through their experts' FFNs, combined by gate."""
    n_tok, d = x_flat.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    pos, keep, counts = positions_and_keep(E, C, idx)
    cap = min(C, n_tok)  # an expert takes at most one pair per token
    if E * cap * d > BUFFER_ELEMS:
        cap = min(cap, max(int(counts.max()), 1))
    slot = torch.where(keep, idx * cap + pos, E * cap)  # dropped: trash row
    tok = torch.arange(n_tok, device=x_flat.device).repeat_interleave(k)
    buf = x_flat.new_zeros((E * cap + 1, d))
    buf[slot.reshape(-1)] = x_flat[tok]
    y_experts = L.apply_mlp(cfg, p["experts"], buf[:-1].view(E, cap, d))
    del buf
    y_flat = y_experts.reshape(E * cap, d)
    y_pairs = y_flat[torch.where(keep, slot, 0)]  # (T, k, d)
    y_pairs = torch.where(keep[..., None], y_pairs, 0.0)
    return torch.einsum("tkd,tk->td", y_pairs, gates)


def apply_moe(cfg, p, x, *, use_ragged: bool = None):
    """x: (B, S, d) -> (y, aux_loss)."""
    if use_ragged is None:
        use_ragged = cfg.moe_ragged
    ragged = use_ragged or cfg.moe_dispatch == "ragged"
    if cfg.moe_dispatch not in ("onehot", "gather", "ragged"):
        raise ValueError(cfg.moe_dispatch)
    B, S, d = x.shape
    n_tok = B * S
    x_flat = x.reshape(n_tok, d)
    gates, idx, aux = route(cfg, p, x_flat)
    # ragged: no capacity, so every pair is kept
    C = n_tok if ragged else capacity(cfg, n_tok)
    y = _dispatch(cfg, p, x_flat, gates, idx, C)
    if cfg.num_shared_experts > 0:
        y = y + L.apply_mlp(cfg, p["shared"], x_flat).sum(0)
    return y.reshape(B, S, d), aux * cfg.router_aux_weight
