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

An expert share (``cfg.experts_held``, expert parallelism's layer on one
device) routes over every router output but holds experts ``[off, off +
held)``: its pairs are found by one stable sort by expert id, where they
are a contiguous run, and only they are gathered, run and combined
(drop-free); the others add nothing here.  While the default registry
records spans, the share counts ``moe_pairs{held=0|1}`` and the largest
held expert's load ``moe_held_load_max`` from the counts it reads back.

``cfg.router_score`` "sigmoid" is DeepSeek-V3's router (``topk_method``
noaux_tc with one group): scores ``s = sigmoid(u W_r)``, the experts
chosen by the top-k of ``s + b`` with ``b`` the per-expert selection bias
(``e_score_correction_bias``, state of the model and not a weight: it is
an argument here, never a parameter), gates the unbiased ``s`` of the
chosen experts, renormalised, times ``cfg.routed_scaling``.  Its loss is
the DeepSeek-V3 report's sequence-wise balance loss.  While spans record
it counts ``moe_bias_moved``: the (token, slot) pairs whose expert is not
among the token's unbiased top-k.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch import tree as T
from repro_torch.core import telemetry as tele
from repro_torch.device import is_abstract
from repro_torch.kernels import prf
from repro_torch.models import layers as L

# expert buffers larger than this many values are sized to the largest
# expert load instead of the capacity (256 MB of f32)
BUFFER_ELEMS = 1 << 26


def moe_shapes(cfg, lead=()):
    d, e = cfg.d_model, cfg.num_experts
    lead = tuple(lead)
    p = {"router": torch.Size(lead + (d, e)),
         "experts": L.mlp_shapes(cfg, cfg.moe_d_ff,
                                 lead + (cfg.held_experts,))}
    if cfg.num_shared_experts > 0:
        p["shared"] = L.mlp_shapes(cfg, cfg.shared_width,
                                   lead + (cfg.num_shared_experts,))
    return p


def init_moe(key, cfg, device=None):
    """``split(key, 3)``: the router, the experts (``split`` into one key
    per expert, stacked as the reference's ``vmap`` stacks them; a share
    takes its experts' keys) and the shared experts (likewise)."""
    d, e = cfg.d_model, cfg.num_experts
    k_router, k_experts, k_shared = prf.split(key, 3)
    off = cfg.expert_offset
    p = {"router": L.normal_over(k_router, (d, e), math.sqrt(d), device),
         "experts": T.stacked(
             lambda k: L.init_mlp(k, cfg, cfg.moe_d_ff, device),
             prf.split(k_experts, e)[off:off + cfg.held_experts])}
    if cfg.num_shared_experts > 0:
        p["shared"] = T.stacked(
            lambda k: L.init_mlp(k, cfg, cfg.shared_width, device),
            prf.split(k_shared, cfg.num_shared_experts))
    return p


def _bincount(flat: torch.Tensor, E: int) -> torch.Tensor:
    """``torch.bincount(flat, minlength=E)`` for ids in ``[0, E)``; on an
    abstract tensor (the cost harness), whose length bincount cannot know,
    the same one pass over ``flat`` as an ``index_add_``."""
    if not is_abstract(flat):
        return torch.bincount(flat, minlength=E)
    return flat.new_zeros((E,)).index_add_(0, flat, torch.ones_like(flat))


MOE_KINDS = ("moe", "ssm_moe", "mla_moe", "kda_moe")


def route_bias_shape(cfg) -> Tuple[int, int]:
    """(MoE layers, experts): one selection bias row per MoE layer of the
    stack, in stack order."""
    return (sum(k in MOE_KINDS for k in cfg.layer_kinds), cfg.num_experts)


def _top_k(scores, k: int) -> torch.Tensor:
    """The top-k's indices by a stable descending sort: ties go to the
    lower expert index, as ``jax.lax.top_k`` breaks them."""
    return torch.sort(scores, dim=-1, descending=True, stable=True)[1][:, :k]


def _route_sigmoid(cfg, logits, n_seq: int, bias):
    """DeepSeek-V3's router on f32 logits (T, E): (gates, idx, the
    sequence-wise balance loss ``mean over sequences of sum_e f_e P_e``,
    ``f_e = E / (k T_s)`` times the sequence's tokens whose unbiased top-k
    holds ``e``, ``P_e`` the mean over the sequence of ``s_e / sum s``)."""
    k = cfg.experts_per_token
    n_tok, E = logits.shape
    scores = torch.sigmoid(logits)
    plain = _top_k(scores, k)
    idx = plain if bias is None else _top_k(scores + bias, k)
    gates = scores.gather(1, idx)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-20) * cfg.routed_scaling
    tel = tele.get_default()
    if (bias is not None and tel.record_spans
            and torch._C._current_graph_task_id() == -1):
        moved = ~(idx[:, :, None] == plain[:, None, :]).any(-1)
        tel.count("moe_bias_moved", int(moved.sum()))
    T_s = n_tok // n_seq
    chosen = torch.zeros_like(scores).scatter_(1, plain, 1.0)
    f = chosen.view(n_seq, T_s, E).sum(1) * (E / (k * T_s))
    P = (scores / scores.sum(-1, keepdim=True)).view(n_seq, T_s, E).mean(1)
    aux = (f * P).sum(-1).mean()
    return gates, idx, aux


def route(cfg, p, x_flat, n_seq: int = 1,
          bias=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (gates (T,k), expert_idx (T,k) int64, aux_loss scalar).

    ``x_flat`` holds ``n_seq`` sequences of equal length, token-major;
    ``bias`` (E,) is the sigmoid router's selection bias (None: zero).
    The top-k is a stable descending sort, so ties go to the lower expert
    index as ``jax.lax.top_k`` breaks them."""
    k = cfg.experts_per_token
    logits = (x_flat @ p["router"].to(x_flat.dtype)).float()  # (T, E)
    if cfg.router_score == "sigmoid":
        gates, idx, aux = _route_sigmoid(cfg, logits, n_seq, bias)
        return gates.to(x_flat.dtype), idx, aux
    probs = torch.softmax(logits, dim=-1)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[:, :k], order[:, :k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch-style load-balance loss: E * sum_e fraction_e * prob_e
    n_tok, E = probs.shape
    counts = _bincount(idx.reshape(-1), E).float()
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
    counts = _bincount(flat, E)
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
    # abstract tensors (the cost harness) have no counts to read: they keep
    # the static worst case
    if E * cap * d > BUFFER_ELEMS and not is_abstract(counts):
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


def _dispatch_held(cfg, p, x_flat, gates, idx):
    """The expert share: every pair routed to a held expert through its
    FFN, drop-free, combined by gate; the other pairs add nothing.  One
    read-back (the per-expert counts) sizes the buffers."""
    n_tok, d = x_flat.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    held, off = cfg.held_experts, cfg.expert_offset
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)  # expert-major, token-minor
    counts = _bincount(flat, E).tolist()
    start = sum(counts[:off])
    load = counts[off:off + held]
    n_held = sum(load)
    tel = tele.get_default()
    if tel.record_spans and torch._C._current_graph_task_id() == -1:
        tel.count("moe_pairs", n_held, held=1)
        tel.count("moe_pairs", flat.numel() - n_held, held=0)
        tel.count("moe_held_load_max", max(load))
    pairs = order[start:start + n_held]
    local = flat[pairs] - off
    starts = torch.tensor([sum(load[:e]) for e in range(held)],
                          device=x_flat.device)
    cap = max(max(load), 1)
    slot = local * cap + torch.arange(n_held, device=x_flat.device) \
        - starts[local]
    buf = x_flat.new_zeros((held * cap, d))
    buf[slot] = x_flat[pairs // k]
    y_experts = L.apply_mlp(cfg, p["experts"], buf.view(held, cap, d))
    del buf
    y_pairs = y_experts.reshape(held * cap, d)[slot] \
        * gates.reshape(-1)[pairs, None]
    return x_flat.new_zeros((n_tok, d)).index_add(0, pairs // k, y_pairs)


def apply_moe(cfg, p, x, *, use_ragged: bool = None, bias=None):
    """x: (B, S, d) -> (y, aux_loss); ``bias`` the sigmoid router's
    selection bias (E,)."""
    if use_ragged is None:
        use_ragged = cfg.moe_ragged
    ragged = use_ragged or cfg.moe_dispatch == "ragged"
    if cfg.moe_dispatch not in ("onehot", "gather", "ragged"):
        raise ValueError(cfg.moe_dispatch)
    B, S, d = x.shape
    n_tok = B * S
    x_flat = x.reshape(n_tok, d)
    gates, idx, aux = route(cfg, p, x_flat, B, bias)
    if cfg.experts_held:
        if not ragged:
            raise ValueError("an expert share dispatches drop-free: set "
                             "moe_dispatch='ragged'")
        y = _dispatch_held(cfg, p, x_flat, gates, idx)
    else:
        # ragged: no capacity, so every pair is kept
        C = n_tok if ragged else capacity(cfg, n_tok)
        y = _dispatch(cfg, p, x_flat, gates, idx, C)
    if cfg.num_shared_experts > 0:
        y = y + L.apply_mlp(cfg, p["shared"], x_flat).sum(0)
    return y.reshape(B, S, d), aux * cfg.router_aux_weight
