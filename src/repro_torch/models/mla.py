"""Multi-head latent attention (MLA), DeepSeek-V2/V3's attention, for
training (``q_lora_rank`` null: the queries are projected straight from
the input).

Per layer, with ``H`` heads, ``dn = qk_nope_head_dim``, ``dr =
qk_rope_head_dim``, ``dv = v_head_dim`` and ``r = kv_lora_rank``:

- ``q = x W_q`` (d, H, dn + dr), split into ``q_nope`` and ``q_rope``;
- ``[c, k_rope] = x W_kv_a`` (d, r + dr): a latent ``c`` and one rope key
  shared by every head;
- ``[k_nope, v] = RMSNorm(c) W_kv_b`` (r, H, dn + dv);
- RoPE on ``q_rope`` and ``k_rope`` only, paired as DeepSeek-V3's modeling
  pairs them (:func:`rope_pairs`); with ``cfg.mla_use_nope`` (Kimi Linear)
  no position encoding: the rope dims stay in the queries and the shared
  key, not rotated;
- queries ``[q_nope, q_rope]`` and keys ``[k_nope, k_rope]`` of width
  ``dn + dr`` against values of width ``dv``, causal, softmax scale
  ``(dn + dr) ** -0.5``, through the chunked f32 core of the GQA layer
  (``layers.attend``); out ``o W_o`` (H, dv, d).

The decode path (a latent cache) is not built: ``models.model`` refuses
to serve this family.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import prf
from repro_torch.models import layers as L


def mla_shapes(cfg, lead=()):
    d, h, r = cfg.d_model, cfg.num_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    shapes = {"wq": (d, h, dn + dr), "wkv_a": (d, r + dr),
              "wkv_b": (r, h, dn + dv), "wo": (h, dv, d)}
    out = {k: torch.Size(tuple(lead) + v) for k, v in shapes.items()}
    out["kv_norm"] = L.norm_shapes(cfg, r, lead)
    return out


def init_mla(key, cfg, device=None):
    """``split(key, 4)`` for wq, wkv_a, wkv_b, wo, each ``N(0, 1 /
    fan_in)``; the latent norm's scale 1."""
    d, h, r = cfg.d_model, cfg.num_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    k1, k2, k3, k4 = prf.split(key, 4)
    return {"wq": L.normal_leaf(k1, (d, h, dn + dr), d ** -0.5, device),
            "wkv_a": L.normal_leaf(k2, (d, r + dr), d ** -0.5, device),
            "kv_norm": L.init_norm(cfg, r, device),
            "wkv_b": L.normal_leaf(k3, (r, h, dn + dv), r ** -0.5, device),
            "wo": L.normal_leaf(k4, (h, dv, d), 1.0 / math.sqrt(h * dv),
                                device)}


def rope_pairs(x, positions, theta: float):
    """RoPE as DeepSeek-V3's ``apply_rotary_pos_emb``: the last dim's
    interleaved pairs ``(2i, 2i + 1)`` are first laid out as ``(i, i +
    dr/2)`` and then rotated by the half rotation (NeoX) at frequency
    ``1 / theta ** (2i / dr)``, computed as the modeling computes it.  The
    output keeps the de-interleaved order (queries and keys alike).
    x: (..., S, heads, dr)."""
    dr = x.shape[-1]
    x = x.unflatten(-1, (dr // 2, 2)).transpose(-1, -2).flatten(-2)
    freqs = 1.0 / (theta ** (torch.arange(0, dr, 2, dtype=torch.float32,
                                          device=x.device) / dr))
    return L.apply_rope(x, positions, theta, freqs=freqs)


def apply_mla(cfg, p, x, positions):
    """x: (B, S, d) -> (B, S, d), causal over ``positions`` (S,)."""
    B, S, _ = x.shape
    dt = x.dtype
    h, r = cfg.num_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    q_nope, q_rope = q.split([dn, dr], dim=-1)
    c, k_rope = (x @ p["wkv_a"].to(dt)).split([r, dr], dim=-1)
    kv = torch.einsum("bsr,rhk->bshk", L.apply_norm(cfg, p["kv_norm"], c),
                      p["wkv_b"].to(dt))
    k_nope, v = kv.split([dn, dv], dim=-1)
    k_rope = k_rope[:, :, None]
    if not cfg.mla_use_nope:
        q_rope = rope_pairs(q_rope, positions, cfg.rope_theta)
        k_rope = rope_pairs(k_rope, positions, cfg.rope_theta)
    q = torch.cat([q_nope, q_rope], dim=-1) * (dn + dr) ** -0.5
    k = torch.cat([k_nope, k_rope.expand(B, S, h, dr)], dim=-1)
    out = L.attend(cfg, q, k, v, positions, positions, causal=True)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt))
