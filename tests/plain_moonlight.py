"""Plain reference of Moonlight-16B-A3B (``model_type`` deepseek_v3: latent
attention and a sigmoid-routed MoE with shared experts): its forward pass,
its loss with the balance term and the expert share, in f32, in plain
PyTorch.

It imports nothing of the port.  No cache, no batching, no kernels: the
equations of ``modeling_deepseek_v3.py`` (the ``DeepseekV3Attention``,
``DeepseekV3MoE``, ``MoEGate`` and ``DeepseekV3MLP`` modules) and of the
DeepSeek-V3 report (arXiv:2412.19437, eqs. 12-20), run on whole tensors.

- Embedding ``E[tokens]``.  Each layer ``h += MLA(RMSNorm1(h))``, then
  ``h += FFN(RMSNorm2(h))``; FFN is a SwiGLU of ``intermediate_size`` in
  the first ``first_k_dense_replace`` layers, else the MoE.
- MLA (``q_lora_rank`` null): ``q = x W_q`` split into nope and rope
  parts; ``[c, k_pe] = x W_kv_a``; ``[k_nope, v] = RMSNorm(c) W_kv_b``;
  RoPE on ``q_pe`` and the one ``k_pe`` every head shares, as
  ``apply_rotary_pos_emb`` does it (the rope dims de-interleaved, then
  rotated by halves; ``inv_freq = 1 / theta ** (arange(0, dr, 2) / dr)``);
  scores ``q k^T * (dn + dr) ** -0.5``, causal, softmax in f32; out
  ``(P v) W_o``.
- MoE gate (``scoring_func`` sigmoid, ``topk_method`` noaux_tc): ``s =
  sigmoid(u W_r)`` over all ``router_experts`` outputs; with ``n_group`` =
  ``topk_group`` = 1 the group step keeps every expert, so the chosen
  experts are ``topk(s + b, k)`` with ``b`` the per-expert
  ``e_score_correction_bias``; the gates are the chosen experts' ``s``
  over their sum (plus 1e-20), times ``routed_scaling_factor``.
  ``MoE(u) = sum_i g_i Expert_i(u) + Shared(u)``, the shared experts one
  SwiGLU of ``n_shared_experts * moe_intermediate_size``.  The expert
  share: only experts ``[expert_offset, expert_offset + n_routed_experts)``
  are computed; pairs routed elsewhere add nothing.
- Output: the final RMSNorm, ``logits = h W_head`` (untied).
- Loss: the mean token cross-entropy over the loss mask plus
  ``aux_loss_alpha`` times, per MoE layer, the report's sequence-wise
  balance loss: per sequence of ``T`` tokens ``sum_i f_i P_i``, ``f_i =
  N_r / (K_r T) * #{t: i in topk(s_t, K_r)}``, ``P_i = mean_t s'_i,t``,
  ``s' = s / sum_j s_j``; averaged over the sequences.

Departures from the published modules, each of them the system's too:
the gate's top-k of ``s + b`` and the balance loss's top-k of ``s`` are
``torch.topk`` here (the modeling's ``sorted=False`` picks the same set);
the balance loss is the report's (the modeling computes none), and its
``f_i`` counts the unbiased top-k, as the report writes it; ``b`` is state
held apart from the weights (an argument here) and is not trained.

A configuration is a dict with the published ``config.json`` keys, plus
``router_experts`` (the router's outputs; ``n_routed_experts`` counts the
experts held), ``expert_offset`` and ``aux_loss_alpha``.  Parameters are a
nested dict with the port's names and layouts: layer 0 under
``stack.layer_0``, the MoE layers stacked under ``stack.scan`` (layer
axis first); ``wq`` (d, heads, dn + dr), ``wkv_a`` (d, r + dr), ``wkv_b``
(r, heads, dn + dv), ``wo`` (heads, dv, d); experts stacked ``(held,
...)``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def swiglu(p, x):
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_in"])) @ p["w_out"]


def layer_params(m, p, i):
    """Layer ``i``'s parameters: a dense head layer, or row ``i - k`` of
    the stacked MoE layers."""
    k = m["first_k_dense_replace"]
    if i < k:
        return p["stack"][f"layer_{i}"]

    def row(t):
        return {n: row(v) for n, v in t.items()} if isinstance(t, dict) \
            else t[i - k]
    return row(p["stack"]["scan"])


def rotary(S, dim, theta, like):
    """The cos and sin tables of positions ``0..S-1``, in ``like``'s
    dtype."""
    dev = like.device
    inv_freq = 1.0 / (theta ** (torch.arange(0, dim, 2, device=dev)
                                .float() / dim))
    freqs = torch.outer(torch.arange(S, device=dev).float(), inv_freq)
    emb = torch.cat((freqs, freqs), dim=-1)
    return emb.cos().to(like.dtype), emb.sin().to(like.dtype)


def rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat((-x2, x1), dim=-1)


def apply_rotary_pos_emb(q, k, cos, sin):
    """q (b, h, S, d), k (b, 1, S, d); the modeling's pairing."""
    def de_interleave(t):
        b, h, s, d = t.shape
        return t.view(b, h, s, d // 2, 2).transpose(4, 3).reshape(b, h, s, d)
    q, k = de_interleave(q), de_interleave(k)
    return q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin


def mla(m, p, x):
    b, S, d = x.shape
    h, r = m["num_attention_heads"], m["kv_lora_rank"]
    dn, dr, dv = m["qk_nope_head_dim"], m["qk_rope_head_dim"], \
        m["v_head_dim"]
    q = (x @ p["wq"].reshape(d, h * (dn + dr))).view(b, S, h, dn + dr)
    q_nope, q_pe = torch.split(q.transpose(1, 2), [dn, dr], dim=-1)
    c, k_pe = torch.split(x @ p["wkv_a"], [r, dr], dim=-1)
    k_pe = k_pe.view(b, S, 1, dr).transpose(1, 2)
    kv = (rms_norm(c, p["kv_norm"]["scale"], m["rms_norm_eps"])
          @ p["wkv_b"].reshape(r, h * (dn + dv))).view(b, S, h, dn + dv)
    k_nope, v = torch.split(kv.transpose(1, 2), [dn, dv], dim=-1)
    cos, sin = rotary(S, dr, m["rope_theta"], x)
    q_pe, k_pe = apply_rotary_pos_emb(q_pe, k_pe, cos, sin)
    query = torch.cat([q_nope, q_pe], dim=-1)
    key = torch.cat([k_nope, k_pe.expand(b, h, S, dr)], dim=-1)
    scores = (query @ key.transpose(2, 3)) * (dn + dr) ** -0.5
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, -torch.inf)
    out = torch.softmax(scores, dim=-1, dtype=torch.float32).to(
        query.dtype) @ v
    return out.transpose(1, 2).reshape(b, S, h * dv) \
        @ p["wo"].reshape(h * dv, d)


def gate(m, p, u, bias):
    """(sigmoid scores (b*S, E), chosen experts (b*S, k), gates (b*S, k))."""
    scores = torch.sigmoid(u.reshape(-1, u.shape[-1]).float()
                           @ p["router"].float())
    _, idx = torch.topk(scores + bias, m["num_experts_per_tok"], dim=-1)
    w = scores.gather(1, idx)
    w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return scores, idx, w * m["routed_scaling_factor"]


def held_experts(m, p, u, idx, gates):
    """The held experts' part of ``sum_i g_i Expert_i(u)``; u (T, d)."""
    out = torch.zeros_like(u)
    for j in range(m["n_routed_experts"]):
        routed = idx == m["expert_offset"] + j  # (T, k)
        tok = routed.any(-1)
        if not tok.any():
            continue
        g = (gates * routed).sum(-1)[tok]
        e = {k: v[j] for k, v in p["experts"].items()}
        out[tok] = out[tok] + (g[:, None] * swiglu(e, u[tok])).to(u.dtype)
    return out


def seq_balance(m, scores, n_seq):
    """The report's sequence-wise balance loss, averaged over sequences."""
    E, k = m["router_experts"], m["num_experts_per_tok"]
    T = scores.shape[0] // n_seq
    top = torch.topk(scores, k, dim=-1).indices
    hits = F.one_hot(top, E).sum(1).float().view(n_seq, T, E).sum(1)
    f = hits * E / (k * T)
    P = (scores / scores.sum(-1, keepdim=True)).view(n_seq, T, E).mean(1)
    return (f * P).sum(-1).mean()


def moe(m, p, u, bias):
    """(MoE(u) of the held experts plus the shared experts, the balance
    term); u (b, S, d)."""
    b, S, d = u.shape
    scores, idx, gates = gate(m, p, u, bias)
    flat = u.reshape(-1, d)
    shared = {k: v[0] for k, v in p["shared"].items()}
    y = held_experts(m, p, flat, idx, gates) + swiglu(shared, flat)
    return y.view(b, S, d), seq_balance(m, scores, b)


def layer(m, i, lp, h, bias):
    """Layer ``i``: (the new residual stream, its balance term)."""
    eps = m["rms_norm_eps"]
    h = h + mla(m, lp["attn"], rms_norm(h, lp["norm1"]["scale"], eps))
    u = rms_norm(h, lp["norm2"]["scale"], eps)
    if i < m["first_k_dense_replace"]:
        return h + swiglu(lp["mlp"], u), torch.zeros((), device=h.device)
    y, lb = moe(m, lp["moe"], u, bias[i - m["first_k_dense_replace"]])
    return h + y, lb


def forward(m, p, tokens, bias):
    """(logits (b, S, vocab), the summed balance terms); ``bias`` (MoE
    layers, router_experts)."""
    h = p["embedding"]["embed"][tokens.long()]
    aux = torch.zeros((), device=h.device)
    for i in range(m["num_hidden_layers"]):
        h, lb = layer(m, i, layer_params(m, p, i), h, bias)
        aux = aux + lb
    h = rms_norm(h, p["final_norm"]["scale"], m["rms_norm_eps"])
    return h @ p["embedding"]["unembed"], aux


def loss(m, p, batch, bias):
    """Mean token cross-entropy over ``loss_mask`` plus the weighted
    balance terms."""
    logits, aux = forward(m, p, batch["tokens"], bias)
    nll = torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, batch["labels"].long()[..., None])[..., 0]
    mask = batch["loss_mask"].float()
    ce = (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return ce + m["aux_loss_alpha"] * aux
