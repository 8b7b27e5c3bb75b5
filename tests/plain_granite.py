"""Plain reference of Granite-4.0-H (IBM's hybrid Mamba-2 / attention stack
with an MoE FFN in every layer): its forward pass, its loss and the expert
share, in f32, in plain PyTorch.

It imports nothing of the port.  No cache, no batching, no kernels: the
layer equations as the published ``config.json`` and ``modeling`` define
them, run on whole tensors.

- Embedding ``E[tokens] * embedding_multiplier``.
- Each layer ``h += r * mixer(RMSNorm1(h))``, then ``u = RMSNorm2(h)``,
  ``h += r * (MoE(u) + Shared(u))`` with ``r = residual_multiplier``.  The
  mixer is by ``layer_types``: Mamba-2 or causal GQA attention without a
  position encoding, its softmax scale ``attention_multiplier``.
- Mamba-2: in_proj -> (z, xBC, dt); a causal depthwise conv, SiLU;
  ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``; the SSD over chunks
  as the Mamba-2 paper's minimal listing computes it (arXiv:2405.21060,
  ``ssd_minimal_discrete``); ``+ D x``; RMSNorm of ``y * silu(z)``;
  out_proj.
- MoE: ``logits = u @ W_r`` over every router output; the top-k logits'
  softmax are the gates; ``MoE(u) = sum_i gate_i Expert_i(u)`` with
  ``Expert(u) = (silu(u W_gate) * u W_in) W_out``.  The expert share: only
  the held experts ``[expert_offset, expert_offset + num_local_experts)``
  are computed; pairs routed elsewhere add nothing.
- Output: the final RMSNorm, ``logits = (h @ E^T) / logits_scaling``.
- Loss: the mean token cross-entropy over the loss mask, plus per MoE layer
  the Switch load-balance term ``E * sum_e frac_e * mean prob_e`` over all
  router outputs times ``router_aux_loss_coef``.

A configuration is a dict with the published ``config.json`` keys
(``num_hidden_layers`` layers of ``layer_types``), plus ``router_experts``
(the router's outputs), ``num_local_experts`` (the experts held) and
``expert_offset``.  Parameters are a nested dict with the port's names and
layouts: ``wq``/``wk``/``wv`` (d, heads, head_dim), ``wo`` (heads,
head_dim, d), experts stacked ``(held, ...)``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def swiglu(p, x):
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_in"])) @ p["w_out"]


def segsum(x):
    """``segsum(x)[..., i, j] = sum(x[..., j+1 : i+1])`` for ``i >= j``,
    ``-inf`` above the diagonal."""
    T = x.shape[-1]
    x = x[..., None].expand(*x.shape, T)
    low = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device), -1)
    x = x.masked_fill(~low, 0.0)
    out = torch.cumsum(x, dim=-2)
    diag = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device))
    return out.masked_fill(~diag, -torch.inf)


def ssd(X, A, B, C, block_len):
    """The SSD of discretised inputs: X (b, S, h, p), A (b, S, h), B and C
    (b, S, h, n); returns Y (b, S, h, p)."""
    b, S, h, p = X.shape
    c = S // block_len
    X, A, B, C = (t.reshape(b, c, block_len, *t.shape[2:])
                  for t in (X, A, B, C))
    A = A.permute(0, 3, 1, 2)  # (b, h, c, l)
    A_cumsum = torch.cumsum(A, dim=-1)
    # the listing's einsums, each taken two operands at a time
    L = torch.exp(segsum(A)).permute(0, 2, 3, 1, 4)  # (b, c, l, h, s)
    CB = torch.einsum("bclhn,bcshn->bclhs", C, B)
    Y_diag = torch.einsum("bclhs,bcshp->bclhp", CB * L, X)
    decay_states = torch.exp(A_cumsum[..., -1:] - A_cumsum)
    states = torch.einsum("bclhn,bclhp->bchpn", B,
                          X * decay_states.permute(0, 2, 3, 1)[..., None])
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    decay_chunk = torch.exp(segsum(F.pad(A_cumsum[..., -1], (1, 0))))
    states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)[:, :-1]
    Y_off = torch.einsum("bclhn,bchpn->bclhp", C, states) \
        * torch.exp(A_cumsum).permute(0, 2, 3, 1)[..., None]
    return (Y_diag + Y_off).reshape(b, S, h, p)


def mamba(m, p, x):
    b, S, d = x.shape
    di = m["mamba_expand"] * d
    nh, hd = m["mamba_n_heads"], m["mamba_d_head"]
    n, K = m["mamba_d_state"], m["mamba_d_conv"]
    assert m["mamba_n_groups"] == 1 and nh * hd == di
    z, xBC, dt = torch.split(x @ p["in_proj"], [di, di + 2 * n, nh], dim=-1)
    conv = F.conv1d(xBC.transpose(1, 2), p["conv_w"].T[:, None, :],
                    p["conv_b"], padding=K - 1, groups=xBC.shape[-1])
    xBC = F.silu(conv[..., :S].transpose(1, 2))
    xs, Bm, Cm = torch.split(xBC, [di, n, n], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(b, S, nh, hd)
    Q = m["mamba_chunk_size"] if S % m["mamba_chunk_size"] == 0 else S
    y = ssd(xh * dt[..., None], A * dt,
            Bm[:, :, None, :].expand(b, S, nh, n),
            Cm[:, :, None, :].expand(b, S, nh, n), Q)
    y = (y + xh * p["D"][:, None]).reshape(b, S, di)
    y = rms_norm(y * F.silu(z), p["norm_scale"], m["rms_norm_eps"])
    return y @ p["out_proj"]


def attention(m, p, x):
    b, S, d = x.shape
    h, kv = m["num_attention_heads"], m["num_key_value_heads"]
    hd = d // h
    q = (x @ p["wq"].reshape(d, h * hd)).reshape(b, S, h, hd)
    k = (x @ p["wk"].reshape(d, kv * hd)).reshape(b, S, kv, hd)
    v = (x @ p["wv"].reshape(d, kv * hd)).reshape(b, S, kv, hd)
    k = k.repeat_interleave(h // kv, dim=2)
    v = v.repeat_interleave(h // kv, dim=2)
    scores = torch.einsum("bqhk,bshk->bhqs", q, k) * m["attention_multiplier"]
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, -torch.inf)
    out = torch.einsum("bhqs,bshk->bqhk", torch.softmax(scores, -1), v)
    return out.reshape(b, S, h * hd) @ p["wo"].reshape(h * hd, d)


def route(m, p, u):
    """(router logits, top-k indices, top-k gates) of every token."""
    logits = u @ p["router"]
    top, idx = torch.topk(logits, m["num_experts_per_tok"], dim=-1)
    return logits, idx, torch.softmax(top, dim=-1)


def held_experts(m, p, u, idx, gates):
    """The held experts' part of ``sum_i gate_i Expert_i(u)``."""
    out = torch.zeros_like(u)
    for j in range(m["num_local_experts"]):
        routed = idx == m["expert_offset"] + j  # (b, S, k)
        tok = routed.any(-1)
        if not tok.any():
            continue
        gate = (gates * routed).sum(-1)[tok]
        e = {k: v[j] for k, v in p["experts"].items()}
        out[tok] = out[tok] + gate[:, None] * swiglu(e, u[tok])
    return out


def load_balance(m, logits, idx):
    """Switch's ``E * sum_e frac_e * mean prob_e`` over all router outputs."""
    E = m["router_experts"]
    probs = torch.softmax(logits.reshape(-1, E), dim=-1)
    frac = torch.bincount(idx.reshape(-1), minlength=E).float() / idx.numel()
    return E * torch.sum(frac * probs.mean(0))


def moe(m, p, u):
    """(MoE(u) + Shared(u) of the held experts, load-balance term)."""
    logits, idx, gates = route(m, p, u)
    shared = {k: v[0] for k, v in p["shared"].items()}
    y = held_experts(m, p, u, idx, gates) + swiglu(shared, u)
    return y, load_balance(m, logits, idx)


def layer(m, i, lp, h):
    """Layer ``i``: (the new residual stream, its load-balance term)."""
    eps, r = m["rms_norm_eps"], m["residual_multiplier"]
    x = rms_norm(h, lp["norm1"]["scale"], eps)
    if m["layer_types"][i] == "mamba":
        h = h + r * mamba(m, lp["mamba"], x)
    else:
        h = h + r * attention(m, lp["attn"], x)
    y, lb = moe(m, lp["moe"], rms_norm(h, lp["norm2"]["scale"], eps))
    return h + r * y, lb


def forward(m, p, tokens):
    """(logits (b, S, vocab), the summed load-balance terms)."""
    h = p["embedding"]["embed"][tokens.long()] * m["embedding_multiplier"]
    aux = torch.zeros((), device=h.device)
    for i in range(m["num_hidden_layers"]):
        h, lb = layer(m, i, p["stack"][f"layer_{i}"], h)
        aux = aux + lb
    h = rms_norm(h, p["final_norm"]["scale"], m["rms_norm_eps"])
    return (h @ p["embedding"]["embed"].T) / m["logits_scaling"], aux


def loss(m, p, batch):
    """Mean token cross-entropy over ``loss_mask`` plus the weighted
    load-balance terms."""
    logits, aux = forward(m, p, batch["tokens"])
    nll = torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, batch["labels"].long()[..., None])[..., 0]
    mask = batch["loss_mask"].float()
    ce = (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return ce + m["router_aux_loss_coef"] * aux
