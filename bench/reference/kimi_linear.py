"""Plain reference of Kimi-Linear-48B-A3B (``model_type`` kimi_linear: Kimi
Delta Attention beside NoPE latent attention, and a sigmoid-routed MoE
with a shared expert): its forward pass, its loss with the balance term
and the expert share in f32, one client's local SGD step and the
synchronous DP-FL round.

The benchmark's copy of ``tests/plain_kimi_linear.py`` (equal on a CPU
seed, ``bench/tests/test_bench_kimi_linear.py``), plus :func:`local_delta`
and :func:`sync_round` (``reference/lm_round.py``'s round over this loss);
it imports nothing of the system, and the entry runs it with TF32 off
(``common.plain_f32``).  On the card the configuration's ``kda_chunk``
selects the chunked form (:func:`kda_chunk`), which the CPU tests hold to
the recurrence.  ``remat`` recomputes each layer in the backward pass
(``torch.utils.checkpoint``: the same operations again, so the same
numbers) so that a 4096-token client fits the card beside the parameters,
their gradients and the round's sums.  Under the bf16 control the gate's
scores, the weighted combine of the experts and KDA's recurrence stay in
f32, and the softmax's probabilities are cast to the inputs' dtype, as the
modeling casts them.

No cache, no batching, no kernels: the equations of the Kimi Linear report
(arXiv:2510.26692, KDA), of FLA's ``KimiDeltaAttention`` module (its
projections, short convolutions, gate and gated output norm) and of the
DeepSeek-V3 report (arXiv:2412.19437, the MLA and the router), run on
whole tensors.

- Embedding ``E[tokens]``.  Each layer ``h += Mixer(RMSNorm1(h))``, then
  ``h += FFN(RMSNorm2(h))``: the mixer is KDA in the 1-based
  ``linear_attn_config.kda_layers`` and MLA in its ``full_attn_layers``;
  FFN a SwiGLU of ``intermediate_size`` in the first
  ``first_k_dense_replace`` layers, else the MoE.
- KDA, ``H`` heads of ``dk``: ``q, k, v = SiLU(conv(x W))`` by causal
  depthwise convolutions of ``short_conv_kernel_size`` without bias
  (``F.conv1d``); ``q, k`` divided by ``sqrt(|.|^2 + 1e-6)`` per head, ``q``
  times ``dk ** -0.5``; ``g = -exp(A_log) softplus((x W_fa) W_fb +
  dt_bias)``; ``beta = sigmoid(x W_b)``; the state ``S_t = (I - beta_t k_t
  k_t^T) Diag(e^g_t) S_{t-1} + beta_t k_t v_t^T`` from zero, ``o_t = S_t^T
  q_t`` (:func:`kda_recurrent`, the definition; :func:`kda_chunk`, the
  same in chunks); ``o <- RMSNorm(o) w sigmoid((x W_ga) W_gb + g_bias)``
  per head; out ``o W_o``.  The low ranks of ``W_fa``/``W_fb`` and
  ``W_ga``/``W_gb`` are ``head_dim``, as FLA builds them.
- MLA (``q_lora_rank`` null, ``mla_use_nope``): ``q = x W_q`` (nope and
  rope parts kept together); ``[c, k_pe] = x W_kv_a``; ``[k_nope, v] =
  RMSNorm(c) W_kv_b``; no position encoding: ``k_pe`` is one key part
  every head shares, not rotated; scores ``q k^T * (dn + dr) ** -0.5``,
  causal, softmax in f32; out ``(P v) W_o``.
- MoE gate (sigmoid, grouped top-k with one group): ``s = sigmoid(u
  W_r)`` over all ``router_experts`` outputs, the chosen experts ``topk(s
  + b, k)`` with ``b`` the per-expert selection bias, gates the chosen
  ``s`` over their sum (plus 1e-20, ``moe_renormalize``) times
  ``routed_scaling_factor``.  ``MoE(u) = sum_i g_i Expert_i(u) +
  Shared(u)``, the shared experts one SwiGLU of ``num_shared_experts *
  moe_intermediate_size``.  The expert share: only experts
  ``[expert_offset, expert_offset + num_experts)`` are computed; pairs
  routed elsewhere add nothing.
- Output: the final RMSNorm, ``logits = h W_head`` (untied).
- Loss: the mean token cross-entropy over the loss mask plus
  ``aux_loss_alpha`` times, per MoE layer, the DeepSeek-V3 report's
  sequence-wise balance loss (``f_i`` of the unbiased top-k, ``P_i`` the
  mean normalised score), averaged over the sequences.

Departures from the published modules, each of them the system's too:
FLA's gate takes ``A_log`` and ``dt_bias`` from its own init, here they
are weights like any other; the balance loss is the report's (the
modeling computes none); ``b`` is state held apart from the weights (an
argument here) and is not trained; FLA's fused kernels compute KDA in
chunks in f32 (the chunked form here, given bf16 inputs, computes the
recurrence in f32 as well and casts its output back).

A configuration is a dict with the published ``config.json`` keys, plus
``router_experts`` (the router's outputs; ``num_experts`` counts the
experts held), ``expert_offset``, ``aux_loss_alpha`` and, to run KDA in
chunks, ``kda_chunk``.  Parameters are a nested dict with the port's names
and layouts: ``stack.layer_{i}`` for every layer; KDA's ``wq``, ``wk``,
``wv`` (d, H, dk), ``conv_*`` (width, H dk), ``wf_a`` / ``wg_a`` (d, r),
``wf_b`` / ``wg_b`` (r, H, dk), ``dt_bias`` / ``g_bias`` (H, dk),
``A_log`` (H,), ``wb`` (d, H), ``o_norm.scale`` (dk,), ``wo`` (H, dk, d);
MLA's ``wq`` (d, heads, dn + dr), ``wkv_a`` (d, r + dr), ``wkv_b`` (r,
heads, dn + dv), ``wo`` (heads, dv, d); experts stacked ``(held, ...)``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.reference import lm_round


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def swiglu(p, x):
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_in"])) @ p["w_out"]


def short_conv(x, w):
    """Causal depthwise convolution of width ``K`` without bias, then SiLU:
    x (b, S, C), w (K, C), ``w[K - 1]`` on the current position."""
    K, C = w.shape
    y = F.conv1d(x.transpose(1, 2), w.t().unsqueeze(1), padding=K - 1,
                 groups=C)[..., :x.shape[1]]
    return F.silu(y.transpose(1, 2))


def l2norm(x):
    return x / torch.sqrt((x * x).sum(-1, keepdim=True) + 1e-6)


def kda_recurrent(q, k, v, g, beta):
    """The definition, token by token: q, k, g (b, S, H, dk), v (b, S, H,
    dv), beta (b, S, H) -> o (b, S, H, dv)."""
    b, S, H, dk = k.shape
    state = q.new_zeros((b, H, dk, v.shape[-1]))
    out = []
    for t in range(S):
        state = g[:, t].exp()[..., None] * state
        kt = k[:, t, :, :, None]  # (b, H, dk, 1)
        u = v[:, t, :, None, :] - (kt * state).sum(-2, keepdim=True)
        state = state + beta[:, t, :, None, None] * kt * u
        out.append((q[:, t, :, :, None] * state).sum(-2))
    return torch.stack(out, 1)


def kda_chunk(q, k, v, g, beta, C: int):
    """The recurrence ``C`` positions at a time, from its equations: within
    a chunk, ``G`` the cumulative log-decay from its start and ``S`` the
    state entering it, ``D_rsc = e^(G_rc - G_sc)`` for ``s <= r`` (zero
    above the diagonal, the exponent masked before the exp), the updates
    ``U`` solve ``(I + beta (k k^T D)_strict) U = beta v - (beta k e^G)
    S``; ``o = (q e^G) S + (q k^T D) U``; the next state ``e^(G_C) S + (k
    e^(G_C - G))^T U``."""
    b, S, H, dk = k.shape
    dv = v.shape[-1]
    state = q.new_zeros((b, H, dk, dv))
    out = []
    for s0 in range(0, S, C):
        qc, kc, vc, gc = (t[:, s0:s0 + C].transpose(1, 2)
                          for t in (q, k, v, g))  # (b, H, L, .)
        bc = beta[:, s0:s0 + C].transpose(1, 2)[..., None]  # (b, H, L, 1)
        L = kc.shape[2]
        G = gc.cumsum(2)
        lower = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
        D = torch.where(lower[..., None], G[:, :, :, None] - G[:, :, None],
                        -torch.inf).exp()  # (b, H, r, s, dk)
        Dk = D * kc[:, :, None]
        Akk = torch.einsum("bhrsc,bhrc->bhrs", Dk, kc).tril(-1)
        Aqk = torch.einsum("bhrsc,bhrc->bhrs", Dk, qc)
        eye = torch.eye(L, dtype=q.dtype, device=q.device)
        U = torch.linalg.solve_triangular(
            eye + bc * Akk, bc * vc - (bc * kc * G.exp()) @ state,
            upper=False)
        out.append(((qc * G.exp()) @ state + Aqk @ U).transpose(1, 2))
        state = G[:, :, -1, :, None].exp() * state \
            + (kc * (G[:, :, -1:] - G).exp()).transpose(-1, -2) @ U
    return torch.cat(out, 1)


def kda(m, p, x, chunk: int):
    """KDA of one layer; x (b, S, d); ``chunk`` 0 runs the recurrence."""
    b, S, d = x.shape
    la = m["linear_attn_config"]
    H, dk = la["num_heads"], la["head_dim"]

    def branch(w, conv):
        return short_conv(x @ w.reshape(d, H * dk), conv).view(b, S, H, dk)

    def low_rank(wa, wb):
        return ((x @ wa) @ wb.reshape(-1, H * dk)).view(b, S, H, dk)
    q = l2norm(branch(p["wq"], p["conv_q"])) * dk ** -0.5
    k = l2norm(branch(p["wk"], p["conv_k"]))
    v = branch(p["wv"], p["conv_v"])
    g = -p["A_log"].exp()[:, None] * F.softplus(
        low_rank(p["wf_a"], p["wf_b"]) + p["dt_bias"])
    beta = torch.sigmoid(x @ p["wb"])
    ct = torch.promote_types(x.dtype, torch.float32)
    ins = [t.to(ct) for t in (q, k, v, g, beta)]
    o = (kda_chunk(*ins, chunk) if chunk else kda_recurrent(*ins)).to(x.dtype)
    o = rms_norm(o, p["o_norm"]["scale"], m["rms_norm_eps"]) \
        * torch.sigmoid(low_rank(p["wg_a"], p["wg_b"]) + p["g_bias"])
    return o.reshape(b, S, H * dk) @ p["wo"].reshape(H * dk, d)


def mla(m, p, x):
    """NoPE latent attention of one layer; x (b, S, d)."""
    assert m["mla_use_nope"], "this reference's MLA is the NoPE one"
    b, S, d = x.shape
    h, r = m["num_attention_heads"], m["kv_lora_rank"]
    dn, dr, dv = m["qk_nope_head_dim"], m["qk_rope_head_dim"], \
        m["v_head_dim"]
    query = (x @ p["wq"].reshape(d, h * (dn + dr))).view(
        b, S, h, dn + dr).transpose(1, 2)
    c, k_pe = torch.split(x @ p["wkv_a"], [r, dr], dim=-1)
    kv = (rms_norm(c, p["kv_norm"]["scale"], m["rms_norm_eps"])
          @ p["wkv_b"].reshape(r, h * (dn + dv))).view(b, S, h, dn + dv)
    k_nope, v = torch.split(kv.transpose(1, 2), [dn, dv], dim=-1)
    key = torch.cat([k_nope, k_pe[:, None].expand(b, h, S, dr)], dim=-1)
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
    _, idx = torch.topk(scores + bias, m["num_experts_per_token"], dim=-1)
    w = scores.gather(1, idx)
    w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return scores, idx, w * m["routed_scaling_factor"]


def held_experts(m, p, u, idx, gates):
    """The held experts' part of ``sum_i g_i Expert_i(u)``; u (T, d).  An
    expert no token chose runs on no rows: it adds nothing, and its
    weights take a zero gradient."""
    out = torch.zeros_like(u)
    for j in range(m["num_experts"]):
        routed = idx == m["expert_offset"] + j  # (T, k)
        tok = routed.any(-1)
        g = (gates * routed).sum(-1)[tok]
        e = {k: v[j] for k, v in p["experts"].items()}
        out[tok] = out[tok] + (g[:, None] * swiglu(e, u[tok])).to(u.dtype)
    return out


def seq_balance(m, scores, n_seq):
    """The report's sequence-wise balance loss, averaged over sequences."""
    E, k = m["router_experts"], m["num_experts_per_token"]
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


def moe_rows(m):
    """Layer index -> its row of the selection bias (MoE layers in order)."""
    k = m["first_k_dense_replace"]
    return {i: i - k for i in range(k, m["num_hidden_layers"])}


def layer(m, i, lp, h, bias, chunk: int):
    """Layer ``i``: (the new residual stream, its balance term)."""
    eps = m["rms_norm_eps"]
    u = rms_norm(h, lp["norm1"]["scale"], eps)
    if i + 1 in m["linear_attn_config"]["kda_layers"]:
        h = h + kda(m, lp["kda"], u, chunk)
    else:
        h = h + mla(m, lp["attn"], u)
    u = rms_norm(h, lp["norm2"]["scale"], eps)
    if i < m["first_k_dense_replace"]:
        return h + swiglu(lp["mlp"], u), torch.zeros((), device=h.device)
    y, lb = moe(m, lp["moe"], u, bias[moe_rows(m)[i]])
    return h + y, lb


def forward(m, p, tokens, bias, chunk=None, remat: bool = False):
    """(logits (b, S, vocab), the summed balance terms); ``bias`` (MoE
    layers, router_experts); KDA in chunks of ``chunk`` (None: the
    configuration's ``kda_chunk``, else the recurrence)."""
    chunk = m.get("kda_chunk", 0) if chunk is None else chunk
    h = p["embedding"]["embed"][tokens.long()]
    aux = torch.zeros((), device=h.device)
    for i in range(m["num_hidden_layers"]):
        lp = p["stack"][f"layer_{i}"]
        if remat:
            h, lb = checkpoint(layer, m, i, lp, h, bias, chunk,
                               use_reentrant=False)
        else:
            h, lb = layer(m, i, lp, h, bias, chunk)
        aux = aux + lb
    h = rms_norm(h, p["final_norm"]["scale"], m["rms_norm_eps"])
    return h @ p["embedding"]["unembed"], aux


def loss(m, p, batch, bias, chunk=None, remat: bool = False):
    """Mean token cross-entropy over ``loss_mask`` plus the weighted
    balance terms."""
    logits, aux = forward(m, p, batch["tokens"], bias, chunk, remat)
    nll = torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, batch["labels"].long()[..., None])[..., 0]
    mask = batch["loss_mask"].float()
    ce = (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return ce + m["aux_loss_alpha"] * aux


def local_delta(m, params, batch, lr: float, *, bias, remat: bool = True):
    """One client's SGD step; returns (delta leaves, its loss)."""
    return lm_round.local_delta(
        lambda p, b: loss(m, p, b, bias, remat=remat), params, batch, lr)


def sync_round(m, params, batch, round_key, *, bias, remat: bool = True,
               **kw):
    """``lm_round.sync_round`` over this loss, the selection bias held
    fixed (it is no parameter: nothing clips, noises or sums it)."""
    return lm_round.sync_round(
        lambda p, b: loss(m, p, b, bias, remat=remat), params, batch,
        round_key, **kw)
