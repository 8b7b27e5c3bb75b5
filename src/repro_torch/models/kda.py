"""Kimi Delta Attention (KDA), Kimi Linear's linear-attention mixer
(arXiv:2510.26692), for training: a gated delta rule whose decay is per
channel, computed in chunks.

Per layer, with ``H`` heads of ``dk`` keys and ``dk`` values and ``x``
the normed input:

- ``q, k, v = SiLU(conv(x W_q)), SiLU(conv(x W_k)), SiLU(conv(x W_v))``,
  each a causal depthwise convolution of width ``cfg.kda_conv_width`` over
  the ``H dk`` channels, without bias; ``q`` and ``k`` L2-normed per head
  (eps 1e-6), ``q`` times ``dk ** -0.5``;
- the log-decay ``g = -exp(A_log_h) softplus((x W_fa) W_fb + dt_bias)``
  per channel (``W_fa`` d x dk, ``W_fb`` dk x H dk: the low rank is the
  head size, as FLA's ``KimiDeltaAttention`` builds it), so ``g <= 0``;
- ``beta = sigmoid(x W_b)``, one a head;
- from ``S_0 = 0`` a sequence, ``S_t = (I - beta_t k_t k_t^T) Diag(e^g_t)
  S_{t-1} + beta_t k_t v_t^T`` and ``o_t = S_t^T q_t`` (:func:`kda_chunked`);
- ``o <- RMSNorm(o) w_norm sigmoid((x W_ga) W_gb + g_bias)``, the norm over
  each head's ``dk`` (eps ``cfg.norm_eps``); out ``o W_o``.

The decode path (a state cache) is not built: ``models.model`` refuses to
serve this family.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import telemetry as tele
from repro_torch.kernels import prf
from repro_torch.models import layers as L
from repro_torch.models import ssm as S

# the intra-chunk scores' sub-chunk: a chunk's off-diagonal blocks anchor
# their decays at sub-chunk boundaries, its diagonal blocks take each
# (position, position, channel) decay whole
SUB_CHUNK = 16
L2_EPS = 1e-6


def kda_shapes(cfg, lead=()):
    d, h, dk, K = (cfg.d_model, cfg.kda_num_heads, cfg.kda_head_dim,
                   cfg.kda_conv_width)
    shapes = {"wq": (d, h, dk), "wk": (d, h, dk), "wv": (d, h, dk),
              "conv_q": (K, h * dk), "conv_k": (K, h * dk),
              "conv_v": (K, h * dk), "wf_a": (d, dk), "wf_b": (dk, h, dk),
              "dt_bias": (h, dk), "A_log": (h,), "wb": (d, h),
              "wg_a": (d, dk), "wg_b": (dk, h, dk), "g_bias": (h, dk),
              "wo": (h, dk, d)}
    out = {k: torch.Size(tuple(lead) + v) for k, v in shapes.items()}
    out["o_norm"] = L.norm_shapes(cfg, dk, lead)
    return out


def init_kda(key, cfg, device=None):
    """Projections ``N(0, 1 / fan_in)`` from ``split(key, 12)``, the
    convolutions ``N(0, 0.2)``; FLA's gate init: ``A`` over ``[1, 16]`` a
    head, ``dt_bias`` the inverse softplus of steps over ``[0.001, 0.1]``;
    the gate bias 0 and the output norm's scale 1."""
    d, h, dk = cfg.d_model, cfg.kda_num_heads, cfg.kda_head_dim
    K, hk = cfg.kda_conv_width, h * dk
    ks = prf.split(key, 12)
    dt0 = torch.linspace(0.001, 0.1, hk, device=device).view(h, dk)
    return {"wq": L.normal_leaf(ks[0], (d, h, dk), d ** -0.5, device),
            "wk": L.normal_leaf(ks[1], (d, h, dk), d ** -0.5, device),
            "wv": L.normal_leaf(ks[2], (d, h, dk), d ** -0.5, device),
            "conv_q": L.normal_leaf(ks[3], (K, hk), 0.2, device),
            "conv_k": L.normal_leaf(ks[4], (K, hk), 0.2, device),
            "conv_v": L.normal_leaf(ks[5], (K, hk), 0.2, device),
            "wf_a": L.normal_leaf(ks[6], (d, dk), d ** -0.5, device),
            "wf_b": L.normal_leaf(ks[7], (dk, h, dk), dk ** -0.5, device),
            "dt_bias": dt0 + torch.log(-torch.expm1(-dt0)),
            "A_log": torch.log(torch.linspace(1.0, 16.0, h, device=device)),
            "wb": L.normal_leaf(ks[8], (d, h), d ** -0.5, device),
            "wg_a": L.normal_leaf(ks[9], (d, dk), d ** -0.5, device),
            "wg_b": L.normal_leaf(ks[10], (dk, h, dk), dk ** -0.5, device),
            "g_bias": torch.zeros((h, dk), device=device),
            "o_norm": L.init_norm(cfg, dk, device),
            "wo": L.normal_leaf(ks[11], (h, dk, d), 1.0 / math.sqrt(hk),
                                device)}


def _l2norm(x):
    return x * torch.rsqrt(x.square().sum(-1, keepdim=True) + L2_EPS)


def _chunks(t, n: int, C: int):
    """(B, S, H, ...) -> (B, H, n, C, ...), zero-padded to ``n C``
    positions (a padded position has no key, no value, no decay and no
    update: the state passes it unchanged)."""
    pad = n * C - t.shape[1]
    if pad:
        t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
    return t.unflatten(1, (n, C)).movedim(3, 1)


def _assemble(diag, off):
    """The (C, C) score matrix of a chunk from its ``ns`` diagonal blocks
    ``diag`` (..., ns, c, c) and the rows of sub-chunks 1..ns-1 against
    every column ``off`` (..., ns - 1, c, C), zero at and after their own
    sub-chunk's columns."""
    ns, c = diag.shape[-3], diag.shape[-1]
    full = torch.cat([off.new_zeros(off.shape[:-3] + (1, c, ns * c)), off],
                     dim=-3)
    full.unflatten(-1, (ns, c)).diagonal(0, -4, -2).copy_(
        diag.movedim(-3, -1))
    return full.flatten(-3, -2)


def kda_chunked(q, k, v, g, beta, chunk: int):
    """The KDA recurrence of the module docstring, chunk by chunk: q, k
    (B, S, H, dk), v (B, S, H, dv), g (B, S, H, dk) the log-decays (<= 0),
    beta (B, S, H).  Returns (o (B, S, H, dv) in v's dtype, the final
    state (B, H, dk, dv)); computed in f32 or wider.

    Within a chunk of ``C`` positions, ``G`` the cumulative log-decay from
    its start and ``S_0`` the state entering it, the updates ``U`` solve
    ``(I + M) U = beta v - (beta k e^G) S_0`` with ``M_rs = beta_r sum_c
    k_rc k_sc e^(G_rc - G_sc)`` for ``s < r``.  The unit lower triangular
    solve gives ``U = U_0 - W S_0`` (``U_0`` of ``beta v``, ``W`` of
    ``beta k e^G``), batched over every chunk and head; then ``o = O_0 +
    Q_e S_0`` and the next state ``A S_0 + B``, where ``A = Diag(e^(G_C)) -
    K_d^T W``, ``B = K_d^T U_0`` and ``K_d = k e^(G_C - G)``.  Only that
    affine map over the chunks loops: one ``baddbmm`` a chunk.

    Every decay is ``e^(G_r - G_s)`` with ``r`` at or after ``s``, never a
    product ``e^(G_r) e^(-G_s)``, which would overflow (a published decay
    reaches ~700 over a chunk): a diagonal block of ``SUB_CHUNK``
    positions (or the chunk, if shorter) takes each position pair's
    channels whole; an earlier sub-chunk's column ``s`` meets row ``r``
    through the boundary ``a`` between them, ``e^(G_r - G_a) e^(G_a -
    G_s)``, both factors at most 1.

    While the default registry records spans, outside the backward pass,
    counts ``kda_chunk_steps``: the chunks the loop steps through."""
    B, Sq, H, dk = k.shape
    dv, out_dt = v.shape[-1], v.dtype
    ct = torch.promote_types(out_dt, torch.float32)
    C = chunk
    c = min(SUB_CHUNK, C)
    if C % c:
        raise ValueError(f"chunk {C} is not a multiple of sub-chunk {c}")
    ns, n = C // c, -(-Sq // C)
    q, k, v, g = (_chunks(t.to(ct), n, C) for t in (q, k, v, g))
    beta = _chunks(beta.to(ct), n, C)[..., None]  # (B, H, n, C, 1)
    G = g.cumsum(-2)

    # diagonal blocks: e^(G_r - G_s) for s <= r within each sub-chunk
    Gs, ks, qs = (t.unflatten(-2, (ns, c)) for t in (G, k, q))
    tri = torch.ones((c, c), dtype=torch.bool, device=k.device).tril()
    ek = torch.where(tri[..., None], Gs[..., :, None, :] - Gs[..., None, :, :],
                     -math.inf).exp() * ks[..., None, :, :]  # (.., r, s, dk)
    rows = torch.stack([ks, qs], -1)  # (..., r, dk, 2)
    diag = torch.matmul(ek, rows)  # (..., ns, r, s, 2)
    del ek
    # off-diagonal: sub-chunk i >= 1's rows against the columns before its
    # start a = i c - 1, each side decayed to a
    ends = Gs[..., :-1, -1, :]  # (..., ns - 1, dk)
    cols = torch.arange(C, device=k.device)
    before = cols < torch.arange(1, ns, device=k.device)[:, None] * c
    kc = torch.where(before[..., None],
                     ends[..., None, :] - G[..., None, :, :],
                     -math.inf).exp() * k[..., None, :, :]  # (.., ns-1, C, dk)
    to_a = (Gs[..., 1:, :, :] - ends[..., None, :]).exp()
    rq = torch.cat([ks[..., 1:, :, :] * to_a, qs[..., 1:, :, :] * to_a], -2)
    off = torch.matmul(rq, kc.transpose(-1, -2))  # (..., ns - 1, 2c, C)
    del kc
    akk = _assemble(diag[..., 0], off[..., :c, :])
    aqk = _assemble(diag[..., 1], off[..., c:, :])
    del diag, off

    eye = torch.ones((C, C), dtype=torch.bool, device=k.device)
    M = (beta * akk).masked_fill(~eye.tril(-1), 0.0)
    P = aqk.masked_fill(~eye.tril(), 0.0)
    eG = G.exp()
    X = torch.linalg.solve_triangular(
        M, torch.cat([beta * v, beta * k * eG], -1), upper=False,
        unitriangular=True)
    U0, W = X.split([dv, dk], -1)
    O0 = P @ U0
    Qe = q * eG - P @ W
    Kd = (k * (G[..., -1:, :] - G).exp()).transpose(-1, -2)  # (.., dk, C)
    A = torch.diag_embed(eG[..., -1, :]) - Kd @ W
    Bn = Kd @ U0

    tel = tele.get_default()
    if tel.record_spans and torch._C._current_graph_task_id() == -1:
        tel.count("kda_chunk_steps", n)
    A = A.movedim(2, 0).reshape(n, B * H, dk, dk)
    Bn = Bn.movedim(2, 0).reshape(n, B * H, dk, dv)
    state = v.new_zeros((B * H, dk, dv))
    entering = []
    for j in range(n):
        entering.append(state)
        state = torch.baddbmm(Bn[j], A[j], state)
    S0 = torch.stack(entering, 1).view(B, H, n, dk, dv)
    o = O0 + Qe @ S0  # (B, H, n, C, dv)
    o = o.movedim(1, 3).flatten(1, 2)[:, :Sq]
    return o.to(out_dt), state.view(B, H, dk, dv)


def apply_kda(cfg, p, x):
    """x: (B, S, d) -> (B, S, d), causal."""
    dt = x.dtype
    h, dk = cfg.kda_num_heads, cfg.kda_head_dim

    def branch(w, conv):
        y = S._causal_conv(x @ w.to(dt).flatten(1), conv.to(dt))
        return y.unflatten(-1, (h, dk))
    q = _l2norm(branch(p["wq"], p["conv_q"])) * dk ** -0.5
    k = _l2norm(branch(p["wk"], p["conv_k"]))
    v = branch(p["wv"], p["conv_v"])
    f = (x @ p["wf_a"].to(dt)) @ p["wf_b"].to(dt).flatten(1)
    g = -torch.exp(p["A_log"].float())[:, None] * S.softplus(
        f.unflatten(-1, (h, dk)).float() + p["dt_bias"])
    beta = torch.sigmoid((x @ p["wb"].to(dt)).float())
    o, _ = kda_chunked(q, k, v, g, beta, cfg.kda_chunk)
    gate = (x @ p["wg_a"].to(dt)) @ p["wg_b"].to(dt).flatten(1)
    gate = torch.sigmoid(gate.unflatten(-1, (h, dk)) + p["g_bias"].to(dt))
    o = L.apply_norm(cfg, p["o_norm"], o) * gate
    return torch.einsum("bshk,hkd->bsd", o, p["wo"].to(dt))
