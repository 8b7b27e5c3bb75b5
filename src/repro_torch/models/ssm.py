"""Mamba-2 block with the SSD (state-space duality) chunked algorithm.

Port of ``repro.models.ssm`` (arXiv:2405.21060 §6): intra-chunk outputs via
the masked-attention dual form, inter-chunk state passing via a loop over
chunk states.  Decode keeps a constant-size (heads, head_dim, state)
recurrent state plus a (conv_width-1)-deep convolution buffer, both updated
IN PLACE.

The reference's three- and four-operand einsums are contracted pairwise
here, in an order that never forms a ``(b, n, Q, Q, nh, hd)`` tensor (26 GB
at mamba2-780m's serve prefill); the largest is the ``(b, n, nh, Q, Q)``
decay matrix, built and scaled in place.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.analytics.bitagg import linspace
from repro_torch.kernels import prf
from repro_torch.models import layers as L


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (no threshold)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def mamba2_shapes(cfg, lead=()):
    d, di = cfg.d_model, cfg.d_inner
    g, ds, nh = cfg.ssm_num_groups, cfg.ssm_state_dim, cfg.ssm_num_heads
    conv_ch = di + 2 * g * ds
    shapes = {"in_proj": (d, 2 * di + 2 * g * ds + nh),
              "conv_w": (cfg.ssm_conv_width, conv_ch), "conv_b": (conv_ch,),
              "dt_bias": (nh,), "A_log": (nh,), "D": (nh,),
              "norm_scale": (di,), "out_proj": (di, d)}
    return {k: torch.Size(tuple(lead) + v) for k, v in shapes.items()}


def init_mamba2(key, cfg, device=None):
    """``split(key, 4)``: in_proj, conv_w, out_proj from the first three;
    ``dt_bias`` and ``A_log`` from ``jnp.linspace`` grids (XLA's formula)
    through ``exp``/``log`` (torch's, within a few ulp of XLA's)."""
    d, di = cfg.d_model, cfg.d_inner
    g, ds, nh = cfg.ssm_num_groups, cfg.ssm_state_dim, cfg.ssm_num_heads
    conv_ch = di + 2 * g * ds
    k1, k2, k3, _ = prf.split(key, 4)
    f32 = torch.float32
    dt0 = linspace(0.001, 0.1, nh, device=device)
    return {
        "in_proj": L.normal_over(k1, (d, 2 * di + 2 * g * ds + nh),
                                 math.sqrt(d), device),
        "conv_w": L.normal_leaf(k2, (cfg.ssm_conv_width, conv_ch), 0.2,
                                device),
        "conv_b": torch.zeros((conv_ch,), dtype=f32, device=device),
        "dt_bias": torch.log(torch.exp(dt0) - 1.0),  # softplus^-1
        "A_log": torch.log(linspace(1.0, 16.0, nh, device=device)),
        "D": torch.ones((nh,), dtype=f32, device=device),
        "norm_scale": torch.ones((di,), dtype=f32, device=device),
        "out_proj": L.normal_over(k3, (di, d), math.sqrt(di), device),
    }


def _split_proj(cfg, zxbcdt):
    di, g, ds, nh = (cfg.d_inner, cfg.ssm_num_groups, cfg.ssm_state_dim,
                     cfg.ssm_num_heads)
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:di + di + 2 * g * ds]
    dt = zxbcdt[..., -nh:]
    return z, xBC, dt


def _causal_conv(xBC, w, b):
    """Depthwise causal conv, width K: xBC (B,S,C), w (K,C)."""
    K = w.shape[0]
    S = xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + S, :] * w[i] for i in range(K))
    return F.silu(out + b)


def ssd_chunked(x, dt, A, B, C, chunk: int, unroll: bool = False):
    """SSD forward.  Shapes:
      x: (b, S, nh, hd)   dt: (b, S, nh)   A: (nh,) (negative)
      B, C: (b, S, g, ds) with g == 1 (grouped state dims)
    Returns y: (b, S, nh, hd) and final state (b, nh, hd, ds).
    ``unroll`` is the reference's scan layout knob (how XLA lays out the
    inter-chunk scan); it changes no value, and the loop here is eager.
    """
    b, S, nh, hd = x.shape
    g, ds = B.shape[2], B.shape[3]
    if g != 1:
        raise ValueError("ssm_num_groups > 1 not supported")
    Q = min(chunk, S)
    if S % Q:
        Q = S
    n = S // Q
    xc = x.reshape(b, n, Q, nh, hd).float()
    dtc = dt.reshape(b, n, Q, nh).float()
    Bc = B.reshape(b, n, Q, ds).float()  # g==1 squeezed
    Cc = C.reshape(b, n, Q, ds).float()

    dA = dtc * A  # (b,n,Q,nh) negative increments
    cum = torch.cumsum(dA, dim=2)  # within-chunk cumulative log-decay
    cum_h = cum.permute(0, 1, 3, 2)  # (b,n,nh,Q)

    # --- intra-chunk (dual / attention-like form) ---
    # M[h,q,k] = exp(cum_q - cum_k) [q >= k] * (C_q . B_k) * dt_k in
    # (b, n, nh, Q, Q), then one batched product with x.  The upper
    # triangle is set to -inf before the exp: the same zeros as the
    # reference's where(tri, exp(rel), 0), but where exp(cum_q - cum_k)
    # overflows there (a chunk's decay past e^88) its gradient stays 0
    # rather than the reference's 0 * inf = NaN.  Without autograd
    # (serving) M is built in place, one buffer; under autograd each factor
    # stays for the backward pass, so the same ops run out of place.
    M = cum_h[..., :, None] - cum_h[..., None, :]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    cb = torch.einsum("bnqs,bnks->bnqk", Cc, Bc)[:, :, None]  # (b,n,1,Q,K)
    dtk = dtc.permute(0, 1, 3, 2)[..., None, :]
    if M.requires_grad:
        M = M.masked_fill(~tri, -math.inf).exp() * cb * dtk
    else:
        M.masked_fill_(~tri, -math.inf)
        M.exp_()
        M.mul_(cb)
        M.mul_(dtk)
    del cb
    y = torch.matmul(M, xc.permute(0, 1, 3, 2, 4))  # (b,n,nh,Q,hd)
    del M

    # --- chunk states ---
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # (b,n,Q,nh)
    xw = xc * (decay_to_end * dtc)[..., None]  # (b,n,Q,nh,hd)
    states = torch.einsum("bnkhp,bnks->bnhps", xw, Bc)
    del xw

    # --- inter-chunk recurrence over n ---
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (b,n,nh)
    s_prev = torch.zeros((b, nh, hd, ds), dtype=torch.float32,
                         device=x.device)
    prev = []
    for i in range(n):
        prev.append(s_prev)
        s_prev = chunk_decay[:, i, :, None, None] * s_prev + states[:, i]
    prev_states = torch.stack(prev, dim=1)  # (b,n,nh,hd,ds) entering chunk
    del prev, states

    # --- inter-chunk contribution ---
    in_decay = torch.exp(cum_h)  # (b,n,nh,Q) from chunk start to position
    y_off = torch.einsum("bnqs,bnhps->bnhqp", Cc, prev_states)
    y = y + y_off * in_decay[..., None]
    y = y.permute(0, 1, 3, 2, 4).reshape(b, S, nh, hd)
    return y.to(x.dtype), s_prev


def apply_mamba2(cfg, p, x, *, return_cache: bool = False):
    """Full-sequence forward.  x: (B, S, d) -> (B, S, d) [, decode cache]."""
    dt_ = x.dtype
    zxbcdt = x @ p["in_proj"].to(dt_)
    z, xBC_raw, dtv = _split_proj(cfg, zxbcdt)
    xBC = _causal_conv(xBC_raw, p["conv_w"].to(dt_), p["conv_b"].to(dt_))
    di, g, ds = cfg.d_inner, cfg.ssm_num_groups, cfg.ssm_state_dim
    Bs, S = x.shape[:2]
    xs = xBC[..., :di]
    Bm = xBC[..., di:di + g * ds].reshape(Bs, S, g, ds)
    Cm = xBC[..., di + g * ds:].reshape(Bs, S, g, ds)
    nh, hd = cfg.ssm_num_heads, cfg.ssm_head_dim
    xh = xs.reshape(Bs, S, nh, hd)
    dtv = softplus(dtv.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, final_state = ssd_chunked(xh, dtv, A, Bm, Cm, cfg.ssm_chunk)
    y = y + xh * p["D"].to(dt_)[None, None, :, None]
    y = y.reshape(Bs, S, di)
    y = L.rmsnorm_gated(y, z, p["norm_scale"])
    out = y @ p["out_proj"].to(dt_)
    if return_cache:
        K = cfg.ssm_conv_width
        tail = xBC_raw[:, -(K - 1):, :]  # raw conv inputs for the next steps
        return out, {"conv": tail, "ssm": final_state}
    return out


# ---------------------------------------------------------------------------
# Decode (single token, constant state)
# ---------------------------------------------------------------------------
def init_mamba2_cache(cfg, batch_size: int, dtype=torch.float32,
                      device=None):
    di, g, ds = cfg.d_inner, cfg.ssm_num_groups, cfg.ssm_state_dim
    nh, hd = cfg.ssm_num_heads, cfg.ssm_head_dim
    conv_ch = di + 2 * g * ds
    return {
        "conv": torch.zeros((batch_size, cfg.ssm_conv_width - 1, conv_ch),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch_size, nh, hd, ds), dtype=torch.float32,
                           device=device),
    }


def decode_mamba2(cfg, p, x, cache):
    """x: (B, 1, d) -> (y (B,1,d), cache updated in place)."""
    dt_ = x.dtype
    zxbcdt = x[:, 0] @ p["in_proj"].to(dt_)  # (B, proj)
    z, xBC, dtv = _split_proj(cfg, zxbcdt)
    # conv buffer update
    hist = torch.cat([cache["conv"], xBC[:, None]], dim=1)  # (B, K, C)
    w = p["conv_w"].to(dt_)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", hist, w)
                      + p["conv_b"].to(dt_))
    cache["conv"].copy_(hist[:, 1:])

    di, g, ds = cfg.d_inner, cfg.ssm_num_groups, cfg.ssm_state_dim
    nh, hd = cfg.ssm_num_heads, cfg.ssm_head_dim
    xs = conv_out[..., :di].reshape(-1, nh, hd).float()
    Bm = conv_out[..., di:di + g * ds].float()  # (B, ds) g==1
    Cm = conv_out[..., di + g * ds:].float()
    dtv = softplus(dtv.float() + p["dt_bias"])  # (B, nh)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dtv * A)  # (B, nh)
    state = cache["ssm"] * dA[..., None, None] \
        + (dtv[..., None] * xs)[..., None] * Bm[:, None, None, :]
    cache["ssm"].copy_(state)
    y = torch.einsum("bhps,bs->bhp", state, Cm) + xs * p["D"][None, :, None]
    y = y.reshape(-1, di).to(dt_)
    y = L.rmsnorm_gated(y, z, p["norm_scale"])
    y = y @ p["out_proj"].to(dt_)
    return y[:, None], cache
