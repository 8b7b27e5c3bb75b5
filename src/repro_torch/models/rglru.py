"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Port of ``repro.models.rglru``.  Recurrent block: two branches over the
normed input —
  gate branch:  gelu(x @ W_gate)
  rec branch :  RG_LRU(causal_conv(x @ W_branch))
merged multiplicatively and projected out.  The RG-LRU is a diagonal linear
recurrence ``h_t = a_t h_{t-1} + b_t``, so prefill runs a log-depth
(Hillis-Steele) scan over the sequence axis where the reference runs
``lax.associative_scan`` (another tree of the same products: held to a
tolerance), and decode carries a (B, width) hidden state, updated IN PLACE.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import prf
from repro_torch.models import layers as L
from repro_torch.models.ssm import softplus

_C = 8.0  # RG-LRU gate sharpness constant from the paper


def rglru_shapes(cfg, lead=()):
    d = cfg.d_model
    r = cfg.rglru_width or d
    shapes = {"w_gate": (d, r), "w_branch": (d, r),
              "conv_w": (cfg.rglru_conv_width, r), "conv_b": (r,),
              "w_a": (r, r), "b_a": (r,), "w_x": (r, r), "b_x": (r,),
              "lambda": (r,), "w_out": (r, d)}
    return {k: torch.Size(tuple(lead) + v) for k, v in shapes.items()}


def _uniform(key, shape, lo: float, hi: float, device=None):
    """``jax.random.uniform(key, shape, f32, lo, hi)``, bit-equal:
    ``max(lo, fma(u, f32(hi - lo), lo))`` over the unit uniforms (XLA
    contracts the scale and shift into one FMA), with the span the f32
    difference of the two f32 bounds."""
    u = prf.uniform(key, shape, device=device)
    lo_t = torch.tensor(lo, dtype=torch.float32, device=u.device)
    hi_t = torch.tensor(hi, dtype=torch.float32, device=u.device)
    return torch.maximum(lo_t, prf.fma_f32(u, hi_t - lo_t, lo_t))


def init_rglru_block(key, cfg, device=None):
    """``split(key, 6)`` for w_gate, w_branch, conv_w, w_a, w_x and the
    ``lambda`` uniforms, ``fold_in(key, 7)`` for w_out.  Every leaf is
    the reference's bit for bit but ``lambda``, which goes through torch's
    ``pow`` (an ulp from XLA's on ~0.1% of inputs) and then the
    cancellation of ``1 - u^(1/8)``: within rtol 1e-4 of the reference."""
    d = cfg.d_model
    r = cfg.rglru_width or d
    k1, k2, k3, k4, k5, k6 = prf.split(key, 6)
    f32 = torch.float32
    # Lambda init so a = sigmoid(Lambda)^c spreads over [0.9, 0.999]
    u = _uniform(k6, (r,), 0.9, 0.999, device)
    ur = u ** (1.0 / _C)
    return {
        "w_gate": L.normal_over(k1, (d, r), math.sqrt(d), device),
        "w_branch": L.normal_over(k2, (d, r), math.sqrt(d), device),
        "conv_w": L.normal_leaf(k3, (cfg.rglru_conv_width, r), 0.2, device),
        "conv_b": torch.zeros((r,), dtype=f32, device=device),
        "w_a": L.normal_over(k4, (r, r), math.sqrt(r), device),
        "b_a": torch.zeros((r,), dtype=f32, device=device),
        "w_x": L.normal_over(k5, (r, r), math.sqrt(r), device),
        "b_x": torch.zeros((r,), dtype=f32, device=device),
        "lambda": torch.log(ur / (1.0 - ur)),
        "w_out": L.normal_over(prf.fold_in(key, 7), (r, d), math.sqrt(r),
                               device),
    }


def _gates(p, u):
    """u: (..., r) branch input -> (a, gated_input) in f32."""
    uf = u.float()
    r_gate = torch.sigmoid(uf @ p["w_a"] + p["b_a"])
    i_gate = torch.sigmoid(uf @ p["w_x"] + p["b_x"])
    log_a = -_C * softplus(p["lambda"]) * r_gate  # (<= 0)
    a = torch.exp(log_a)
    # sqrt(1 - a^2) normalization keeps the state scale bounded
    norm = prf.sqrt_f32(torch.clamp_min(1.0 - torch.square(a), 1e-12))
    return a, norm * (i_gate * uf)


def linear_scan(a, b):
    """Inclusive scan of ``h_t = a_t h_{t-1} + b_t`` (h_{-1} = 0) along
    axis 1, in ceil(log2 S) doubling steps: after the step of stride ``s``
    each position holds the composition of the ``2s`` elements ending
    there."""
    S = a.shape[1]
    s = 1
    while s < S:
        b = torch.cat([b[:, :s], a[:, s:] * b[:, :-s] + b[:, s:]], dim=1)
        if 2 * s < S:
            a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return b


def rg_lru_scan(p, u):
    """Full-sequence RG-LRU.  u: (B, S, r)."""
    a, b = _gates(p, u)  # (B,S,r) f32
    return linear_scan(a, b).to(u.dtype)


def rg_lru_step(p, u, h_prev):
    """Single decode step.  u: (B, r); h_prev: (B, r) f32."""
    a, b = _gates(p, u)
    h = a * h_prev + b
    return h.to(u.dtype), h


def _causal_conv(x, w, b):
    K = w.shape[0]
    S = x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    return sum(pad[:, i:i + S, :] * w[i] for i in range(K)) + b


def apply_rglru_block(cfg, p, x, *, return_cache: bool = False):
    """x: (B, S, d) -> (B, S, d) [, decode cache]."""
    dt = x.dtype
    gate = F.gelu(x @ p["w_gate"].to(dt), approximate="tanh")
    u_raw = x @ p["w_branch"].to(dt)
    u = _causal_conv(u_raw, p["conv_w"].to(dt), p["conv_b"].to(dt))
    h = rg_lru_scan(p, u)
    out = (gate * h) @ p["w_out"].to(dt)
    if return_cache:
        K = cfg.rglru_conv_width
        h_final = h[:, -1].float()  # carried decode state
        return out, {"h": h_final, "conv": u_raw[:, -(K - 1):, :]}
    return out


def init_rglru_cache(cfg, batch_size: int, dtype=torch.float32, device=None):
    r = cfg.rglru_width or cfg.d_model
    return {
        "h": torch.zeros((batch_size, r), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch_size, cfg.rglru_conv_width - 1, r),
                            dtype=dtype, device=device),
    }


def decode_rglru_block(cfg, p, x, cache):
    """x: (B, 1, d) -> (y (B,1,d), cache updated in place)."""
    dt = x.dtype
    xt = x[:, 0]
    gate = F.gelu(xt @ p["w_gate"].to(dt), approximate="tanh")
    u = xt @ p["w_branch"].to(dt)  # (B, r)
    hist = torch.cat([cache["conv"], u[:, None]], dim=1)  # (B, K, r)
    w = p["conv_w"].to(dt)
    u = torch.einsum("bkr,kr->br", hist, w) + p["conv_b"].to(dt)
    cache["conv"].copy_(hist[:, 1:])
    h_out, h_state = rg_lru_step(p, u, cache["h"])
    cache["h"].copy_(h_state)
    y = (gate * h_out) @ p["w_out"].to(dt)
    return y[:, None], cache
