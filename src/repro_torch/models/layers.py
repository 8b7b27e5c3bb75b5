"""Shared transformer layers: norms, RoPE, GQA attention, MLPs, embeddings.

Port of ``repro.models.layers`` for the decoder families.  Layers are
functions ``(cfg, params, x, ...) -> y`` over nested dicts of tensors, with
the JAX package's layouts at every public function: activations
``(B, S, d)``, heads ``(B, S, H, hd)``, a KV cache
``{'k': (B, W, KV, hd), 'v': ..., 'pos': (W,) int32}``.

The large products (QKV, output, MLP, unembed) and the chunked prefill
attention are plain PyTorch, as the reference leaves them to XLA; the
decode attention, self and cross, runs the K10 kernel
(``kernels.flash_decode``) on CUDA tensors.  Unlike the reference, the
KV-cache functions update the cache IN PLACE and return the same dict.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_decode as K
from repro_torch.kernels import prf

# Query-chunk size for memory-safe attention (linear-in-queries score memory).
ATTN_QUERY_CHUNK = 512
_F32_MIN = torch.finfo(torch.float32).min


# ---------------------------------------------------------------------------
# Parameter draws (the reference's key tree and jax.random.normal draws)
# ---------------------------------------------------------------------------
def normal_leaf(key, shape, scale: float, device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, f32) * scale``, bit-equal (the
    Python-float scale rounds to f32, as JAX multiplies by it)."""
    z = prf.normal(key, tuple(shape), device=device)
    return z * torch.tensor(scale, dtype=torch.float32, device=z.device)


def normal_over(key, shape, divisor: float, device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, f32) / divisor``, bit-equal to the
    reference's init as ``build_model(cfg).init`` runs it op by op: a true
    f32 division by ``f32(divisor)`` (under ``jit`` XLA multiplies by the
    rounded reciprocal instead, which moves some values by an ulp)."""
    z = prf.normal(key, tuple(shape), device=device)
    return z / torch.tensor(divisor, dtype=torch.float32, device=z.device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def norm_shapes(cfg, d: int, lead=()):
    p = {"scale": torch.Size(tuple(lead) + (d,))}
    if cfg.norm == "layernorm":
        p["bias"] = torch.Size(tuple(lead) + (d,))
    return p


def init_norm(cfg, d: int, device=None):
    p = {"scale": torch.ones(d, dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(d, dtype=torch.float32, device=device)
    return p


def apply_norm(cfg, p, x):
    eps = cfg.norm_eps
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:  # rmsnorm
        ms = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * p["scale"]
    return out.to(x.dtype)


def rmsnorm_gated(x, z, scale, eps: float = 1e-6):
    """Mamba-2 style gated RMSNorm: RMSNorm(x * silu(z))."""
    xf = (x * F.silu(z)).float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (half-rotation / NeoX convention)
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def apply_rope(x, positions, theta: float, freqs=None):
    """x: (..., S, n_heads, head_dim); positions: broadcastable to (..., S);
    ``freqs`` (head_dim / 2,) in place of ``rope_freqs(head_dim, theta)``."""
    if freqs is None:
        freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------
def attention_shapes(cfg, lead=()):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shapes = {"wq": (d, h, hd), "wk": (d, kv, hd), "wv": (d, kv, hd),
              "wo": (h, hd, d)}
    if cfg.qkv_bias:
        shapes.update({"bq": (h, hd), "bk": (kv, hd), "bv": (kv, hd)})
    return {k: torch.Size(tuple(lead) + v) for k, v in shapes.items()}


def init_attention(key, cfg, device=None, d: Optional[int] = None):
    """The reference's ``init_attention``: ``split(key, 4)`` for wq, wk,
    wv, wo; zero biases."""
    d = d or cfg.d_model
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    k1, k2, k3, k4 = prf.split(key, 4)
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(h * hd)
    p = {"wq": normal_leaf(k1, (d, h, hd), s_in, device),
         "wk": normal_leaf(k2, (d, kv, hd), s_in, device),
         "wv": normal_leaf(k3, (d, kv, hd), s_in, device),
         "wo": normal_leaf(k4, (h, hd, d), s_out, device)}
    if cfg.qkv_bias:
        for name, n in (("bq", h), ("bk", kv), ("bv", kv)):
            p[name] = torch.zeros((n, hd), dtype=torch.float32, device=device)
    return p


def _qkv(cfg, p, x, positions, use_rope: bool):
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dgk->bsgk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dgk->bsgk", x, p["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _grouped_scores(q, k):
    """q: (B,Q,H,hd)  k: (B,S,KV,hd)  ->  (B,KV,rep,Q,S) grouped GQA scores."""
    B, Q, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Q, KV, H // KV, hd)
    return torch.einsum("bqgrk,bsgk->bgrqs", qg, k)


def _grouped_out(probs, v):
    """probs: (B,KV,rep,Q,S)  v: (B,S,KV,hd)  ->  (B,Q,H,hd)."""
    B, KV, rep, Q, S = probs.shape
    out = torch.einsum("bgrqs,bsgk->bqgrk", probs, v)
    return out.reshape(B, Q, KV * rep, v.shape[-1])


def attention(cfg, p, x, positions, *, causal: bool = True,
              window: Optional[int] = None, kv_override=None,
              cross: bool = False, return_kv: bool = False):
    """Training/prefill attention, chunked over queries (memory-safe).

    Where ``S`` is not a multiple of the chunk, the reference falls back to
    one chunk of ``S`` queries; the port keeps the chunk and runs a shorter
    last one.  Each query row is computed the same way either way, and the
    score tensor stays ``chunk x S`` (a 3104-token VLM sequence would
    otherwise hold a 20 GB one).

    kv_override: (k, v, k_positions) — for cross attention over encoder
    memory.  cross: no RoPE on the queries and no causal mask.
    return_kv: also return the (k, v) computed here (prefill cache fill).
    """
    q, k, v = _qkv(cfg, p, x, positions,
                   cfg.pos_emb == "rope" and not cross)
    if kv_override is not None:
        k, v, k_positions = kv_override
    else:
        k_positions = positions
    q = q * (cfg.attention_multiplier or cfg.head_dim ** -0.5)
    if cfg.attn_seq_shard:
        # context parallelism: queries split over `model` (K/V whole), so
        # attention splits even where the heads do not divide the axis
        q = _over_model(q, 1)

    out = attend(cfg, q, k, v, positions, k_positions,
                 causal=causal and not cross, window=window)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    if return_kv:
        return y, (k, v)
    return y


def attend(cfg, q, k, v, positions, k_positions, *, causal: bool,
           window: Optional[int] = None):
    """The softmax core of training/prefill attention, chunked over
    queries: q (B, S, H, hd) already scaled, k (B, S_k, KV, hd), v (B, S_k,
    KV, hd_v) -> (B, S, H, hd_v).  Scores and softmax in f32, one ``chunk
    x S_k`` score tensor at a time; ``causal`` masks keys after the query
    (and, with ``window``, those ``window`` or more before it)."""
    S = q.shape[1]
    chunk = cfg.attn_q_chunk or ATTN_QUERY_CHUNK
    outs = []
    for c0 in range(0, S, chunk):
        qpos = positions[c0:c0 + chunk]
        scores = _grouped_scores(q[:, c0:c0 + chunk], k).float()
        if causal:
            mask = qpos[:, None] >= k_positions[None, :]
            if window is not None:
                mask &= (qpos[:, None] - k_positions[None, :]) < window
            scores.masked_fill_(~mask, _F32_MIN)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        del scores
        outs.append(_grouped_out(probs, v))  # (B, chunk, H, hd_v)
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def _over_model(t, dim: Optional[int]):
    """The reference's ``attn_seq_shard`` constraint as a ``DTensor``
    layout: ``t`` split along ``dim`` over the mesh's ``model`` axis
    (``dim=None``: whole on it), its other mesh axes as they were.  A plain
    tensor (one device) is returned as it is."""
    if type(t) is torch.Tensor:
        return t
    from torch.distributed.tensor import DTensor, Replicate, Shard
    names = t.device_mesh.mesh_dim_names if isinstance(t, DTensor) else None
    if not names or "model" not in names:
        return t
    placements = list(t.placements)
    placements[names.index("model")] = Replicate() if dim is None \
        else Shard(dim)
    return t.redistribute(t.device_mesh, placements)


def fill_kv_cache(cfg, cache, k, v, positions):
    """Write prefill (k, v) at ``positions`` into a fresh cache (full or
    ring), in place; returns ``cache``."""
    S = k.shape[1]
    W = cache["k"].shape[1]
    if W >= S:  # full cache: contiguous write
        cache["k"][:, :S] = k
        cache["v"][:, :S] = v
        cache["pos"][:S] = positions
        return cache
    # ring buffer: keep the last W entries at slot = pos % W
    tail_pos = positions[S - W:]
    slots = (tail_pos % W).long()
    cache["k"].index_copy_(1, slots, k[:, S - W:].to(cache["k"].dtype))
    cache["v"].index_copy_(1, slots, v[:, S - W:].to(cache["v"].dtype))
    cache["pos"].index_copy_(0, slots, tail_pos.to(torch.int32))
    return cache


def _cross_decode(cfg, p, x, cross_kv):
    """One decoder token attending, unmasked and without RoPE, over the
    encoder's ``(k, v)`` (B, S_enc, KV, hd): K10 with every slot valid
    (``slot_pos = arange(S_enc)``, ``pos = S_enc - 1``, no window), which
    is the reference's plain softmax over all frames.  Only q is
    projected: the reference's new k/v are unused there."""
    k, v = cross_kv
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
    q = q * (cfg.attention_multiplier or cfg.head_dim ** -0.5)
    S = k.shape[1]
    slot_pos = torch.arange(S, dtype=torch.int32, device=x.device)
    out = K.flash_decode(q[:, 0].float().contiguous(), k, v, slot_pos, S - 1)
    out = out.to(dt)[:, None]
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt))


def attention_decode(cfg, p, x, cache, pos: int, *,
                     window: Optional[int] = None, cross_kv=None):
    """Single-token decode against a (ring-buffer or full) KV cache.

    x: (B, 1, d); cache: {'k': (B, W, KV, hd), 'v': ..., 'pos': (W,) int32};
    pos: absolute position of the new token (a Python int).  Writes the
    new k/v/pos at slot ``pos`` (``pos % W`` when windowed; clamped to
    ``W - 1`` as the reference's ``dynamic_update_slice`` clamps) IN PLACE,
    then runs K10 over the cache.  Returns (out (B,1,d), cache).

    cross_kv: the encoder's ``(k, v)``, each (B, S_enc, KV, hd) contiguous:
    cross attention through K10 over every frame; ``cache`` is returned
    untouched.
    """
    if cross_kv is not None:
        return _cross_decode(cfg, p, x, cross_kv), cache
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _qkv(cfg, p, x, positions, cfg.pos_emb == "rope")
    q = q * (cfg.attention_multiplier or cfg.head_dim ** -0.5)

    W = cache["k"].shape[1]
    slot = pos if window is None else pos % W  # ring buffer when windowed
    # dynamic_update_slice clamps the write into the cache: past the end it
    # lands on the last slot
    slot = min(max(slot, 0), W - 1)
    cache["k"][:, slot] = k_new[:, 0]
    cache["v"][:, slot] = v_new[:, 0]
    cache["pos"][slot] = pos

    k, v, slot_pos = cache["k"], cache["v"], cache["pos"]
    q = q[:, 0].float().contiguous()
    if cfg.attn_seq_shard:
        # decode context parallelism: each device scores its share of the
        # cache's slots for every head; the partial rows combine
        q = _over_model(q, None)
        k, v, slot_pos = (_over_model(k, 1), _over_model(v, 1),
                          _over_model(slot_pos, 0))
    out = K.flash_decode(q, k, v, slot_pos, pos, window=window or 0)
    out = out.to(x.dtype)[:, None]  # (B, 1, H, hd)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype)), cache


def init_kv_cache(cfg, batch_size: int, max_len: int, dtype=torch.float32,
                  device=None):
    W = max_len if cfg.attention_window is None \
        else min(cfg.attention_window, max_len)
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch_size, W, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch_size, W, kv, hd), dtype=dtype, device=device),
        "pos": torch.full((W,), -1, dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def mlp_shapes(cfg, d_ff: int, lead=()):
    d = cfg.d_model
    shapes = {"w_in": (d, d_ff), "w_out": (d_ff, d)}
    if cfg.mlp_act == "swiglu":
        shapes["w_gate"] = (d, d_ff)
    return {k: torch.Size(tuple(lead) + v) for k, v in shapes.items()}


def init_mlp(key, cfg, d_ff: int, device=None, d: Optional[int] = None):
    """The reference's ``init_mlp``: ``split(key, 3)`` for w_in, w_out and
    (swiglu) w_gate."""
    d = d or cfg.d_model
    k1, k2, k3 = prf.split(key, 3)
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(d_ff)
    p = {"w_in": normal_leaf(k1, (d, d_ff), s_in, device),
         "w_out": normal_leaf(k2, (d_ff, d), s_out, device)}
    if cfg.mlp_act == "swiglu":
        p["w_gate"] = normal_leaf(k3, (d, d_ff), s_in, device)
    return p


def apply_mlp(cfg, p, x):
    dt = x.dtype
    h = x @ p["w_in"].to(dt)
    if cfg.mlp_act == "swiglu":
        h = F.silu(x @ p["w_gate"].to(dt)) * h
    elif cfg.mlp_act == "relu2":
        h = torch.square(torch.relu(h))
    elif cfg.mlp_act == "gelu":
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    else:
        raise ValueError(cfg.mlp_act)
    return h @ p["w_out"].to(dt)


# ---------------------------------------------------------------------------
# Embeddings / heads
# ---------------------------------------------------------------------------
def embedding_shapes(cfg):
    p = {"embed": torch.Size((cfg.vocab_size, cfg.d_model))}
    if not cfg.tie_embeddings:
        p["unembed"] = torch.Size((cfg.d_model, cfg.vocab_size))
    if cfg.pos_emb == "learned":
        p["pos_embed"] = torch.Size((cfg.max_seq_len, cfg.d_model))
    return p


def init_embedding(key, cfg, device=None):
    """The reference's ``init_embedding``: embed from ``key``, unembed from
    ``fold_in(key, 1)``, learned positions from ``fold_in(key, 2)``."""
    s = 1.0 / math.sqrt(cfg.d_model)
    p = {"embed": normal_leaf(key, (cfg.vocab_size, cfg.d_model), s, device)}
    if not cfg.tie_embeddings:
        p["unembed"] = normal_leaf(prf.fold_in(key, 1),
                                   (cfg.d_model, cfg.vocab_size), s, device)
    if cfg.pos_emb == "learned":
        p["pos_embed"] = normal_leaf(prf.fold_in(key, 2),
                                     (cfg.max_seq_len, cfg.d_model), 0.02,
                                     device)
    return p


def embed_tokens(cfg, p, tokens, dtype):
    x = p["embed"].to(dtype)[tokens]
    if cfg.family == "hybrid":  # gemma lineage scales embeddings
        x = x * math.sqrt(cfg.d_model)
    if cfg.embedding_multiplier != 1.0:
        x = x * cfg.embedding_multiplier
    return x


def unembed(cfg, p, x):
    if cfg.tie_embeddings:
        logits = x @ p["embed"].to(x.dtype).T
    else:
        logits = x @ p["unembed"].to(x.dtype)
    if cfg.logits_scaling != 1.0:
        logits = logits / cfg.logits_scaling
    return logits


def sincos_positions(seq_len: int, d_model: int, device=None):
    """Fixed sinusoidal embeddings (whisper encoder)."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d_model // 2, dtype=torch.float32,
                       device=device)[None, :]
    angle = pos / torch.pow(10000.0, 2 * dim / d_model)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------
def cross_entropy(logits, labels, mask=None):
    """Mean masked token cross-entropy, computed in f32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
