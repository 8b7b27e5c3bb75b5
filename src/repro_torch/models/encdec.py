"""Whisper-style encoder-decoder backbone (audio frontend stubbed).

Port of ``repro.models.encdec``.  Encoder: bidirectional attention over
precomputed frame embeddings with sinusoidal positions.  Decoder: causal
self-attention (KV cache for decode) + cross-attention over the encoder
memory + MLP.  LayerNorm, GELU, learned decoder positions — per
arXiv:2212.04356.

Decode runs both attentions through K10: the self-attention over its KV
cache (updated in place), the cross-attention over the prefill's
``cross_k``/``cross_v`` with every frame valid.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import prf
from repro_torch.models import layers as L


def init_cross_attention(key, cfg, device=None):
    return L.init_attention(key, cfg, device)


def cross_attention(cfg, p, x, memory):
    """x: (B, S_dec, d) queries over memory (B, S_enc, d).  No mask, no
    rope."""
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k, v = cross_kv(cfg, p, memory)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
    q = q * cfg.head_dim ** -0.5
    scores = L._grouped_scores(q, k).float()
    probs = torch.softmax(scores, dim=-1).to(dt)
    out = L._grouped_out(probs, v)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt))


def cross_kv(cfg, p, memory):
    """The encoder memory's (k, v), each (B, S_enc, KV, hd) contiguous."""
    dt = memory.dtype
    k = torch.einsum("bsd,dgk->bsgk", memory, p["wk"].to(dt))
    v = torch.einsum("bsd,dgk->bsgk", memory, p["wv"].to(dt))
    if cfg.qkv_bias:
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return k.contiguous(), v.contiguous()


def _encoder_block_shapes(cfg):
    d = cfg.d_model
    return {"norm1": L.norm_shapes(cfg, d), "attn": L.attention_shapes(cfg),
            "norm2": L.norm_shapes(cfg, d),
            "mlp": L.mlp_shapes(cfg, cfg.d_ff)}


def _decoder_block_shapes(cfg):
    d = cfg.d_model
    return {"norm1": L.norm_shapes(cfg, d),
            "self_attn": L.attention_shapes(cfg),
            "norm_c": L.norm_shapes(cfg, d),
            "cross_attn": L.attention_shapes(cfg),
            "norm2": L.norm_shapes(cfg, d),
            "mlp": L.mlp_shapes(cfg, cfg.d_ff)}


def init_encoder_block(key, cfg, device=None):
    k1, k2 = prf.split(key, 2)
    d = cfg.d_model
    return {"norm1": L.init_norm(cfg, d, device),
            "attn": L.init_attention(k1, cfg, device),
            "norm2": L.init_norm(cfg, d, device),
            "mlp": L.init_mlp(k2, cfg, cfg.d_ff, device)}


def apply_encoder_block(cfg, p, x):
    positions = torch.arange(x.shape[1], device=x.device)
    h = L.attention(cfg, p["attn"], L.apply_norm(cfg, p["norm1"], x),
                    positions, causal=False)
    x = x + h
    return x + L.apply_mlp(cfg, p["mlp"], L.apply_norm(cfg, p["norm2"], x))


def init_decoder_block(key, cfg, device=None):
    k1, k2, k3 = prf.split(key, 3)
    d = cfg.d_model
    return {"norm1": L.init_norm(cfg, d, device),
            "self_attn": L.init_attention(k1, cfg, device),
            "norm_c": L.init_norm(cfg, d, device),
            "cross_attn": init_cross_attention(k2, cfg, device),
            "norm2": L.init_norm(cfg, d, device),
            "mlp": L.init_mlp(k3, cfg, cfg.d_ff, device)}


def apply_decoder_block(cfg, p, x, positions, memory):
    h = L.attention(cfg, p["self_attn"], L.apply_norm(cfg, p["norm1"], x),
                    positions)
    x = x + h
    x = x + cross_attention(cfg, p["cross_attn"],
                            L.apply_norm(cfg, p["norm_c"], x), memory)
    return x + L.apply_mlp(cfg, p["mlp"], L.apply_norm(cfg, p["norm2"], x))


# ---------------------------------------------------------------------------
def encdec_shapes(cfg) -> Dict:
    p: Dict = {"embedding": L.embedding_shapes(cfg)}
    for i in range(cfg.num_encoder_layers):
        p[f"enc_{i}"] = _encoder_block_shapes(cfg)
    p["enc_norm"] = L.norm_shapes(cfg, cfg.d_model)
    for i in range(cfg.num_layers):
        p[f"dec_{i}"] = _decoder_block_shapes(cfg)
    p["dec_norm"] = L.norm_shapes(cfg, cfg.d_model)
    return p


def init_encdec(key, cfg, device=None) -> Dict:
    """The embedding from ``fold_in(key, 0)``, encoder block ``i`` from
    ``fold_in(key, 100 + i)``, decoder block ``i`` from ``fold_in(key,
    200 + i)``."""
    p: Dict = {"embedding": L.init_embedding(prf.fold_in(key, 0), cfg,
                                             device)}
    for i in range(cfg.num_encoder_layers):
        p[f"enc_{i}"] = init_encoder_block(prf.fold_in(key, 100 + i), cfg,
                                           device)
    p["enc_norm"] = L.init_norm(cfg, cfg.d_model, device)
    for i in range(cfg.num_layers):
        p[f"dec_{i}"] = init_decoder_block(prf.fold_in(key, 200 + i), cfg,
                                           device)
    p["dec_norm"] = L.init_norm(cfg, cfg.d_model, device)
    return p


def encode(cfg, p, audio_embeds):
    """audio_embeds: (B, S_enc, d) — stub frontend output."""
    pe = L.sincos_positions(audio_embeds.shape[1], cfg.d_model,
                            audio_embeds.device)
    x = audio_embeds + pe.to(audio_embeds.dtype)
    for i in range(cfg.num_encoder_layers):
        x = apply_encoder_block(cfg, p[f"enc_{i}"], x)
    return L.apply_norm(cfg, p["enc_norm"], x)


def _embed(cfg, emb, tokens, dtype, start: int = 0):
    x = L.embed_tokens(cfg, emb, tokens, dtype)
    return x + emb["pos_embed"][start:start + tokens.shape[1]].to(dtype)


def decode_train(cfg, p, memory, tokens):
    """Teacher-forced decoder pass.  tokens: (B, S) -> logits (B, S, V)."""
    emb = p["embedding"]
    x = _embed(cfg, emb, tokens, memory.dtype)
    positions = torch.arange(tokens.shape[1], device=x.device)
    for i in range(cfg.num_layers):
        x = apply_decoder_block(cfg, p[f"dec_{i}"], x, positions, memory)
    x = L.apply_norm(cfg, p["dec_norm"], x)
    return L.unembed(cfg, emb, x)


def apply_encdec(cfg, p, batch):
    memory = encode(cfg, p, batch["audio_embeds"])
    return decode_train(cfg, p, memory, batch["tokens"])


# --- decode path -----------------------------------------------------------
def init_encdec_cache(cfg, batch_size: int, max_len: int,
                      dtype=torch.float32, device=None) -> Dict:
    kv = (batch_size, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim)
    c: Dict = {"memory": torch.zeros((batch_size, cfg.encoder_seq,
                                      cfg.d_model), dtype=dtype,
                                     device=device)}
    for i in range(cfg.num_layers):
        c[f"dec_{i}"] = {
            "self": L.init_kv_cache(cfg, batch_size, max_len, dtype, device),
            "cross_k": torch.zeros(kv, dtype=dtype, device=device),
            "cross_v": torch.zeros(kv, dtype=dtype, device=device),
        }
    return c


def prefill_encdec(cfg, p, batch, max_len: int, dtype=torch.float32):
    """Encode audio + teacher-force the prompt, filling decode caches."""
    memory = encode(cfg, p, batch["audio_embeds"])
    tokens = batch["tokens"]
    B, S = tokens.shape
    emb = p["embedding"]
    x = _embed(cfg, emb, tokens, memory.dtype)
    positions = torch.arange(S, device=x.device)
    cache: Dict = {"memory": memory}
    for i in range(cfg.num_layers):
        bp = p[f"dec_{i}"]
        h, (k, v) = L.attention(cfg, bp["self_attn"],
                                L.apply_norm(cfg, bp["norm1"], x), positions,
                                return_kv=True)
        x = x + h
        self_c = L.fill_kv_cache(
            cfg, L.init_kv_cache(cfg, B, max_len, dtype, x.device), k, v,
            positions)
        del k, v
        x = x + cross_attention(cfg, bp["cross_attn"],
                                L.apply_norm(cfg, bp["norm_c"], x), memory)
        x = x + L.apply_mlp(cfg, bp["mlp"], L.apply_norm(cfg, bp["norm2"], x))
        ck, cv = cross_kv(cfg, bp["cross_attn"], memory)
        cache[f"dec_{i}"] = {"self": self_c, "cross_k": ck, "cross_v": cv}
    x = L.apply_norm(cfg, p["dec_norm"], x)
    return L.unembed(cfg, emb, x), cache


def decode_step_encdec(cfg, p, cache, tokens, pos: int):
    """tokens: (B, 1) one new decoder token at absolute position ``pos`` (a
    Python int); the self-attention caches are updated in place."""
    emb = p["embedding"]
    x = _embed(cfg, emb, tokens, cache["memory"].dtype, pos)
    for i in range(cfg.num_layers):
        bp = p[f"dec_{i}"]
        c = cache[f"dec_{i}"]
        h, _ = L.attention_decode(cfg, bp["self_attn"],
                                  L.apply_norm(cfg, bp["norm1"], x),
                                  c["self"], pos)
        x = x + h
        h, _ = L.attention_decode(cfg, bp["cross_attn"],
                                  L.apply_norm(cfg, bp["norm_c"], x), None,
                                  pos, cross_kv=(c["cross_k"], c["cross_v"]))
        x = x + h
        x = x + L.apply_mlp(cfg, bp["mlp"], L.apply_norm(cfg, bp["norm2"], x))
    x = L.apply_norm(cfg, p["dec_norm"], x)
    return L.unembed(cfg, emb, x), cache
