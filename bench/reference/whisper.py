"""Plain reference of a Whisper encoder-decoder (arXiv:2212.04356), its
token loss, one client's local SGD step and a synchronous DP-FL round.

Encoder: the frame embeddings (the mel and convolution front end is a stub:
the frames come in as embeddings) plus sinusoidal positions, pre-norm
blocks of bidirectional self-attention and a GELU MLP, a final LayerNorm.
Decoder: token embeddings plus learned positions, pre-norm blocks of causal
self-attention, cross-attention over the encoder's output and the MLP, a
final LayerNorm, logits through the tied embedding.  Loss: the mean token
cross-entropy over the loss mask.

Departures from the published model, as the configuration file states
them and the system runs them: LayerNorm epsilon ``layer_norm_eps``
(1e-6; Whisper's code uses 1e-5), the tanh form of GELU, the sinusoid
``pos / 10000^(2i/d)`` with the sines and cosines concatenated (Whisper's
``log_timescale_increment`` spaces them over ``d/2 - 1``), no biases on the
attention projections, and a learned position table of ``max_seq_len``
rows.  Parameters are a nested dict with the system's names and layouts:
``wq``/``wk``/``wv`` are (d, heads, head_dim), ``wo`` (heads, head_dim, d).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.reference import jrandom
from bench.reference.common import flatten, unflatten


def layer_norm(p, x, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * p["scale"] + p["bias"]


def attention(m, p, x, kv, causal: bool):
    B, S, d = x.shape
    H, hd = m["num_heads"], m["head_dim"]
    q = (x @ p["wq"].reshape(d, H * hd)).reshape(B, S, H, hd)
    k = (kv @ p["wk"].reshape(d, H * hd)).reshape(B, -1, H, hd)
    v = (kv @ p["wv"].reshape(d, H * hd)).reshape(B, -1, H, hd)
    scores = torch.einsum("bqhk,bshk->bhqs", q, k) / math.sqrt(hd)
    if causal:
        T = scores.shape[-1]
        mask = torch.ones(S, T, dtype=torch.bool, device=x.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    out = torch.einsum("bhqs,bshk->bqhk", torch.softmax(scores, -1), v)
    return out.reshape(B, S, H * hd) @ p["wo"].reshape(H * hd, d)


def mlp(p, x):
    return F.gelu(x @ p["w_in"], approximate="tanh") @ p["w_out"]


def sinusoids(length: int, d: int, device):
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0, device=device), 2 * i / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def forward_loss(m, p, batch):
    """Mean token cross-entropy of one batch: ``audio_embeds`` (B, S_enc,
    d), ``tokens``/``labels`` (B, S) and ``loss_mask`` (B, S)."""
    eps = m["layer_norm_eps"]
    audio = batch["audio_embeds"]
    x = audio + sinusoids(audio.shape[1], m["d_model"], audio.device)
    for i in range(m["num_encoder_layers"]):
        b = p[f"enc_{i}"]
        h = layer_norm(b["norm1"], x, eps)
        x = x + attention(m, b["attn"], h, h, causal=False)
        x = x + mlp(b["mlp"], layer_norm(b["norm2"], x, eps))
    mem = layer_norm(p["enc_norm"], x, eps)
    tokens = batch["tokens"].long()
    emb = p["embedding"]
    y = emb["embed"][tokens] + emb["pos_embed"][:tokens.shape[1]]
    for i in range(m["num_layers"]):
        b = p[f"dec_{i}"]
        h = layer_norm(b["norm1"], y, eps)
        y = y + attention(m, b["self_attn"], h, h, causal=True)
        y = y + attention(m, b["cross_attn"], layer_norm(b["norm_c"], y, eps),
                          mem, causal=False)
        y = y + mlp(b["mlp"], layer_norm(b["norm2"], y, eps))
    logits = layer_norm(p["dec_norm"], y, eps) @ emb["embed"].T
    nll = torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, batch["labels"].long()[..., None])[..., 0]
    mask = batch["loss_mask"].float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def local_delta(m, params, batch, lr: float, steps: int):
    """One client's ``steps`` of SGD; returns (delta leaves, first loss)."""
    paths = [q for q, _ in flatten(params)]
    p0 = [x for _, x in flatten(params)]
    cur, first = p0, None
    for _ in range(steps):
        leaves = [x.detach().requires_grad_(True) for x in cur]
        loss = forward_loss(m, unflatten(paths, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        first = float(loss.detach()) if first is None else first
        with torch.no_grad():
            cur = [x - lr * (torch.zeros_like(x) if g is None else g)
                   for x, g in zip(leaves, grads)]
    with torch.no_grad():
        return [a - b for a, b in zip(cur, p0)], first


def sync_round(m, params, batch, round_key, *, cohort: int, lr: float,
               steps: int, clip_norm: float, noise_multiplier: float,
               server_lr: float, noise_tag: int):
    """One DP-FL round with weights 1 and noise in the TEE: every client's
    delta clipped by its whole-model norm, the mean, Gaussian noise of
    std ``noise_multiplier * clip_norm / cohort`` drawn as the system
    draws it (``split(fold_in(key, noise_tag), leaves)[i]``), FedAvg.
    Returns (new params, mean loss, noised mean delta leaves, clean mean
    delta leaves)."""
    paths = [q for q, _ in flatten(params)]
    p0 = [x for _, x in flatten(params)]
    acc = [torch.zeros_like(x) for x in p0]
    losses = []
    for c in range(cohort):
        cb = {k: v[c] for k, v in batch.items()}
        delta, loss = local_delta(m, params, cb, lr, steps)
        losses.append(loss)
        norm = math.sqrt(sum(float(torch.sum(d.double() ** 2))
                             for d in delta))
        scale = min(1.0, clip_norm / max(norm, 1e-12))
        for a, d in zip(acc, delta):
            a.add_(d, alpha=scale)
        del delta
    clean = [a / cohort for a in acc]
    std = noise_multiplier * clip_norm / cohort
    keys = jrandom.split(jrandom.fold_in(round_key, noise_tag), len(p0))
    noised = [c + std * jrandom.normal(k, tuple(c.shape), c.device)
              if std > 0 else c for c, k in zip(clean, keys)]
    new = [x + server_lr * n for x, n in zip(p0, noised)]
    return unflatten(paths, new), sum(losses) / cohort, noised, clean
