"""Plain reference of the Mamba-2 language model (arXiv:2405.21060): its
forward pass and loss in f32, one client's local SGD step and the
synchronous DP-FL round.

It imports nothing of the system.  Each of ``num_layers`` layers is ``h +=
Mamba2(RMSNorm(h))`` (the mixer of ``reference/granite.py``: in_proj,
causal depthwise conv, the SSD of the paper's minimal listing, ``+ D x``,
the gated RMSNorm, out_proj), then a final RMSNorm and the tied head
``logits = h E^T``; the loss is the mean token cross-entropy over the loss
mask.  ``remat`` recomputes each layer in the backward pass.

A configuration is the benchmark's file (``num_layers``, ``d_model``,
``ssm_*``, ``vocab_size``).  It states no RMSNorm epsilon: the reference
takes 1e-6, the system's (the paper's code uses 1e-5).  Parameters are a
nested dict with the system's names and layouts: the layers stacked under
``stack.scan`` (layer axis first).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from bench.reference import lm_round
from bench.reference.granite import mamba, rms_norm

NORM_EPS = 1e-6


def mixer_config(m: dict) -> dict:
    """The mixer's keys (``config.json`` names, as ``granite.mamba`` reads
    them)."""
    di = m["ssm_expand"] * m["d_model"]
    return {"mamba_expand": m["ssm_expand"],
            "mamba_n_heads": di // m["ssm_head_dim"],
            "mamba_d_head": m["ssm_head_dim"],
            "mamba_d_state": m["ssm_state_dim"],
            "mamba_d_conv": m["ssm_conv_width"],
            "mamba_n_groups": m["ssm_num_groups"],
            "mamba_chunk_size": m["ssm_chunk"], "rms_norm_eps": NORM_EPS}


def layer(mc, lp, h):
    return h + mamba(mc, lp["mamba"], rms_norm(h, lp["norm1"]["scale"],
                                               NORM_EPS))


def forward(m, p, tokens, remat: bool = False):
    """Logits (b, S, vocab)."""
    mc = mixer_config(m)
    embed = p["embedding"]["embed"]
    h = embed[tokens.long()]
    scan = p["stack"]["scan"]
    for i in range(m["num_layers"]):
        lp = {"mamba": {k: v[i] for k, v in scan["mamba"].items()},
              "norm1": {"scale": scan["norm1"]["scale"][i]}}
        h = checkpoint(layer, mc, lp, h, use_reentrant=False) if remat \
            else layer(mc, lp, h)
    h = rms_norm(h, p["final_norm"]["scale"], NORM_EPS)
    return h @ embed.T


def loss(m, p, batch, remat: bool = False):
    logits = forward(m, p, batch["tokens"], remat)
    nll = torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, batch["labels"].long()[..., None])[..., 0]
    mask = batch["loss_mask"].float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def sync_round(m, params, batch, round_key, *, remat: bool = True, **kw):
    """``lm_round.sync_round`` over this loss."""
    return lm_round.sync_round(lambda p, b: loss(m, p, b, remat), params,
                               batch, round_key, **kw)
