"""Model facade of the dense decoder family (port of ``repro.models.model``).

``build_model(cfg)`` returns a ``Model`` with the reference's interface:

  init(key)                         -> params
  apply(params, batch)              -> (logits, aux)
  loss_fn(params, batch)            -> (loss, metrics)
  init_cache(batch_size, max_len)   -> decode cache
  prefill(params, batch, max_len)   -> (logits, cache)
  decode_step(params, cache, tokens, pos) -> (logits, cache)

Only ``family="dense"`` is ported (qwen2-1.5b, deepseek-7b,
deepseek-coder-33b, minitron-4b); the other families raise
``NotImplementedError``.  ``decode_step`` updates the cache in place (and
returns it); ``pos`` is a Python int.

``build_mlp_classifier(cfg)`` builds the paper's own model, the dense-feature
MLP binary classifier (``configs/mlp.py``); its ``init(key)`` draws the
reference's ``jax.random.normal`` weights from the same key words, bit for
bit.

``param_shapes`` gives the exact leaf paths and shapes of the JAX init, and
``init(key)`` (``init_params(cfg, seed)`` for ``PRNGKey(seed)``) draws the
reference's own weights from the same key words, bit for bit: the same key
tree (``fold_in``/``split``) and ``jax.random.normal`` draws, times the same
f32 scales; zero biases, unit norm scales.  Layout (dense, ``num_layers >
1``): the layers are stacked under ``stack.scan`` with the layer axis
leading, as the JAX ``vmap``-ed init produces them::

  embedding.embed                       (vocab, d)
  final_norm.scale                      (d,)
  stack.scan.attn.{wq, wk, wv}          (L, d, heads|kv, head_dim)
  stack.scan.attn.wo                    (L, heads, head_dim, d)
  stack.scan.attn.{bq, bk, bv}          (L, heads|kv, head_dim)   qkv_bias
  stack.scan.mlp.{w_in, w_gate}         (L, d, d_ff)              w_gate: swiglu
  stack.scan.mlp.w_out                  (L, d_ff, d)
  stack.scan.{norm1, norm2}.scale       (L, d)
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple

import torch

from repro_torch import device as _device
from repro_torch.kernels import prf
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


class Model(NamedTuple):
    cfg: Any
    init: Callable
    apply: Callable
    loss_fn: Callable
    init_cache: Callable
    prefill: Callable
    decode_step: Callable


def _check_dense(cfg, what: str) -> None:
    if cfg.family != "dense" or cfg.block_pattern is not None:
        raise NotImplementedError(
            f"{what}: only the dense family is ported (got {cfg.family!r}); "
            "moe, ssm, hybrid, vlm and audio are ROADMAP Queue 1, item 11")


def param_shapes(cfg) -> Dict:
    """Nested dict of ``torch.Size`` — the JAX init's tree, leaf for leaf."""
    _check_dense(cfg, "param_shapes")
    return {"embedding": L.embedding_shapes(cfg),
            "stack": T.stack_shapes(cfg),
            "final_norm": L.norm_shapes(cfg, cfg.d_model)}


def init_params(cfg, seed: int = 0, device=None) -> Dict:
    """``build_model(cfg).init(PRNGKey(seed))`` of the reference, bit-equal,
    on ``device`` (default the GPU)."""
    return init_from_key(cfg, prf.PRNGKey(seed), _device.resolve(device))


def init_from_key(cfg, key, device) -> Dict:
    """The reference's dense init from key words: the embedding from
    ``fold_in(key, 0)``, the stack from ``fold_in(key, 1)``."""
    _check_dense(cfg, "init")
    return {"embedding": L.init_embedding(prf.fold_in(key, 0), cfg, device),
            "stack": T.init_stack(prf.fold_in(key, 1), cfg, device),
            "final_norm": L.init_norm(cfg, cfg.d_model, device)}


def _embed_inputs(cfg, params, batch, dtype):
    emb = params["embedding"]
    x = L.embed_tokens(cfg, emb, batch["tokens"], dtype)
    if cfg.pos_emb == "learned":
        x = x + emb["pos_embed"][: x.shape[1]].to(dtype)
    return x


def build_model(cfg, *, device=None) -> Model:
    """The dense family's model on ``device`` (default the GPU): ``init`` and
    ``init_cache`` allocate there; the other functions run where their
    inputs are."""
    _check_dense(cfg, "build_model")
    dev = _device.resolve(device)
    dtype = getattr(torch, cfg.compute_dtype)

    def init(key):
        return init_from_key(cfg, key, dev)

    def apply(params, batch):
        x = _embed_inputs(cfg, params, batch, dtype)
        positions = torch.arange(x.shape[1], device=x.device)
        x, aux = T.apply_stack(cfg, params["stack"], x, positions)
        x = L.apply_norm(cfg, params["final_norm"], x)
        return L.unembed(cfg, params["embedding"], x), aux

    def loss_fn(params, batch):
        logits, aux = apply(params, batch)
        labels = batch.get("labels", batch["tokens"])
        ce = L.cross_entropy(logits, labels, batch.get("loss_mask"))
        return ce + aux, {"ce": ce, "aux": aux}

    def init_cache(batch_size, max_len):
        return T.init_stack_cache(cfg, batch_size, max_len, dtype, dev)

    def prefill(params, batch, max_len):
        x = _embed_inputs(cfg, params, batch, dtype)
        positions = torch.arange(x.shape[1], device=x.device)
        x, cache = T.prefill_stack(cfg, params["stack"], x, positions,
                                   max_len, dtype)
        x = L.apply_norm(cfg, params["final_norm"], x[:, -1:])
        return L.unembed(cfg, params["embedding"], x), cache

    def decode_step(params, cache, tokens, pos: int):
        emb = params["embedding"]
        x = L.embed_tokens(cfg, emb, tokens, dtype)
        if cfg.pos_emb == "learned":
            x = x + emb["pos_embed"][pos:pos + 1].to(dtype)[None]
        x, cache = T.decode_stack(cfg, params["stack"], x, cache, pos)
        x = L.apply_norm(cfg, params["final_norm"], x)
        return L.unembed(cfg, emb, x), cache

    return Model(cfg, init, apply, loss_fn, init_cache, prefill, decode_step)


# ---------------------------------------------------------------------------
# The paper's dense-feature MLP binary classifier (configs/mlp.py)
# ---------------------------------------------------------------------------
def build_mlp_classifier(cfg, *, device=None) -> Model:
    """Binary classifier on dense features — the paper's model class.

    ``init(key)`` takes ``(k0, k1)`` key words: layer ``i``'s weight is
    ``normal(fold_in(key, i), (din, dout)) * din ** -0.5``, its bias zero.
    """
    dev = _device.resolve(device)
    act = {"relu": torch.relu, "tanh": torch.tanh}[cfg.activation]

    def init(key):
        dims = (cfg.num_features,) + tuple(cfg.hidden_dims) + (1,)
        params = {}
        for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
            z = prf.normal(prf.fold_in(key, i), (din, dout), device=dev)
            params[f"dense_{i}"] = {
                "w": z * torch.tensor(din ** -0.5, dtype=torch.float32,
                                      device=dev),
                "b": torch.zeros((dout,), dtype=torch.float32, device=dev),
            }
        return params

    def apply(params, batch):
        x = batch["features"].to(torch.float32)
        n = len(params)
        for i in range(n):
            p = params[f"dense_{i}"]
            x = x @ p["w"] + p["b"]
            if i < n - 1:
                x = act(x)
        return x[..., 0], torch.zeros((), dtype=torch.float32,
                                      device=x.device)

    def loss_fn(params, batch):
        logit, _ = apply(params, batch)
        y = batch["label"].to(torch.float32)
        # numerically-stable sigmoid BCE
        loss = (torch.clamp(logit, min=0) - logit * y
                + torch.log1p(torch.exp(-torch.abs(logit))))
        w = batch.get("weight")
        if w is None:
            loss = torch.mean(loss)
        else:
            loss = torch.mean(loss * w) / torch.clamp(torch.mean(w),
                                                      min=1e-9)
        acc = torch.mean(((logit > 0) == (y > 0.5)).to(torch.float32))
        return loss, {"bce": loss, "accuracy": acc}

    def _no_decode(*a, **k):
        raise NotImplementedError("classifier has no decode path")

    return Model(cfg, init, apply, loss_fn, _no_decode, _no_decode,
                 _no_decode)
