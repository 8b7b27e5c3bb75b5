"""Model facade: every registry architecture behind one interface (port of
``repro.models.model``).

``build_model(cfg)`` returns a ``Model`` with the reference's interface:

  init(key)                         -> params
  apply(params, batch)              -> (logits, aux)
  loss_fn(params, batch)            -> (loss, metrics)
  init_cache(batch_size, max_len)   -> decode cache
  prefill(params, batch, max_len)   -> (logits, cache)
  decode_step(params, cache, tokens, pos) -> (logits, cache)

for the decoder families (dense, moe, ssm, hybrid, vlm) and the
encoder-decoder (audio); a stack with a block that trains but does not
serve (``transformer.TRAIN_ONLY_KINDS``: Granite-4.0-H's ``ssm_moe``,
DeepSeek-V3's latent attention, whose latent cache is not built) refuses
``init_cache``, ``prefill`` and ``decode_step`` with
``NotImplementedError``.  The Model's ``route_bias`` is the sigmoid
router's selection bias (``moe.route_bias_shape``; zero unless given):
state of the model that ``apply`` and ``loss_fn`` read and no round
trains, clips or sums, since it is no parameter.  A VLM batch may carry ``patch_embeds`` (B,
n_image, d), fused ahead of the text tokens (the logits are cut back to the
text positions); an audio batch carries ``audio_embeds`` (B, encoder_seq,
d).  ``decode_step`` updates the cache in place (and returns it); ``pos``
is a Python int.

``build_mlp_classifier(cfg)`` builds the paper's own model, the dense-feature
MLP binary classifier (``configs/mlp.py``); its ``init(key)`` draws the
reference's ``jax.random.normal`` weights from the same key words, bit for
bit.

``param_shapes`` gives the exact leaf paths and shapes of the JAX init, and
``init(key)`` (``init_params(cfg, seed)`` for ``PRNGKey(seed)``) draws the
reference's own weights from the same key words, bit for bit: the same key
tree (``fold_in``/``split``, one ``split`` key per expert and per scanned
layer where the reference ``vmap``s) and ``jax.random.normal`` draws, times
(or, where the reference divides, over) the same f32 scales; zero biases,
unit norm scales.  Three leaves go through transcendental functions whose
last bit torch and XLA round apart: the RG-LRU's ``lambda`` and Mamba-2's
``dt_bias`` and ``A_log``.  Layout (dense, ``num_layers > 1``): the layers
are stacked under ``stack.scan`` with the layer axis leading, as the JAX
``vmap``-ed init produces them::

  embedding.embed                       (vocab, d)
  final_norm.scale                      (d,)
  stack.scan.attn.{wq, wk, wv}          (L, d, heads|kv, head_dim)
  stack.scan.attn.wo                    (L, heads, head_dim, d)
  stack.scan.attn.{bq, bk, bv}          (L, heads|kv, head_dim)   qkv_bias
  stack.scan.mlp.{w_in, w_gate}         (L, d, d_ff)              w_gate: swiglu
  stack.scan.mlp.w_out                  (L, d_ff, d)
  stack.scan.{norm1, norm2}.scale       (L, d)

A MoE stack has ``stack.scan.moe.{router, experts.*, shared.*}`` (experts
stacked after the layer axis) behind a dense ``stack.layer_0`` when
``first_k_dense``; a hybrid ``block_pattern`` is ``stack.layer_{i}``
throughout; the encoder-decoder is ``embedding``, ``enc_{i}``, ``enc_norm``,
``dec_{i}`` and ``dec_norm``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple

import torch

from repro_torch import device as _device
from repro_torch.kernels import prf
from repro_torch.models import encdec as E
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import transformer as T


class Model(NamedTuple):
    cfg: Any
    init: Callable
    apply: Callable
    loss_fn: Callable
    init_cache: Callable
    prefill: Callable
    decode_step: Callable
    route_bias: Any = None


def param_shapes(cfg) -> Dict:
    """Nested dict of ``torch.Size`` — the JAX init's tree, leaf for leaf."""
    if cfg.family == "audio":
        return E.encdec_shapes(cfg)
    return {"embedding": L.embedding_shapes(cfg),
            "stack": T.stack_shapes(cfg),
            "final_norm": L.norm_shapes(cfg, cfg.d_model)}


def init_params(cfg, seed: int = 0, device=None) -> Dict:
    """``build_model(cfg).init(PRNGKey(seed))`` of the reference, bit-equal
    (but for the three transcendental leaves), on ``device`` (default the
    GPU)."""
    return init_from_key(cfg, prf.PRNGKey(seed), _device.resolve(device))


def init_from_key(cfg, key, device) -> Dict:
    """The reference's init from key words: for a decoder, the embedding
    from ``fold_in(key, 0)``, the stack from ``fold_in(key, 1)``; the
    encoder-decoder's own tree (``encdec.init_encdec``)."""
    if cfg.family == "audio":
        return E.init_encdec(key, cfg, device)
    return {"embedding": L.init_embedding(prf.fold_in(key, 0), cfg, device),
            "stack": T.init_stack(prf.fold_in(key, 1), cfg, device),
            "final_norm": L.init_norm(cfg, cfg.d_model, device)}


def _embed_inputs(cfg, params, batch, dtype):
    """Token embedding, with the VLM's patch embeddings fused ahead of the
    text (early fusion) and learned positions."""
    emb = params["embedding"]
    x = L.embed_tokens(cfg, emb, batch["tokens"], dtype)
    if cfg.family == "vlm" and "patch_embeds" in batch:
        x = torch.cat([batch["patch_embeds"].to(dtype), x], dim=1)
    if cfg.pos_emb == "learned":
        x = x + emb["pos_embed"][: x.shape[1]].to(dtype)
    return x


def build_model(cfg, *, use_ragged_moe: bool = False, device=None,
                route_bias=None) -> Model:
    """The model of ``cfg`` on ``device`` (default the GPU): ``init`` and
    ``init_cache`` allocate there; the other functions run where their
    inputs are.  ``use_ragged_moe`` selects the drop-free MoE dispatch;
    ``route_bias`` is the sigmoid router's selection bias (zero when
    None)."""
    if use_ragged_moe and not cfg.moe_ragged:
        cfg = cfg.with_overrides(moe_ragged=True)
    dev = _device.resolve(device)
    if cfg.family == "audio":
        return _build_encdec(cfg, dev)
    dtype = getattr(torch, cfg.compute_dtype)
    if cfg.router_score == "sigmoid" and route_bias is None:
        route_bias = torch.zeros(M.route_bias_shape(cfg),
                                 dtype=torch.float32, device=dev)

    def init(key):
        return init_from_key(cfg, key, dev)

    def apply(params, batch):
        x = _embed_inputs(cfg, params, batch, dtype)
        positions = torch.arange(x.shape[1], device=x.device)
        x, aux = T.apply_stack(cfg, params["stack"], x, positions,
                               use_ragged_moe=use_ragged_moe,
                               route_bias=route_bias)
        x = L.apply_norm(cfg, params["final_norm"], x)
        if cfg.family == "vlm" and "patch_embeds" in batch:
            x = x[:, batch["patch_embeds"].shape[1]:]  # text positions
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

    no_serve = sorted(set(cfg.layer_kinds) & set(T.TRAIN_ONLY_KINDS))
    if no_serve:
        def init_cache(*a, **k):
            raise NotImplementedError(
                f"{cfg.name}: block kind(s) {no_serve} train but have no "
                f"decode cache to serve from")
        prefill = decode_step = init_cache
    return Model(cfg, init, apply, loss_fn, init_cache, prefill, decode_step,
                 route_bias)


def _build_encdec(cfg, dev) -> Model:
    dtype = getattr(torch, cfg.compute_dtype)

    def init(key):
        return init_from_key(cfg, key, dev)

    def apply(params, batch):
        logits = E.apply_encdec(cfg, params, batch)
        return logits, torch.zeros((), dtype=torch.float32,
                                   device=logits.device)

    def loss_fn(params, batch):
        logits, aux = apply(params, batch)
        labels = batch.get("labels", batch["tokens"])
        ce = L.cross_entropy(logits, labels, batch.get("loss_mask"))
        return ce, {"ce": ce, "aux": aux}

    def init_cache(batch_size, max_len):
        return E.init_encdec_cache(cfg, batch_size, max_len, dtype, dev)

    def prefill(params, batch, max_len):
        logits, cache = E.prefill_encdec(cfg, params, batch, max_len, dtype)
        return logits[:, -1:], cache

    def decode_step(params, cache, tokens, pos: int):
        return E.decode_step_encdec(cfg, params, cache, tokens, pos)

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
