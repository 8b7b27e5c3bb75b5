"""On-device inference entry point (port of ``repro.launch.serve``).

Inits a model from ``--seed`` (the reference's weights and prompt: the same
``PRNGKey(seed)`` draws, bit for bit), optionally int8-quantizes the weights
(the paper: "efficient model quantization ... for incorporating models in
mobile applications"), prefills a batch of random prompts and greedily
decodes N tokens per request against the KV cache.  Runs on the GPU unless
``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      --reduced --batch 4 --prompt-len 32 --decode-tokens 16 [--device cpu]

Every registry architecture serves: the VLM's stub patch embeddings and
the audio model's stub frame embeddings are ``0.02 * normal`` draws from the
prompt's own key, as the reference draws them, and a VLM's decode positions
start after its image tokens.  ``--window N`` serves the sliding-window
(ring-buffer cache) decode variant of a full-attention model; ``--layers
N`` cuts the depth to the first N layers (a hybrid keeps its pattern's
first N kinds), for a model whose full depth does not fit one card.
``--checkpoint DIR`` serves the ``params`` of a checkpoint (either
package's ``checkpoint.save``) instead of the seed's weights.
"""
from __future__ import annotations

import argparse
import time
from typing import List, NamedTuple, Optional

import torch

from repro_torch import device as _device
from repro_torch import tree as T
from repro_torch.kernels import prf


def quantize_int8(params):
    """Per-tensor symmetric int8 weight quantization (served models):
    every leaf of 2+ dims becomes ``(int8 values, f32 scale)``."""

    def q(x):
        if x.dim() < 2:
            return x  # norms/biases stay f32
        scale = x.abs().max().clamp_min(1e-8) \
            / torch.tensor(127.0, device=x.device)
        return torch.round(x / scale).to(torch.int8), scale

    return T.tree_map(q, params)


def dequantize_int8(qparams):
    def dq(x):
        if isinstance(x, tuple):
            qv, scale = x
            return qv.to(torch.float32) * scale
        return x

    return T.tree_map(dq, qparams)


def stub_inputs(cfg, key, batch: int, device) -> dict:
    """The reference's stub frontends: ``patch_embeds`` (VLM) or
    ``audio_embeds`` (audio), ``0.02 * normal(key, ...)`` from the key that
    also draws the prompt; ``{}`` for a text-only model."""
    shape = {"vlm": (batch, cfg.num_image_tokens, cfg.d_model),
             "audio": (batch, cfg.encoder_seq, cfg.d_model)}.get(cfg.family)
    if shape is None:
        return {}
    z = prf.normal(key, shape, device=device)
    name = "patch_embeds" if cfg.family == "vlm" else "audio_embeds"
    return {name: z * torch.tensor(0.02, dtype=torch.float32,
                                   device=z.device)}


def cut_depth(cfg, layers: int):
    """``cfg`` with its first ``layers`` layers (a block pattern cut to
    match)."""
    pattern = cfg.block_pattern
    return cfg.with_overrides(
        num_layers=layers,
        block_pattern=None if pattern is None else pattern[:layers])


class Generation(NamedTuple):
    """A greedy run: ``tokens`` (B, 1 + decode_tokens), the prefill's pick
    first; ``logits`` the prefill's last-position logits then each decode
    step's, each (B, vocab), when kept; host seconds of both phases, each
    ending in a device synchronise."""

    tokens: torch.Tensor
    logits: Optional[List[torch.Tensor]]
    prefill_s: float
    decode_s: float


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(model, params, tokens: torch.Tensor, decode_tokens: int, *,
             max_len: Optional[int] = None, keep_logits: bool = False,
             inputs: Optional[dict] = None) -> Generation:
    """Prefill ``tokens`` (B, S) with the batch's other ``inputs``
    (:func:`stub_inputs`), then ``decode_tokens`` greedy steps at positions
    S + off, S + off + 1, ... (``off`` the VLM's image tokens, else 0)
    against the cache (``max_len`` deep, default S + decode_tokens +
    off)."""
    B, S = tokens.shape
    cfg = model.cfg
    off = cfg.num_image_tokens if cfg.family == "vlm" else 0
    max_len = max_len or S + decode_tokens + off
    dev = tokens.device
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": tokens, **(inputs or {})},
                                  max_len)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    kept = [logits[:, -1]] if keep_logits else None
    tok = logits[:, -1].argmax(-1)[:, None]
    outs = [tok]
    t0 = time.perf_counter()
    for i in range(decode_tokens):
        logits, cache = model.decode_step(params, cache, tok, S + off + i)
        tok = logits[:, 0].argmax(-1)[:, None]
        outs.append(tok)
        if keep_logits:
            kept.append(logits[:, 0])
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return Generation(torch.cat(outs, dim=1), kept, t_prefill, t_decode)


def main(argv=None, *, session: Optional[dict] = None):
    """The serve CLI.  ``session``, if a dict, receives the run's ``model``,
    ``params``, prompt ``tokens``, stub ``inputs`` and ``generation`` (with
    every step's logits), so a caller can check what was served."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-tokens", type=int, default=16)
    ap.add_argument("--int8", action="store_true", help="int8 weight quant")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--window", type=int, default=None,
                    help="sliding-window decode variant (ring-buffer cache)")
    ap.add_argument("--layers", type=int, default=None,
                    help="serve the first N layers only (a depth cut)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import registry
    from repro_torch.models.model import build_model

    dev = _device.resolve(args.device)
    cfg = registry.get_config(args.arch, reduced=args.reduced)
    if args.window is not None:
        cfg = cfg.decode_variant(args.window)
    if args.layers is not None:
        cfg = cut_depth(cfg, args.layers)
    max_len = args.prompt_len + args.decode_tokens + cfg.num_image_tokens
    cfg = cfg.with_overrides(max_seq_len=max(cfg.max_seq_len, max_len))
    model = build_model(cfg, device=dev)
    key = prf.PRNGKey(args.seed)
    if args.checkpoint:
        from repro_torch.checkpoint.checkpoint import restore
        tree, manifest = restore(args.checkpoint, device=dev)
        params = tree["params"]
        print(f"restored step {manifest['step']}")
    else:
        params = model.init(key)

    if args.int8:
        n0 = sum(x.numel() * x.element_size() for x in T.leaves(params))
        qp = quantize_int8(params)
        del params
        n1 = sum(x[0].numel() + 4 if isinstance(x, tuple)
                 else x.numel() * x.element_size() for x in T.leaves(qp))
        params = dequantize_int8(qp)
        del qp
        print(f"int8 quantization: {n0 / 2**20:.1f} MiB -> "
              f"{n1 / 2**20:.1f} MiB")

    B, S = args.batch, args.prompt_len
    tokens = prf.randint(key, (B, S), 0, cfg.vocab_size, device=dev).long()
    inputs = stub_inputs(cfg, key, B, dev)
    gen = generate(model, params, tokens, args.decode_tokens,
                   max_len=max_len, keep_logits=session is not None,
                   inputs=inputs)
    print(f"prefill: {B}x{S} in {gen.prefill_s * 1e3:.1f} ms "
          f"({B * S / gen.prefill_s:.0f} tok/s)")
    print(f"decode: {args.decode_tokens} steps in {gen.decode_s * 1e3:.1f} ms "
          f"({B * args.decode_tokens / max(gen.decode_s, 1e-9):.0f} tok/s)")
    print("sample:", gen.tokens[0, :10].tolist())
    if session is not None:
        session.update(model=model, params=params, tokens=tokens,
                       inputs=inputs, generation=gen)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
