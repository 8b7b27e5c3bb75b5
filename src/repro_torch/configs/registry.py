"""Architecture registry: ``--arch <id>`` resolution and per-shape input
specs (port of ``repro.configs.registry``).

``input_specs`` describes every model input of an (arch, shape) pair as a
:class:`TensorSpec` (shape and torch dtype), the port's stand-in for the
reference's ``jax.ShapeDtypeStruct``; the input shapes themselves are in
``configs.shapes``.
"""
from __future__ import annotations

import importlib
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.configs.shapes import SHAPES

# arch-id -> module name
_ARCH_MODULES: Dict[str, str] = {
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_a16e",
    "mamba2-780m": "repro_torch.configs.mamba2_780m",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "deepseek-7b": "repro_torch.configs.deepseek_7b",
    "internvl2-76b": "repro_torch.configs.internvl2_76b",
    "deepseek-coder-33b": "repro_torch.configs.deepseek_coder_33b",
    "minitron-4b": "repro_torch.configs.minitron_4b",
    "qwen2-1.5b": "repro_torch.configs.qwen2_1_5b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
}

ARCH_IDS = tuple(_ARCH_MODULES)

# Architectures of the port alone (the reference has no such config);
# ``get_config`` resolves them, ``ARCH_IDS`` stays the reference's.
_PORT_ONLY_MODULES: Dict[str, str] = {
    "granite-4.0-h-small": "repro_torch.configs.granite_4_0_h_small",
    "moonlight-16b-a3b": "repro_torch.configs.moonlight_16b_a3b",
    "kimi-linear-48b-a3b": "repro_torch.configs.kimi_linear_48b_a3b",
}

# Sliding window of the long_500k decode variant of full-attention archs.
LONG_CONTEXT_WINDOW = 4096

# (arch, shape) pairs that are skipped, with the reason.
SKIPS = {
    ("whisper-tiny", "long_500k"): (
        "enc-dec with learned absolute positions and 448-token decoder "
        "context; 500k decode is architecturally unrepresentable"
    ),
}


class TensorSpec(NamedTuple):
    """An input's shape and dtype (no storage)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    mod = importlib.import_module(
        _ARCH_MODULES.get(arch) or _PORT_ONLY_MODULES[arch])
    return mod.reduced() if reduced else mod.CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def config_for_pair(arch: str, shape_name: str,
                    reduced: bool = False) -> Optional[ModelConfig]:
    """Config adjusted for the given input shape; None if the pair is
    skipped.  Full-attention archs (dense, moe, vlm) run long_500k decode
    through the sliding-window ring-buffer variant."""
    if (arch, shape_name) in SKIPS:
        return None
    cfg = get_config(arch, reduced=reduced)
    shape = get_shape(shape_name)
    if shape.name == "long_500k" and cfg.family in ("dense", "moe", "vlm"):
        cfg = cfg.decode_variant(LONG_CONTEXT_WINDOW)
    if shape.seq_len > cfg.max_seq_len:
        cfg = cfg.with_overrides(max_seq_len=shape.seq_len)
    return cfg


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                dtype: torch.dtype = torch.float32) -> Dict[str, TensorSpec]:
    """Every model input of this (arch, shape) as a :class:`TensorSpec`.

    Train: the whole DP-FL round batch, one sequence per client (tokens,
    labels, loss mask).  Prefill: the request batch.  Decode: one new token
    and its position (the cache is model-structured, see ``init_cache``).
    The VLM adds its projected patch embeddings, whisper its frame
    embeddings.
    """
    B, S = shape.global_batch, shape.seq_len
    if shape.mode == "decode":
        return {"tokens": TensorSpec((B, 1), torch.int32),
                "pos": TensorSpec((), torch.int32)}

    def token_batch(n_text: int) -> Dict[str, TensorSpec]:
        d = {"tokens": TensorSpec((B, n_text), torch.int32)}
        if shape.mode == "train":
            d["labels"] = TensorSpec((B, n_text), torch.int32)
            d["loss_mask"] = TensorSpec((B, n_text), dtype)
        return d

    if cfg.family == "vlm":
        n_img = cfg.num_image_tokens
        d = token_batch(S - n_img)
        d["patch_embeds"] = TensorSpec((B, n_img, cfg.d_model), dtype)
        return d
    if cfg.family == "audio":
        d = token_batch(S)
        d["audio_embeds"] = TensorSpec((B, cfg.encoder_seq, cfg.d_model),
                                       dtype)
        return d
    return token_batch(S)
