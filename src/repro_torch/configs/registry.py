"""Architecture registry: ``--arch <id>`` resolution (port of
``repro.configs.registry``).

The JAX package's per-shape helpers (``config_for_pair``, ``input_specs``)
serve its XLA lowering harness and have no counterpart here yet; the input
shapes themselves are in ``configs.shapes``.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

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

# Sliding window of the long_500k decode variant of full-attention archs.
LONG_CONTEXT_WINDOW = 4096


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    mod = importlib.import_module(_ARCH_MODULES[arch])
    return mod.reduced() if reduced else mod.CONFIG
