"""Granite-4.0-H-Small (32B, 9B active) — a hybrid of Mamba-2 and GQA
attention, every layer followed by an MoE FFN.

[ibm-granite/granite-4.0-h-small, config.json] 40 layers by
``layer_types`` (36 Mamba-2, attention at 5, 15, 25 and 35), d_model 4096;
Mamba-2 with 128 heads x 64, state 128, one group, conv 4, chunk 256,
expand 2; attention with 32 query and 8 KV heads of 128, no position
encoding (NoPE); 72 SwiGLU experts of width 768, top-10, and one shared
SwiGLU expert of width 1536; µP multipliers (embedding x12, residual
x0.22, softmax scale 0.0078125, logits / 16); a tied vocabulary of
100,352; RMSNorm eps 1e-5.
"""
from repro_torch.configs.base import GraniteHybridConfig

LAYER_TYPES = tuple("attention" if i % 10 == 5 else "mamba"
                    for i in range(40))


def block_pattern(layer_types) -> tuple:
    """The port's block kinds of ``layer_types``: a Mamba-2 layer is
    ``ssm_moe``, an attention layer ``moe`` (each with its MoE FFN)."""
    return tuple({"mamba": "ssm_moe", "attention": "moe"}[t]
                 for t in layer_types)


CONFIG = GraniteHybridConfig(
    name="granite-4.0-h-small",
    family="moe",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=0,
    vocab_size=100_352,
    pos_emb="none",
    tie_embeddings=True,
    block_pattern=block_pattern(LAYER_TYPES),
    num_experts=72,
    num_shared_experts=1,
    experts_per_token=10,
    moe_d_ff=768,
    shared_d_ff=1536,
    moe_dispatch="ragged",
    ssm_state_dim=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv_width=4,
    ssm_chunk=256,
    ssm_num_groups=1,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    attention_multiplier=0.0078125,
    logits_scaling=16.0,
    norm_eps=1e-5,
    max_seq_len=131_072,
    citation="https://huggingface.co/ibm-granite/granite-4.0-h-small",
)


def reduced() -> GraniteHybridConfig:
    """Every mechanism at a CPU test's size: one period of five layers
    (attention at index 2), 9 experts of which a layer holds all, top-3."""
    return GraniteHybridConfig(
        name="granite-4.0-h-reduced",
        family="moe",
        num_layers=5,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=0,
        vocab_size=256,
        pos_emb="none",
        tie_embeddings=True,
        block_pattern=block_pattern(("mamba", "mamba", "attention", "mamba",
                                     "mamba")),
        num_experts=9,
        num_shared_experts=1,
        experts_per_token=3,
        moe_d_ff=32,
        shared_d_ff=48,
        moe_dispatch="ragged",
        ssm_state_dim=16,
        ssm_expand=2,
        ssm_head_dim=16,
        ssm_conv_width=4,
        ssm_chunk=8,
        ssm_num_groups=1,
        embedding_multiplier=12.0,
        residual_multiplier=0.22,
        attention_multiplier=0.0625,
        logits_scaling=16.0,
        norm_eps=1e-5,
        max_seq_len=64,
        citation=CONFIG.citation,
    )
