"""Kimi-Linear-48B-A3B (Moonshot AI; ``model_type`` kimi_linear): Kimi Delta
Attention (KDA, a chunked gated delta rule) in three of every four layers,
NoPE latent attention (MLA) in the fourth, and a sigmoid-routed MoE of 256
experts, at 48B parameters, 3B active.

[moonshotai/Kimi-Linear-48B-A3B-Instruct, config.json] 27 layers, hidden
size 2304; ``linear_attn_config``: KDA in layers 1-3, 5-7, ..., 25, 26
(1-based ``kda_layers``, 20 layers) with 32 heads of 128 and short
convolutions of width 4, MLA in ``full_attn_layers`` [4, 8, ..., 24, 27]
(7 layers) with 32 heads, ``q_lora_rank`` null, ``kv_lora_rank`` 512,
``qk_nope_head_dim`` 128, ``qk_rope_head_dim`` 64, ``v_head_dim`` 128 and
``mla_use_nope`` true; layer 0 a dense SwiGLU of 9216
(``first_k_dense_replace`` 1), layers 1-26 an MoE of 256 SwiGLU experts of
1024, top-8 of sigmoid scores (``moe_router_activation_func``, grouped
top-k with one group), ``moe_renormalize``, ``routed_scaling_factor``
2.446, one shared expert of 1024; an untied vocabulary of 163,840; RMSNorm
eps 1e-5.  The top-level ``head_dim`` 72 (2304 / 32) shapes neither mixer.

KDA (the Kimi Linear report, arXiv:2510.26692; ``models/kda.py``): per
channel decay from a low-rank projection (rank 128, the head size, as
FLA's ``KimiDeltaAttention`` builds it), a delta-rule state a head, and
an output gate of the same low rank with a bias; computed in chunks of
64.  The router is
Moonlight's (DeepSeek-V3's): sigmoid scores, top-8 of ``s + b`` with a
per-expert selection bias ``b``, gates ``2.446 s_i / sum_j s_j`` over the
chosen, and the sequence-wise balance loss at alpha 1e-4 (``config.json``
gives none).
"""
from repro_torch.configs.base import KimiLinearConfig

FULL_ATTN_LAYERS = (4, 8, 12, 16, 20, 24, 27)
KDA_LAYERS = tuple(i for i in range(1, 28) if i not in FULL_ATTN_LAYERS)

CONFIG = KimiLinearConfig(
    name="kimi-linear-48b-a3b",
    family="moe",
    num_layers=27,
    d_model=2304,
    num_heads=32,
    num_kv_heads=32,
    d_ff=9216,
    vocab_size=163_840,
    tie_embeddings=False,
    num_experts=256,
    num_shared_experts=1,
    experts_per_token=8,
    moe_d_ff=1024,
    shared_d_ff=1024,
    first_k_dense=1,
    moe_dispatch="ragged",
    router_aux_weight=1e-4,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    router_score="sigmoid",
    routed_scaling=2.446,
    norm_eps=1e-5,
    max_seq_len=8192,
    kda_layers=KDA_LAYERS,
    full_attn_layers=FULL_ATTN_LAYERS,
    kda_num_heads=32,
    kda_head_dim=128,
    kda_conv_width=4,
    kda_chunk=64,
    mla_use_nope=True,
    citation="https://huggingface.co/moonshotai/Kimi-Linear-48B-A3B-Instruct",
)


def reduced() -> KimiLinearConfig:
    """Every mechanism at a CPU test's size: 6 layers (KDA with the dense
    FFN, two KDA with MoE, MLA: a whole 3:1 period; then KDA and a second
    MLA), d 64, 4 MLA heads (latent 32, nope 16, rope 8, v 16),
    4 KDA heads of 16 in chunks of 32, 8 experts of
    which a layer holds all, top-3."""
    return KimiLinearConfig(
        name="kimi-linear-reduced",
        family="moe",
        num_layers=6,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=96,
        vocab_size=256,
        tie_embeddings=False,
        num_experts=8,
        num_shared_experts=1,
        experts_per_token=3,
        moe_d_ff=32,
        shared_d_ff=32,
        first_k_dense=1,
        moe_dispatch="ragged",
        router_aux_weight=1e-4,
        kv_lora_rank=32,
        qk_nope_head_dim=16,
        qk_rope_head_dim=8,
        v_head_dim=16,
        router_score="sigmoid",
        routed_scaling=2.446,
        norm_eps=1e-5,
        max_seq_len=128,
        kda_layers=(1, 2, 3, 5),
        full_attn_layers=(4, 6),
        kda_num_heads=4,
        kda_head_dim=16,
        kda_conv_width=4,
        kda_chunk=32,
        mla_use_nope=True,
        citation=CONFIG.citation,
    )
