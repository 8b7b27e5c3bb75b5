"""Moonlight-16B-A3B (Moonshot AI; ``model_type`` deepseek_v3): DeepSeek-V3's
stack of latent attention (MLA) and sigmoid-routed MoE at 16B parameters,
3B active.

[moonshotai/Moonlight-16B-A3B, config.json] 27 layers, hidden size 2048;
layer 0 a dense SwiGLU of width 11264 (``first_k_dense_replace`` 1), layers
1-26 MoE with 64 routed SwiGLU experts of width 1408, top-6, and 2 shared
experts (one SwiGLU of width 2 x 1408, as ``modeling_deepseek_v3`` builds
them); MLA with 16 heads, ``q_lora_rank`` null, ``kv_lora_rank`` 512,
``qk_nope_head_dim`` 128, ``qk_rope_head_dim`` 64, ``v_head_dim`` 128;
``rope_theta`` 50000, no ``rope_scaling``; RMSNorm eps 1e-5; an untied
vocabulary of 163,840; 8192 positions.

The router is DeepSeek-V3's (arXiv:2412.19437 §2.1.2 and §2.1.3;
``scoring_func`` sigmoid, ``topk_method`` noaux_tc with ``n_group`` 1 and
``topk_group`` 1, ``norm_topk_prob``, ``routed_scaling_factor`` 2.446):
``s = sigmoid(u W_r)``, the experts of ``topk(s + b, 6)`` with ``b`` the
per-expert ``e_score_correction_bias``, gates ``g_i = 2.446 s_i / sum_j
s_j`` over the chosen experts' unbiased scores.  Its loss is the report's
sequence-wise balance loss ``alpha sum_i f_i P_i`` per sequence (``seq_aux``
true), ``f_i = N_r / (K_r T)`` times the tokens whose top-6 of ``s`` holds
expert ``i``, ``P_i = mean_t s_i,t / sum_j s_j,t``, with alpha 1e-4 (the
report's; ``config.json`` gives none).  MLA is ``modeling_deepseek_v3``'s
``DeepseekV3Attention``: RoPE on the 64 rope dims only, which the modeling
de-interleaves (pairs ``(2i, 2i + 1)`` to ``(i, i + 32)``) before its half
rotation (``models/mla.py`` ``rope_pairs``), softmax scale ``192 ** -0.5``.
"""
from repro_torch.configs.base import LatentMoEConfig

CONFIG = LatentMoEConfig(
    name="moonlight-16b-a3b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=11_264,
    vocab_size=163_840,
    rope_theta=50_000.0,
    tie_embeddings=False,
    num_experts=64,
    num_shared_experts=1,
    experts_per_token=6,
    moe_d_ff=1408,
    shared_d_ff=2 * 1408,
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
    citation="https://huggingface.co/moonshotai/Moonlight-16B-A3B",
)


def reduced() -> LatentMoEConfig:
    """Every mechanism at a CPU test's size: 3 layers (one dense), d 64, 4
    heads, latent 32, nope 16, rope 8, v 16, 8 experts of which a layer
    holds all, top-3."""
    return LatentMoEConfig(
        name="moonlight-reduced",
        family="moe",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=96,
        vocab_size=256,
        rope_theta=50_000.0,
        tie_embeddings=False,
        num_experts=8,
        num_shared_experts=1,
        experts_per_token=3,
        moe_d_ff=32,
        shared_d_ff=64,
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
        max_seq_len=64,
        citation=CONFIG.citation,
    )
