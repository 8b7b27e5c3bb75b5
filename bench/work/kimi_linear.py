"""The necessary work of a DP-FL round on Kimi-Linear-48B-A3B (Kimi Delta
Attention beside NoPE latent attention, a sigmoid-routed MoE), counted
from the configuration file's sizes (``config.json`` keys;
``num_experts`` experts held of ``router_experts``).

FLOPs are the matrix products' (an FMA two) at what the inputs need: each
KDA layer's projections (queries, keys and values, the output, the
decay's and the output gate's two low-rank products of ``head_dim``, the
``beta`` head) and its core, counted by the recurrence whatever form
computes it: 7 FLOPs a (key, value) pair of a head a token (the decay's
multiply, then ``k^T S``, the rank-1 update and ``S^T q`` at an FMA each);
each MLA layer's projections and causal attention over the half of each
square at or below the diagonal (queries and keys of ``qk_nope +
qk_rope``, values of ``v_head_dim``); the dense SwiGLU of layer 0; each
MoE layer's router, shared SwiGLU and the held experts over the (token,
slot) pairs routed to them; the head.  Convolutions, norms and gates
(elementwise) are not counted.  A client's local step is three forward
passes' products (forward, and backward's two).  Bytes and Threefry draws
as ``work/moonlight.py`` counts them.
"""
from __future__ import annotations

from bench.work import counts

# FLOPs of KDA's recurrence a (key, value) pair of a head and token
KDA_CORE = 7


def _widths(m: dict) -> dict:
    la = m["linear_attn_config"]
    return {"d": m["hidden_size"], "h": m["num_attention_heads"],
            "r": m["kv_lora_rank"], "dn": m["qk_nope_head_dim"],
            "dr": m["qk_rope_head_dim"], "dv": m["v_head_dim"],
            "kh": la["num_heads"], "dk": la["head_dim"],
            "conv": la["short_conv_kernel_size"],
            "n_kda": len(la["kda_layers"]),
            "n_mla": len(la["full_attn_layers"]),
            "f": m["moe_intermediate_size"], "fd": m["intermediate_size"],
            "fs": m["num_shared_experts"] * m["moe_intermediate_size"],
            "E": m["router_experts"], "held": m["num_experts"],
            "dense": m["first_k_dense_replace"]}


def moe_layers(m: dict) -> int:
    return m["num_hidden_layers"] - m["first_k_dense_replace"]


def param_leaves(m: dict) -> tuple:
    """(parameters, leaves) of the configuration as the system lays it
    out: every layer apart (``stack.layer_{i}``), one shared SwiGLU."""
    w = _widths(m)
    d, h, dk, hk = w["d"], w["h"], w["dk"], w["kh"] * w["dk"]
    kda = (4 * d * hk + 3 * w["conv"] * hk + 2 * (d * dk + dk * hk) + hk
           + d * w["kh"] + w["kh"] + hk + dk)
    mla = (d * h * (w["dn"] + w["dr"]) + d * (w["r"] + w["dr"]) + w["r"]
           + w["r"] * h * (w["dn"] + w["dv"]) + h * w["dv"] * d)
    moe = d * w["E"] + 3 * d * w["f"] * w["held"] + 3 * d * w["fs"]
    n = (2 * m["vocab_size"] * d + d + w["n_kda"] * kda + w["n_mla"] * mla
         + w["dense"] * 3 * d * w["fd"] + moe_layers(m) * moe
         + m["num_hidden_layers"] * 2 * d)
    # embed, unembed, the final norm; two norms a layer; KDA's 16 leaves,
    # MLA's 5; the dense SwiGLU's 3, the MoE's 7
    leaves = (3 + 2 * m["num_hidden_layers"] + 16 * w["n_kda"]
              + 5 * w["n_mla"] + 3 * w["dense"] + 7 * moe_layers(m))
    return n, leaves


def forward_flops(m: dict, seq: int, held_pairs: float) -> float:
    """Matrix-product FLOPs of one sequence's forward pass, with
    ``held_pairs`` (token, slot) pairs on held experts over its layers."""
    w = _widths(m)
    d, h, dk, kh = w["d"], w["h"], w["dk"], w["kh"]
    hk = kh * dk
    kda = (2 * d * 3 * hk                       # queries, keys, values
           + 2 * hk * d                         # output
           + 2 * 2 * (d * dk + dk * hk)         # decay and gate, low rank
           + 2 * d * kh                         # beta
           + KDA_CORE * kh * dk * dk)           # the recurrence
    mla = (2 * d * h * (w["dn"] + w["dr"])          # queries
           + 2 * d * (w["r"] + w["dr"])             # latent, shared key
           + 2 * w["r"] * h * (w["dn"] + w["dv"])   # up-projection
           + 2 * h * w["dv"] * d                    # output
           + 2 * (seq / 2) * h * (w["dn"] + w["dr"])  # causal QK
           + 2 * (seq / 2) * h * w["dv"])           # causal PV
    dense = 3 * 2 * d * w["fd"]
    moe = 2 * d * w["E"] + 3 * 2 * d * w["fs"]      # router, shared
    per_token = (w["n_kda"] * kda + w["n_mla"] * mla + w["dense"] * dense
                 + moe_layers(m) * moe + 2 * d * m["vocab_size"])
    return float(seq * per_token + held_pairs * 3 * 2 * d * w["f"])


def routed_held_pairs(m: dict, seq: int) -> float:
    """Held pairs of one sequence under uniform routing: ``held / E`` of
    its ``seq * k`` pairs a MoE layer."""
    w = _widths(m)
    return moe_layers(m) * seq * m["num_experts_per_token"] * w["held"] \
        / w["E"]


def round_work(m: dict, n: int, cohort: int, seq: int, tee_noise: bool,
               held_pairs: float) -> dict:
    """One round of ``cohort`` clients, one local step each on one
    ``seq``-token sequence; ``held_pairs`` a client as routed."""
    flops = 3.0 * cohort * forward_flops(m, seq, held_pairs)
    draws = cohort * n + (n if tee_noise else 0)
    return {"flops": flops,
            "bytes": 8.0 * n * cohort + 8.0 * n + 8.0 * n,
            "int_ops": counts.threefry_ops(draws, counts.JAX_ROUNDS)}
