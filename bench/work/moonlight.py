"""The necessary work of a DP-FL round on Moonlight-16B-A3B (DeepSeek-V3's
latent attention and sigmoid-routed MoE), counted from the configuration
file's sizes (``config.json`` keys; ``n_routed_experts`` experts held of
``router_experts``).

FLOPs are the matrix products' (an FMA two) at what the inputs need: MLA's
projections (queries, the joint latent and rope key, the latent's
up-projection to per-head nope keys and values, the output), causal
attention over the half of each square at or below the diagonal with
queries and keys of ``qk_nope + qk_rope`` and values of ``v_head_dim``,
the dense SwiGLU of layer 0, each MoE layer's router, shared SwiGLU and
the held experts over the (token, slot) pairs routed to them, the head.
A client's local step is three forward passes' products (forward, and
backward's two).  Bytes and Threefry draws are ``counts.round_work``'s.
"""
from __future__ import annotations

from bench.work import counts


def _widths(m: dict) -> dict:
    return {"d": m["hidden_size"], "h": m["num_attention_heads"],
            "r": m["kv_lora_rank"], "dn": m["qk_nope_head_dim"],
            "dr": m["qk_rope_head_dim"], "dv": m["v_head_dim"],
            "f": m["moe_intermediate_size"], "fd": m["intermediate_size"],
            "fs": m["n_shared_experts"] * m["moe_intermediate_size"],
            "E": m["router_experts"], "held": m["n_routed_experts"],
            "dense": m["first_k_dense_replace"]}


def moe_layers(m: dict) -> int:
    return m["num_hidden_layers"] - m["first_k_dense_replace"]


def param_leaves(m: dict) -> tuple:
    """(parameters, leaves) of the configuration as the system lays it
    out: layer 0 apart, the MoE layers stacked, one shared SwiGLU."""
    w = _widths(m)
    d, h = w["d"], w["h"]
    mla = (d * h * (w["dn"] + w["dr"]) + d * (w["r"] + w["dr"]) + w["r"]
           + w["r"] * h * (w["dn"] + w["dv"]) + h * w["dv"] * d)
    dense = mla + 3 * d * w["fd"] + 2 * d
    moe = (mla + d * w["E"] + 3 * d * w["f"] * w["held"] + 3 * d * w["fs"]
           + 2 * d)
    n = 2 * m["vocab_size"] * d + d + w["dense"] * dense \
        + moe_layers(m) * moe
    # embed, unembed, the final norm; a dense layer's 10 leaves; the
    # stacked MoE layers' 14
    return n, 3 + 10 * w["dense"] + 14


def forward_flops(m: dict, seq: int, held_pairs: float) -> float:
    """Matrix-product FLOPs of one sequence's forward pass, with
    ``held_pairs`` (token, slot) pairs on held experts over its layers."""
    w = _widths(m)
    d, h = w["d"], w["h"]
    mla = (2 * d * h * (w["dn"] + w["dr"])          # queries
           + 2 * d * (w["r"] + w["dr"])             # latent, rope key
           + 2 * w["r"] * h * (w["dn"] + w["dv"])   # up-projection
           + 2 * h * w["dv"] * d                    # output
           + 2 * (seq / 2) * h * (w["dn"] + w["dr"])  # causal QK
           + 2 * (seq / 2) * h * w["dv"])           # causal PV
    dense = 3 * 2 * d * w["fd"]
    moe = 2 * d * w["E"] + 3 * 2 * d * w["fs"]      # router, shared
    per_token = (m["num_hidden_layers"] * mla + w["dense"] * dense
                 + moe_layers(m) * moe + 2 * d * m["vocab_size"])
    return float(seq * per_token + held_pairs * 3 * 2 * d * w["f"])


def routed_held_pairs(m: dict, seq: int) -> float:
    """Held pairs of one sequence under uniform routing: ``held / E`` of
    its ``seq * k`` pairs a MoE layer."""
    w = _widths(m)
    return moe_layers(m) * seq * m["num_experts_per_tok"] * w["held"] \
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
