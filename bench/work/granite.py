"""The necessary work of a DP-FL round on Granite-4.0-H, counted from the
configuration file's sizes (``config.json`` keys, ``num_hidden_layers``
layers of ``layer_types``, ``num_local_experts`` experts held of
``router_experts``).

FLOPs are the matrix products' (an FMA two) at what the inputs need:
causal attention and the SSD's intra-chunk products over the half of each
square at or below the diagonal, the held experts over the (token, slot)
pairs routed to them.  A client's local step is three forward passes'
products (forward, and backward's two).  Bytes and Threefry draws are
``counts.round_work``'s: the deltas written and read, the int32 sums, the
parameters read and written; a JAX uniform per client element and a
normal per element of the TEE noise.
"""
from __future__ import annotations

from bench.work import counts


def _widths(m: dict) -> dict:
    d = m["hidden_size"]
    di = m["mamba_expand"] * d
    n, nh = m["mamba_d_state"], m["mamba_n_heads"]
    return {"d": d, "di": di, "n": n, "nh": nh, "hd": m["mamba_d_head"],
            "conv": di + 2 * m["mamba_n_groups"] * n,
            "h": m["num_attention_heads"], "kv": m["num_key_value_heads"],
            "ahd": d // m["num_attention_heads"],
            "f": m["intermediate_size"], "fs": m["shared_intermediate_size"],
            "E": m["router_experts"], "held": m["num_local_experts"]}


def layer_types(m: dict) -> list:
    return m["layer_types"][:m["num_hidden_layers"]]


def param_leaves(m: dict) -> tuple:
    """(parameters, leaves) of the configuration as the system lays it
    out."""
    w = _widths(m)
    d = w["d"]
    mamba = (d * (2 * w["di"] + 2 * w["n"] + w["nh"])      # in_proj
             + m["mamba_d_conv"] * w["conv"] + w["conv"]    # conv w, b
             + 3 * w["nh"] + w["di"]                        # dt_bias, A, D, norm
             + w["di"] * d)                                 # out_proj
    attn = 2 * d * w["h"] * w["ahd"] + 2 * d * w["kv"] * w["ahd"]
    moe = (d * w["E"] + 3 * d * w["f"] * w["held"]
           + 3 * d * w["fs"] + 2 * d)                       # + both norms
    n, leaves = m["vocab_size"] * d + d, 2
    for t in layer_types(m):
        n += moe + (mamba if t == "mamba" else attn)
        leaves += 9 + (8 if t == "mamba" else 4)
    return n, leaves


def forward_flops(m: dict, seq: int, held_pairs: float) -> float:
    """Matrix-product FLOPs of one sequence's forward pass, with
    ``held_pairs`` (token, slot) pairs on held experts over its layers."""
    w = _widths(m)
    d, Q = w["d"], min(m["mamba_chunk_size"], seq)
    mamba = (2 * d * (2 * w["di"] + 2 * w["n"] + w["nh"])  # in_proj
             + 2 * m["mamba_d_conv"] * w["conv"]           # conv
             + 2 * (Q / 2) * w["n"]                        # C.B in-chunk
             + 2 * (Q / 2) * w["nh"] * w["hd"]             # (L o CB) x
             + 2 * 2 * w["nh"] * w["hd"] * w["n"]          # states, y_off
             + 2 * w["di"] * d)                            # out_proj
    attn = (2 * d * (2 * w["h"] + 2 * w["kv"]) * w["ahd"]  # q, k, v, o
            + 2 * 2 * (seq / 2) * w["h"] * w["ahd"])       # causal QK, PV
    moe = 2 * d * w["E"] + 3 * 2 * d * w["fs"]             # router, shared
    per_token = sum(moe + (mamba if t == "mamba" else attn)
                    for t in layer_types(m)) + 2 * d * m["vocab_size"]
    return float(seq * per_token + held_pairs * 3 * 2 * d * w["f"])


def routed_held_pairs(m: dict, seq: int) -> float:
    """Held pairs of one sequence under uniform routing: ``held / E`` of
    its ``seq * k`` pairs a layer."""
    w = _widths(m)
    return (len(layer_types(m)) * seq * m["num_experts_per_tok"]
            * w["held"] / w["E"])


def round_work(m: dict, n: int, cohort: int, seq: int, tee_noise: bool,
               held_pairs: float) -> dict:
    """One round of ``cohort`` clients, one local step each on one
    ``seq``-token sequence; ``held_pairs`` a client as routed."""
    flops = 3.0 * cohort * forward_flops(m, seq, held_pairs)
    draws = cohort * n + (n if tee_noise else 0)
    return {"flops": flops,
            "bytes": 8.0 * n * cohort + 8.0 * n + 8.0 * n,
            "int_ops": counts.threefry_ops(draws, counts.JAX_ROUNDS)}
