"""The necessary work of a DP-FL round on the Mamba-2 language model,
counted from the configuration file's sizes (``num_layers``, ``d_model``,
``ssm_*``, ``vocab_size``; the head tied).

FLOPs are the matrix products' (an FMA two): in_proj, the depthwise conv,
the SSD's intra-chunk products over the half of each chunk's square at or
below the diagonal, its chunk states and their contribution, out_proj, and
the head.  A client's local step is three forward passes' products.
Bytes and Threefry draws are ``counts.round_work``'s.
"""
from __future__ import annotations

from bench.work import counts


def param_leaves(m: dict) -> tuple:
    return counts.param_leaves(m)


def forward_flops(m: dict, seq: int) -> float:
    """Matrix-product FLOPs of one sequence's forward pass."""
    d, n, hd = m["d_model"], m["ssm_state_dim"], m["ssm_head_dim"]
    di = m["ssm_expand"] * d
    nh = di // hd
    conv = di + 2 * m["ssm_num_groups"] * n
    Q = min(m["ssm_chunk"], seq)
    layer = (2 * d * (2 * di + 2 * n + nh)       # in_proj
             + 2 * m["ssm_conv_width"] * conv    # conv
             + 2 * (Q / 2) * n                   # C.B in-chunk
             + 2 * (Q / 2) * nh * hd             # (L o CB) x
             + 2 * 2 * nh * hd * n               # states, y_off
             + 2 * di * d)                       # out_proj
    return float(seq * (m["num_layers"] * layer + 2 * d * m["vocab_size"]))


def routed_held_pairs(m: dict, seq: int) -> float:
    return 0.0


def round_work(m: dict, n: int, cohort: int, seq: int, tee_noise: bool,
               held_pairs: float = 0.0) -> dict:
    """One round of ``cohort`` clients, one local step each on one
    ``seq``-token sequence (``held_pairs`` unused: no experts)."""
    flops = 3.0 * cohort * forward_flops(m, seq)
    draws = cohort * n + (n if tee_noise else 0)
    return {"flops": flops,
            "bytes": 8.0 * n * cohort + 8.0 * n + 8.0 * n,
            "int_ops": counts.threefry_ops(draws, counts.JAX_ROUNDS)}
