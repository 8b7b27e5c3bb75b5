"""The necessary work of each cell, counted from the configuration's sizes.

The counts are the work the algorithm needs, whatever implements it: each
byte of a delta, a buffer row and the parameters read once and written once;
the Threefry evaluations that the protocol's streams define; the model's
matrix products.  ``least_time`` turns a count into the least time at the
H100's published peaks (``peaks.json``), the numerator of every ``*_mfu``
and ``*_roofline`` share.
"""
from __future__ import annotations

import json
from pathlib import Path

PEAKS = {k: v["value"] for k, v in json.loads(
    (Path(__file__).with_name("peaks.json")).read_text()).items()
    if isinstance(v, dict)}

# rounds of the two Threefry-2x32 variants the system's streams use: the
# protocol's counter streams (masks, stochastic-rounding uniforms, recovery)
# and JAX's threefry_2x32 behind jax.random (round uniforms, TEE noise)
STREAM_ROUNDS = 13
JAX_ROUNDS = 20


def threefry_ops(evaluations: float, rounds: int) -> float:
    """32-bit integer operations of ``evaluations`` Threefry-2x32 calls."""
    return evaluations * rounds * PEAKS["threefry_ops_per_round"]


def least_time(work: dict) -> float:
    """Seconds the work needs at the published peaks: the largest of its
    bytes, float operations and integer operations over their rates."""
    return max(work.get("bytes", 0.0) / PEAKS["hbm_bytes_per_s"],
               work.get("flops", 0.0) / PEAKS["f32_flops_per_s"],
               work.get("int_ops", 0.0) / PEAKS["int32_ops_per_s"])


def add(*works: dict) -> dict:
    out: dict = {}
    for w in works:
        for k, v in w.items():
            out[k] = out.get(k, 0.0) + v
    return out


def scale(work: dict, n: float) -> dict:
    return {k: v * n for k, v in work.items()}


# ---------------------------------------------------------------------------
# Parameter counts
# ---------------------------------------------------------------------------
def _ln(m: dict, d: int) -> int:
    return 2 * d if m["norm"] == "layernorm" else d


def _attn(m: dict) -> int:
    d, h, kv, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], \
        m["head_dim"]
    return d * h * hd + 2 * d * kv * hd + h * hd * d


def _mlp(m: dict) -> int:
    mult = 3 if m["mlp_act"] == "swiglu" else 2
    return mult * m["d_model"] * m["d_ff"]


def param_leaves(m: dict) -> tuple:
    """(parameters, leaves) of a model configuration file's sizes."""
    d, v = m["d_model"], m["vocab_size"]
    if m["family"] == "ssm":
        di = m["ssm_expand"] * d
        g, ds = m["ssm_num_groups"], m["ssm_state_dim"]
        nh = di // m["ssm_head_dim"]
        conv_dim = di + 2 * g * ds
        layer = (d * (2 * di + 2 * g * ds + nh)          # in_proj
                 + m["ssm_conv_width"] * conv_dim + conv_dim  # conv w, b
                 + di * d                                 # out_proj
                 + 2 * nh + di                            # A_log, D, norm
                 + nh                                     # dt_bias
                 + d)                                     # norm1
        n = v * d * (1 if m["tie_embeddings"] else 2) + d
        return n + m["num_layers"] * layer, 11
    if m["family"] == "audio":
        ln = _ln(m, d)
        enc = _attn(m) + _mlp(m) + 2 * ln
        dec = 2 * _attn(m) + _mlp(m) + 3 * ln
        n = v * d + m["max_seq_len"] * d \
            + m["num_encoder_layers"] * enc + ln \
            + m["num_layers"] * dec + ln
        norm_leaves = 2 if m["norm"] == "layernorm" else 1
        leaves = (2 + m["num_encoder_layers"] * (6 + 2 * norm_leaves)
                  + norm_leaves
                  + m["num_layers"] * (10 + 3 * norm_leaves) + norm_leaves)
        return n, leaves
    raise ValueError(f"no parameter count for family {m['family']!r}")


# ---------------------------------------------------------------------------
# Aggregation (AsyncServer in a masked streaming mode)
# ---------------------------------------------------------------------------
def push_work(n: int, slots: int) -> dict:
    """One masked streamed push of an ``n``-element delta into a session of
    ``slots`` (complete mask graph): the delta read, its norm and weighted
    encode, the int32 row written; one stochastic-rounding word and
    ``slots - 1`` pairwise mask words per element, two words an
    evaluation."""
    words = n * slots
    return {"bytes": 8.0 * n, "flops": 5.0 * n,
            "int_ops": threefry_ops(words / 2, STREAM_ROUNDS)}


def k1_work(n: int, slots: int) -> dict:
    """K1 (``quantize_mask_prf``) alone for one push: the weighted f32 row
    read, the int32 row written, the same words as :func:`push_work`."""
    return {"bytes": 8.0 * n, "flops": 2.0 * n,
            "int_ops": threefry_ops(n * slots / 2, STREAM_ROUNDS)}


def flush_work(n: int, slots: int, present: int) -> dict:
    """One flush: ``present`` rows read, the parameters read and written,
    the decode and server step; each absent slot's edges to the present
    ones regenerated once (the recovery sweep)."""
    absent = slots - present
    edges = absent * present
    return {"bytes": 4.0 * n * present + 8.0 * n,
            "flops": 3.0 * n,
            "int_ops": threefry_ops(n * edges / 2, STREAM_ROUNDS)}


def version_work(n: int, slots: int, present: int) -> dict:
    """Everything one published version needs: its pushes and its flush."""
    return add(scale(push_work(n, slots), present),
               flush_work(n, slots, present))


# ---------------------------------------------------------------------------
# Synchronous DP-FL round (build_round_step) on an encoder-decoder
# ---------------------------------------------------------------------------
def encdec_forward_flops(m: dict, enc_seq: int, dec_seq: int) -> float:
    """Matrix-product FLOPs (an FMA two) of one sample's forward pass."""
    d, hhd, f, v = m["d_model"], m["num_heads"] * m["head_dim"], m["d_ff"], \
        m["vocab_size"]
    proj = 2 * d * (2 * hhd + 2 * m["num_kv_heads"] * m["head_dim"])
    enc = m["num_encoder_layers"] * enc_seq * (
        proj + 4 * enc_seq * hhd + 4 * d * f)
    dec_self = dec_seq * (proj + 4 * dec_seq * hhd)
    dec_cross = (dec_seq * 4 * d * hhd                 # q, o
                 + enc_seq * 4 * d * m["num_kv_heads"] * m["head_dim"]
                 + dec_seq * 4 * enc_seq * hhd)
    dec = m["num_layers"] * (dec_self + dec_cross + dec_seq * 4 * d * f)
    return float(enc + dec + 2 * dec_seq * d * v)


def round_work(m: dict, n: int, cohort: int, enc_seq: int, dec_seq: int,
               local_steps: int, tee_noise: bool) -> dict:
    """One round: each client's local steps (forward and backward, three
    forward passes' products), the deltas written and read, the int32 sums,
    the parameters read and written; one JAX-uniform (Threefry-20) per
    client element for the stochastic rounding and one per element for the
    TEE noise."""
    flops = 3.0 * cohort * local_steps * encdec_forward_flops(
        m, enc_seq, dec_seq)
    draws = cohort * n + (n if tee_noise else 0)
    return {"flops": flops,
            "bytes": 8.0 * n * cohort + 8.0 * n + 8.0 * n,
            "int_ops": threefry_ops(draws, JAX_ROUNDS)}
