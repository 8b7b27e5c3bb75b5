"""Cells at a size the CPU runs in seconds: every width cut, the traffic's
shape kept (the session, the dropout, the cohort's chunking)."""
from __future__ import annotations

import copy

from bench import harness as H

SMALL_MODELS = {
    "mamba2-780m": {"num_layers": 2, "d_model": 64, "vocab_size": 256,
                    "ssm_state_dim": 16, "ssm_head_dim": 16, "ssm_chunk": 16},
    "whisper-tiny": {"num_layers": 1, "num_encoder_layers": 1, "d_model": 64,
                     "num_heads": 2, "num_kv_heads": 2, "head_dim": 32,
                     "d_ff": 128, "vocab_size": 256, "encoder_seq": 16,
                     "max_seq_len": 8},
}
SMALL_TRAFFIC = {"agg": {"chunk_elems": 4096},
                 "train": {"cohort": 4, "seq_len": 8, "encoder_frames": 16,
                           "batches": 4}}


def small_spec(name: str) -> dict:
    spec = copy.deepcopy(H.cell_spec(name))
    m = spec["model"]
    cut = SMALL_MODELS[m["name"]]
    m.update(cut)
    m["overrides"] = dict(m["overrides"], **cut)
    spec["traffic"].update(SMALL_TRAFFIC[spec["traffic"]["entry"]])
    if "pool" in spec["cell"]:
        spec["cell"]["pool"] = 4
    return spec
