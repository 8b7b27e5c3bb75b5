#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # one CUDA GPU; builds the kernels

Phases (each prints its seconds):

  1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
     ``nvcc`` per source, all at once) and hold each against its plain
     PyTorch version on the card (bit-equal ints): ragged widths, complete /
     circulant / table mask graphs, ``slot_offset`` shards, rows beyond the
     session, nonzero uniform offsets, several fixed-point scales, every
     packed width 1..32 in both directions, and the main path's own shapes;
     K1, K2's PRF lane and K4, which walk element pairs (one Threefry per
     counter, both words used), at odd and even n (1, 2, 3, ...), odd and
     even uniform offsets (up to stream positions past 2^32), unaligned x,
     complete graphs of 3, 8, 10 and 4000 slots, rings up to 4000
     neighbours and a table, and K2 shards whose rows cross num_slots; and
     the rebuilt ``jax.random`` draws and ``prf.sqrt_f32`` on the card
     bit-equal to the CPU's (``normal`` and ``sqrt_f32`` on 2^24 values,
     ``randint``, the dense init);
  2. the main path: the buffered-async aggregation server (``AsyncServer``)
     on qwen2-1.5b's published widths, depth cut from 28 to 2 layers
     (326,970,880 parameters, 1.31 GB f32 per delta), ``buffer_size=8``,
     ``param_chunk_elems=2**25`` (5 chunks; the 233M-element embedding alone),
     at ``secure_agg_bits`` 32 and 16 (the packed 19-bit wire).  Each masked
     mode runs a full session and a 6-of-8 session whose flush recovers the
     two dropped slots, and must decode to parameters bit-equal to its
     unmasked counterpart on the same deltas and keys: ``client``
     (encode_push/push_encoded) and ``tee_stream`` against the streamed
     ``off`` engine, batched ``tee`` against ``stream_encode=False`` ``off``;
  2b. the compressed path on the same model: ``compress_mode="sketch"`` at
     ``compress_rate=0.2`` (m = 46,674,740 wire coordinates at the embedding
     chunk), ``client`` and ``tee_stream`` bit-equal to compressed streamed
     ``off`` at bits 32 and 16 through a full and a 6-of-8 session; one
     ``subsample`` run (``client``, bits 16, against its ``off`` twin); one
     ``tee_stream`` run with ``enclave_wire_bits=8`` (finite, moved, enclave
     bytes < 0.3 of the raw wire); wire bytes per contribution of each;
  2c. the serving path: ``python -m repro_torch.launch.serve``'s ``main``
     at qwen2-1.5b's published width AND depth (28 layers, 1,543,714,304
     parameters, f32, TF32 off), batch 8, prompt 2048, 32 greedy decode
     steps (KV cache W = 2080): once plain, once ``--int8``, once
     ``--window 1024`` (the ring-buffer cache); every step's logits held
     against a teacher-forced ``apply`` over prompt + generated tokens;
     prefill and decode ms and tok/s; a ``torch.profiler`` breakdown of 4
     decode steps of the plain run (device-busy ms, idle share, kernels);
     the init's time (the reference's key tree and normal draws), a second
     init held bit-equal to the served weights;
  2g. the other families: ``serve.main`` at each one's published width,
     batch 8, 32 greedy steps, f32: deepseek-moe-16b cut to 4 of 28
     layers (the dense ``layer_0`` + 3 scanned MoE layers; 2,267,039,744
     parameters) at its published capacity 1.25 and again (``generate`` on
     the same weights and prompt) at ``capacity_factor = 64``, drop-free;
     mamba2-780m at its full 48 layers (no attention, no K10);
     recurrentgemma-2b at its full 26 layers (8 local-attention layers,
     MQA over a 2048-slot ring that the 2080-long decode wraps);
     internvl2-76b cut to 2 of 80 layers behind 1024 stub image tokens;
     whisper-tiny's 4 + 4 layers over 1500 stub encoder frames (prompt
     32).  Every step's logits against a teacher-forced ``apply`` over
     prompt + generated tokens, but at the published MoE capacity (a
     single-token step drops pairs that the batch does not), where the
     prefill's logits are held against ``apply`` on the prompt and the
     steps must be finite; a ``torch.profiler`` breakdown of 4 decode
     steps each (device-busy ms, idle share) and each run's peak memory;
  2d. training: ``python -m repro_torch.launch.train``'s ``main`` at
     qwen2-1.5b's published width AND depth (28 layers, cohort 4, sequence
     64, 2 rounds, secure-agg bits 32, TEE noise 0.3; every printed loss,
     clip fraction and update norm finite), with the round's time split
     into local SGD / privatize / encode (torch uniforms apart) / sum /
     decode + server optimizer and the peak device memory; two rounds
     through ``build_round_step`` at full width with noise 0 on the same
     params, batch and key, one at bits 32 (K3, K6, K7) and one at bits 0
     (K3, K8), whose new params agree within the fixed-point resolution;
     a ``secure_agg_masked`` round and an unmasked one at 2 layers (depth
     cut for time), bit-equal; ``--classifier`` for 20 rounds, whose loss
     falls;
  2e. federated analytics and the control plane: the FA example's twin
     (``repro_torch.examples.federated_analytics``) at its own size (50,000
     devices x 4 features, 256 thresholds, flip 0.1; estimates against the
     true statistics); ``tests/test_system.py``'s pipeline at its own size
     (``repro_torch.examples.paper_pipeline``: a 20,000 x 32 FA sample,
     minmax over 128 thresholds, the label ratio at flip 0.1,
     ``DevicePopulation(512)``, 40 DP-FL rounds at cohort 64, DP metrics;
     test_system's four gates); a fleet-scale query through
     ``threshold_cdf`` (2^20 devices x 32 features x 128 thresholds, flip
     0.1, 16 device tiles; a monotone CDF within 0.01 of the values'
     empirical CDF), its time split into torch draws, K9 and the rest;
  2f. the aggregation tier (``ShardedAsyncServer``, run right after 2b on
     the same model): 4 leaves x 2 slots (the flat buffer of 8), each
     session one arrival batch, ``client`` and ``tee_stream`` in both
     topologies and the batched ``tee`` tree, each ``torch.equal`` to the
     flat ``AsyncServer`` on the same deltas and keys (full session +
     recovered 6-of-8 flush); a bits-16 ``client`` tree (the 19-bit wire,
     K5) with 2 of 8 clients dropped and leaf 1 dead mid-ingest, equal to
     the flat server over the 4 survivors; ``sketch`` at 0.2 equal to the
     compressed flat server; the push ms of a batch of 8, full and
     recovering flush ms beside the flat server's, peak device memory;
     ``examples/observability_smoke``'s twin at these widths (reconcile
     clean, the replay's trace and params equal); ``simulate`` sync vs
     async; ``simulate_training("async", mask_mode="client",
     faults=FaultPlan(...))`` on the classifier (finite losses, the final
     loss below the first decile's); the sharded round on the classifier
     (4 leaves; masked == unmasked, within 1e-6 of the single-host round);
  2i. (run right after 2f) the tier across processes: phase 2f's runs
     (``client`` and ``tee_stream`` in both topologies, the batched ``tee``
     tree, the bits-16 ``client`` tree with 2 dropped clients and a dead
     leaf, sketch@0.2) and its sharded round (masked and unmasked) through
     ``repro_torch.launch.dist.run`` on an NCCL world of one rank per card
     (``torch.cuda.device_count()``) and on gloo worlds of 2 and 4 ranks
     sharing cuda:0, every run in every world: each rank holds and encodes only its
     block of leaves and the ranks' int32 partials meet in an int64
     ``all_reduce`` taken mod 2^32 (gloo stages it through the host);
     every rank's final params must be phase 2f's (SHA-256 of the bytes);
     each rank's push, flush (leaf partials / combine), combine bytes and
     peak memory;
  2h. (run after 2d) the standalone protocol, checkpoints and training the
     other families: ``encode_masked_contribution`` through K1 at the
     embedding chunk, ``torch.equal`` to its plain branch on the card; 8
     such rows, slots 2 and 5 absent, flushed by ``aggregate_masked_buffer``
     with recovery ``torch.equal`` to the unmasked flush of the 6
     survivors' ``encode_contribution`` rows; ``secure_aggregate`` of 8
     updates of 2^20 at 24 bits bit-equal to the CPU's, its masks summing
     to 0 and its mean within a fixed-point level; phase
     2d's CLI run checkpoints after round 2 (``--checkpoint-dir
     build/smoke_checkpoint``): ``step_2`` restores ``torch.equal`` to the
     run's final params, and ``serve.main --checkpoint`` at phase 2c's
     settings prints ``restored step 2`` and samples what ``generate``
     samples on the trained params (payload bytes, save and restore
     seconds; the directory deleted after); one round of each other family
     at its published width, sequence 64, bits 32, noise 0: mamba2-780m
     and whisper-tiny at full depth through ``train.main --full`` (cohort
     4), deepseek-moe-16b (4 layers, cohort 2; masked and unmasked,
     bit-equal), recurrentgemma-2b (20 of 26 layers, cohort 2) and
     internvl2-76b (1 of 80 layers behind 1024 stub image tokens, cohort
     1) through ``build_round_step``, each sized under ~60 GiB; whisper-tiny
     also at bits 32 vs bits 0 (within the fixed-point resolution); each
     run's metrics finite, params moved, round split by its ``round.*``
     spans and peak memory;
  2j. (before phase 3) the cost harness: ``repro_torch.launch.dryrun`` at
     full width on the production 16 x 16 mesh for decode_32k of every
     arch and the recorded whisper-tiny x long_500k skip (each pair OK,
     its dominant term, bound and peak; counted on the host against the
     H100's rates in ``repro_torch.launch.analysis``), then phase 2c's
     decode step and phase 2d's round counted on one device: each
     whole-step bound must not exceed what this run measured for that work
     (the decode step's device-busy ms, the round's fenced
     ``round.execute`` ms), and each estimated peak must fall within
     ``PEAK_BAND`` of the card's own for that work;
  3. the exact kernel launch counts of each path (and zero plain-version
     calls): K10 once per layer per decode step of each serve run (phase
     2g: once per attention layer per step, twice per whisper decoder
     layer, never in mamba2); per
     training round at cohort 4 (one chunk of 4 clients, 14 leaves) K3 14,
     K6 56 and K7 14 at bits 32, K3 14 and K8 14 at bits 0; K9 once per
     device tile of each CDF vote (2 in the example, 1 in the pipeline, 16
     in the fleet query); the tier's runs from their shapes and ledgers
     (K1 per chunk of each masked encode, K5 per chunk of each packed
     encode or landing, K2's PRF lane per chunk per leaf per flush, K4 per
     chunk of each sketch push, K3/K6/K7 per leaf / client leaf / leaf);
     phase 2i: each world's launches summed over its ranks as one process
     would launch them (every landed row encoded once, on its leaf's rank;
     K7 once per rank in the rounds);
     phase 2h: K10 per layer per decode step of the served checkpoint and
     of ``generate`` on the trained params, K1 once per protocol row and
     K7 once per protocol flush, per family round K3 once per leaf, K6
     once per client leaf, K7 once per leaf (bits 0: K3 and K8);
  4. the card's name and power limit, each kernel's time at the main path's
     largest shape beside its bound (bytes over 3.35 TB/s, float operations
     over 67 T/s, integer instructions over the issue rate SMs x 128 x the
     maximum SM clock) and its plain version's time; K2's PRF lane (its
     launches counted apart) beside its unmasked lane; K10's
     device time (calls queued behind a sleep kernel) at the serve shape,
     the decode_32k shape and phase 2g's four new shapes, each beside one
     ``scaled_dot_product_attention`` call on the same inputs; K9 at the
     fleet query's launch shape (2^16 x 32 x 128).

Phase 1 also holds K9 (``bit_counts``) bit-equal to its plain version
(ragged N and F, T up to 256, p in {0, 0.1, 0.5, 1}, boundary uniforms, NaN
values, +-inf thresholds, the fleet tile), and K10 (``flash_decode``, float
attention) to its plain version within rtol = atol = 2e-5 (f32 sums in
another order): f32 and bf16 K/V, window 0 and > 0, wrapped ring buffers,
partly filled caches, ragged W (1, 7, 63, 65, 129, 300, ...), hd 32 to
256, the serve path's shapes, decode_32k and phase 2g's (MQA hd 256 over
a wrapped 2048 ring, cross attention over 1500 frames, MHA, GQA rep 8 at
W 3104), with the kernel's CTAs per SM
and the split count it gives; K6
(``quantize_mask``, with and without a mask, ragged D, +-inf, NaN and
saturating inputs) and K7 (``dequantize``, both multipliers) bit-equal; K3
(``sq_norms``) within rtol 1e-5 and K8 (``scale_accum``) within 1e-6 of
the largest |s_c x_c| sum (f32 sums).
Phase 4 times K3, K6, K7 and K8 at the training round's largest leaf
(4 x 385,351,680) beside one library call each (``vector_norm``,
``scales @ x``, ``torch.mul``; none computes K6).

The last line is ``{"ok": true, "device": {...}}``; any failure exits
non-zero before it.  Deltas and weights are random, made from ``--seed``.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# The card's rates (HBM bytes/s, f32 and integer op/s, the Threefry's
# instructions) are repro_torch.launch.analysis's, the one place they are
# kept; main() sets the integer issue rate there from this card.

DEVICE = "cuda"
NUM_LAYERS = 2
BUFFER = 8
CHUNK_ELEMS = 1 << 25
EXPECT_CHUNKS = 5
EXPECT_PARAMS = 326_970_880
DELTA_SCALE = 2e-5  # per-element std: a delta's L2 norm is ~0.36 < clip 1.0
SKETCH_RATE = 0.2  # the builders' rate in results/compression_tradeoff.csv
# phase 2f: the aggregation tier over the same model, 4 leaves x 2 slots
# (the flat server's buffer of 8)
TIER_LEAVES, TIER_LEAF_BUFFER = 4, 2
# phase 2i: the same runs across processes (the published widths; a CPU
# rehearsal sets the reduced config)
DIST_REDUCED = False
EMBED = 151_936 * 1536  # the embedding chunk, the main path's largest
# phase 2c: the serve CLI at qwen2-1.5b's full width and depth
SERVE_ARGS = ["--arch", "qwen2-1.5b", "--full", "--batch", "8",
              "--prompt-len", "2048", "--decode-tokens", "32"]
SERVE_RUNS = (("full", []), ("int8", ["--int8"]),
              ("window1024", ["--window", "1024"]))
SERVE_B, SERVE_S, SERVE_STEPS, SERVE_LAYERS = 8, 2048, 32, 28
SERVE_PARAMS = 1_543_714_304
# decode logits vs teacher forcing: f32 with TF32 off, the same weights; the
# two differ by summation order only (M=8 vs M=16640 products, K10's online
# softmax vs the chunked prefill softmax) through 28 layers
TF_ATOL = 1e-3
# K10 against its plain version (f32 sums in another order)
FD_TOL = dict(rtol=2e-5, atol=2e-5)
# phase 2d: the train CLI at qwen2-1.5b's full width and depth
TRAIN_ARGS = ["--full", "--rounds", "2", "--cohort", "4", "--seq-len", "64"]
TRAIN_ARCH, TRAIN_REDUCED = "qwen2-1.5b", False
TRAIN_COHORT, TRAIN_SEQ, TRAIN_ROUNDS = 4, 64, 2
TRAIN_LEAVES = 14
MASKED_LAYERS = 2  # the masked/unmasked pair's depth, cut for time
CLASSIFIER_ARGS = ["--classifier", "--rounds", "20", "--log-every", "5"]
CLASSIFIER_ROUNDS = 20
# the classifier round: cohort 16 in 2 chunks of 8 clients, 6 leaves
CLASSIFIER_CHUNKS, CLASSIFIER_LEAVES, CLASSIFIER_COHORT = 2, 6, 16
# K3 and K8 against their plain versions (f32 sums)
SQ_RTOL = 1e-5
ACC_RTOL = 1e-6
# the round's largest leaf: qwen2-1.5b's stacked MLP weight, 28 x 1536 x 8960
ROUND_LEAF = 28 * 1536 * 8960
# K10's timed shapes: (B, H, KV, hd, W, window) of the serve path, of
# decode_32k (configs/shapes.py: batch 128, one qwen2 layer's 32768-deep
# cache) and of phase 2g's families: recurrentgemma-2b's MQA ring of 2048
# (10 query heads: two row groups), whisper-tiny's cross attention over
# 1500 frames, deepseek-moe-16b's MHA and internvl2-76b's GQA rep 8 behind
# 1024 image tokens
FD_SHAPES = (("serve", 8, 12, 2, 128, 2080, 0),
             ("decode_32k", 128, 12, 2, 128, 32768, 0),
             ("hybrid", 8, 10, 1, 256, 2048, 2048),
             ("cross", 8, 6, 6, 64, 1500, 0),
             ("moe", 8, 16, 16, 128, 2080, 0),
             ("vlm", 8, 64, 8, 128, 3104, 0))
# phase 2g: the other families served at full width through serve.main,
# batch 8, 32 greedy steps, f32; depth cut where 80 GB or the run's time
# forces it.  (run, arch, layers or None for the full depth, prompt,
# parameters counted from param_shapes, K10 launches per decode step)
FAMILY_B, FAMILY_STEPS = 8, 32
FAMILY_RUNS = (
    ("moe", "deepseek-moe-16b", 4, 2048, 2_267_039_744, 4),
    ("moe-dropfree", "deepseek-moe-16b", 4, 2048, 2_267_039_744, 4),
    ("ssm", "mamba2-780m", None, 2048, 780_148_992, 0),
    ("hybrid", "recurrentgemma-2b", None, 2048, 2_894_574_080, 8),
    ("vlm", "internvl2-76b", 2, 2048, 3_812_663_296, 2),
    ("audio", "whisper-tiny", None, 32, 39_593_856, 8),
)
# moe-dropfree: the moe run's weights and prompt at capacity_factor =
# num_experts, where no (token, slot) pair is dropped
DROPFREE_CAPACITY = 64.0
# a token routed to another expert set by the teacher-forced pass than by
# the served one is a near-tie when its k-th and (k+1)-th router
# probabilities differ by at most this much in the teacher-forced pass
# (f32 sums in another order move a probability by ~1e-9 here)
NEAR_TIE = 1e-6
# phase 2h: the standalone protocol at the embedding chunk (8 slots, 2 of
# them absent at the flush), secure_aggregate of 8 updates of 2^20, phase
# 2d's checkpoint (step_2, written under build/) served at phase 2c's
# settings, and training the other families at their published widths.
PROTO_ROWS, PROTO_ABSENT = 8, (2, 5)
# secure_aggregate at 24 bits: its field for 8 updates is 2^27, so their
# sum cannot wrap (at 32 bits the field stays 2^32 and a sum of 8 values
# past ~4.6 sigma wraps, as the reference's does)
SECAGG_UPDATES, SECAGG_D, SECAGG_BITS = 8, 1 << 20, 24
CKPT_DIR = ROOT / "build" / "smoke_checkpoint"
CKPT_EVERY = 2
# (run, arch, layers or None for the full depth, cohort, parameters,
# leaves, entry point): "cli" through train.main --full, "round" through
# build_round_step on the depth-cut config.  Sized at ~(16 + 4 x cohort)
# bytes a parameter (phase 2d's round: 46.07 GiB for 1,543,714,304 at
# cohort 4), each under ~60 GiB: deepseek-moe-16b at phase 2g's 4 layers
# needs cohort 2 (50.7 GiB); recurrentgemma-2b at cohort 2 is cut from 26
# to 20 layers (53.2 GiB); internvl2-76b's 2,957,008,896 parameters at 1
# layer need cohort 1 (55.1 GiB).  Each config's max_seq_len is train.py's,
# max(sequence, 64): whisper-tiny's learned decoder positions shrink to 64
# rows (36,472,704 parameters where it serves 39,593,856)
FAMILY_SEQ, FAMILY_ROUNDS = 64, 1
FAMILY_TRAIN = (
    ("train-ssm", "mamba2-780m", None, 4, 780_148_992, 11, "cli"),
    ("train-audio", "whisper-tiny", None, 4, 36_472_704, 110, "cli"),
    ("train-moe", "deepseek-moe-16b", 4, 2, 2_267_039_744, 25, "round"),
    ("train-hybrid", "recurrentgemma-2b", 20, 2, 2_380_659_200, 266,
     "round"),
    ("train-vlm", "internvl2-76b", 1, 1, 2_957_008_896, 12, "round"),
)
FAMILY_FULL = True  # False: the reduced configs (a CPU rehearsal)
# phase 2e: a fleet-scale FA query through threshold_cdf: one statistics
# cohort of 2^20 devices over the paper's 32 dense features and
# test_system's 128-threshold grid, randomized response at 0.1; K9 votes
# 2^16 devices a launch (core/analytics/bitagg.py VOTE_TILE_CUDA)
FLEET_DEVICES, FLEET_FEATURES, FLEET_THRESHOLDS = 1 << 20, 32, 128
FLEET_FLIP, FLEET_TILE = 0.1, 1 << 16
FLEET_TOL = 0.01  # the voted CDF against the values' empirical CDF
# K9's work per vote: compare, two uniform compares, and, add, add
K9_OPS = 6
# phase 2j: the cost harness (repro_torch.launch.dryrun) at full width on
# the production 16 x 16 mesh, one shape per arch (decode_32k: the whole
# --all sweep takes ~8.5 min of host time) and the recorded skip; then the
# whole-step bounds of phases 2c and 2d against their measurements, and
# each step's estimated peak, which must fall in [PEAK_BAND] of the card's
DRYRUN_PAIRS = tuple((a, "decode_32k") for a in (
    "recurrentgemma-2b", "llama4-scout-17b-a16e", "mamba2-780m",
    "deepseek-moe-16b", "deepseek-7b", "internvl2-76b",
    "deepseek-coder-33b", "minitron-4b", "qwen2-1.5b", "whisper-tiny")) + (
    ("whisper-tiny", "long_500k"),)
PEAK_BAND = (0.75, 1.25)
# what phases 2c and 2d measured, for phase 2j: {"decode": {"busy_ms",
# "peak_bytes"}, "round": {"ms", "peak_bytes"}}
MEASURED: dict = {}


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        log(f"== {self.name}")
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"== {self.name}: {time.perf_counter() - self.t0:.1f} s")
        return False


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def sync(torch) -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# phase 1: build + kernel parity
# ---------------------------------------------------------------------------
def build_kernels() -> None:
    from repro_torch.kernels import _build
    logs = _build.build_all(verbose=True)
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  ptxas[{name}]: {line.strip()}")
    for name in _build.SOURCES:
        _build.load(name)
        log(f"  loaded {_build.library_path(name).name}")


def _sessions(torch, ksa, sa):
    perm = [3, 0, 9, 1, 4, 8, 2, 7, 6, 5]
    table = sa.neighbor_table(10, 4, perm, device="cuda")
    return {
        "complete8": ksa.SessionMeta(key_words=(0x1234, 0x5A5E), num_slots=8),
        "ring10": ksa.SessionMeta(key_words=(7, 9), num_slots=10, degree=4),
        "table10": ksa.SessionMeta(key_words=(11, 13), num_slots=10,
                                   degree=4, neighbors=table),
    }


def kernel_parity(torch) -> None:
    from repro_torch.core.fl import secure_agg as sa
    from repro_torch.kernels import prf
    from repro_torch.kernels import secure_agg as ksa
    g = torch.Generator(device="cuda").manual_seed(1)
    sessions = _sessions(torch, ksa, sa)
    scale = 67108862.75 / 4.0
    n = 0
    for D in (1, 1000, 4097, (1 << 20) + 3):
        x = torch.randn(D, generator=g, device="cuda") * 1e-3
        for name, s in sessions.items():
            for slot, u_off in ((0, 0), (s.num_slots - 1, 12345)):
                got = ksa.quantize_mask_prf(x, scale, slot, (5, 6), s,
                                            u_offset=u_off)
                want = ksa.quantize_mask_prf_plain(x, scale, slot, (5, 6), s,
                                                   u_offset=u_off)
                torch.cuda.synchronize()
                check(torch.equal(got, want),
                      f"quantize_mask_prf != plain (D={D}, {name}, "
                      f"slot={slot}, u_offset={u_off})")
                n += 1
    log(f"  quantize_mask_prf: {n} cases bit-equal to the plain version")
    n = 0
    for C, D in ((8, 1), (8, 777), (5, (1 << 18) + 5)):
        x = torch.randn(C, D, generator=g, device="cuda") * 1e-3
        w = torch.rand(C, generator=g, device="cuda")
        u = prf.uniform_block(3, 4, C * D, device="cuda").reshape(C, D)
        m = torch.randint(-2 ** 31, 2 ** 31, (C, D), generator=g,
                          device="cuda", dtype=torch.int64).to(torch.int32)
        lanes = [("plain", {}), ("masks", {"masks": m})]
        for name, s in sessions.items():
            lanes.append((name, {"session": s}))
            # a shard: rows at slots 3.., the ones beyond the session gated
            lanes.append((name + "+offset3",
                          {"session": s._replace(slot_offset=3)}))
        for name, kw in lanes:
            got = ksa.weighted_quantize_accum(x, w, u, scale, **kw)
            want = ksa.weighted_quantize_accum_plain(x, w, u, scale, **kw)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"weighted_quantize_accum != plain (C={C}, D={D}, {name})")
            n += 1
    log(f"  weighted_quantize_accum: {n} cases bit-equal to the plain "
        "version")
    n = 0
    # even and odd uniform offsets (both ODD_U cases), one whose stream
    # positions pass 2^32, ragged and whole Hadamard blocks, a tail quad,
    # x 4 bytes off 16-byte alignment
    scales = (scale, 131067.5, 3333.25, 16777215.6875, 1e-3)
    for D in (1, 3, 511, 512, 513, 4097, (1 << 20) + 3):
        buf = torch.randn(D + 1, generator=g, device="cuda") * 1e-3
        for i, u_off in enumerate((0, 1, 4097, 1 << 30, (1 << 32) - 3)):
            sc = scales[i]
            okw = (0x1234 + D, 0xCB01 + i)
            for x in ((buf[:D], buf[1:]) if D == 4097 else (buf[:D],)):
                got = ksa.rotate_quantize_prf(x, sc, okw, (5, 6),
                                              u_offset=u_off)
                want = ksa.rotate_quantize_prf_plain(x, sc, okw, (5, 6),
                                                     u_offset=u_off)
                torch.cuda.synchronize()
                check(torch.equal(got, want),
                      f"rotate_quantize_prf != plain (D={D}, scale={sc}, "
                      f"u_offset={u_off}, "
                      f"aligned={x.data_ptr() % 16 == 0})")
                n += 1
    log(f"  rotate_quantize_prf: {n} cases bit-equal to the plain version")
    n = 0
    for bits in range(1, 33):
        for D in (1, 33, 1000, 100_003):
            q = torch.randint(0, 2 ** bits, (D,), generator=g, device="cuda",
                              dtype=torch.int64).to(torch.int32)
            words = ksa.pack_residues(q, bits)
            check(torch.equal(words, ksa.pack_residues_plain(q, bits)),
                  f"pack_residues != plain (bits={bits}, D={D})")
            back = ksa.unpack_residues(words, D, bits)
            check(torch.equal(back, ksa.unpack_residues_plain(words, D,
                                                              bits)),
                  f"unpack_residues != plain (bits={bits}, D={D})")
            torch.cuda.synchronize()
            check(torch.equal(back, q),
                  f"pack/unpack round trip (bits={bits}, D={D})")
            n += 1
    log(f"  pack_residues/unpack_residues: {n} cases bit-equal to the plain "
        "versions and round-tripped")
    paired_prf_parity(torch, g)
    flash_decode_parity(torch, g)
    round_kernel_parity(torch, g)
    bitagg_parity(torch, g)
    jax_random_parity(torch)
    sqrt_parity(torch, g)


def sqrt_parity(torch, g) -> None:
    """``prf.sqrt_f32`` (the port's square root wherever the reference has
    ``jnp.sqrt``) gives the same bits on the card as on the CPU, where it
    is the correctly rounded root (tests/test_torch_sqrt.py): 2^24 values,
    half random bit patterns of every finite non-negative f32."""
    from repro_torch.kernels import prf
    n = 1 << 24
    uni = torch.rand(n // 2, generator=g, device="cuda") * 1e4
    pat = torch.randint(0, 0x7F800000, (n // 2,), generator=g, device="cuda",
                        dtype=torch.int64).to(torch.int32).view(torch.float32)
    x = torch.cat([uni, pat])
    got = prf.sqrt_f32(x).cpu()
    want = prf.sqrt_f32(x.cpu())
    diff = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    check(diff == 0, f"sqrt_f32 on the card != on the CPU: {diff} of {n}")
    log(f"  sqrt_f32: {n:,} values bit-equal on the card and the CPU")


def paired_prf_parity(torch, g) -> None:
    """K1 and K2's PRF lane walk element pairs (one Threefry per counter,
    both words used): bit-equal at odd and even n (1, 2, 3, ...), odd and
    even uniform offsets (one whose stream positions pass 2^32), x 4 bytes
    off 16-byte alignment, the 8-slot complete graph (keys in registers),
    other complete graphs, rings and
    a table up to MAX_KERNEL_NEIGHBORS neighbours (keys in shared memory;
    K2 staging all rows or row by row), and K2 shards whose rows cross
    num_slots."""
    from repro_torch.core.fl import secure_agg as sa
    from repro_torch.kernels import prf
    from repro_torch.kernels import secure_agg as ksa
    big = ksa.MAX_KERNEL_NEIGHBORS
    perm = [3, 0, 9, 1, 4, 8, 2, 7, 6, 5]
    meta = ksa.SessionMeta
    sessions = {
        "complete8": meta(key_words=(0x1234, 0x5A5E), num_slots=8),
        "complete3": meta(key_words=(5, 6), num_slots=3),
        "complete10": meta(key_words=(7, 8), num_slots=10),
        "ring10": meta(key_words=(7, 9), num_slots=10, degree=4),
        "table10": meta(key_words=(11, 13), num_slots=10, degree=4,
                        neighbors=sa.neighbor_table(10, 4, perm,
                                                    device="cuda")),
        f"complete{big}": meta(key_words=(3, 1), num_slots=big),
        f"ring{big + 2}x{big}": meta(key_words=(4, 1), num_slots=big + 2,
                                     degree=big),
    }
    scale = 67108862.75 / 4.0
    n1 = n2 = 0
    for name, s in sessions.items():
        small = s.num_slots <= 10
        sizes = (1, 2, 3, 4, 5, 7, 8, 1000, 4097) if small else \
            (1, 2, 3, 5, 1001)
        for n in sizes:
            x = torch.randn(n + 1, generator=g, device="cuda") * 1e-3
            for xs in (x[:n], x[1:]):
                for slot in sorted({0, s.num_slots // 2, s.num_slots - 1}):
                    for u_off in (0, 1, 2, 3, 12345, (1 << 32) - 3):
                        got = ksa.quantize_mask_prf(xs, scale, slot, (5, 6),
                                                    s, u_offset=u_off)
                        want = ksa.quantize_mask_prf_plain(
                            xs, scale, slot, (5, 6), s, u_offset=u_off)
                        torch.cuda.synchronize()
                        check(torch.equal(got, want),
                              f"quantize_mask_prf != plain ({name}, n={n}, "
                              f"slot={slot}, u_offset={u_off}, "
                              f"aligned={xs.data_ptr() % 16 == 0})")
                        n1 += 1
        shapes = ((1, 1), (8, 2), (8, 3), (5, 1000), (8, 4097), (3, 4096)) \
            if small else ((2, 5), (3, 1001))
        for C, D in shapes:
            x = torch.randn(C, D, generator=g, device="cuda") * 1e-3
            w = torch.rand(C, generator=g, device="cuda")
            u = prf.uniform_block(3, 4, C * D, device="cuda").reshape(C, D)
            for off in sorted({0, 3, s.num_slots - 2, s.num_slots - 1}):
                kw = {"session": s._replace(slot_offset=off)}
                got = ksa.weighted_quantize_accum(x, w, u, scale, **kw)
                want = ksa.weighted_quantize_accum_plain(x, w, u, scale, **kw)
                torch.cuda.synchronize()
                check(torch.equal(got, want),
                      f"weighted_quantize_accum PRF lane != plain ({name}, "
                      f"C={C}, D={D}, slot_offset={off})")
                n2 += 1
    log(f"  paired PRF kernels: quantize_mask_prf {n1} and the "
        f"weighted_quantize_accum PRF lane {n2} cases bit-equal to the plain "
        f"versions (graphs {', '.join(sessions)})")


def jax_random_parity(torch) -> None:
    """The rebuilt jax.random draws on the card equal the CPU's bit for bit
    (the CPU's equal jax.random's, tests/test_torch_jrandom.py): normal on
    2^24 draws, randint at the serve prompt's vocabulary, and the dense
    family's init at qwen2-reduced."""
    from repro_torch.configs import registry
    from repro_torch.kernels import prf
    from repro_torch.models.model import build_model
    n = 1 << 24
    for seed in (0, 1):
        key = prf.fold_in(prf.PRNGKey(seed), 11)
        t0 = time.perf_counter()
        got = prf.normal(key, (n,), device="cuda")
        torch.cuda.synchronize()
        gpu_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = prf.normal(key, (n,))
        cpu_s = time.perf_counter() - t0
        check(torch.equal(got.cpu(), want),
              f"normal on the card != on the CPU (seed {seed}): "
              f"{int((got.cpu() != want).sum())} of {n} differ")
        log(f"  normal: {n:,} draws bit-equal on the card and the CPU (seed "
            f"{seed}; card {gpu_s:.2f} s, CPU {cpu_s:.2f} s)")
        del got, want
    key = prf.PRNGKey(3)
    check(torch.equal(prf.randint(key, (8, 2048), 0, 151_936,
                                  device="cuda").cpu(),
                      prf.randint(key, (8, 2048), 0, 151_936)),
          "randint on the card != on the CPU")
    cfg = registry.get_config("qwen2-1.5b", reduced=True)
    got = build_model(cfg, device="cuda").init(prf.PRNGKey(2))
    want = build_model(cfg, device="cpu").init(prf.PRNGKey(2))
    from repro_torch import tree as T
    check(all(torch.equal(b.cpu(), a) for a, b in zip(T.leaves(want),
                                                       T.leaves(got))),
          "the dense init on the card != on the CPU")
    log("  randint (8 x 2048 of 151,936) and the qwen2-reduced init: "
        "bit-equal on the card and the CPU")


def bitagg_parity(torch, g) -> None:
    """K9 bit-equal to its plain version: ragged N and F, T in {1, 64, 128,
    256}, p in {0, 0.1, 0.5, 1}, uniforms at f32(p/2) and f32(p), NaN
    values, +-inf thresholds, and the fleet query's launch shape."""
    import math
    from repro_torch.kernels import bitagg as k9
    cases = [(N, F, T, p) for N, F in ((1, 1), (777, 3), (4097, 5))
             for T in (1, 64, 128, 256) for p in (0.0, 0.1, 0.5, 1.0)]
    cases += [(FLEET_TILE, FLEET_FEATURES, FLEET_THRESHOLDS, p)
              for p in (0.0, FLEET_FLIP)]
    for N, F, T, p in cases:
        v = torch.randn(N, F, generator=g, device="cuda") * 2.0
        v.view(-1)[::97] = math.nan
        thr = torch.sort(torch.randn(T, generator=g, device="cuda")).values
        thr[0] = -math.inf
        if T > 1:
            thr[-1] = math.inf
        u = torch.rand(N, F, T, generator=g, device="cuda")
        edge = torch.tensor([p / 2.0, p, 0.0], device="cuda")
        u.view(-1)[::101] = edge.repeat(-(-u.numel() // 303))[
            :u.view(-1)[::101].numel()]
        got = k9.bit_counts(v, thr, u, p)
        want = k9.bit_counts_plain(v, thr, u, p)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"bit_counts != plain (N={N}, F={F}, T={T}, p={p})")
        del v, u, got, want
    torch.cuda.empty_cache()
    log(f"  bit_counts: {len(cases)} cases bit-equal to the plain version")


def round_kernel_parity(torch, g) -> None:
    """K6 and K7 bit-equal to their plain versions; K3 and K8 within their
    stated tolerances (f32 sums in another order)."""
    import math
    from repro_torch.kernels import dp_clip as kdp
    from repro_torch.kernels import secure_agg as ksa
    edges = torch.tensor([math.inf, -math.inf, math.nan, 3e9, -3e9, 1e30,
                          -0.0, 0.0, 2.5, -2.5], device="cuda")
    n = 0
    for D in (1, 10, 1000, 4097, (1 << 20) + 3, (1 << 20) + 4):
        x = torch.randn(D, generator=g, device="cuda") * 3.0
        x[:min(D, 10)] = edges[:min(D, 10)]
        u = torch.rand(D, generator=g, device="cuda")
        m = torch.randint(-2 ** 31, 2 ** 31, (D,), generator=g,
                          device="cuda", dtype=torch.int64).to(torch.int32)
        for scale, vr in ((131067.5, 4.0), (134217726.75, math.inf),
                          (1e9, math.inf)):
            for mask in (m, None):
                got = ksa.quantize_mask(x, mask, u, scale, vr)
                want = ksa.quantize_mask_plain(x, mask, u, scale, vr)
                torch.cuda.synchronize()
                check(torch.equal(got, want),
                      f"quantize_mask != plain (D={D}, scale={scale}, "
                      f"vr={vr}, mask={mask is not None})")
                n += 1
        for scale in (131067.5, 33554430.75, 3.0):
            for inv in (ksa.pallas_inverse(scale), ksa.jit_inverse(scale)):
                got = ksa.dequantize(m, inv)
                torch.cuda.synchronize()
                check(torch.equal(got, ksa.dequantize_plain(m, inv)),
                      f"dequantize != plain (D={D}, inv={inv})")
                n += 1
    log(f"  quantize_mask/dequantize: {n} cases bit-equal to the plain "
        "versions")
    n, worst_sq, worst_acc = 0, 0.0, 0.0
    for C, D in ((1, 1), (4, 7), (3, 1000), (4, 4096), (8, (1 << 20) + 3),
                 (4, (1 << 22) + 8)):
        x = torch.randn(C, D, generator=g, device="cuda")
        s = torch.rand(C, generator=g, device="cuda")
        sq, sq_want = kdp.sq_norms(x), kdp.sq_norms_plain(x)
        acc, acc_want = kdp.scale_accum(x, s), kdp.scale_accum_plain(x, s)
        torch.cuda.synchronize()
        e_sq = float(((sq - sq_want).abs() / sq_want.abs()).max())
        top = float((s[:, None] * x).abs().sum(0).max())
        e_acc = float((acc - acc_want).abs().max()) / top
        worst_sq, worst_acc = max(worst_sq, e_sq), max(worst_acc, e_acc)
        check(e_sq <= SQ_RTOL, f"sq_norms != plain (C={C}, D={D}): "
              f"relative {e_sq:.3g}")
        check(e_acc <= ACC_RTOL, f"scale_accum != plain (C={C}, D={D}): "
              f"{e_acc:.3g} of the largest |s x| sum")
        n += 1
    log(f"  sq_norms: {n} cases within rtol {SQ_RTOL} (worst "
        f"{worst_sq:.3g}); scale_accum: within {ACC_RTOL} of the largest "
        f"|s x| sum (worst {worst_acc:.3g})")


def ring_slots(torch, W: int, pos: int, filled: int):
    """slot_pos of a ring buffer after positions 0..pos were written at
    ``p % W``, keeping the last ``filled`` (-1 elsewhere)."""
    s = torch.arange(W, device="cuda")
    last = pos - torch.remainder(pos - s, W)
    keep = (last >= 0) & (last > pos - filled)
    return torch.where(keep, last, -1).to(torch.int32)


def flash_decode_parity(torch, g) -> None:
    from repro_torch.kernels import flash_decode as kfd
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # B, H, KV, hd, W, K/V dtype, window, pos, filled slots
        (2, 8, 2, 64, 512, f32, 0, 511, 512),
        (2, 8, 2, 64, 512, f32, 128, 511, 512),
        (1, 10, 1, 256, 300, f32, 0, 180, 181),  # ragged W, 2 row groups
        (2, 4, 4, 32, 100, bf16, 0, 130, 100),  # wrapped ring
        (2, 4, 4, 32, 100, bf16, 64, 130, 100),  # ... with a window
        (3, 16, 8, 128, 1000, bf16, 0, 599, 600),  # partly filled
        (4, 32, 32, 128, 777, f32, 0, 776, 777),  # MHA (rep 1)
        (1, 4, 2, 128, 7, f32, 0, 6, 7),  # W below one tile
        (2, 8, 2, 64, 512, f32, 0, 5, 0),  # no valid slot: mean of v
        (8, 12, 2, 128, 2080, f32, 0, 2048, 2049),  # serve: first step
        (8, 12, 2, 128, 2080, f32, 0, 2079, 2080),  # serve: last step
        (8, 12, 2, 128, 2080, bf16, 0, 2079, 2080),
        (8, 12, 2, 128, 1024, f32, 1024, 2079, 1024),  # --window 1024 ring
        (8, 12, 2, 128, 1, f32, 0, 0, 1),  # one slot: one split
        (8, 12, 2, 128, 63, f32, 0, 62, 63),  # tiles partly filled
        (8, 12, 2, 128, 65, bf16, 0, 64, 65),
        (8, 12, 2, 128, 129, f32, 0, 128, 100),
        (2, 16, 2, 256, 700, bf16, 0, 699, 700),  # hd 256, bf16
        (128, 12, 2, 128, 32768, f32, 0, 32767, 32768),  # decode_32k
        # phase 2g's served shapes: recurrentgemma-2b's MQA ring (its last
        # step wrapped), whisper-tiny's cross attention (every frame
        # valid), deepseek-moe-16b's MHA, internvl2-76b behind its images
        (8, 10, 1, 256, 2048, f32, 2048, 2079, 2048),
        (8, 6, 6, 64, 1500, f32, 0, 1499, 1500),
        (8, 16, 16, 128, 2080, f32, 0, 2079, 2080),
        (8, 64, 8, 128, 3104, f32, 0, 3103, 3104),
    ]
    worst = 0.0
    for B, H, KV, hd, W, dt, window, pos, filled in cases:
        q = torch.randn(B, H, hd, generator=g, device="cuda") * hd ** -0.5
        k = torch.randn(B, W, KV, hd, generator=g, device="cuda").to(dt)
        v = torch.randn(B, W, KV, hd, generator=g, device="cuda").to(dt)
        slot = ring_slots(torch, W, pos, filled)
        got = kfd.flash_decode(q, k, v, slot, pos, window=window)
        want = kfd.flash_decode_plain(q, k, v, slot, pos, window=window)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        worst = max(worst, err)
        check(bool(torch.isfinite(got).all())
              and torch.allclose(got, want, **FD_TOL),
              f"flash_decode != plain (B={B} H={H} KV={KV} hd={hd} W={W} "
              f"{dt} window={window} pos={pos} filled={filled}): max |err| "
              f"{err:.3g}")
    del q, k, v, got, want
    torch.cuda.empty_cache()
    log(f"  flash_decode: {len(cases)} cases within rtol=atol=2e-5 of the "
        f"plain version (max |err| {worst:.3g})")
    # the split choice on this card: whole waves of the kernel's CTAs
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    occ = {(hd, bf): kfd.ctas_per_sm("cuda", hd, bf)
           for hd in kfd.HEAD_DIMS for bf in (False, True)}
    waves = []
    for shape, B, H, KV, hd, W, _ in FD_SHAPES:
        per_sm = occ[(hd, False)]
        nsplit = kfd.splits(B, KV, H // KV, W, sms=sms, per_sm=per_sm)
        ctas = kfd.row_groups(B, KV, H // KV) * nsplit
        waves.append(f"{shape} {nsplit} splits, {ctas} CTAs = "
                     f"{ctas / (sms * per_sm):g} waves")
    log(f"  flash_decode CTAs per SM (hd, bf16): "
        f"{', '.join(f'{k}: {v}' for k, v in occ.items())}; {sms} SMs; "
        f"{'; '.join(waves)}")


# ---------------------------------------------------------------------------
# phase 2: the main path at full width
# ---------------------------------------------------------------------------
def _cuda_ms(torch, fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _device_ms(torch, fn, reps: int) -> float:
    """Device time per call of ``fn``, for calls of tens of microseconds: a
    sleep kernel (~50 ms) holds the stream while the host enqueues every
    call, so the host's launch cost does not fall between the events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


class MainPath:
    """Drives ``AsyncServer`` sessions on one set of seeded deltas."""

    def __init__(self, torch, seed: int, cfg):
        from repro_torch.models.model import init_params
        self.torch = torch
        self.seed = seed
        self.cfg = cfg.with_overrides(num_layers=NUM_LAYERS)
        self.params = init_params(self.cfg, seed=seed, device=DEVICE)
        self.timings = {}
        self.wire = {}
        self.lanes = {}

    def delta(self, i: int):
        from repro_torch import tree as T
        g = self.torch.Generator(device=DEVICE).manual_seed(
            self.seed * 7919 + 1000 + i)
        return T.tree_map(
            lambda p: self.torch.randn(p.shape, generator=g, device=DEVICE)
            * DELTA_SCALE, self.params)

    def run(self, mode: str, bits: int, fl_kw=None, tag: str = "", **kw):
        """Session 0: 8 pushes (auto-apply).  Session 1: slots 3 and 6 drop
        out, ``flush()`` recovers.  ``fl_kw`` adds FLConfig fields (the
        compressed and enclave runs).  Returns the final parameters."""
        torch = self.torch
        from repro_torch.configs.base import FLConfig
        from repro_torch.core import telemetry as tele
        from repro_torch.core.fl.async_fl import AsyncServer
        fl = FLConfig(cohort_size=BUFFER, clip_norm=1.0, noise_multiplier=0.0,
                      secure_agg_bits=bits, param_chunk_elems=CHUNK_ELEMS,
                      **(fl_kw or {}))
        tel = tele.Telemetry(record_spans=True, fence=True)
        srv = AsyncServer(self.params, fl, buffer_size=BUFFER,
                          staleness_mode="constant", mask_mode=mode,
                          telemetry=tel, device=DEVICE, **kw)
        check(srv.plan.num_chunks == EXPECT_CHUNKS,
              f"{srv.plan.num_chunks} chunks")
        sessions = [list(range(BUFFER)), [0, 1, 2, 4, 5, 7]]
        i = 0
        for version, slots in enumerate(sessions):
            for slot in slots:
                d = self.delta(i)
                i += 1
                sync(torch)
                if mode == "client":
                    cp = srv.encode_push(d, version, slot=slot)
                    check(srv.push_encoded(cp), "push_encoded refused")
                else:
                    check(srv.push(d, version, slot=slot), "push refused")
                del d
            if version == 1:
                check(srv.flush(), "flush abstained")
        check(srv.version == 2, f"server at version {srv.version}")
        sync(torch)
        spans = {}
        for s in tel.spans:
            key = s.name + ("/recovery" if s.labels.get("recovery") else "")
            spans.setdefault(key, []).append(s.dur_ns / 1e6)
        label = mode + ("" if kw.get("stream_encode", True) else "-batched")
        label += tag
        self.timings[(label, bits)] = spans
        self.wire[(label, bits)] = wire_bytes(srv)
        self.lanes[(label, bits)] = {
            lane: sum(v for (n, lk), v in tel.counters().items()
                      if n == "upload_bytes" and ("lane", lane) in lk)
            for lane in ("packed", "compressed", "enclave")}
        params = srv.params
        for k in ("weight_total", "update_norm"):
            v = float(srv.last_metrics[k])
            check(v == v and v > 0, f"{label}: bad metric {k}={v}")
        del srv
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
        return params


def wire_bytes(srv) -> int:
    """Bytes one contribution's streamed row takes on the (packed) wire."""
    from repro_torch.core.fl import aggregation as agg
    from repro_torch.core.fl import secure_agg as sa
    if not srv._streaming:
        return 4 * srv.plan.total  # the raw f32 delta
    return 4 * sum(sa.packed_words(wc.padded, srv._spec.field_modulus)
                   for wc in agg.plan_wire_chunks(srv._spec, srv.plan))


def trees_equal(torch, a, b) -> bool:
    from repro_torch import tree as T
    return all(torch.equal(x, y) for x, y in zip(T.leaves(a), T.leaves(b)))


def finite(torch, tree) -> bool:
    from repro_torch import tree as T
    return all(bool(torch.isfinite(x).all()) for x in T.leaves(tree))


def main_path(torch, mp: MainPath) -> None:
    from repro_torch import tree as T
    plan_total = sum(int(p.numel()) for p in T.leaves(mp.params))
    check(plan_total == EXPECT_PARAMS, f"{plan_total} parameters")
    log(f"  {mp.cfg.name} widths, {NUM_LAYERS} of 28 layers: {plan_total:,} "
        f"parameters; buffer {BUFFER}; chunks of <= {CHUNK_ELEMS:,}")
    for bits in (32, 16):
        t0 = time.perf_counter()
        ref_stream = mp.run("off", bits)
        check(finite(torch, ref_stream), "off: non-finite params")
        moved = max(float((a - b).abs().max()) for a, b in
                    zip(T.leaves(ref_stream), T.leaves(mp.params)))
        check(moved > 0, "off: the parameters did not move")
        for mode in ("client", "tee_stream"):
            got = mp.run(mode, bits)
            check(trees_equal(torch, got, ref_stream),
                  f"{mode} (bits {bits}) != streamed off")
            log(f"  bits {bits}: {mode} bit-equal to streamed off "
                "(full session + recovered 6-of-8 flush)")
            del got
        del ref_stream
        ref_batched = mp.run("off", bits, stream_encode=False)
        got = mp.run("tee", bits)
        check(trees_equal(torch, got, ref_batched),
              f"tee (bits {bits}) != batched off")
        log(f"  bits {bits}: tee bit-equal to stream_encode=False off "
            "(full session + 6-of-8 flush)")
        del got, ref_batched
        log(f"  bits {bits}: {time.perf_counter() - t0:.1f} s")
    report_timings(mp)


def report_timings(mp: MainPath) -> None:
    for (label, bits), spans in sorted(mp.timings.items()):
        parts = []
        for key in ("encode_push", "push_encoded", "push", "decode",
                    "decode/recovery"):
            if key in spans:
                parts.append(f"{key} median {statistics.median(spans[key]):.1f}"
                             f" ms (n={len(spans[key])})")
        # the first push of each session also derives its compression
        # operators (a compressed run's median excludes that)
        key = "encode_push" if "encode_push" in spans else "push"
        parts.append("first push of each session " + ", ".join(
            f"{spans[key][i]:.1f}" for i in (0, BUFFER)) + " ms")
        # a full session: buffer x (median push-side ms) + its flush
        push_ms = sum(statistics.median(spans[k]) for k in
                      ("encode_push", "push_encoded", "push") if k in spans)
        rate = BUFFER / ((BUFFER * push_ms + spans["decode"][0]) / 1e3)
        log(f"  timing {label} bits {bits}: " + "; ".join(parts)
            + f"; {rate:.1f} updates/s; wire "
            f"{mp.wire[(label, bits)]:,} B/contribution")
    mp.timings.clear()


def compressed_path(torch, mp: MainPath) -> None:
    """Phase 2b: sketch (and one subsample) uploads, and the enclave wire."""
    from repro_torch import tree as T
    sketch = {"compress_mode": "sketch", "compress_rate": SKETCH_RATE}
    for bits in (32, 16):
        t0 = time.perf_counter()
        ref = mp.run("off", bits, sketch, tag="+sketch")
        check(finite(torch, ref), "off+sketch: non-finite params")
        moved = max(float((a - b).abs().max()) for a, b in
                    zip(T.leaves(ref), T.leaves(mp.params)))
        check(moved > 0, "off+sketch: the parameters did not move")
        for mode in ("client", "tee_stream"):
            got = mp.run(mode, bits, sketch, tag="+sketch")
            check(trees_equal(torch, got, ref),
                  f"{mode}+sketch (bits {bits}) != streamed off+sketch")
            log(f"  bits {bits}: {mode}+sketch@{SKETCH_RATE} bit-equal to "
                "streamed off+sketch (full session + recovered 6-of-8 flush)")
            del got
        del ref
        full = mp.wire[("off", bits)] if ("off", bits) in mp.wire else None
        comp_b = mp.wire[("off+sketch", bits)]
        if full:
            log(f"  bits {bits}: sketch wire {comp_b:,} B vs {full:,} B "
                f"uncompressed per contribution ({comp_b / full:.3f}x)")
        pushes = BUFFER + 6
        lanes = mp.lanes[("client+sketch", bits)]
        check(lanes["compressed"] == 2 * pushes * comp_b
              and lanes["packed"] == 0,
              f"client+sketch bits {bits}: upload_bytes lanes {lanes}")
        log(f"  bits {bits}: {time.perf_counter() - t0:.1f} s")
    sub = {"compress_mode": "subsample", "compress_rate": SKETCH_RATE}
    ref = mp.run("off", 16, sub, tag="+subsample")
    got = mp.run("client", 16, sub, tag="+subsample")
    check(finite(torch, got), "client+subsample: non-finite params")
    check(trees_equal(torch, got, ref),
          "client+subsample (bits 16) != streamed off+subsample")
    log(f"  bits 16: client+subsample@{SKETCH_RATE} bit-equal to streamed "
        "off+subsample")
    del got, ref
    got = mp.run("tee_stream", 32, {"enclave_wire_bits": 8}, tag="+enclave8")
    check(finite(torch, got), "tee_stream+enclave8: non-finite params")
    moved = max(float((a - b).abs().max()) for a, b in
                zip(T.leaves(got), T.leaves(mp.params)))
    check(moved > 0, "tee_stream+enclave8: the parameters did not move")
    ebytes = mp.lanes[("tee_stream+enclave8", 32)]["enclave"]
    raw = (BUFFER + 6) * 4 * sum(int(p.numel()) for p in T.leaves(mp.params))
    check(0 < ebytes < 0.3 * raw,
          f"enclave bytes {ebytes} not below 0.3 of the raw wire {raw}")
    log(f"  tee_stream enclave_wire_bits=8: enclave bytes {ebytes:,} = "
        f"{ebytes / raw:.3f} of the raw f32 wire; moved {moved:.3g}")
    del got
    report_timings(mp)


# ---------------------------------------------------------------------------
# phase 2f: the aggregation tier at full width
# ---------------------------------------------------------------------------
def stacked_deltas(torch, mp, idx):
    """Deltas ``idx`` of ``mp`` as one (K,)-stacked tree, filled in place."""
    from repro_torch import tree as T
    out = T.tree_map(lambda p: torch.empty((len(idx),) + tuple(p.shape),
                                           dtype=p.dtype, device=DEVICE),
                     mp.params)
    for j, i in enumerate(idx):
        d = mp.delta(i)
        T.tree_map(lambda o, x: o[j].copy_(x), out, d)
        del d
    return out


def _tier_fl(bits: int, fl_kw=None):
    from repro_torch.configs.base import FLConfig
    return FLConfig(cohort_size=BUFFER, clip_norm=1.0, noise_multiplier=0.0,
                    secure_agg_bits=bits, param_chunk_elems=CHUNK_ELEMS,
                    **(fl_kw or {}))


def _tier_server(mp, mode, two_level, bits=32, fl_kw=None):
    from repro_torch.core import telemetry as tele
    from repro_torch.core.fl.hierarchy import ShardedAsyncServer
    tel = tele.Telemetry(record_spans=True, fence=True)
    srv = ShardedAsyncServer(mp.params, _tier_fl(bits, fl_kw),
                             num_leaves=TIER_LEAVES,
                             leaf_buffer=TIER_LEAF_BUFFER,
                             staleness_mode="constant", mask_mode=mode,
                             two_level=two_level, telemetry=tel,
                             device=DEVICE)
    check(srv.plan.num_chunks == EXPECT_CHUNKS and srv.buffer_size == BUFFER,
          f"tier plan {srv.plan.num_chunks} chunks, {srv.buffer_size} slots")
    return srv, tel


def _land(srv, batch, version, slots):
    """One arrival batch: encoded by the clients and landed (client), or
    ingested raw (the other modes)."""
    if srv.mask_mode == "client":
        cps = srv.encode_push(batch, version, slot=list(slots))
        check(srv.push_encoded(cps) == len(cps), "push_encoded refused")
    else:
        srv.push(batch, version, slots=list(slots))


def tier_run(torch, mp, mode, two_level, bits=32, fl_kw=None):
    """MainPath.run's sessions on the 4 x 2 tier, each session one arrival
    batch: session 0 all 8 slots (applies on arrival), session 1 slots 3
    and 6 drop out and ``flush()`` recovers them.  Returns (params, spans
    by name: "push" = the batch's ingest (client: encode + land), "decode",
    "decode/recovery")."""
    srv, tel = _tier_server(mp, mode, two_level, bits, fl_kw)
    sessions = [(range(BUFFER), range(BUFFER)),
                (range(BUFFER, BUFFER + 6), (0, 1, 2, 4, 5, 7))]
    for version, (idx, slots) in enumerate(sessions):
        batch = stacked_deltas(torch, mp, list(idx))
        sync(torch)
        _land(srv, batch, version, slots)
        del batch
    check(srv.flush(), "tier flush abstained")
    check(srv.version == 2, f"tier at version {srv.version}")
    sync(torch)
    spans = {}
    for sp in tel.spans:
        key = sp.name
        if sp.name in ("encode_push", "push_encoded", "ingest"):
            key = "push"
        elif sp.name == "decode" and sp.labels.get("recovery"):
            key = "decode/recovery"
        spans.setdefault(key, []).append(sp.dur_ns / 1e6)
    # client: encode + land of one batch are two spans; pair them up
    if mode == "client":
        p = spans["push"]
        spans["push"] = [p[i] + p[i + 1] for i in range(0, len(p), 2)]
    params = srv.params
    del srv
    empty_cache(torch)
    return params, spans


def _flat_session_ms(mp, label, bits):
    """The flat server's numbers from MainPath.run: 8 pushes of session 0
    (median push x 8), its flush, the recovering flush."""
    sp = mp.timings[(label, bits)]
    push = sum(statistics.median(sp[k]) for k in
               ("encode_push", "push_encoded", "push") if k in sp)
    return BUFFER * push, sp["decode"][0], sp["decode/recovery"][0]


def _peak_gib(torch, reset: bool = False) -> float:
    """Peak allocated device memory since the last reset (then reset)."""
    if DEVICE != "cuda":
        return float("nan")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if reset:
        torch.cuda.reset_peak_memory_stats()
    return peak


def tier_path(torch, mp, counts: dict, smi: str, digests: dict) -> dict:
    """Phase 2f.  ``counts[run]`` gets the kernel counts of each run and
    ``digests[run]`` the SHA-256 of its final params (what phase 2i's
    ranks must reproduce); returns the launches each run must show
    (nonzero kernels only)."""
    from repro_torch import tree as T
    from repro_torch.kernels import secure_agg as ksa
    from repro_torch.testing import tree_digest
    C = EXPECT_CHUNKS
    pushes = BUFFER + 6
    want = {}
    _peak_gib(torch, reset=True)
    peaks = {}
    rows = []

    # 1. client and tee_stream, flat and tree, vs the flat AsyncServer
    #    (client == tee_stream == streamed off bit for bit: phase 2)
    reset_counts()
    ref = mp.run("client", 32)
    counts["tier-flat-ref"] = kernel_counts()
    peaks["flat client"] = _peak_gib(torch, reset=True)
    want["tier-flat-ref"] = {"quantize_mask_prf": pushes * C}
    flat_ms = _flat_session_ms(mp, "client", 32)
    rows.append(("flat AsyncServer client",) + flat_ms)
    for mode in ("client", "tee_stream"):
        for two_level in (False, True):
            topo = "tree" if two_level else "flat"
            reset_counts()
            got, spans = tier_run(torch, mp, mode, two_level)
            counts[f"tier-{mode}-{topo}"] = kernel_counts()
            peaks[f"{mode}-{topo}"] = _peak_gib(torch, reset=True)
            want[f"tier-{mode}-{topo}"] = {"quantize_mask_prf": pushes * C}
            check(trees_equal(torch, got, ref),
                  f"tier {mode}/{topo} != the flat AsyncServer")
            digests[f"tier-{mode}-{topo}"] = tree_digest(got)
            log(f"  tier {mode}, {topo} topology ({TIER_LEAVES} leaves x "
                f"{TIER_LEAF_BUFFER}): params bit-equal to the flat "
                f"AsyncServer at buffer {BUFFER} (full session + recovered "
                "6-of-8 flush)")
            rows.append((f"tier {mode} {topo}", spans["push"][0],
                         spans["decode"][0], spans["decode/recovery"][0]))
            del got
    del ref

    # 2. batched tee: the tree's per-leaf K2 PRF lanes vs the flat engine
    reset_counts()
    ref = mp.run("tee", 32)
    peaks["flat tee"] = _peak_gib(torch, reset=True)
    flat_ms = _flat_session_ms(mp, "tee", 32)
    got, spans = tier_run(torch, mp, "tee", True)
    counts["tier-tee"] = kernel_counts()
    peaks["tee-tree"] = _peak_gib(torch, reset=True)
    want["tier-tee"] = {ksa.PRF_LANE: 2 * C + 2 * TIER_LEAVES * C}
    check(trees_equal(torch, got, ref), "tier tee/tree != flat tee")
    digests["tier-tee"] = tree_digest(got)
    log("  tier tee (batched), tree: params bit-equal to the flat tee "
        "AsyncServer (full session + 6-of-8 flush)")
    rows.append(("flat AsyncServer tee",) + flat_ms)
    rows.append(("tier tee tree", spans["push"][0], spans["decode"][0],
                 spans["decode/recovery"][0]))
    del got, ref

    # 3. client dropout + an ingest leaf death on the tree, at bits 16 (the
    #    19-bit packed wire, K5): slots 1 and 6 never arrive, leaf 1 dies
    #    holding slots 2 and 3, the flush recovers all of them
    reset_counts()
    srv, tel = _tier_server(mp, "client", True, bits=16)
    _land(srv, stacked_deltas(torch, mp, [0, 2, 3]), 0, [0, 2, 3])
    lost = srv.mark_leaf_dead(1)
    check(lost == [2, 3] and srv.live_capacity == BUFFER - TIER_LEAF_BUFFER,
          f"leaf death lost {lost}, live capacity {srv.live_capacity}")
    _land(srv, stacked_deltas(torch, mp, [4, 5, 7]), 0, [4, 5, 7])
    sync(torch)
    t0 = time.perf_counter()
    check(srv.flush(), "leaf-death flush abstained")
    sync(torch)
    death_ms = (time.perf_counter() - t0) * 1e3
    got = srv.params
    digests["tier-leafdeath"] = tree_digest(got)
    fm = dict(srv.fault_metrics)
    del srv
    from repro_torch.core.fl.async_fl import AsyncServer
    flat = AsyncServer(mp.params, _tier_fl(16), buffer_size=BUFFER,
                       staleness_mode="constant", mask_mode="client",
                       device=DEVICE)
    for s in (0, 4, 5, 7):
        d = mp.delta(s)
        check(flat.push_encoded(flat.encode_push(d, 0, slot=s)), "refused")
        del d
    check(flat.flush(), "survivor flush abstained")
    counts["tier-leafdeath"] = kernel_counts()
    peaks["leaf death + survivors"] = _peak_gib(torch, reset=True)
    want["tier-leafdeath"] = {"quantize_mask_prf": 10 * C,
                              "pack_residues": 10 * C,
                              "unpack_residues": 10 * C}
    check(trees_equal(torch, got, flat.params),
          "tier after a leaf death != the flat server over the survivors")
    check(fm["dead_leaves"] == 1 and fm["lost_contributions"] == 2,
          f"fault metrics {fm}")
    log(f"  tier client tree, bits 16: 2 of 8 clients dropped + leaf 1 dead "
        f"mid-ingest (slots 2, 3 lost): recovering flush {death_ms:.1f} ms, "
        "params bit-equal to the flat server over the 4 survivors")
    del got, flat
    empty_cache(torch)

    # 4. the compressed tier: sketch@0.2 vs the compressed flat server
    sketch = {"compress_mode": "sketch", "compress_rate": SKETCH_RATE}
    reset_counts()
    ref = mp.run("client", 32, sketch, tag="+sketch")
    peaks["flat client+sketch"] = _peak_gib(torch, reset=True)
    flat_ms = _flat_session_ms(mp, "client+sketch", 32)
    got, spans = tier_run(torch, mp, "client", True, fl_kw=sketch)
    counts["tier-sketch"] = kernel_counts()
    peaks["client+sketch-tree"] = _peak_gib(torch, reset=True)
    want["tier-sketch"] = {"rotate_quantize_prf": 2 * pushes * C}
    check(trees_equal(torch, got, ref),
          "compressed tier != the compressed flat server")
    digests["tier-sketch"] = tree_digest(got)
    log(f"  tier client+sketch@{SKETCH_RATE}, tree: params bit-equal to the "
        "compressed flat AsyncServer (full session + recovered 6-of-8)")
    rows.append(("flat AsyncServer client+sketch",) + flat_ms)
    rows.append(("tier client+sketch tree", spans["push"][0],
                 spans["decode"][0], spans["decode/recovery"][0]))
    del got, ref
    mp.timings.clear()
    for name, push_ms, flush_ms, rec_ms in rows:
        log(f"  timing {name}: push of a batch of {BUFFER} {push_ms:.1f} ms; "
            f"full flush {flush_ms:.1f} ms; recovering flush (2 of 8 "
            f"dropped) {rec_ms:.1f} ms; {smi}")

    # 5. the observability twin at these widths (noise off: the TEE draw of
    #    3.3e8 normals would dominate every flush)
    from repro_torch.core import obs
    from repro_torch.examples import observability_smoke as smoke
    reset_counts()
    sess = {}
    t0 = time.perf_counter()
    rc = smoke.main(["--device", DEVICE, "--out",
                     str(ROOT / "build" / "obs_smoke")],
                    params=mp.params, delta=mp.delta,
                    fl_kw={"param_chunk_elems": CHUNK_ELEMS,
                           "noise_multiplier": 0.0}, session=sess)
    obs_s = time.perf_counter() - t0
    counts["tier-obs"] = kernel_counts()
    peaks["observability twin"] = _peak_gib(torch, reset=True)
    check(rc == 0, "observability_smoke: conservation problem")
    for t, s in ((sess["tel"], sess["srv"]), (sess["tel2"], sess["srv2"])):
        rep = obs.reconcile(t, applied_updates=s._applied_updates)
        check(rep.problems == [], f"reconcile: {rep.problems}")
    check(sess["inj"].plan.trace == sess["inj2"].plan.trace
          and trees_equal(torch, sess["srv"].params, sess["srv2"].params),
          "observability_smoke: the replay diverged")
    check(sess["srv"].fault_metrics["dead_leaves"] >= 1, "no leaf died")
    encodes = sum(1 for t in (sess["tel"], sess["tel2"]) for sp in t.spans
                  if sp.name == "encode_push")
    stored = sum(t.total("stored_contributions")
                 for t in (sess["tel"], sess["tel2"]))
    want["tier-obs"] = {"quantize_mask_prf": encodes * C,
                        "pack_residues": encodes * C,
                        "unpack_residues": int(stored) * C}
    log(f"  observability_smoke at {mp.cfg.name} widths: {obs_s:.1f} s, "
        f"reconcile clean, replay equal (trace and params), {encodes} "
        f"encodes, {int(stored)} stored, "
        f"totals {obs.reconcile(sess['tel']).totals}")
    del sess
    empty_cache(torch)

    # 6. the fleet simulators: numpy simulate, simulate_training on the card
    from repro_torch.configs import mlp as mlp_cfg
    from repro_torch.core import telemetry as tele
    from repro_torch.core.fl import async_fl
    from repro_torch.core.fl.faults import FaultPlan, FaultSpec
    from repro_torch.kernels import prf
    from repro_torch.models.model import build_mlp_classifier
    kw = dict(population=20_000, cohort=128, target_updates=12_800,
              model_bytes=4e6, seed=7, dropout=0.15)
    s_sync, s_async = async_fl.simulate("sync", **kw), \
        async_fl.simulate("async", **kw)
    check(s_async.wall_clock < s_sync.wall_clock
          and s_async.total_bytes < s_sync.total_bytes,
          "simulate: async not faster than sync")
    log(f"  simulate (examples/async_vs_sync fleet): sync "
        f"{s_sync.wall_clock:.0f} s / async {s_async.wall_clock:.0f} s "
        f"simulated ({s_sync.wall_clock / s_async.wall_clock:.2f}x), bytes "
        f"{s_sync.total_bytes / s_async.total_bytes:.2f}x")
    cfg = mlp_cfg.CONFIG
    model = build_mlp_classifier(cfg, device=DEVICE)
    key = prf.PRNGKey(9)
    wstar = prf.normal(key, (cfg.num_features,), device=DEVICE)

    def make_client_batch(seed, n):
        x = prf.normal(prf.fold_in(key, seed), (n, 4, cfg.num_features),
                       device=DEVICE)
        return {"features": x, "label": (torch.einsum(
            "cbf,f->cb", x, wstar) > 0).to(torch.float32)}

    from repro_torch.configs.base import FLConfig
    tel = tele.Telemetry(record_spans=True)
    reset_counts()
    t0 = time.perf_counter()
    res = async_fl.simulate_training(
        "async", loss_fn=model.loss_fn, params=model.init(prf.PRNGKey(0)),
        fl_cfg=FLConfig(local_steps=2, local_lr=0.4, clip_norm=1.0,
                        server_lr=1.0),
        make_client_batch=make_client_batch, target_updates=96, cohort=16,
        population=64, buffer_size=8, seed=1, mask_mode="client",
        faults=FaultPlan(FaultSpec(p_client_death=0.1, p_duplicate=0.2,
                                   p_delay=0.2, delay_pushes=2,
                                   straggler_frac=0.25, seed=4)),
        telemetry=tel, device=DEVICE)
    sim_s = time.perf_counter() - t0
    counts["tier-simtrain"] = kernel_counts()
    encodes = sum(1 for sp in tel.spans if sp.name == "encode_push")
    want["tier-simtrain"] = {"quantize_mask_prf": encodes}
    import math
    first = statistics.mean(res.losses[:max(1, len(res.losses) // 10)])
    check(all(math.isfinite(v) for v in res.losses)
          and res.final_loss < first,
          f"simulate_training: loss {first:.4f} -> {res.final_loss:.4f}")
    log(f"  simulate_training(async, client, FaultPlan) on the classifier: "
        f"{sim_s:.1f} s host, loss {first:.4f} -> {res.final_loss:.4f}, "
        f"{res.sim.server_steps} server steps, fault metrics "
        f"{res.fault_metrics}")

    # 7. the sharded sync round (K3, K6, K7 per leaf): masked == unmasked
    from repro_torch.core.fl import round as fl_round
    torch.use_deterministic_algorithms(True, warn_only=True)
    params = model.init(prf.PRNGKey(0))
    x = prf.normal(prf.fold_in(key, 1), (CLASSIFIER_COHORT, 2,
                                         cfg.num_features), device=DEVICE)
    batch = {"features": x, "label": (x.sum(-1) > 0).to(torch.float32)}
    outs = {}
    reset_counts()
    for name, masked, leaves in (("sharded", False, TIER_LEAVES),
                                 ("sharded-masked", True, TIER_LEAVES),
                                 ("single-host", False, 0)):
        fl = FLConfig(cohort_size=CLASSIFIER_COHORT, local_steps=1,
                      local_lr=0.2, clip_norm=1.0, secure_agg_bits=32,
                      secure_agg_masked=masked, secure_agg_degree=4)
        if leaves:
            step = fl_round.build_sharded_round_step(
                model.loss_fn, fl, cohort_size=CLASSIFIER_COHORT,
                num_leaves=leaves, device=DEVICE)
        else:
            step = fl_round.build_round_step(
                model.loss_fn, fl, cohort_size=CLASSIFIER_COHORT,
                device=DEVICE)
        outs[name] = step(fl_round.init_fl_state(params, fl), dict(batch),
                          prf.PRNGKey(3))[0].params
    torch.use_deterministic_algorithms(False)
    counts["tier-round"] = kernel_counts()
    Lc = CLASSIFIER_LEAVES
    want["tier-round"] = {"sq_norms": 2 * TIER_LEAVES * Lc + Lc,
                          "quantize_mask": 3 * CLASSIFIER_COHORT * Lc,
                          "dequantize": 3 * Lc}
    check(trees_equal(torch, outs["sharded"], outs["sharded-masked"]),
          "sharded round: masked != unmasked")
    digests["tier-round"] = tree_digest(outs["sharded"])
    worst = max(float((a - b).abs().max()) for a, b in zip(
        T.leaves(outs["sharded"]), T.leaves(outs["single-host"])))
    check(worst <= 1e-6, f"sharded round vs single host: {worst:.3g}")
    log(f"  sharded round ({TIER_LEAVES} leaves, cohort "
        f"{CLASSIFIER_COHORT}): masked bit-equal to unmasked; vs the "
        f"single-host round max |dparam| {worst:.3g}")
    del outs, params, model
    empty_cache(torch)

    launched = {}
    for run in want:
        for k, v in counts[run].items():
            launched[k] = launched.get(k, 0) + v["launches"]
    log("  peak device memory by run (GiB): " + ", ".join(
        f"{k} {v:.2f}" for k, v in peaks.items()))
    log(f"  phase 2f peak device memory {max(peaks.values()):.2f} GiB; "
        "launches: "
        + ", ".join(f"{k} {launched.get(k, 0)}" for k in (
            "quantize_mask_prf", "weighted_quantize_accum", ksa.PRF_LANE,
            "rotate_quantize_prf", "pack_residues", "unpack_residues")))
    return want


# ---------------------------------------------------------------------------
# phase 2i: the aggregation tier across processes
# ---------------------------------------------------------------------------
def _dist_cases(seed: int):
    """Phase 2f's tier runs and sharded rounds as ``repro_torch.testing``
    cases (same deltas, slots, keys and flushes; each arrival pushed alone,
    which lands the rows of the 2f batches bit for bit)."""
    from repro_torch.testing import ModelSource, RoundCase, TierCase
    source = ModelSource("qwen2-1.5b", NUM_LAYERS, seed, seed * 7919 + 1000,
                         DELTA_SCALE, reduced=DIST_REDUCED)

    def fl(bits, **kw):
        return dict(cohort_size=BUFFER, clip_norm=1.0, noise_multiplier=0.0,
                    secure_agg_bits=bits, param_chunk_elems=CHUNK_ELEMS, **kw)

    def one_by_one(idx, version, slots):
        return [("push", (i,), version, (s,)) for i, s in zip(idx, slots)]

    sessions = (one_by_one(range(BUFFER), 0, range(BUFFER))
                + one_by_one(range(BUFFER, BUFFER + 6), 1, (0, 1, 2, 4, 5, 7))
                + [("flush", None)])
    death = (one_by_one((0, 2, 3), 0, (0, 2, 3)) + [("dead", 1)]
             + one_by_one((4, 5, 7), 0, (4, 5, 7)) + [("flush", None)])
    L, Bl = TIER_LEAVES, TIER_LEAF_BUFFER
    cases = [TierCase(f"tier-{mode}-{'tree' if tl else 'flat'}", mode, tl,
                      L, Bl, fl(32), sessions)
             for mode in ("client", "tee_stream") for tl in (False, True)]
    cases += [TierCase("tier-tee", "tee", True, L, Bl, fl(32), sessions),
              TierCase("tier-leafdeath", "client", True, L, Bl, fl(16),
                       death),
              TierCase("tier-sketch", "client", True, L, Bl,
                       fl(32, compress_mode="sketch",
                          compress_rate=SKETCH_RATE), sessions)]
    rfl = dict(cohort_size=CLASSIFIER_COHORT, local_steps=1, local_lr=0.2,
               clip_norm=1.0, secure_agg_bits=32, secure_agg_degree=4)
    cases += [RoundCase(name, dict(rfl, secure_agg_masked=masked),
                        CLASSIFIER_COHORT, L, seed=0, data_seed=9)
              for name, masked in (("tier-round", False),
                                   ("tier-round-masked", True))]
    return source, cases


def _dist_want(case, world: int) -> dict:
    """The launches a case must show summed over the ranks: every landed
    row is encoded once, on its leaf's rank; every rank decodes."""
    from repro_torch.kernels import secure_agg as ksa
    C, pushes = EXPECT_CHUNKS, BUFFER + 6
    if case.name == "tier-tee":
        return {ksa.PRF_LANE: 2 * TIER_LEAVES * C}
    if case.name == "tier-leafdeath":
        return dict.fromkeys(("quantize_mask_prf", "pack_residues",
                              "unpack_residues"), 6 * C)
    if case.name == "tier-sketch":
        return {"rotate_quantize_prf": pushes * C}
    if case.name.startswith("tier-round"):
        Lc = CLASSIFIER_LEAVES
        return {"sq_norms": TIER_LEAVES * Lc,
                "quantize_mask": CLASSIFIER_COHORT * Lc,
                "dequantize": world * Lc}
    return {"quantize_mask_prf": pushes * C}


def dist_tier_path(torch, seed: int, digests: dict, counts: dict,
                   smi: str) -> dict:
    """Phase 2i: phase 2f's runs on ``torch.distributed`` worlds on the
    card, every run in every world: gloo worlds of 2 and 4 ranks sharing
    cuda:0 (NCCL refuses two ranks on one device; gloo's combine stages the
    partials through the host, at ~0.5-1 GB/s a rank,
    ``tools/gloo_combine.py``) and an NCCL world of one rank per card.
    Every rank of every run
    must end with phase 2f's params (SHA-256 of the bytes, the digests 2f
    took); the ranks' launches, summed, must be exact.  Returns the
    launches each world's runs must show (``counts[dist-W-run]`` gets the
    summed counts)."""
    from repro_torch.launch import dist
    from repro_torch.testing import tier_world
    source, cases = _dist_cases(seed)
    worlds = [(2, "gloo"), (4, "gloo")]
    if DEVICE == "cuda":
        worlds.append((torch.cuda.device_count(), "nccl"))
    want = {}
    for world, backend in worlds:
        t0 = time.perf_counter()
        ranks = dist.run(tier_world, world, [source], cases, device=DEVICE,
                         backend=backend, digest=True)
        wall = time.perf_counter() - t0
        for case in cases:
            res = [r[case.name] for r in ranks]
            ref = case.name if case.name != "tier-round-masked" \
                else "tier-round"
            check(all(r["params"] == digests[ref] for r in res),
                  f"{backend} world of {world}: {case.name} differs from "
                  "phase 2f's one-process result")
            path = f"dist{world}{backend}-{case.name}"
            summed = {}
            for r in res:
                for k, v in r["counts"].items():
                    s = summed.setdefault(k, {"launches": 0,
                                              "plain_calls": 0})
                    s["launches"] += v["launches"]
                    s["plain_calls"] += v["plain_calls"]
            counts[path] = summed
            want[path] = _dist_want(case, world)
            for r in res:
                sp = r["spans"]

                def ms(name):
                    return " / ".join(f"{d:.1f}" for d in sp.get(name, []))

                if case.name.startswith("tier-round"):
                    stages = (f"inputs {ms('round.inputs')} ms, setup "
                              f"{ms('round.setup')} ms, round "
                              f"{ms('round.execute')} ms: local SGD "
                              f"{ms('round.local_sgd')}, combine "
                              f"{ms('combine')}, decode "
                              f"{ms('round.decode')}")
                else:
                    push = sum(sum(sp.get(k, [])) for k in
                               ("ingest", "encode_push", "push_encoded"))
                    stages = (f"push {push:.1f} ms in all; flushes "
                              f"{ms('decode')} ms: leaf partials "
                              f"{ms('leaf_partials')}, combine "
                              f"{ms('combine')}")
                log(f"  {backend} {world} rank {r['rank']} {case.name}: "
                    f"{stages} ms; combine {r['combine_bytes']:,} B; peak "
                    f"{r['peak_gib']:.2f} GiB; {r['wall_s']:.1f} s (+ "
                    f"{r['build_s']:.1f} s params and deltas, "
                    f"{r['digest_s']:.1f} s digest)")
        devices = sorted({str(dist.rank_device(r, DEVICE))
                          for r in range(world)})
        log(f"  {backend} world of {world} rank(s) on {', '.join(devices)}: "
            f"{len(cases)} runs equal to phase 2f's ({wall:.1f} s with "
            f"spawn); {smi}")
    return want


# ---------------------------------------------------------------------------
# phase 2c: the serving path at full width and depth
# ---------------------------------------------------------------------------
def serve_path(torch, seed: int, counts: dict, smi: str) -> None:
    """Three runs of the serve CLI; each decode checked against teacher
    forcing.  ``counts[run]`` gets the kernel counts of each run."""
    import math
    from repro_torch import tree as T
    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.models.model import param_shapes
    cfg = registry.get_config("qwen2-1.5b", reduced=False)
    n = sum(math.prod(s) for s in T.leaves(param_shapes(cfg)))
    check(n == SERVE_PARAMS and cfg.num_layers == SERVE_LAYERS,
          f"qwen2-1.5b: {n} parameters, {cfg.num_layers} layers")
    log(f"  qwen2-1.5b at full width and depth: {n:,} parameters, "
        f"{cfg.num_layers} layers; batch {SERVE_B}, prompt {SERVE_S}, "
        f"{SERVE_STEPS} decode steps; {smi}")
    for name, extra in SERVE_RUNS:
        session = {}
        reset_counts()
        rc = serve.main(SERVE_ARGS + extra + ["--seed", str(seed),
                                              "--device", DEVICE],
                        session=session)
        counts[f"serve-{name}"] = kernel_counts()
        check(rc == 0, f"serve {name}: exit {rc}")
        gen = session["generation"]
        check(tuple(gen.tokens.shape) == (SERVE_B, SERVE_STEPS + 1),
              f"serve {name}: tokens {tuple(gen.tokens.shape)}")
        check(len(gen.logits) == SERVE_STEPS + 1, "serve: logits kept")
        # teacher forcing: apply over prompt + generated tokens; the logits
        # at position S-1+j are the prefill's (j=0) and decode step j's
        full = torch.cat([session["tokens"], gen.tokens[:, :SERVE_STEPS]], 1)
        logits, _ = session["model"].apply(session["params"],
                                           {"tokens": full})
        want = logits[:, SERVE_S - 1:]
        del logits
        got = torch.stack(gen.logits, dim=1)
        check(bool(torch.isfinite(got).all()), f"serve {name}: non-finite")
        err = float((got - want).abs().max())
        top = float(want.abs().max())
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        check(err <= TF_ATOL, f"serve {name}: decode logits differ from "
              f"teacher forcing by {err:.3g} > {TF_ATOL}")
        decode_ms = gen.decode_s * 1e3 / SERVE_STEPS
        if name == "full":
            MEASURED["decode"] = decode_profile(torch, session, smi, SERVE_S)
            init_cost(torch, session, seed, n, smi)
        log(f"  serve {name}: prefill {gen.prefill_s * 1e3:.1f} ms "
            f"({SERVE_B * SERVE_S / gen.prefill_s:.0f} tok/s); decode "
            f"{decode_ms:.2f} ms/step ({SERVE_B * 1e3 / decode_ms:.0f} "
            f"tok/s); teacher-forced max |dlogit| {err:.3g} (|logit| <= "
            f"{top:.3g}, argmax agreement {agree:.3f}) over "
            f"{SERVE_STEPS + 1} positions; {smi}")
        del session, gen, got, want, full
        torch.cuda.empty_cache()


def init_cost(torch, session: dict, seed: int, n: int, smi: str) -> None:
    """The reference's init rebuilt (``n`` ``jax.random.normal`` draws
    through the torch Threefry-20 stream and XLA's ``erf_inv``), timed once
    more and held bit-equal to the weights just served."""
    from repro_torch import tree as T
    from repro_torch.kernels import prf
    sync(torch)
    t0 = time.perf_counter()
    again = session["model"].init(prf.PRNGKey(seed))
    sync(torch)
    init_s = time.perf_counter() - t0
    check(all(torch.equal(a, b) for a, b in zip(
        T.leaves(again), T.leaves(session["params"]))),
          "a second init differs from the served weights")
    log(f"  init (the reference's key tree, {n:,} normal draws): "
        f"{init_s:.2f} s, bit-equal to the served weights; {smi}")
    del again
    empty_cache(torch)


def decode_profile(torch, session: dict, smi: str, prompt: int,
                   steps: int = 4, label: str = "decode profile") -> dict:
    """``torch.profiler`` over ``steps`` decode steps of a served run (after
    a fresh prefill of its prompt of ``prompt`` tokens): host ms per step,
    device-busy ms per step (the sum of kernel times; one stream), the idle
    share, the kernels by device time and the steps' peak memory."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    model, params = session["model"], session["params"]
    gen = session["generation"]
    cfg = model.cfg
    off = cfg.num_image_tokens if cfg.family == "vlm" else 0
    batch = {"tokens": session["tokens"], **session.get("inputs", {})}
    B = session["tokens"].shape[0]
    max_len = prompt + len(gen.logits) - 1 + off
    _, cache = model.prefill(params, batch, max_len)
    sync(torch)
    # the steps' peak: what they allocate beyond everything already held,
    # plus their arguments (params and cache)
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    from repro_torch import tree as T
    held = sum(t.numel() * t.element_size()
               for t in T.leaves(params) + T.leaves(cache))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            _, cache = model.decode_step(params, cache,
                                         gen.tokens[:, i:i + 1],
                                         prompt + off + i)
        sync(torch)
        host_ms = (time.perf_counter() - t0) * 1e3 / steps
    peak = (torch.cuda.max_memory_allocated() - base + held
            if DEVICE == "cuda" else 0)
    del cache
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((us / 1e3 / steps, e.count / steps, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if not rows:
        log(f"  {label}: the profiler saw no device time")
        return {}
    k10 = sum(r[0] for r in rows if "flash_decode" in r[2])
    n_kernels = sum(r[1] for r in rows)
    log(f"  {label} ({steps} steps, B={B}, max_len={max_len}): "
        f"{host_ms:.2f} ms per step on the host clock, device busy "
        f"{busy:.3f} ms per step ({n_kernels:.0f} kernels), "
        f"idle share {1 - busy / host_ms:.3f}; K10 {k10:.3f} ms per step; "
        f"{smi}")
    for ms, n, key in rows[:8]:
        log(f"    {ms:8.3f} ms/step  x{n:5.0f}  {key[:90]}")
    return {"host_ms": host_ms, "busy_ms": busy, "kernels": n_kernels,
            "idle": 1 - busy / host_ms, "k10_ms": k10, "peak_bytes": peak}


# ---------------------------------------------------------------------------
# phase 2g: serving the other families at full width
# ---------------------------------------------------------------------------
def _family_cfg(registry, serve, arch: str, depth, prompt: int):
    """The config serve.main builds for the run (max_seq_len raised to the
    run's length, the depth cut)."""
    cfg = registry.get_config(arch)
    max_len = prompt + FAMILY_STEPS + cfg.num_image_tokens
    cfg = cfg.with_overrides(max_seq_len=max(cfg.max_seq_len, max_len))
    return (serve.cut_depth(cfg, depth) if depth else cfg), max_len


class RouteLog:
    """While active, records each MoE routing: every token's expert set
    (sorted) and the gap between its k-th and (k+1)-th router
    probabilities."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.route, self.calls = moe, moe.route, []

        def route(cfg, p, x):
            out = self.route(cfg, p, x)
            probs = self.torch.softmax((x @ p["router"]).float(), dim=-1)
            top = probs.topk(cfg.experts_per_token + 1, dim=-1).values
            self.calls.append((self.torch.sort(out[1], dim=-1).values,
                               top[:, -2] - top[:, -1]))
            return out
        moe.route = route
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route
        return False


def routing_flips(torch, served, forced, n_moe: int, B: int, S: int,
                  N: int):
    """Compare the served run's routings (``n_moe`` prefill calls, then
    ``n_moe`` per decode step) with the teacher-forced pass's (one call
    per MoE layer over the B x (S + N) tokens), layer by layer.  Returns
    (per batch row: some token routed apart, the teacher-forced
    probability gaps of the tokens routed apart at their row's first such
    layer).  Below that layer both passes routed the row alike, so its
    inputs there differ by rounding only; past it, the tokens routed apart
    carry other expert outputs and may route apart at any gap."""
    rows = torch.zeros(B, dtype=torch.bool, device=forced[0][0].device)
    gaps = []
    for layer in range(n_moe):
        tf_idx, tf_gap = forced[layer]
        tf_idx = tf_idx.view(B, S + N, -1)
        steps = [served[n_moe * (i + 1) + layer][0] for i in range(N)]
        got = torch.cat([served[layer][0].view(B, S, -1),
                         torch.stack(steps, 1)], 1)
        diff = (got != tf_idx).any(-1)
        gaps.append(tf_gap.view(B, S + N)[diff & ~rows[:, None]])
        rows |= diff.any(1)
    return rows, torch.cat(gaps)


def families_path(torch, seed: int, counts: dict, smi: str) -> None:
    """One served run per family (serve.main at full width; the drop-free
    MoE run through serve.generate on the moe run's weights and prompt);
    each checked against a teacher-forced ``apply`` (the published-capacity
    MoE run: its prefill against ``apply`` on the prompt, since a
    single-token step drops pairs that a batch does not), a decode profile
    and its peak memory.  ``counts[serve-<run>]`` gets each run's kernel
    counts."""
    import math
    from repro_torch import tree as T
    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.models.model import build_model, param_shapes
    moe = None
    for run, arch, depth, prompt, n_params, _ in FAMILY_RUNS:
        cfg, max_len = _family_cfg(registry, serve, arch, depth, prompt)
        n = sum(math.prod(s) for s in T.leaves(param_shapes(cfg)))
        check(n == n_params, f"{run}: {n} parameters, want {n_params}")
        full_depth = registry.get_config(arch).num_layers
        log(f"  {run}: {arch} at its published width, {cfg.num_layers} of "
            f"{full_depth} layers{'' if depth is None else ' (cut)'}, "
            f"{n:,} parameters; batch {FAMILY_B}, prompt {prompt}"
            f"{f' + {cfg.num_image_tokens} image tokens' if cfg.num_image_tokens else ''}"
            f", {FAMILY_STEPS} decode steps, KV cache {max_len}; {smi}")
        empty_cache(torch)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        if run == "moe-dropfree":
            model = build_model(cfg.with_overrides(
                capacity_factor=DROPFREE_CAPACITY), device=DEVICE)
            session = dict(moe, model=model)
            with RouteLog(torch) as served:
                session["generation"] = serve.generate(
                    model, session["params"], session["tokens"],
                    FAMILY_STEPS, max_len=max_len, keep_logits=True,
                    inputs=session["inputs"])
            moe = None
        else:
            session = {}
            argv = ["--arch", arch, "--full", "--batch", str(FAMILY_B),
                    "--prompt-len", str(prompt), "--decode-tokens",
                    str(FAMILY_STEPS), "--seed", str(seed), "--device",
                    DEVICE] + ([] if depth is None else
                               ["--layers", str(depth)])
            rc = serve.main(argv, session=session)
            check(rc == 0, f"serve {run}: exit {rc}")
            check(session["model"].cfg == cfg, f"serve {run}: config")
        counts[f"serve-{run}"] = kernel_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        gen = session["generation"]
        check(tuple(gen.tokens.shape) == (FAMILY_B, FAMILY_STEPS + 1),
              f"serve {run}: tokens {tuple(gen.tokens.shape)}")
        got = torch.stack(gen.logits, dim=1)
        check(bool(torch.isfinite(got).all()), f"serve {run}: non-finite")
        model, params = session["model"], session["params"]
        if run == "moe":
            what = "prefill logits vs apply on the prompt"
            tokens = session["tokens"]
            got = got[:, :1]
        else:
            what = (f"teacher-forced over {FAMILY_STEPS + 1} positions")
            tokens = torch.cat([session["tokens"],
                                gen.tokens[:, :FAMILY_STEPS]], 1)
        with (RouteLog(torch) if run == "moe-dropfree"
              else contextlib.nullcontext()) as forced:
            logits, _ = model.apply(params, {"tokens": tokens,
                                             **session["inputs"]})
        want = logits[:, prompt - 1:prompt - 1 + got.shape[1]].clone()
        del logits
        row_err = (got - want).abs().amax((1, 2))
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        held = torch.ones_like(row_err, dtype=torch.bool)
        if run == "moe-dropfree":
            # a top-k near-tie may route a token to another expert set when
            # the pass has another batch shape (f32 sums in another
            # order); the row it feeds then differs by more than the
            # rounding.  Rows whose every token routes alike in both
            # passes are held to TF_ATOL; each row's first tokens routed
            # apart must be near-ties; most rows must be held.
            n_moe = cfg.layer_kinds.count("moe")
            flipped, gaps = routing_flips(torch, served.calls, forced.calls,
                                          n_moe, FAMILY_B, prompt,
                                          FAMILY_STEPS)
            held = ~flipped
            worst_gap = float(gaps.max()) if gaps.numel() else 0.0
            check(worst_gap <= NEAR_TIE, f"serve {run}: a token first "
                  f"routed apart at a probability gap of {worst_gap:.3g} > "
                  f"{NEAR_TIE}")
            check(int(held.sum()) * 2 >= FAMILY_B, f"serve {run}: "
                  f"{int(flipped.sum())} of {FAMILY_B} rows routed apart")
            what += (f"; {gaps.numel()} tokens first routed apart by "
                     f"near-ties (gap <= {worst_gap:.3g}) in rows "
                     f"{flipped.nonzero().flatten().tolist()}, whose max "
                     f"|dlogit| is {float(row_err[flipped].max()) if flipped.any() else 0.0:.3g}"
                     f"; the {int(held.sum())} other rows")
            del served, forced
        err = float(row_err[held].max())
        check(err <= TF_ATOL, f"serve {run}: {what}: max |dlogit| "
              f"{err:.3g} > {TF_ATOL}")
        del got, want, tokens
        empty_cache(torch)
        prof = decode_profile(torch, session, smi, prompt,
                              label=f"{run} decode profile")
        decode_ms = gen.decode_s * 1e3 / FAMILY_STEPS
        log(f"  serve {run}: prefill {gen.prefill_s * 1e3:.1f} ms "
            f"({FAMILY_B * prompt / gen.prefill_s:.0f} tok/s); decode "
            f"{decode_ms:.2f} ms/step ({FAMILY_B * 1e3 / decode_ms:.0f} "
            f"tok/s); device {prof.get('busy_ms', float('nan')):.3f} "
            f"ms/step, idle share {prof.get('idle', float('nan')):.3f}; "
            f"peak {peak:.2f} GiB; {what}: max |dlogit| {err:.3g} (argmax "
            f"agreement {agree:.3f}); {smi}")
        if run == "moe":
            moe = session
        del session, gen, model, params
        empty_cache(torch)


# ---------------------------------------------------------------------------
# phase 2d: the training round at full width and depth
# ---------------------------------------------------------------------------
ROUND_PARTS = ("round.local_sgd", "round.privatize", "round.encode",
               "round.uniforms", "round.sum", "round.decode")


def round_breakdown(tel) -> list:
    """Per ``round.execute`` span: {total, part: ms} from its fenced inner
    spans (``round.sum`` and ``round.uniforms`` nest in ``round.encode``
    when the round encodes; encode is reported without them)."""
    by_sid = {sp.sid: sp for sp in tel.spans}

    def root(sp):
        while sp.parent is not None and sp.name != "round.execute":
            sp = by_sid[sp.parent]
        return sp.sid if sp.name == "round.execute" else None

    rounds = {sp.sid: {"total": sp.dur_ns / 1e6, **dict.fromkeys(
        ROUND_PARTS, 0.0)} for sp in tel.spans if sp.name == "round.execute"}
    for sp in tel.spans:
        r = root(sp) if sp.name in ROUND_PARTS else None
        if r is not None:
            rounds[r][sp.name] += sp.dur_ns / 1e6
    out = []
    for sid in sorted(rounds):
        b = rounds[sid]
        if b["round.encode"]:
            b["round.encode"] -= b["round.uniforms"] + b["round.sum"]
        out.append(b)
    return out


def _finite_metrics(history) -> bool:
    import math
    return all(math.isfinite(m[k]) for m in history
               for k in ("loss", "clip_fraction", "update_norm"))


def train_path(torch, seed: int, counts: dict, smi: str) -> dict:
    """Phase 2d; ``counts[run]`` gets the kernel counts of each run.
    Returns the CLI run's final params and its checkpoint's save seconds
    (phase 2h serves that checkpoint)."""
    import math
    from repro_torch import tree as T
    from repro_torch.checkpoint import checkpoint as ck
    from repro_torch.configs import registry
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import telemetry as tele
    from repro_torch.core.fl import aggregation as agg
    from repro_torch.core.fl import round as fl_round
    from repro_torch.data.synthetic import fl_token_batch
    from repro_torch.kernels import prf
    from repro_torch.launch import train
    from repro_torch.models.model import build_model

    # 1. the train CLI at full width: its lines, its time split, its memory;
    # it checkpoints after round CKPT_EVERY (the save timed)
    tel = tele.Telemetry(record_spans=True, fence=True)
    prev = tele.set_default(tel)
    session, save_s, save = {}, [], ck.save

    def timed_save(*a, **kw):
        t0 = time.perf_counter()
        save(*a, **kw)
        save_s.append(time.perf_counter() - t0)

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    try:
        ck.save = timed_save
        reset_counts()
        base = 0
        if DEVICE == "cuda":
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        rc = train.main(TRAIN_ARGS + [
            "--seed", str(seed), "--log-every", "1", "--device", DEVICE,
            "--checkpoint-dir", str(CKPT_DIR), "--checkpoint-every",
            str(CKPT_EVERY)], session=session)
        counts["train-full"] = kernel_counts()
    finally:
        ck.save = save
        tele.set_default(prev)
    check(len(save_s) == TRAIN_ROUNDS // CKPT_EVERY,
          f"train: {len(save_s)} checkpoints saved")
    check(rc == 0, f"train: exit {rc}")
    hist = session["metrics"]
    check(len(hist) == TRAIN_ROUNDS and _finite_metrics(hist),
          f"train: non-finite round metrics {hist}")
    n = sum(int(x.numel()) for x in T.leaves(session["state"].params))
    leaves = len(T.leaves(session["state"].params))
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30
            if DEVICE == "cuda" else float("nan"))
    log(f"  train {TRAIN_ARCH}: {n:,} parameters in {leaves} leaves, cohort "
        f"{TRAIN_COHORT}, sequence {TRAIN_SEQ}, {TRAIN_ROUNDS} rounds; peak "
        f"device memory {peak:.2f} GiB; {smi}")
    check(leaves == TRAIN_LEAVES, f"train: {leaves} leaves")
    for r, b in enumerate(round_breakdown(tel)):
        parts = "; ".join(f"{k.split('.')[1]} {b[k]:.1f}"
                          for k in ROUND_PARTS)
        log(f"  train round {r}: {b['total']:.1f} ms = {parts} (ms; encode "
            f"without its uniforms and sums); loss {hist[r]['loss']:.4f} "
            f"clip% {hist[r]['clip_fraction']:.2f} |u| "
            f"{hist[r]['update_norm']:.3f}")
    # the run's own peak (params, state, rounds), beyond what was held
    MEASURED["round"] = {
        "ms": min(b["total"] for b in round_breakdown(tel)),
        "peak_bytes": torch.cuda.max_memory_allocated() - base
        if DEVICE == "cuda" else 0}
    stash = {"params": session["state"].params, "save_s": save_s[-1]}
    del session
    empty_cache(torch)

    # 2. bits 32 and bits 0 from the same params, batch and key, noise 0
    cfg = registry.get_config(TRAIN_ARCH, reduced=TRAIN_REDUCED)
    cfg = cfg.with_overrides(max_seq_len=max(TRAIN_SEQ, 64))
    model = build_model(cfg, device=DEVICE)
    params = model.init(prf.PRNGKey(seed))
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in fl_token_batch(
        TRAIN_COHORT, TRAIN_SEQ, cfg.vocab_size, seed=seed + 1).items()}
    rng = prf.fold_in(prf.PRNGKey(seed), 10_000)
    news, times = {}, {}
    for bits in (32, 0):
        fl = FLConfig(cohort_size=TRAIN_COHORT, local_lr=0.5, clip_norm=1.0,
                      noise_multiplier=0.0, secure_agg_bits=bits)
        step = fl_round.build_round_step(model.loss_fn, fl,
                                         cohort_size=TRAIN_COHORT,
                                         device=DEVICE)
        reset_counts()
        t0 = time.perf_counter()
        new, met = step(fl_round.init_fl_state(params, fl), batch, rng)
        sync(torch)
        times[bits] = (time.perf_counter() - t0) * 1e3
        counts[f"round-bits{bits}"] = kernel_counts()
        check(math.isfinite(float(met["loss"])), f"bits {bits}: loss")
        news[bits] = new.params
        del new, step
        empty_cache(torch)
    scale = agg.fixed_point_scale(FLConfig(secure_agg_bits=32), TRAIN_COHORT)
    # the two sums differ by < 1 fixed-point level per client: the mean by
    # <= 1/scale, plus an ulp of |p| where p + delta rounds the other way
    atol = TRAIN_COHORT / scale
    worst = 0.0
    for a, b in zip(T.leaves(news[32]), T.leaves(news[0])):
        d = (a - b).abs()
        worst = max(worst, float(d.max()))
        check(bool((d <= atol + 2.4e-7 * b.abs()).all()),
              f"bits 32 vs bits 0: max |dp| {float(d.max()):.3g} > "
              f"{atol:.3g} + 2 ulp")
    log(f"  round at bits 32 ({times[32]:.0f} ms) vs bits 0 "
        f"({times[0]:.0f} ms), noise 0, the same params/batch/key: max "
        f"|dparam| {worst:.3g} (bound {atol:.3g} + 2 ulp of |p|)")
    del news, params, model
    empty_cache(torch)

    # 3. masked vs unmasked, bit-equal (depth cut to MASKED_LAYERS); the
    # two local-SGD passes must agree bit for bit, so torch runs its
    # deterministic algorithms here (the embedding's index backward)
    torch.use_deterministic_algorithms(True, warn_only=True)
    cfg2 = cfg.with_overrides(num_layers=MASKED_LAYERS)
    model = build_model(cfg2, device=DEVICE)
    params = model.init(prf.PRNGKey(seed))
    outs = {}
    for masked in (True, False):
        fl = FLConfig(cohort_size=TRAIN_COHORT, local_lr=0.5, clip_norm=1.0,
                      noise_multiplier=0.0, secure_agg_bits=32,
                      secure_agg_masked=masked)
        step = fl_round.build_round_step(model.loss_fn, fl,
                                         cohort_size=TRAIN_COHORT,
                                         device=DEVICE)
        reset_counts()
        t0 = time.perf_counter()
        new, _ = step(fl_round.init_fl_state(params, fl), batch, rng)
        sync(torch)
        counts[f"round-{'masked' if masked else 'unmasked'}"] = \
            kernel_counts()
        outs[masked] = (new.params, (time.perf_counter() - t0) * 1e3)
    same = all(torch.equal(a, b) for a, b in zip(
        T.leaves(outs[True][0]), T.leaves(outs[False][0])))
    torch.use_deterministic_algorithms(False)
    check(same, "the masked round's params differ from the unmasked round's")
    log(f"  {MASKED_LAYERS}-layer round, masked ({outs[True][1]:.0f} ms) "
        f"and unmasked ({outs[False][1]:.0f} ms): params bit-equal")
    del outs, params, model, batch
    empty_cache(torch)

    # 4. the paper's classifier: the loss falls
    session = {}
    reset_counts()
    rc = train.main(CLASSIFIER_ARGS + ["--seed", str(seed), "--device",
                                       DEVICE], session=session)
    counts["train-classifier"] = kernel_counts()
    losses = [m["loss"] for m in session["metrics"]]
    check(rc == 0 and _finite_metrics(session["metrics"]),
          "classifier: failed or non-finite")
    late = statistics.mean(losses[-5:])
    check(late < losses[0], f"classifier: loss {losses[0]:.4f} -> {late:.4f}")
    log(f"  classifier, {CLASSIFIER_ROUNDS} rounds: loss {losses[0]:.4f} -> "
        f"{late:.4f} (mean of the last 5)")
    return stash


# ---------------------------------------------------------------------------
# phase 2h: the standalone protocol, checkpoints, training the other families
# ---------------------------------------------------------------------------
def checkpoint_path(torch, seed: int, stash: dict, counts: dict,
                    smi: str) -> None:
    """Phase 2d's ``step_2`` restored ``torch.equal`` to that run's final
    params; ``serve.main --checkpoint`` at phase 2c's settings prints
    ``restored step 2`` and samples what ``generate`` samples on the
    trained params passed directly.  The directory is deleted after."""
    from repro_torch import tree as T
    from repro_torch.checkpoint import checkpoint as ck
    from repro_torch.launch import serve
    path = CKPT_DIR / f"step_{CKPT_EVERY}"
    check(ck.latest_step_dir(str(CKPT_DIR)) == str(path),
          f"latest checkpoint {ck.latest_step_dir(str(CKPT_DIR))}")
    nbytes = os.path.getsize(path / "payload.msgpack")
    sync(torch)
    t0 = time.perf_counter()
    tree, manifest = ck.restore(str(path), device=DEVICE)
    sync(torch)
    restore_s = time.perf_counter() - t0
    check(manifest["step"] == CKPT_EVERY
          and manifest["metadata"]["arch"] == TRAIN_ARCH,
          f"checkpoint manifest {manifest['step']}, {manifest['metadata']}")
    want_paths, want = T.flatten(stash["params"])
    got_paths, got = T.flatten(tree["params"])
    check(got_paths == want_paths and all(
        torch.equal(a, b) for a, b in zip(got, want)),
        "the restored checkpoint differs from the trained params")
    del tree, got
    empty_cache(torch)
    log(f"  checkpoint {path.name}: payload {nbytes:,} bytes, save "
        f"{stash['save_s']:.2f} s, restore to {DEVICE} {restore_s:.2f} s "
        f"(read, sha256, decode, copy); params torch.equal to the trained "
        f"ones; {smi}")
    session, out = {}, io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(out):
        rc = serve.main(SERVE_ARGS + ["--seed", str(seed), "--device",
                                      DEVICE, "--checkpoint", str(path)],
                        session=session)
    counts["serve-checkpoint"] = kernel_counts()
    lines = out.getvalue().splitlines()
    for line in lines:
        log(f"    | {line}")
    check(rc == 0 and lines[0] == f"restored step {CKPT_EVERY}",
          f"serve --checkpoint: exit {rc}, {lines[:1]}")
    reset_counts()
    gen = serve.generate(session["model"], stash["params"],
                         session["tokens"], SERVE_STEPS,
                         inputs=session["inputs"])
    counts["serve-trained"] = kernel_counts()
    served = session["generation"]
    check(torch.equal(gen.tokens, served.tokens),
          "the checkpoint's sample differs from the trained params'")
    log(f"  serve --checkpoint: prefill {served.prefill_s * 1e3:.1f} ms, "
        f"decode {served.decode_s * 1e3 / SERVE_STEPS:.2f} ms/step; its "
        f"{SERVE_B} x {SERVE_STEPS + 1} tokens equal generate() on the "
        f"trained params")
    del session, gen, served
    stash.clear()
    shutil.rmtree(CKPT_DIR)
    empty_cache(torch)


def protocol_path(torch, seed: int, counts: dict, smi: str) -> None:
    """The single-row protocol at the embedding chunk: K1 through
    ``encode_masked_contribution`` ``torch.equal`` to its plain branch; 8
    masked rows, slots ``PROTO_ABSENT`` absent, flushed with recovery
    ``torch.equal`` to the unmasked flush of the survivors'
    ``encode_contribution`` rows; ``secure_aggregate`` of 8 updates of
    2^20 on the card bit-equal to the CPU's, its masks summing to 0."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.core.fl import aggregation as agg
    from repro_torch.core.fl import secure_agg as sa
    from repro_torch.kernels import prf
    spec = agg.make_spec(FLConfig(clip_norm=1.0, secure_agg_bits=32,
                                  noise_multiplier=0.0), PROTO_ROWS)
    key = prf.PRNGKey(seed)
    sess = agg.make_mask_session(spec, prf.fold_in(key, 0x5E55))
    flush_rng = prf.fold_in(key, 0xF1)

    def delta(b):
        g = torch.Generator(device=DEVICE).manual_seed(seed * 7919 + 500 + b)
        return torch.randn(EMBED, generator=g, device=DEVICE) * DELTA_SCALE

    reset_counts()
    rows = torch.empty((PROTO_ROWS, EMBED), dtype=torch.int32, device=DEVICE)
    enc_ms = []
    for b in range(PROTO_ROWS):
        x, rng = delta(b), prf.fold_in(key, b)
        sync(torch)
        t0 = time.perf_counter()
        rows[b] = agg.encode_masked_contribution(x, 1.0, b, spec, sess,
                                                 rng)[0]
        sync(torch)
        enc_ms.append((time.perf_counter() - t0) * 1e3)
        if b == 0:
            t0 = time.perf_counter()
            alt = agg.encode_masked_contribution(x, 1.0, b, spec, sess, rng,
                                                 use_kernel=False)[0]
            sync(torch)
            plain_ms = (time.perf_counter() - t0) * 1e3
            check(torch.equal(rows[0], alt),
                  "K1's masked row differs from the plain branch")
            del alt
        del x
    present = [0 if b in PROTO_ABSENT else 1 for b in range(PROTO_ROWS)]
    survivors = [b for b in range(PROTO_ROWS) if present[b]]
    sync(torch)
    t0 = time.perf_counter()
    got = agg.aggregate_masked_buffer(rows, present, float(len(survivors)),
                                      spec, sess, flush_rng)
    sync(torch)
    flush_ms = (time.perf_counter() - t0) * 1e3
    del rows
    empty_cache(torch)
    plain = torch.stack([agg.encode_contribution(
        delta(b), 1.0, spec, prf.fold_in(key, b))[0] for b in survivors])
    want = agg.aggregate_masked_buffer(plain, [1] * len(survivors),
                                       float(len(survivors)), spec, None,
                                       flush_rng, masked=False)
    check(torch.equal(got, want), "the recovered masked flush differs from "
          "the survivors' unmasked flush")
    del plain, got, want
    empty_cache(torch)
    log(f"  protocol at the {EMBED:,}-wide embedding chunk, {PROTO_ROWS} "
        f"slots: encode_masked_contribution (K1) median "
        f"{statistics.median(enc_ms):.2f} ms, torch.equal to its plain "
        f"branch ({plain_ms:.0f} ms); flush with slots {PROTO_ABSENT} "
        f"recovered {flush_ms:.0f} ms, torch.equal to the unmasked flush of "
        f"the {len(survivors)} survivors; {smi}")
    g = torch.Generator().manual_seed(seed + 3)
    ups = [torch.randn(SECAGG_D, generator=g) * 0.3
           for _ in range(SECAGG_UPDATES)]
    srng = prf.fold_in(key, 0xA66)
    sync(torch)
    t0 = time.perf_counter()
    on_card = sa.secure_aggregate([u.to(DEVICE) for u in ups], SECAGG_BITS,
                                  4.0, seed=seed, rng=srng)
    sync(torch)
    card_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    on_cpu = sa.secure_aggregate(ups, SECAGG_BITS, 4.0, seed=seed,
                                 rng=srng)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    peers = list(range(SECAGG_UPDATES))
    zero = sa.aggregate_masked([sa.pairwise_mask(
        (SECAGG_D,), c, peers, seed, device=DEVICE) for c in peers])
    check(torch.equal(on_card.cpu(), on_cpu), "secure_aggregate on the card "
          "differs from the CPU's")
    check(not bool(zero.any()), "the pairwise masks do not sum to 0")
    # stochastic rounding moves each value by less than one level
    step = 4.0 / (2 ** (SECAGG_BITS - 1) - 1)
    err = float((on_cpu - torch.stack(ups).mean(0)).abs().max())
    check(err <= 2 * step, f"secure_aggregate is {err:.3g} from the mean")
    counts["protocol"] = kernel_counts()
    log(f"  secure_aggregate of {SECAGG_UPDATES} x {SECAGG_D:,} (bits "
        f"{SECAGG_BITS}, stochastic rounding): {card_ms:.0f} ms on the card, "
        f"bit-equal to the CPU's ({cpu_ms:.0f} ms); masks sum to 0; max "
        f"|mean error| {err:.3g} (one level {step:.3g})")


def _family_batch(torch, cfg, cohort: int, seed: int, r: int) -> dict:
    """train.py's round batch: token streams and, for a VLM or audio model,
    its stub embeddings ``0.02 * normal(fold_in(key, r))``."""
    from repro_torch.data.synthetic import fl_token_batch
    from repro_torch.kernels import prf
    b = fl_token_batch(cohort, FAMILY_SEQ, cfg.vocab_size,
                       seed=seed * 7919 + r)
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in b.items()}
    n = {"vlm": cfg.num_image_tokens, "audio": cfg.encoder_seq}.get(
        cfg.family)
    if n is not None:
        z = prf.normal(prf.fold_in(prf.PRNGKey(seed), r),
                       (cohort, 1, n, cfg.d_model), device=DEVICE)
        name = "patch_embeds" if cfg.family == "vlm" else "audio_embeds"
        batch[name] = z * torch.tensor(0.02, device=DEVICE)
    return batch


def _log_round(tel, run: str, hist, peak: float, smi: str) -> None:
    for r, b in enumerate(round_breakdown(tel)):
        parts = "; ".join(f"{k.split('.')[1]} {b[k]:.1f}"
                          for k in ROUND_PARTS)
        log(f"  {run} round {r}: {b['total']:.1f} ms = {parts} (ms); loss "
            f"{hist[r]['loss']:.4f} clip% {hist[r]['clip_fraction']:.2f} "
            f"|u| {hist[r]['update_norm']:.3f}; peak {peak:.2f} GiB; {smi}")


def _moved(torch, a, b) -> bool:
    from repro_torch import tree as T
    return any(not torch.equal(x, y) for x, y in zip(T.leaves(a),
                                                     T.leaves(b)))


def family_train_path(torch, seed: int, counts: dict, smi: str) -> dict:
    """Each family of FAMILY_TRAIN trained at its published width: one
    round at sequence FAMILY_SEQ, bits 32, noise 0 (``train.main`` or
    ``build_round_step``); its metrics finite, its params moved, its round
    split by the ``round.*`` spans, its peak memory.  The MoE round runs
    masked and unmasked (bit-equal); whisper-tiny at bits 32 and bits 0
    (within the fixed-point resolution).  Returns each run's launches."""
    import math
    from repro_torch import tree as T
    from repro_torch.configs import registry
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import telemetry as tele
    from repro_torch.core.fl import aggregation as agg
    from repro_torch.core.fl import round as fl_round
    from repro_torch.kernels import prf
    from repro_torch.launch import serve, train
    from repro_torch.models.model import build_model, param_shapes
    want = {}
    key = prf.PRNGKey(seed)
    for run, arch, depth, cohort, n_params, n_leaves, how in FAMILY_TRAIN:
        cfg = registry.get_config(arch, reduced=not FAMILY_FULL)
        cfg = cfg.with_overrides(max_seq_len=max(FAMILY_SEQ, 64))
        if depth:
            cfg = serve.cut_depth(cfg, depth)
        shapes = T.leaves(param_shapes(cfg))
        n = sum(math.prod(s) for s in shapes)
        check(n == n_params and len(shapes) == n_leaves,
              f"{run}: {n} parameters in {len(shapes)} leaves")
        log(f"  {run}: {arch}{f' ({depth} layers)' if depth else ''}, "
            f"{n:,} parameters in {n_leaves} leaves, cohort {cohort}, "
            f"sequence {FAMILY_SEQ}")
        per_round = dict(sq_norms=n_leaves, quantize_mask=cohort * n_leaves,
                         dequantize=n_leaves)
        tel = tele.Telemetry(record_spans=True, fence=True)
        _peak_gib(torch, reset=True)
        if how == "cli":
            session = {}
            prev = tele.set_default(tel)
            try:
                reset_counts()
                rc = train.main(
                    ["--arch", arch, "--rounds", str(FAMILY_ROUNDS),
                     "--cohort", str(cohort), "--seq-len", str(FAMILY_SEQ),
                     "--noise", "0", "--log-every", "1", "--seed",
                     str(seed), "--device", DEVICE]
                    + (["--full"] if FAMILY_FULL else []), session=session)
                counts[run] = kernel_counts()
            finally:
                tele.set_default(prev)
            peak = _peak_gib(torch)
            check(rc == 0 and _finite_metrics(session["metrics"]),
                  f"{run}: exit {rc}, metrics {session['metrics']}")
            model, hist = session["model"], session["metrics"]
            new = session["state"].params
            del session
            params = model.init(key)
        else:
            model = build_model(cfg, device=DEVICE)
            params = model.init(key)
        batch = _family_batch(torch, cfg, cohort, seed, 0)
        rng = prf.fold_in(key, 10_000)

        def round_once(bits, masked=False, name=run):
            fl = FLConfig(cohort_size=cohort, local_lr=0.5, clip_norm=1.0,
                          noise_multiplier=0.0, secure_agg_bits=bits,
                          secure_agg_masked=masked)
            t = tele.Telemetry(record_spans=True, fence=True)
            step = fl_round.build_round_step(model.loss_fn, fl,
                                             cohort_size=cohort,
                                             telemetry=t, device=DEVICE)
            _peak_gib(torch, reset=True)
            reset_counts()
            out, met = step(fl_round.init_fl_state(params, fl), batch, rng)
            counts[name] = kernel_counts()
            h = [{k: float(v) for k, v in met.items()}]
            check(_finite_metrics(h), f"{name}: non-finite {h}")
            return out.params, h, t, _peak_gib(torch)

        if how == "round":
            if cfg.family == "moe":
                torch.use_deterministic_algorithms(True, warn_only=True)
                masked, _, _, _ = round_once(32, True, f"{run}-masked")
                want[f"{run}-masked"] = per_round
            new, hist, tel, peak = round_once(32)
            if cfg.family == "moe":
                torch.use_deterministic_algorithms(False)
                check(not _moved(torch, masked, new),
                      f"{run}: the masked round differs from the unmasked")
                log(f"  {run}: the masked round's params bit-equal to the "
                    f"unmasked round's")
                del masked
        rounds = FAMILY_ROUNDS if how == "cli" else 1
        want[run] = {k: rounds * v for k, v in per_round.items()}
        _log_round(tel, run, hist, peak, smi)
        check(_moved(torch, params, new), f"{run}: the params did not move")
        if cfg.family == "audio":
            news = {}
            for bits in (32, 0):
                news[bits], _, _, _ = round_once(bits, name=f"{run}-bits{bits}")
            want[f"{run}-bits32"] = per_round
            want[f"{run}-bits0"] = dict(sq_norms=n_leaves,
                                        scale_accum=n_leaves)
            scale = agg.fixed_point_scale(FLConfig(secure_agg_bits=32),
                                          cohort)
            atol = cohort / scale
            worst = max(float((a - b).abs().max()) for a, b in zip(
                T.leaves(news[32]), T.leaves(news[0])))
            check(all(bool(((a - b).abs() <= atol + 2.4e-7 * b.abs()).all())
                      for a, b in zip(T.leaves(news[32]),
                                      T.leaves(news[0]))),
                  f"{run}: bits 32 vs bits 0 max |dp| {worst:.3g}")
            log(f"  {run}: bits 32 vs bits 0 from the same params, batch and "
                f"key: max |dparam| {worst:.3g} (bound {atol:.3g} + 2 ulp)")
            del news
        del model, params, new, batch
        empty_cache(torch)
    return want


def empty_cache(torch) -> None:
    if DEVICE == "cuda":
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 2j: the cost harness
# ---------------------------------------------------------------------------
def cost_path(smi: str) -> None:
    """Phase 2j.  (a) ``python -m repro_torch.launch.dryrun`` at full width
    on the production mesh for ``DRYRUN_PAIRS``: each pair OK (or the
    recorded skip), its dominant term, bound and peak.  (b) The builders at
    phases 2c's and 2d's shapes on one device: each whole-step bound must
    not exceed what the smoke measured for the same work (a decode step's
    device-busy ms, a round's fenced ``round.execute`` ms), and each
    estimated peak must fall within ``PEAK_BAND`` of the card's
    ``max_memory_allocated`` for that work."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import analysis, dryrun, lowering, train
    out = ROOT / "build" / "smoke_dryrun.jsonl"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.unlink(missing_ok=True)
    t0 = time.perf_counter()
    for arch, shape in DRYRUN_PAIRS:
        rc = dryrun.main(["--arch", arch, "--shape", shape,
                          "--out", str(out)])
        check(rc == 0, f"dryrun {arch} x {shape}: exit {rc}")
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    check(len(lines) == len(DRYRUN_PAIRS), f"dryrun: {len(lines)} lines")
    for res in lines:
        if "skipped" in res:
            check((res["arch"], res["shape"]) in registry.SKIPS,
                  f"dryrun: {res['arch']} x {res['shape']} skipped")
            log(f"  {res['arch']} x {res['shape']}: SKIP (recorded)")
            continue
        r = res["roofline"]
        log(f"  {res['arch']} x {res['shape']} on 16 x 16: "
            f"{r['dominant']}-bound, {r['bound_time_s'] * 1e3:.4g} ms "
            f"(compute {r['t_compute_s'] * 1e3:.4g}, memory "
            f"{r['t_memory_s'] * 1e3:.4g}, collective "
            f"{r['t_collective_s'] * 1e3:.4g}); peak "
            f"{res['memory']['peak_bytes_est'] / 2 ** 30:.2f} GiB; "
            f"replicated {res['replicated_regions'] or 'none'}")
    log(f"  dryrun: {len(lines)} pairs in {time.perf_counter() - t0:.1f} s "
        "(counted on the host; the bounds model this card)")

    # (b) the whole step against the card's own measurements
    cfg = registry.get_config("qwen2-1.5b")
    targs = train.parse_args(TRAIN_ARGS)
    steps = (
        ("decode", lowering.build_decode,
         ShapeConfig("serve", SERVE_S + SERVE_STEPS, SERVE_B, "decode"),
         cfg, {"dtype": "float32"}, {},
         MEASURED["decode"]["busy_ms"], "device-busy ms a decode step"),
        ("round", lowering.build_train,
         ShapeConfig("smoke", TRAIN_SEQ, TRAIN_COHORT, "train"),
         registry.get_config(TRAIN_ARCH, reduced=TRAIN_REDUCED)
         .with_overrides(max_seq_len=max(TRAIN_SEQ, 64)),
         {"dtype": "float32",
          "clients_per_chunk": train.clients_per_chunk(targs)},
         {"fl_cfg": train.fl_config(targs)}, MEASURED["round"]["ms"],
         "fenced round.execute ms"),
    )
    for name, build, shape, c, opts, kw, meas_ms, what in steps:
        t0 = time.perf_counter()
        run, depths = lowering.run_step(build, c, shape, opts=opts, **kw)
        roof = analysis.roofline(run.counts)
        mem = analysis.memory_summary(run.memory)
        bound_ms = roof["bound_time_s"] * 1e3
        est = mem["peak_bytes_est"]
        peak = MEASURED[name]["peak_bytes"]
        ct = roof["compute_terms"]
        log(f"  {name} (qwen2-1.5b f32, {shape.global_batch} x "
            f"{shape.seq_len}, one device; depths {depths}): bound "
            f"{bound_ms:.3f} ms by {roof['dominant']} ({roof['bytes_per_device'] / 1e9:.2f} GB;"
            f" matmul {ct['matmul_s'] * 1e3:.3f} ms, float "
            f"{ct['float_s'] * 1e3:.3f} ms, integer "
            f"{ct['integer_s'] * 1e3:.3f} ms); measured {meas_ms:.3f} "
            f"{what}: measured / bound {meas_ms / bound_ms:.2f}; peak "
            f"estimated {est / 2 ** 30:.2f} GiB vs max_memory_allocated "
            f"{peak / 2 ** 30:.2f} GiB ({est / peak:.3f}); counted in "
            f"{time.perf_counter() - t0:.1f} s; {smi}")
        check(bound_ms <= meas_ms, f"{name}: the bound {bound_ms:.3f} ms "
              f"exceeds the measured {meas_ms:.3f} ms: the count is wrong")
        check(PEAK_BAND[0] <= est / peak <= PEAK_BAND[1],
              f"{name}: estimated peak {est} B is {est / peak:.3f} of the "
              f"card's {peak} B, outside {PEAK_BAND}")


# ---------------------------------------------------------------------------
# phase 2e: federated analytics and the control plane
# ---------------------------------------------------------------------------
def _span_ms(tel, name: str) -> list:
    return [sp.dur_ns / 1e6 for sp in tel.spans if sp.name == name]


def analytics_path(torch, seed: int, counts: dict, smi: str) -> None:
    """Phase 2e; ``counts[run]`` gets the kernel counts of each run."""
    import math
    import numpy as np
    from repro_torch.core import telemetry as tele
    from repro_torch.core.analytics import bitagg as fa
    from repro_torch.data.synthetic import ClassifierTask
    from repro_torch.examples import federated_analytics as ex
    from repro_torch.examples import paper_pipeline as pp
    from repro_torch.kernels import prf

    # (a) the FA example at its own size: estimates against the truth
    session = {}
    reset_counts()
    t0 = time.perf_counter()
    rc = ex.main(["--device", DEVICE], session=session)
    sync(torch)
    ex_s = time.perf_counter() - t0
    counts["fa-example"] = kernel_counts()
    check(rc == 0, f"federated_analytics: exit {rc}")
    # a debiased 1-bit mean over N devices: std <= (hi-lo)/2/(1-p)/sqrt(N)
    sigma = (ex.HI - ex.LO) * 0.5 / (1 - ex.FLIP) / math.sqrt(ex.DEVICES)
    err = float(np.abs(session["mean_est"] - session["mean_true"]).max())
    check(err <= 5 * sigma, f"FA means off by {err:.1f} > 5 sigma "
          f"({5 * sigma:.1f})")
    grid = (ex.HI - ex.LO) / (ex.THRESHOLDS - 1)
    perr = max(float(np.abs(e - t).max())
               for e, t in session["percentiles"].values())
    check(perr <= 2 * grid, f"FA percentiles off by {perr:.1f} > two grid "
          f"steps ({2 * grid:.1f})")
    check(abs(session["ratio"] - 0.12) <= 0.03,
          f"FA label ratio {session['ratio']:.4f}")
    f = session["factors"]
    want = (session["raw"] - float(f.shift[0])) / float(f.scale[0])
    check(session["spec_version"] == 2 and math.isfinite(
        session["normalized"]) and abs(session["normalized"] - want)
          <= 1e-5 * max(1.0, abs(want)),
          f"pushed spec: normalized {session['normalized']} != {want}")
    log(f"  FA example ({ex.DEVICES:,} devices x {ex.FEATURES} features, "
        f"{ex.THRESHOLDS} thresholds, flip {ex.FLIP}): {ex_s:.1f} s; means "
        f"within {err:.1f} of the truth (5 sigma {5 * sigma:.1f}), "
        f"percentiles within {perr:.1f} (two grid steps {2 * grid:.1f}), "
        f"P(y=1) {session['ratio']:.3f}")
    del session

    # (b) tests/test_system.py's pipeline at its own size, its four gates
    session = {}
    tel = tele.Telemetry(record_spans=True, fence=True)
    prev = tele.set_default(tel)
    try:
        reset_counts()
        t0 = time.perf_counter()
        rc = pp.main(["--device", DEVICE], session=session)
        sync(torch)
        pp_s = time.perf_counter() - t0
        counts["fa-pipeline"] = kernel_counts()
    finally:
        tele.set_default(prev)
    check(rc == 0, f"paper_pipeline: exit {rc}")
    losses = session["losses"]
    late = statistics.mean(losses[-5:])
    check(late < 0.88 * losses[0], f"pipeline loss {losses[0]:.4f} -> "
          f"{late:.4f} (gate: < 0.88 x the first)")
    check(abs(session["pos_ratio"] - 0.1) <= 0.03,
          f"pipeline P(y=1) {session['pos_ratio']:.4f} (gate: 0.1 +- 0.03)")
    auc = float(session["derived"]["roc_auc"])
    check(auc > 0.70, f"pipeline roc_auc {auc:.4f} (gate: > 0.70)")
    eps = session["accountant"].epsilon(1e-6)
    check(math.isfinite(eps) and eps > 0, f"pipeline epsilon {eps}")
    rounds = _span_ms(tel, "round.execute")
    vote = _span_ms(tel, "fa.vote")
    parts = round_breakdown(tel)
    split = "; ".join(
        f"{k.split('.')[1]} {statistics.median(b[k] for b in parts):.1f}"
        for k in ROUND_PARTS)
    log(f"  pipeline ({pp.FA_DEVICES:,}-device FA sample, "
        f"{pp.THRESHOLDS} thresholds; {pp.ROUNDS} rounds at cohort "
        f"{pp.COHORT}): {pp_s:.1f} s; FA vote {vote[0]:.1f} ms; round "
        f"median {statistics.median(rounds):.1f} ms (first "
        f"{rounds[0]:.1f}) = {split} (medians, ms; encode without its "
        f"uniforms and sums); loss {losses[0]:.4f} -> {late:.4f}; P(y=1) "
        f"{session['pos_ratio']:.4f}; roc_auc {auc:.4f}; eps(1e-6) "
        f"{eps:.2f}; {smi}")
    del session

    # (c) a fleet-scale FA query: monotone, within FLEET_TOL of the truth
    task = ClassifierTask(num_features=FLEET_FEATURES, pos_ratio=0.1, seed=7)
    vals = torch.from_numpy(task.sample_devices(
        FLEET_DEVICES, rng_seed=seed + 77)["features_raw"]).to(DEVICE)
    thr = fa.linspace(-4096.0, 4096.0, FLEET_THRESHOLDS, device=DEVICE)
    tel = tele.Telemetry(record_spans=True, fence=True)
    prev = tele.set_default(tel)
    try:
        reset_counts()
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() if DEVICE == "cuda" else 0
        cdf = fa.threshold_cdf(vals, thr, prf.PRNGKey(seed), FLEET_FLIP)
        sync(torch)
        counts["fa-fleet"] = kernel_counts()
    finally:
        tele.set_default(prev)
    peak = ((torch.cuda.max_memory_allocated() - base) / 2 ** 30
            if DEVICE == "cuda" else float("nan"))
    total = _span_ms(tel, "fa.vote")[0]
    draws = sum(_span_ms(tel, "fa.vote.draws"))
    k9_ms = sum(_span_ms(tel, "fa.vote.bit_counts"))
    srt = torch.sort(vals, dim=0).values.T.contiguous()
    emp = torch.searchsorted(srt, thr.expand(FLEET_FEATURES, -1).contiguous(),
                             right=True).to(torch.float32) / FLEET_DEVICES
    gap = float((cdf - emp).abs().max())
    check(bool(torch.isfinite(cdf).all())
          and bool((cdf[:, 1:] >= cdf[:, :-1]).all()),
          "fleet CDF not finite and monotone")
    check(gap <= FLEET_TOL, f"fleet CDF off the empirical CDF by {gap:.4f} "
          f"> {FLEET_TOL}")
    tiles = len(_span_ms(tel, "fa.vote.bit_counts"))
    log(f"  fleet FA query ({FLEET_DEVICES:,} devices x {FLEET_FEATURES} x "
        f"{FLEET_THRESHOLDS}, flip {FLEET_FLIP}, {tiles} tiles): "
        f"{total:.1f} ms = draws "
        f"{draws:.1f} + K9 {k9_ms:.2f} + rest {total - draws - k9_ms:.1f}; "
        f"peak device memory {peak:.2f} GiB above the values; max |CDF - "
        f"empirical| {gap:.5f}; {smi}")
    del vals, cdf, srt, emp
    empty_cache(torch)


# ---------------------------------------------------------------------------
# phase 4: kernel times at the main path's largest shape
# ---------------------------------------------------------------------------
def _cycled(fn, n: int):
    """fn(0), fn(1), ... fn(n-1), fn(0), ... on successive calls."""
    state = [0]

    def call():
        i = state[0] % n
        state[0] += 1
        return fn(i)
    return call


def flash_decode_times(torch, launches: int) -> dict:
    """K10 at each of ``FD_SHAPES``: kernel, plain version, one
    ``scaled_dot_product_attention`` call; bound by bytes.  The serve
    shape's numbers are the entry's, the others nested under their
    names."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_decode as kfd
    g = torch.Generator(device="cuda").manual_seed(3)
    res = {}
    for shape, B, H, KV, hd, W, window in FD_SHAPES:
        nbytes = 2 * B * W * KV * hd * 4 + 2 * B * H * hd * 4 + W * 4
        # a decode step reads each layer's cache cold (the weights stream
        # between layers): caches under 100 MB take 8 copies, past the
        # 50 MB L2
        nbuf = 8 if nbytes < 1e8 else 1
        q = torch.randn(B, H, hd, generator=g, device="cuda") * hd ** -0.5
        ks = [torch.randn(B, W, KV, hd, generator=g, device="cuda")
              for _ in range(nbuf)]
        vs = [torch.randn(B, W, KV, hd, generator=g, device="cuda")
              for _ in range(nbuf)]
        pos = W - 1 + (32 if window else 0)  # a ring wrapped 32 slots
        slot = ring_slots(torch, W, pos, W)
        got = kfd.flash_decode(q, ks[0], vs[0], slot, pos, window=window)
        want = kfd.flash_decode_plain(q, ks[0], vs[0], slot, pos,
                                      window=window)
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, **FD_TOL),
              f"flash_decode != plain at {shape}: {err:.3g}")
        # the library yardstick: the rep query heads of a kv head as the
        # query length of one SDPA over (B, KV) heads; mask from slot_pos
        valid = (slot >= 0) & (slot <= pos)
        if window:
            valid &= (pos - slot) < window
        mask = valid.view(1, 1, 1, W)

        def sdpa(i):
            return F.scaled_dot_product_attention(
                q.view(B, KV, H // KV, hd), ks[i].permute(0, 2, 1, 3),
                vs[i].permute(0, 2, 1, 3), attn_mask=mask, scale=1.0)
        lib_err = float((sdpa(0).reshape(B, H, hd) - want).abs().max())
        del got, want
        reps = 10 if shape == "decode_32k" else 50
        kernel = _cycled(lambda i: kfd.flash_decode(
            q, ks[i], vs[i], slot, pos, window=window), nbuf)
        ms = _device_ms(torch, kernel, reps)
        call_ms = _cuda_ms(torch, kernel, reps)  # host launch cost included
        plain_ms = _device_ms(torch, _cycled(
            lambda i: kfd.flash_decode_plain(q, ks[i], vs[i], slot, pos,
                                             window=window), nbuf), 3)
        lib_ms = _device_ms(torch, _cycled(sdpa, nbuf), reps)
        # two products, and mask/max/exp/sum per score
        ops = 4 * B * H * W * hd + 5 * B * H * W
        e = _entry("flash_decode",
                   "src/repro_torch/kernels/csrc/flash_decode.cu",
                   "src/repro/kernels/flash_decode.py:62", launches, ms,
                   plain_ms, ops, nbytes, max_abs_err=err, library_ms=lib_ms)
        e["library_max_abs_err"] = lib_err
        nsplit = kfd.splits(
            B, KV, H // KV, W,
            sms=torch.cuda.get_device_properties(0).multi_processor_count,
            per_sm=kfd.ctas_per_sm("cuda", hd, False))
        e["splits"] = nsplit
        log(f"  flash_decode {shape} (B={B} H={H} KV={KV} hd={hd} W={W}"
            f"{f' window={window}' if window else ''}, f32, {nsplit} "
            f"splits merged in the launch): {ms:.4f} ms on the device, "
            f"{call_ms:.4f} ms per call back to back (bound "
            f"{e['bound_ms']:.4f} ms by {e['bound_by']}, "
            f"{nbytes / 1e6:.1f} MB); plain {plain_ms:.3f} ms; SDPA "
            f"{lib_ms:.4f} ms (max |err| {lib_err:.3g}); kernel max |err| "
            f"{err:.3g}")
        res[shape] = e
        del q, ks, vs, slot
        torch.cuda.empty_cache()
    entry = dict(res["serve"])
    for shape, *_ in FD_SHAPES[1:]:
        entry[shape] = {k: res[shape][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err", "splits")}
    return entry


def kernel_times(torch, counts) -> list:
    from repro_torch.kernels import prf
    from repro_torch.launch import analysis
    from repro_torch.kernels import secure_agg as ksa
    D = EMBED
    g = torch.Generator(device="cuda").manual_seed(2)
    scale = ((2 ** 31 - 1) / BUFFER - 1.0) / 4.0
    session = ksa.SessionMeta(key_words=(0x5A5E, 0xC401), num_slots=BUFFER)
    nbrs = BUFFER - 1
    out = []

    x = torch.randn(D, generator=g, device="cuda") * DELTA_SCALE
    run = lambda: ksa.quantize_mask_prf(x, scale, 3, (1, 2), session)  # noqa
    got = run()
    t0 = time.perf_counter()
    want = ksa.quantize_mask_prf_plain(x, scale, 3, (1, 2), session)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(torch.equal(got, want), "quantize_mask_prf != plain at full width")
    del want
    ms = _cuda_ms(torch, run, 5)
    # uniform + mask words, 2 words a Threefry; per element the scale
    # multiply, floor, subtract, compare, select, add, convert (7) and a
    # multiply-add per mask word
    evals = (1 + nbrs) * D / 2
    ops = evals * analysis.THREEFRY_OPS + D * (7 + nbrs)
    nbytes = D * 4 + D * 4
    out.append(_entry("quantize_mask_prf",
                      "src/repro_torch/kernels/csrc/quantize_mask_prf.cu",
                      "src/repro/kernels/secure_agg.py:203",
                      counts["quantize_mask_prf"], ms, plain_ms, ops, nbytes,
                      integer=True))
    del x, got
    torch.cuda.empty_cache()

    x = torch.randn(BUFFER, D, generator=g, device="cuda") * DELTA_SCALE
    w = torch.ones(BUFFER, device="cuda")
    u = prf.uniform_block(7, 8, BUFFER * D, device="cuda").reshape(BUFFER, D)
    run = lambda: ksa.weighted_quantize_accum(  # noqa
        x, w, u, scale, session=session)
    got = run()
    t0 = time.perf_counter()
    want = ksa.weighted_quantize_accum_plain(x, w, u, scale, session=session)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(torch.equal(got, want),
          "weighted_quantize_accum != plain at full width")
    del want
    ms = _cuda_ms(torch, run, 3)
    lane_ms = _cuda_ms(
        torch, lambda: ksa.weighted_quantize_accum(x, w, u, scale), 3)
    # every row's mask streams (the lane generates them all, though a full
    # session's masks cancel), 2 words a Threefry; per (row, element) the
    # two multiplies, floor, subtract, compare, select, add, convert, the
    # accumulate (9) and a multiply-add per mask word
    evals = BUFFER * nbrs * D / 2
    ops = evals * analysis.THREEFRY_OPS + BUFFER * D * (9 + nbrs)
    nbytes = 2 * BUFFER * D * 4 + BUFFER * 4 + D * 4
    k2 = _entry("weighted_quantize_accum",
                "src/repro_torch/kernels/csrc/weighted_quantize_accum.cu",
                "src/repro/kernels/secure_agg.py:417",
                counts[ksa.PRF_LANE], ms, plain_ms, ops, nbytes,
                integer=True)
    # the unmasked lane (batched off): the same bytes, no PRF
    lane = _entry("", "", "", 0, lane_ms, 0.0, BUFFER * D * 9, nbytes,
                  integer=True)
    k2.update(lane="PRF session masks (tee); launches are this lane's",
              unmasked_lane_launches=counts["weighted_quantize_accum"],
              unmasked_lane_ms=lane_ms,
              unmasked_lane_bound_ms=lane["bound_ms"],
              unmasked_lane_bound_by=lane["bound_by"])
    log(f"  weighted_quantize_accum unmasked lane ({BUFFER}x{D}): "
        f"{lane_ms:.3f} ms (bound {lane['bound_ms']:.3f} ms by "
        f"{lane['bound_by']})")
    out.append(k2)
    del x, w, u, got
    torch.cuda.empty_cache()

    # K4 at the embedding chunk: the sketch push's rotate + encode
    x = torch.randn(D, generator=g, device="cuda") * DELTA_SCALE
    okw = (0x1234, 0xCB01)
    run = lambda: ksa.rotate_quantize_prf(x, scale, okw, (1, 2),  # noqa
                                          u_offset=12345)
    got = run()
    t0 = time.perf_counter()
    want = ksa.rotate_quantize_prf_plain(x, scale, okw, (1, 2),
                                         u_offset=12345)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(torch.equal(got, want), "rotate_quantize_prf != plain at full "
          "width")
    del want
    ms = _cuda_ms(torch, run, 5)
    # the even-offset case (two counters a quad, where 12345 takes three)
    even_ms = _cuda_ms(torch, lambda: ksa.rotate_quantize_prf(
        x, scale, okw, (1, 2), u_offset=0), 5)
    full = int(got.numel())
    # one Threefry per two positions of each stream (sign and uniform, as
    # stream_block generates them), 9 butterfly adds, scale, round
    ops = full * analysis.THREEFRY_OPS + full * (9 + 5)
    nbytes = D * 4 + full * 4
    k4 = _entry("rotate_quantize_prf",
                "src/repro_torch/kernels/csrc/rotate_quantize_prf.cu",
                "src/repro/kernels/secure_agg.py:300",
                counts["rotate_quantize_prf"], ms, plain_ms, ops, nbytes,
                integer=True)
    k4["even_u_offset_ms"] = even_ms
    log(f"  rotate_quantize_prf at u_offset 0: {even_ms:.3f} ms")
    out.append(k4)
    del x, got
    torch.cuda.empty_cache()

    # K5 at the embedding chunk: the engine field at bits 16 and buffer 8
    # is 19 bits wide (the entries' numbers); 8 bits is the enclave wire
    q = torch.randint(0, 1 << 19, (D,), generator=g, device="cuda",
                      dtype=torch.int32)
    for bits in (19, 8):
        qb = q & ((1 << bits) - 1)
        nwords = -(-D * bits // 32)
        words = ksa.pack_residues(qb, bits)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = ksa.pack_residues_plain(qb, bits)
        torch.cuda.synchronize()
        pack_plain = (time.perf_counter() - t0) * 1e3
        check(torch.equal(words, want),
              f"pack_residues != plain at full width (bits {bits})")
        t0 = time.perf_counter()
        want = ksa.unpack_residues_plain(words, D, bits)
        torch.cuda.synchronize()
        unpack_plain = (time.perf_counter() - t0) * 1e3
        check(torch.equal(want, qb),
              f"unpack_residues plain round trip (bits {bits})")
        del want
        check(torch.equal(ksa.unpack_residues(words, D, bits), qb),
              f"unpack_residues round trip at full width (bits {bits})")
        pack_ms = _cuda_ms(torch, lambda: ksa.pack_residues(qb, bits), 10)
        unpack_ms = _cuda_ms(
            torch, lambda: ksa.unpack_residues(words, D, bits), 10)
        nbytes = D * 4 + nwords * 4
        pack = _entry("pack_residues",
                      "src/repro_torch/kernels/csrc/pack_residues.cu",
                      "src/repro/kernels/secure_agg.py:527",
                      counts["pack_residues"], pack_ms, pack_plain,
                      D * 4, nbytes)
        unpack = _entry("unpack_residues",
                        "src/repro_torch/kernels/csrc/pack_residues.cu",
                        "src/repro/kernels/secure_agg.py:570",
                        counts["unpack_residues"], unpack_ms, unpack_plain,
                        D * 6, nbytes)
        if bits == 19:
            out += [pack, unpack]
        for e in (pack, unpack):
            log(f"  {e['name']} bits {bits} ({D} residues): {e['ms']:.3f} "
                f"ms (bound {e['bound_ms']:.3f} ms by {e['bound_by']}; "
                f"plain {e['plain_ms']:.1f} ms)")
        del words, qb
    for e in out:
        log(f"  {e['name']}: {e['ms']:.3f} ms (bound {e['bound_ms']:.3f} ms "
            f"by {e['bound_by']}; plain {e['plain_ms']:.1f} ms)")
    return out


def _plain_ms(torch, fn):
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def round_kernel_times(torch, launches, smi: str) -> list:
    """K3, K8 at (4, ROUND_LEAF) and K6, K7 at (ROUND_LEAF,): kernel (CUDA
    events), plain version (host clock, once), one library call."""
    import math
    from repro_torch.kernels import dp_clip as kdp
    from repro_torch.kernels import secure_agg as ksa
    g = torch.Generator(device="cuda").manual_seed(4)
    C, D = TRAIN_COHORT, ROUND_LEAF
    out = []
    x = torch.randn(C, D, generator=g, device="cuda") * DELTA_SCALE
    s = torch.rand(C, generator=g, device="cuda")
    got = kdp.sq_norms(x)
    plain_ms, want = _plain_ms(torch, lambda: kdp.sq_norms_plain(x))
    err = float((got - want).abs().max())
    check(err <= SQ_RTOL * float(want.abs().max()),
          f"sq_norms != plain at the round's leaf: {err:.3g}")
    ms = _cuda_ms(torch, lambda: kdp.sq_norms(x), 10)
    lib_ms = _cuda_ms(torch, lambda: torch.linalg.vector_norm(x, dim=1), 10)
    out.append(_entry("sq_norms", "src/repro_torch/kernels/csrc/dp_clip.cu",
                      "src/repro/kernels/dp_clip.py:39",
                      launches["sq_norms"], ms, plain_ms, 2 * C * D,
                      C * D * 4 + C * 4, max_abs_err=err, library_ms=lib_ms))
    got = kdp.scale_accum(x, s)
    plain_ms, want = _plain_ms(torch, lambda: kdp.scale_accum_plain(x, s))
    err = float((got - want).abs().max())
    check(err <= ACC_RTOL * float((s[:, None] * x).abs().sum(0).max()),
          f"scale_accum != plain at the round's leaf: {err:.3g}")
    del got, want
    ms = _cuda_ms(torch, lambda: kdp.scale_accum(x, s), 10)
    lib_ms = _cuda_ms(torch, lambda: s @ x, 10)
    out.append(_entry("scale_accum",
                      "src/repro_torch/kernels/csrc/dp_clip.cu",
                      "src/repro/kernels/dp_clip.py:69",
                      launches["scale_accum"], ms, plain_ms, 2 * C * D,
                      C * D * 4 + C * 4 + D * 4, max_abs_err=err,
                      library_ms=lib_ms))
    del x
    empty_cache(torch)

    from repro_torch.core.fl import aggregation as agg
    from repro_torch.configs.base import FLConfig
    scale = agg.fixed_point_scale(FLConfig(secure_agg_bits=32), C)
    x = torch.randn(D, generator=g, device="cuda") * DELTA_SCALE
    u = torch.rand(D, generator=g, device="cuda")
    m = torch.randint(-2 ** 31, 2 ** 31, (D,), generator=g, device="cuda",
                      dtype=torch.int64).to(torch.int32)
    for mask in (m, None):
        got = ksa.quantize_mask(x, mask, u, scale, math.inf)
        plain_ms, want = _plain_ms(torch, lambda: ksa.quantize_mask_plain(
            x, mask, u, scale, math.inf))
        check(torch.equal(got, want), "quantize_mask != plain at the "
              f"round's leaf (mask={mask is not None})")
        del got, want
        ms = _cuda_ms(torch, lambda: ksa.quantize_mask(x, mask, u, scale,
                                                       math.inf), 10)
        e = _entry("quantize_mask",
                   "src/repro_torch/kernels/csrc/quantize_mask.cu",
                   "src/repro/kernels/secure_agg.py:84",
                   launches["quantize_mask"], ms, plain_ms, 8 * D,
                   D * (16 if mask is not None else 12))
        if mask is not None:
            masked = e
        else:
            masked.update(no_mask_ms=e["ms"], no_mask_plain_ms=e["plain_ms"],
                          no_mask_bound_ms=e["bound_ms"])
            out.append(masked)
        log(f"  quantize_mask ({D}, mask={mask is not None}): "
            f"{e['ms']:.3f} ms (bound {e['bound_ms']:.3f} ms by "
            f"{e['bound_by']}; plain {e['plain_ms']:.1f} ms)")
    inv = ksa.jit_inverse(scale)
    got = ksa.dequantize(m, inv)
    plain_ms, want = _plain_ms(torch, lambda: ksa.dequantize_plain(m, inv))
    check(torch.equal(got, want), "dequantize != plain at the round's leaf")
    del got, want
    ms = _cuda_ms(torch, lambda: ksa.dequantize(m, inv), 10)
    lib_ms = _cuda_ms(torch, lambda: torch.mul(m, inv), 10)
    out.append(_entry("dequantize",
                      "src/repro_torch/kernels/csrc/quantize_mask.cu",
                      "src/repro/kernels/secure_agg.py:600",
                      launches["dequantize"], ms, plain_ms, D, 8 * D,
                      library_ms=lib_ms))
    del x, u, m
    empty_cache(torch)
    for e in out:
        lib = "none" if e["library_ms"] is None else \
            f"{e['library_ms']:.3f} ms"
        log(f"  {e['name']}: {e['ms']:.3f} ms (bound {e['bound_ms']:.3f} ms "
            f"by {e['bound_by']}; plain {e['plain_ms']:.1f} ms; library "
            f"{lib}); {smi}")
    return out


def bitagg_time(torch, launches, smi: str) -> dict:
    """K9 at the fleet query's launch shape: kernel (CUDA events), plain
    version (host clock, once); no torch call computes it."""
    from repro_torch.kernels import bitagg as k9
    g = torch.Generator(device="cuda").manual_seed(5)
    N, F, T = FLEET_TILE, FLEET_FEATURES, FLEET_THRESHOLDS
    v = torch.randn(N, F, generator=g, device="cuda") * 500.0
    thr = torch.linspace(-4096.0, 4096.0, T, device="cuda")
    u = torch.rand(N, F, T, generator=g, device="cuda")
    got = k9.bit_counts(v, thr, u, FLEET_FLIP)
    plain_ms, want = _plain_ms(torch, lambda: k9.bit_counts_plain(
        v, thr, u, FLEET_FLIP))
    check(torch.equal(got, want), "bit_counts != plain at the fleet tile")
    del got, want
    ms = _cuda_ms(torch, lambda: k9.bit_counts(v, thr, u, FLEET_FLIP), 10)
    e = _entry("bit_counts", "src/repro_torch/kernels/csrc/bitagg.cu",
               "src/repro/kernels/bitagg.py:39", launches["bit_counts"], ms,
               plain_ms, K9_OPS * N * F * T,
               4 * (N * F * T + N * F + T + F * T), integer=True)
    log(f"  bit_counts ({N}x{F}x{T}): {ms:.3f} ms (bound {e['bound_ms']:.3f} "
        f"ms by {e['bound_by']}; plain {plain_ms:.1f} ms; library none); "
        f"{smi}")
    del v, u
    empty_cache(torch)
    return e


def _entry(name, source, replaces, launches, ms, plain_ms, ops, nbytes, *,
           max_abs_err=0, library_ms=None, integer=False):
    """A kernel's line; ``ops`` are float operations (an FMA two) against
    the f32 rate, or with ``integer`` instructions against the issue
    rate."""
    from repro_torch.launch.analysis import kernel_bound_ms
    bound, by = kernel_bound_ms(ops, nbytes, integer=integer)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": library_ms}


def reset_counts() -> None:
    from repro_torch.testing import reset_kernel_counts
    reset_kernel_counts()


def kernel_counts() -> dict:
    from repro_torch import testing
    return testing.kernel_counts()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is false; this smoke run needs "
            "a CUDA GPU")
        return 2
    if not (SRC / "repro_torch").is_dir():
        log(f"FAIL: {SRC / 'repro_torch'} not found; run from a checkout of "
            "the repository")
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi = smi[0] if smi else "nvidia-smi: no output"
    from repro_torch.launch import analysis
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.split()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = analysis.set_int_rate(sms, float(clk[0]))
    log(f"integer issue rate: {sms} SMs x 128 lane-ops/clk x {clk[0]} MHz "
        f"= {rate / 1e12:.2f} T/s")

    with Phase("phase 1: build + kernel parity"):
        build_kernels()
        kernel_parity(torch)

    with Phase("phase 2: main path at full width"):
        from repro_torch.configs import qwen2_1_5b
        mp = MainPath(torch, args.seed, qwen2_1_5b.CONFIG)
        reset_counts()
        main_path(torch, mp)
        counts = {"uncompressed": kernel_counts()}

    with Phase("phase 2b: compressed uploads and the enclave wire"):
        reset_counts()
        compressed_path(torch, mp)
        counts["compressed"] = kernel_counts()

    with Phase("phase 2f: the aggregation tier at full width"):
        digests = {}
        tier_want = tier_path(torch, mp, counts, smi, digests)
        mp_seed = mp.seed
        del mp
        torch.cuda.empty_cache()

    with Phase("phase 2i: the aggregation tier across processes"):
        tier_want.update(dist_tier_path(torch, mp_seed, digests, counts,
                                        smi))

    with Phase("phase 2c: serving qwen2-1.5b at full width and depth"):
        serve_path(torch, args.seed, counts, smi)

    with Phase("phase 2g: serving the other families at full width"):
        families_path(torch, args.seed, counts, smi)

    with Phase("phase 2d: training qwen2-1.5b at full width and depth"):
        stash = train_path(torch, args.seed, counts, smi)

    with Phase("phase 2h: the standalone protocol, checkpoints and "
               "training the other families"):
        checkpoint_path(torch, args.seed, stash, counts, smi)
        del stash
        protocol_path(torch, args.seed, counts, smi)
        family_want = family_train_path(torch, args.seed, counts, smi)

    with Phase("phase 2e: federated analytics and the control plane"):
        analytics_path(torch, args.seed, counts, smi)

    with Phase("phase 2j: the cost harness and the whole-step roofline"):
        cost_path(smi)

    with Phase("phase 3: kernels on the main path"):
        from repro_torch.kernels import secure_agg as ksa
        # launches per path: one per chunk of every push (or flush) that
        # runs the kernel; 14 pushes and 2 flushes per run
        per_run = EXPECT_CHUNKS * (BUFFER + 6)
        flushes = EXPECT_CHUNKS * 2
        want = {
            # bits 32/16 x (client + tee_stream); batched off (unmasked
            # lane) and tee (PRF lane) x 2 bits; the 19-bit client wire
            # packs and unpacks every chunk
            "uncompressed": {"quantize_mask_prf": 4 * per_run,
                             "weighted_quantize_accum": 2 * flushes,
                             ksa.PRF_LANE: 2 * flushes,
                             "rotate_quantize_prf": 0,
                             "pack_residues": per_run,
                             "unpack_residues": per_run},
            # sketch: off + client + tee_stream x 2 bits; the bits-16 client
            # runs (sketch, subsample) pack; the enclave run is an
            # uncompressed tee_stream push whose 8-bit wire packs
            "compressed": {"quantize_mask_prf": per_run,
                           "weighted_quantize_accum": 0, ksa.PRF_LANE: 0,
                           "rotate_quantize_prf": 6 * per_run,
                           "pack_residues": 3 * per_run,
                           "unpack_residues": 3 * per_run},
        }
        round_kernels = ("sq_norms", "scale_accum", "quantize_mask",
                         "dequantize")
        for path in ("uncompressed", "compressed"):
            want[path]["flash_decode"] = 0
            want[path]["bit_counts"] = 0
            want[path].update(dict.fromkeys(round_kernels, 0))
        zero = dict.fromkeys(want["compressed"], 0)
        # serving: K10 once per layer per decode step, nothing else
        for name, _ in SERVE_RUNS:
            want[f"serve-{name}"] = dict(zero)
            want[f"serve-{name}"]["flash_decode"] = SERVE_LAYERS * SERVE_STEPS
        # the other families: K10 once per attention layer per step (the
        # whisper decoder: a self and a cross attention per layer); none in
        # mamba2
        for run, *_, per_step in FAMILY_RUNS:
            want[f"serve-{run}"] = dict(zero,
                                        flash_decode=per_step * FAMILY_STEPS)
        # training, one chunk of 4 clients a round: K3 once per leaf, K6
        # once per client leaf and K7 once per leaf at bits 32, K8 once per
        # leaf at bits 0
        L, C = TRAIN_LEAVES, TRAIN_COHORT
        sa_round = dict(zero, sq_norms=L, quantize_mask=C * L, dequantize=L)
        want["train-full"] = {k: TRAIN_ROUNDS * v
                              for k, v in sa_round.items()}
        want["round-bits32"] = sa_round
        want["round-bits0"] = dict(zero, sq_norms=L, scale_accum=L)
        want["round-masked"] = want["round-unmasked"] = sa_round
        Lc = CLASSIFIER_LEAVES
        want["train-classifier"] = dict(
            zero, sq_norms=CLASSIFIER_ROUNDS * CLASSIFIER_CHUNKS * Lc,
            quantize_mask=CLASSIFIER_ROUNDS * CLASSIFIER_COHORT * Lc,
            dequantize=CLASSIFIER_ROUNDS * Lc)
        # analytics: K9 once per device tile of each CDF vote (the example's
        # percentile query and its minmax factors; the pipeline's minmax
        # factors; the fleet query's 16 tiles), plus the pipeline's rounds:
        # cohort 64 in 4 chunks of 16, 6 leaves
        from repro_torch.examples import paper_pipeline as pp
        pp_chunks = pp.COHORT // pp.CLIENTS_PER_CHUNK
        want["fa-example"] = dict(zero, bit_counts=2)
        want["fa-pipeline"] = dict(
            zero, bit_counts=1, sq_norms=pp.ROUNDS * pp_chunks * Lc,
            quantize_mask=pp.ROUNDS * pp.COHORT * Lc,
            dequantize=pp.ROUNDS * Lc)
        want["fa-fleet"] = dict(zero, bit_counts=FLEET_DEVICES // FLEET_TILE)
        # the tier (phase 2f): counted per run from the runs' own shapes
        # and ledgers (K1 once per chunk of every masked encode, K5 once
        # per chunk of every packed encode / landing, K2's PRF lane once
        # per chunk per leaf per tier flush, K4 per chunk of every sketch
        # push, K3/K6/K7 per leaf / client leaf / leaf of each round)
        for path, nonzero in tier_want.items():
            want[path] = dict(zero, **nonzero)
        # phase 2h: K10 once per layer per decode step of the served
        # checkpoint and of generate() on the trained params; K1 once per
        # encoded protocol row (its plain branch and secure_aggregate
        # launch nothing); each family round K3 once per leaf, K6 once per
        # client leaf, K7 once per leaf (bits 0: K3 and K8 once per leaf)
        for name in ("serve-checkpoint", "serve-trained"):
            want[name] = dict(zero, flash_decode=SERVE_LAYERS * SERVE_STEPS)
        want["protocol"] = dict(zero, quantize_mask_prf=PROTO_ROWS,
                                dequantize=2)  # K7: the two flushes' decode
        for path, nonzero in family_want.items():
            want[path] = dict(zero, **nonzero)
        launches = {}
        for path, got in counts.items():
            runs = {k: v["launches"] for k, v in got.items()}
            plain = {k: v["plain_calls"] for k, v in got.items()}
            log(f"  {path} path: " + json.dumps({"launches": runs,
                                                  "plain_calls": plain}))
            check(runs == want[path],
                  f"{path} path launches {runs}, want {want[path]}")
            check(all(v == 0 for v in plain.values()),
                  f"plain versions ran on the CUDA path: {plain}")
            for k, v in runs.items():
                launches[k] = launches.get(k, 0) + v
        check(all(v > 0 for v in launches.values()),
              f"a kernel never launched on the main path: {launches}")


    with Phase("phase 4: device and kernel times"):
        entries = kernel_times(torch, launches)
        entries.append(flash_decode_times(torch, launches["flash_decode"]))
        entries += round_kernel_times(torch, launches, smi)
        entries.append(bitagg_time(torch, launches, smi))

    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
