"""Configuration dataclasses for models, input shapes, FL and meshes.

The port's own copy of ``repro.configs.base`` (the port imports nothing of
the JAX package): every ported architecture gets a ``ModelConfig`` in its own
module under ``repro_torch.configs`` with the exact published dimensions
(citation in ``citation``), plus a ``reduced()`` variant used by CPU tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description — enough to build any of the 6 families."""

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- norm / activation / embedding ---
    mlp_act: str = "swiglu"  # swiglu | relu2 | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    qkv_bias: bool = False
    tie_embeddings: bool = False
    pos_emb: str = "rope"  # rope | learned | none
    rope_theta: float = 10000.0

    # --- attention windowing ---
    # None => full causal attention.  An int => sliding-window attention with
    # this window (used natively by hybrid local-attn layers, and as the
    # long-context decode variant for dense archs on ``long_500k``).
    attention_window: Optional[int] = None

    # --- hybrid layer pattern ---
    # None => homogeneous stack of the family's default block.
    # Otherwise a tuple with one entry per layer drawn from
    # {'attn', 'local_attn', 'rglru', 'ssm', 'moe', 'dense'}.
    block_pattern: Optional[Tuple[str, ...]] = None

    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0  # per-expert hidden dim (d_ff = dense-layer hidden dim)
    first_k_dense: int = 0  # leading layers that use a dense MLP
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_ragged: bool = False  # sort+ragged_dot dispatch (beyond-paper)
    moe_dispatch: str = "onehot"  # onehot | gather | ragged (see models/moe.py)

    # --- SSM (Mamba-2 / SSD) ---
    ssm_state_dim: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 128
    ssm_num_groups: int = 1

    # --- RG-LRU (RecurrentGemma) ---
    rglru_width: int = 0  # recurrence width (d_rnn); 0 -> d_model
    rglru_conv_width: int = 4

    # --- encoder-decoder (audio) ---
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq: int = 1500  # precomputed frame embeddings (stub frontend)

    # --- VLM ---
    num_image_tokens: int = 0  # early-fusion patch embeddings (stub frontend)

    # --- numerics / capacity ---
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    max_seq_len: int = 8192

    # --- distribution hints (consumed by launch/sharding.py) ---
    fsdp: bool = False  # 2-D param sharding (data axis) for >=multi-B archs
    remat: bool = False  # activation checkpointing over the layer scan

    # --- cost-probe knobs (launch/lowering.py): XLA HloCostAnalysis counts
    # while-loop bodies ONCE, so roofline probes lower with scans unrolled.
    scan_unroll: bool = False
    attn_q_chunk: int = 0  # 0 -> layers.ATTN_QUERY_CHUNK

    # beyond-paper: shard attention over the QUERY SEQUENCE on the `model`
    # axis (context parallelism).  The TP fallback when num_heads doesn't
    # divide the model axis (e.g. qwen2's 12 heads on TP16) — otherwise the
    # whole attention block compiles fully replicated.
    attn_seq_shard: bool = False

    citation: str = ""

    # Defaults of the fields :class:`GraniteHybridConfig` adds.  Class
    # attributes, not fields: every other configuration's fields stay the
    # reference's, and every other configuration computes as it did.
    embedding_multiplier = 1.0  # token embeddings times this
    residual_multiplier = 1.0  # each block's branch times this
    attention_multiplier = 0.0  # softmax scale; 0 -> head_dim ** -0.5
    logits_scaling = 1.0  # logits divided by this
    shared_d_ff = 0  # shared experts' hidden dim; 0 -> moe_d_ff
    norm_eps = 1e-6
    experts_held = 0  # routed experts held here; 0 -> all num_experts
    expert_offset = 0  # the first held expert's index
    # the default of the field :class:`LatentMoEConfig` adds: the router's
    # scores ("softmax", or DeepSeek-V3's "sigmoid" with a selection bias)
    router_score = "softmax"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))
        if self.family in ("dense", "moe", "vlm", "hybrid", "audio"):
            assert self.num_heads % max(self.num_kv_heads, 1) == 0, self.name

    # ------------------------------------------------------------------
    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def decode_variant(self, window: Optional[int]) -> "ModelConfig":
        """Sliding-window variant for long-context decode (ring-buffer KV)."""
        return self.with_overrides(attention_window=window)

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        if self.block_pattern is not None:
            assert len(self.block_pattern) == self.num_layers
            return self.block_pattern
        default = {
            "dense": "attn",
            "vlm": "attn",
            "moe": "moe",
            "ssm": "ssm",
            "audio": "attn",
        }[self.family]
        kinds = []
        for i in range(self.num_layers):
            if default == "moe" and i < self.first_k_dense:
                kinds.append("attn")  # attention + dense MLP
            else:
                kinds.append(default)
        return tuple(kinds)

    @property
    def held_experts(self) -> int:
        """Routed experts this device holds of each MoE layer."""
        return self.experts_held or self.num_experts

    @property
    def shared_width(self) -> int:
        return self.shared_d_ff or self.moe_d_ff

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks), for roofline N."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        n = v * d  # embedding
        if not self.tie_embeddings:
            n += v * d  # lm head
        for kind in self.layer_kinds:
            if kind in ("attn", "local_attn"):
                n += self._attn_params() + self._mlp_params(f)
            elif kind == "moe":
                n += self._attn_params() + self._moe_params()
            elif kind == "ssm":
                n += self._ssm_params()
            elif kind == "ssm_moe":
                n += self._ssm_params() + self._moe_params()
            elif kind == "mla":
                n += self._mla_params() + self._mlp_params(f)
            elif kind == "mla_moe":
                n += self._mla_params() + self._moe_params()
            elif kind == "kda":
                n += self._kda_params() + self._mlp_params(f)
            elif kind == "kda_moe":
                n += self._kda_params() + self._moe_params()
            elif kind == "rglru":
                n += self._rglru_params() + self._mlp_params(f)
            n += 2 * d  # norms
        if self.is_encoder_decoder:
            for _ in range(self.num_encoder_layers):
                n += self._attn_params() + self._mlp_params(f) + 2 * d
            # cross attention in every decoder layer
            n += self.num_layers * self._attn_params()
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE top-k), for MODEL_FLOPS = 6*N_active*D."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        for kind in self.layer_kinds:
            if kind in ("moe", "ssm_moe", "mla_moe", "kda_moe"):
                n += (self._attn_params() if kind == "moe" else
                      self._ssm_params() if kind == "ssm_moe" else
                      self._kda_params() if kind == "kda_moe" else
                      self._mla_params())
                n += self.experts_per_token * self._mlp_params(self.moe_d_ff)
                n += self.num_shared_experts * self._mlp_params(
                    self.shared_width)
                n += d * self.num_experts
            elif kind == "mla":
                n += self._mla_params() + self._mlp_params(self.d_ff)
            elif kind == "kda":
                n += self._kda_params() + self._mlp_params(self.d_ff)
            else:
                n += self._attn_params() + self._mlp_params(self.d_ff)
            n += 2 * d
        return n

    def _attn_params(self) -> int:
        d, h, kv, hd = self.d_model, self.num_heads, self.num_kv_heads, self.head_dim
        n = d * h * hd + 2 * d * kv * hd + h * hd * d
        if self.qkv_bias:
            n += (h + 2 * kv) * hd
        return n

    def _moe_params(self) -> int:
        """The held experts, the shared experts and the router."""
        return (self.held_experts * self._mlp_params(self.moe_d_ff)
                + self.num_shared_experts * self._mlp_params(self.shared_width)
                + self.d_model * self.num_experts)

    def _mlp_params(self, f: int) -> int:
        if f == 0:
            return 0
        mult = 3 if self.mlp_act == "swiglu" else 2
        return mult * self.d_model * f

    def _ssm_params(self) -> int:
        d, di, ds = self.d_model, self.d_inner, self.ssm_state_dim
        g, nh = self.ssm_num_groups, self.ssm_num_heads
        in_proj = d * (2 * di + 2 * g * ds + nh)
        conv = self.ssm_conv_width * (di + 2 * g * ds)
        out = di * d
        extra = nh * 2 + di  # A_log, D, out-norm
        return in_proj + conv + out + extra

    def _rglru_params(self) -> int:
        d, r = self.d_model, self.rglru_width or self.d_model
        # two input branches + conv + gates (W_a, W_x) + out proj + Lambda
        return 2 * d * r + self.rglru_conv_width * r + 2 * r * r + r * d + 2 * r


@dataclass(frozen=True)
class GraniteHybridConfig(ModelConfig):
    """A ``ModelConfig`` with the settings of IBM's Granite-4.0-H stacks:
    µP multipliers (embeddings, each residual branch, the softmax scale,
    the logits), the RMSNorm epsilon, a shared expert of its own width, and
    the expert share of expert parallelism.

    The share: each MoE layer's router keeps all ``num_experts`` outputs
    and its top-k, this device holds routed experts ``[expert_offset,
    expert_offset + experts_held)``, and the layer computes only the
    (token, slot) pairs routed to them, drop-free (``moe_dispatch``
    "ragged"); what absent experts would add is left out.  The block kind
    ``ssm_moe`` is a Mamba-2 mixer followed by an MoE FFN."""

    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    attention_multiplier: float = 0.0
    logits_scaling: float = 1.0
    shared_d_ff: int = 0
    norm_eps: float = 1e-6
    experts_held: int = 0
    expert_offset: int = 0

    def __post_init__(self):
        super().__post_init__()
        if self.block_pattern is not None:  # a JSON override gives a list
            object.__setattr__(self, "block_pattern",
                               tuple(self.block_pattern))
        _check_share(self)


def _check_share(cfg) -> None:
    if cfg.expert_offset + cfg.held_experts > cfg.num_experts:
        raise ValueError(
            f"{cfg.name}: experts [{cfg.expert_offset}, "
            f"{cfg.expert_offset + cfg.held_experts}) are not all among the "
            f"router's {cfg.num_experts}")


@dataclass(frozen=True)
class LatentMoEConfig(ModelConfig):
    """A ``ModelConfig`` of DeepSeek-V3's stack (``model_type``
    deepseek_v3): latent attention (MLA) in every layer, a dense SwiGLU in
    the first ``first_k_dense`` layers and an MoE FFN in the rest (block
    kinds ``mla`` and ``mla_moe``), the RMSNorm epsilon, a shared expert
    of its own width, and the expert share of :class:`GraniteHybridConfig`.

    MLA (``models/mla.py``): queries of ``qk_nope_head_dim +
    qk_rope_head_dim`` per head; keys and values from a
    ``kv_lora_rank``-wide latent, RMS-normed, plus one rope key of
    ``qk_rope_head_dim`` shared by the heads; values of ``v_head_dim``.
    ``router_score`` "sigmoid" is the DeepSeek-V3 router
    (``models/moe.py``): the top-k of sigmoid scores plus a per-expert
    selection bias, gates the unbiased scores of the chosen experts,
    renormalised, times ``routed_scaling``, and the sequence-wise balance
    loss times ``router_aux_weight``."""

    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    router_score: str = "sigmoid"
    routed_scaling: float = 1.0
    shared_d_ff: int = 0
    norm_eps: float = 1e-6
    experts_held: int = 0
    expert_offset: int = 0
    # RoPE on the rope dims (False), or those dims kept and not rotated
    # (True: Kimi Linear's MLA)
    mla_use_nope: bool = False

    def __post_init__(self):
        super().__post_init__()
        if self.router_score not in ("softmax", "sigmoid"):
            raise ValueError(f"{self.name}: router_score "
                             f"{self.router_score!r}")
        _check_share(self)

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        return tuple("mla" if i < self.first_k_dense else "mla_moe"
                     for i in range(self.num_layers))

    def _mla_params(self) -> int:
        d, h, r = self.d_model, self.num_heads, self.kv_lora_rank
        dn, dr, dv = (self.qk_nope_head_dim, self.qk_rope_head_dim,
                      self.v_head_dim)
        return (d * h * (dn + dr) + d * (r + dr) + r
                + r * h * (dn + dv) + h * dv * d)


@dataclass(frozen=True)
class KimiLinearConfig(LatentMoEConfig):
    """A :class:`LatentMoEConfig` of Kimi Linear's stack (``model_type``
    kimi_linear): Kimi Delta Attention (KDA, ``models/kda.py``) in the
    1-based layers ``kda_layers`` and MLA in ``full_attn_layers``, as
    ``linear_attn_config`` lists them; a dense SwiGLU in the first
    ``first_k_dense`` layers and an MoE FFN in the rest (block kinds
    ``kda``, ``kda_moe``, ``mla``, ``mla_moe``).

    KDA: ``kda_num_heads`` heads of ``kda_head_dim`` keys and values,
    short convolutions of ``kda_conv_width``, the decay's and the output
    gate's low-rank projections ``kda_head_dim`` wide, computed in chunks
    of ``kda_chunk`` tokens.  ``mla_use_nope`` is true here: the MLA layers
    keep their rope dims in the queries and the shared key without rotating
    them."""

    kda_layers: Tuple[int, ...] = ()
    full_attn_layers: Tuple[int, ...] = ()
    kda_num_heads: int = 0
    kda_head_dim: int = 0
    kda_conv_width: int = 4
    kda_chunk: int = 64
    mla_use_nope: bool = True

    def __post_init__(self):
        super().__post_init__()
        for f in ("kda_layers", "full_attn_layers"):  # JSON gives lists
            object.__setattr__(self, f, tuple(getattr(self, f)))
        if sorted(self.kda_layers + self.full_attn_layers) != \
                list(range(1, self.num_layers + 1)):
            raise ValueError(f"{self.name}: kda_layers and full_attn_layers "
                             f"do not partition layers 1..{self.num_layers}")

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        kda = set(self.kda_layers)
        return tuple(("kda" if i + 1 in kda else "mla")
                     + ("" if i < self.first_k_dense else "_moe")
                     for i in range(self.num_layers))

    def _kda_params(self) -> int:
        d, r = self.d_model, self.kda_head_dim
        hk = self.kda_num_heads * r
        return (4 * d * hk                      # q, k, v, out
                + 3 * self.kda_conv_width * hk  # the short convolutions
                + 2 * (d * r + r * hk) + hk     # decay and gate, gate bias
                + d * self.kda_num_heads        # beta
                + self.kda_num_heads + hk       # A_log, dt_bias
                + self.kda_head_dim)            # the output norm


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned (seq_len, global_batch, mode) input shape."""

    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.mode == "decode"


@dataclass(frozen=True)
class FLConfig:
    """Federated-learning round configuration (the paper's technique)."""

    cohort_size: int = 128  # clients per round
    local_steps: int = 1  # local SGD steps per client (K)
    local_lr: float = 0.5
    clip_norm: float = 1.0  # per-client L2 clip (DP-SGD)
    noise_multiplier: float = 0.0  # sigma; noise std = sigma * clip / cohort
    noise_placement: str = "tee"  # tee | device  (paper §Model aggregation)
    secure_agg_bits: int = 32  # fixed-point quantization width
    secure_agg_range: float = 4.0  # clip range for fixed-point encoding
    # end-to-end masked sync rounds: every cohort slot adds its pairwise
    # session mask to the encoded int32 delta inside the jitted round step;
    # the masks cancel in the modular sum, so the round is bit-identical to
    # the unmasked one while no unmasked encoding ever leaves a client slot.
    secure_agg_masked: bool = False
    # pairwise-mask communication graph degree: 0 = complete graph (every
    # pair of session slots shares a mask stream — the Bonawitz et al.
    # baseline); an even k >= 2 masks each slot with its k neighbours
    # only (SecAgg+-style sparse graph, Bell et al. 2020: O(log n) degree
    # suffices at production session sizes), cutting mask generation from
    # O(B^2) to O(B*k) streams per session.
    secure_agg_degree: int = 0
    # sparse-graph topology: by default the k-regular neighbourhoods are
    # RANDOM, drawn per session from the session key (Bell et al. analyze
    # random k-regular graphs — a fixed circulant ring lets an adversary
    # know every session's mask partners in advance).  True falls back to
    # the deterministic circulant ring.
    secure_agg_circulant: bool = False
    # --- hierarchical aggregation tier (core/fl/hierarchy.py) ---
    # number of leaf aggregators and session slots per leaf.  0 = unset:
    # ShardedAsyncServer then requires explicit constructor arguments.
    # num_leaves may EXCEED the visible device count — every logical leaf
    # lives on the one device, as the leading axis of the tier's buffer.
    num_leaves: int = 0
    leaf_buffer: int = 0
    # session topology of the tier: False = one global mask session sharded
    # across leaves (the flat layout — recovery edges cross leaves); True =
    # a SESSION TREE: every leaf runs its own local mask session over its
    # leaf_buffer slots and flushes a masked partial into a root session
    # over num_leaves slots.  Fault-isolated: one leaf's dropout recovery
    # sweeps only that leaf's edges, and a whole dead leaf is recovered at
    # the root with one num_leaves-slot sweep.
    two_level: bool = False
    server_opt: str = "fedavg"  # fedavg | fedadam | fedadagrad | fedavgm
    server_lr: float = 1.0
    server_beta1: float = 0.9
    server_beta2: float = 0.99
    server_eps: float = 1e-5
    dp_delta: float = 1e-6
    # beyond-paper: quantized update collectives (int8 stochastic rounding)
    update_quant_bits: int = 0  # 0 = off, 8/16 = quantize before aggregation
    # beyond-paper: accumulate per-client-slot partials across the chunk scan
    # and cross-device-reduce ONCE per round (vs once per chunk).  Bit-exact
    # same sum (int32 addition is associative/commutative mod 2^32).
    deferred_agg: bool = False
    # --- pytree-native aggregation (aggregation.ParamPlan) ---
    # target flat elements per aggregation chunk.  0 = one chunk spanning
    # the whole model (the legacy flat engine, unpadded).  > 0 groups
    # consecutive WHOLE leaves greedily up to this many elements per chunk;
    # each chunk runs its own mask session and the engines never
    # materialize the full (D,) aggregation.
    param_chunk_elems: int = 0
    # --- upload compression (core/fl/compression.py) ---
    # structured/sketched client updates inside the masked field (McMahan
    # et al., arXiv 1602.05629): "none" ships every coordinate (legacy);
    # "subsample" keeps a PRF-seeded random compress_rate fraction of each
    # chunk; "sketch" random-rotates (sign-flip + block Walsh-Hadamard)
    # before subsampling so sparse updates survive.  Operators derive from
    # the session key at both ends of the push split — nothing extra on
    # the wire.  Streaming engines only (mask_mode off/tee_stream/client).
    compress_mode: str = "none"
    compress_rate: float = 1.0  # kept fraction of coordinates, (0, 1]
    # enclave wire quantization: tee/tee_stream uploads are raw f32 by
    # default; > 0 stochastically quantizes the client delta to this many
    # bits (packed words on the wire) before enclave ingest.  0 = off.
    enclave_wire_bits: int = 0
    # --- graceful degradation (core/fl/faults.py) ---
    # minimum fraction of live session slots that must be filled before a
    # deadline flush releases a params update.  0.0 keeps the legacy
    # flush-whatever-arrived behaviour; a flush below quorum ABSTAINS
    # (defers the buffered contributions, emits a metric) rather than
    # decoding a garbage sub-quorum aggregate.
    flush_quorum: float = 0.0
    # --- drift robustness under churn ---
    # FedProx (Li et al. 2020): proximal term mu/2 * ||w - w_round||^2 added
    # to the local objective, i.e. g += mu * (w - w_round) each local step.
    # 0.0 = plain FedAvg/FedBuff local SGD.
    fedprox_mu: float = 0.0
    # SCAFFOLD (Karimireddy et al. 2020): client/server control variates
    # correct client drift; the variate deltas ride the pytree push API
    # next to the model delta.  Async (FedBuff) simulation only.
    scaffold: bool = False

    def __post_init__(self):
        if self.secure_agg_degree > 0 and self.secure_agg_degree % 2 != 0:
            raise ValueError(
                f"secure_agg_degree must be even (each slot pairs with "
                f"k/2 neighbours on each side of the session ring); got "
                f"{self.secure_agg_degree}. Round up to "
                f"{self.secure_agg_degree + 1} or use 0 for the complete "
                f"graph.")
        if self.secure_agg_bits > 32:
            raise ValueError(
                f"secure_agg_bits={self.secure_agg_bits} exceeds the int32 "
                f"secure-aggregation field; the fixed-point transport is "
                f"mod 2^32. Use secure_agg_bits <= 32 (0 disables secure "
                f"aggregation).")
        if self.two_level and self.num_leaves == 0:
            raise ValueError(
                "two_level=True requires a leaf tier: set num_leaves (> 0) "
                "and leaf_buffer so the session tree has leaf sessions to "
                "build (see ShardedAsyncServer).")
        if self.num_leaves > 0 and self.leaf_buffer == 0:
            raise ValueError(
                f"num_leaves={self.num_leaves} but leaf_buffer=0: each leaf "
                f"aggregator needs a per-leaf slot count. Set leaf_buffer "
                f"(buffer_size = num_leaves * leaf_buffer).")
        if self.leaf_buffer > 0 and self.num_leaves == 0:
            raise ValueError(
                f"leaf_buffer={self.leaf_buffer} but num_leaves=0: a leaf "
                f"slot count without leaves is unused. Set num_leaves or "
                f"drop leaf_buffer.")
        if self.param_chunk_elems < 0:
            raise ValueError(
                f"param_chunk_elems must be >= 0 (0 = single-chunk flat "
                f"plan); got {self.param_chunk_elems}.")
        if self.compress_mode not in ("none", "subsample", "sketch"):
            raise ValueError(
                f"compress_mode={self.compress_mode!r}: want 'none', "
                f"'subsample' or 'sketch' (core/fl/compression.py).")
        if not 0.0 < self.compress_rate <= 1.0:
            raise ValueError(
                f"compress_rate={self.compress_rate} is the kept fraction "
                f"of each chunk's coordinates; want 0 < rate <= 1 (1.0 "
                f"disables compression).")
        if (self.compress_mode != "none" and self.compress_rate < 1.0
                and self.secure_agg_bits == 0):
            raise ValueError(
                f"compress_mode={self.compress_mode!r} rides the "
                f"fixed-point secure-aggregation wire; set secure_agg_bits "
                f"> 0 (it is 0 = disabled).")
        if self.enclave_wire_bits != 0 and not (
                2 <= self.enclave_wire_bits <= 32):
            raise ValueError(
                f"enclave_wire_bits={self.enclave_wire_bits}: want 0 (raw "
                f"f32 enclave wire) or a packed width in [2, 32].")
        if not 0.0 <= self.flush_quorum <= 1.0:
            raise ValueError(
                f"flush_quorum is a fraction of live session slots; got "
                f"{self.flush_quorum} (want 0.0 <= q <= 1.0).")
        if self.fedprox_mu < 0.0:
            raise ValueError(
                f"fedprox_mu must be >= 0 (0 disables the proximal term); "
                f"got {self.fedprox_mu}.")
        if self.scaffold and self.fedprox_mu > 0.0:
            raise ValueError(
                "scaffold=True and fedprox_mu > 0 are alternative drift "
                "corrections; enable one at a time.")
