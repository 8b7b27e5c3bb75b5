"""Granite-4.0-H-Small through the port's normal path (``build_model``, the
round step, the train CLI) against the plain reference ``plain_granite``,
at ``reduced()`` size on the CPU with seeded random weights; the expert
share against the uncut layer; the registry; the serve CLI's refusal; the
layer spans and the share's counters.

Tolerances, each with its reason: every comparison is f32 against f32 on
the CPU, so what differs is the order of operations (the port's SSD sums
the intra-chunk products in another order than the paper's listing, the
attention is chunked and grouped, the MoE combine adds experts in another
order).  That leaves ~1e-6 relative on logits and the loss and up to
~1e-5 on a gradient leaf; the limits are 10x above.  A router near-tie
(ROADMAP Queue 3) would flip a token's expert and move a gradient by
O(1): the reference computes the router logits with the same ``x @ W_r``
product, and these seeds have no such tie.
"""
import dataclasses

import pytest
import torch

from repro_torch import tree as T
from repro_torch.configs import registry
from repro_torch.configs.base import FLConfig
from repro_torch.core import telemetry as tele
from repro_torch.core.fl.round import build_round_step, init_fl_state
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.model import build_model
from repro_torch.testing import pin_cpu_threads

import plain_granite as ref

pin_cpu_threads()

ARCH = "granite-4.0-h-small"
KINDS = {"ssm_moe": "mamba", "moe": "attention"}


def ref_config(cfg) -> dict:
    """The reference's dict (``config.json`` keys) of a port config."""
    return {
        "hidden_size": cfg.d_model, "num_hidden_layers": cfg.num_layers,
        "layer_types": [KINDS[k] for k in cfg.layer_kinds],
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "attention_multiplier": cfg.attention_multiplier,
        "embedding_multiplier": cfg.embedding_multiplier,
        "residual_multiplier": cfg.residual_multiplier,
        "logits_scaling": cfg.logits_scaling, "rms_norm_eps": cfg.norm_eps,
        "mamba_n_heads": cfg.ssm_num_heads, "mamba_d_head": cfg.ssm_head_dim,
        "mamba_d_state": cfg.ssm_state_dim,
        "mamba_n_groups": cfg.ssm_num_groups,
        "mamba_d_conv": cfg.ssm_conv_width,
        "mamba_chunk_size": cfg.ssm_chunk, "mamba_expand": cfg.ssm_expand,
        "router_experts": cfg.num_experts,
        "num_local_experts": cfg.held_experts,
        "expert_offset": cfg.expert_offset,
        "num_experts_per_tok": cfg.experts_per_token,
        "router_aux_loss_coef": cfg.router_aux_weight,
        "vocab_size": cfg.vocab_size}


# the reduced stack whole, and holding experts [3, 6) of its 9
CONFIGS = {"whole": {}, "share": {"experts_held": 3, "expert_offset": 3}}


def _setup(which: str, seed: int = 0, B: int = 2, S: int = 16):
    cfg = registry.get_config(ARCH, reduced=True).with_overrides(
        **CONFIGS[which])
    model = build_model(cfg, device="cpu")
    params = model.init((seed, 7))
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g)
    batch = {"tokens": toks[:, :-1].to(torch.int32),
             "labels": toks[:, 1:].to(torch.int32),
             "loss_mask": (torch.rand((B, S), generator=g) > 0.2).float()}
    return cfg, model, params, batch


def _worst_leaf_gap(prog, want) -> float:
    """Largest ``|prog - want| / max(|want|, median |want|)`` over leaves."""
    norms = [float(w.norm()) for w in want]
    floor = sorted(norms)[len(norms) // 2]
    return max(float((a - b).norm()) / max(n, floor, 1e-30)
               for a, b, n in zip(prog, want, norms))


@pytest.mark.parametrize("which", sorted(CONFIGS))
def test_logits_loss_and_grads_match_the_reference(which):
    cfg, model, params, batch = _setup(which)
    m = ref_config(cfg)
    assert T.leaves(params)[0].dtype == torch.float32
    paths, leaves = T.flatten(params)
    lp = [x.clone().requires_grad_(True) for x in leaves]
    lr = [x.clone().requires_grad_(True) for x in leaves]
    logits, _ = model.apply(T.unflatten(paths, lp), batch)
    want, _ = ref.forward(m, T.unflatten(paths, lr), batch["tokens"])
    assert float((logits - want).abs().max()) \
        <= 1e-5 * float(want.detach().abs().max())
    loss = model.loss_fn(T.unflatten(paths, lp), batch)[0]
    loss_ref = ref.loss(m, T.unflatten(paths, lr), batch)
    assert abs(float(loss) - float(loss_ref)) <= 1e-5 * abs(float(loss_ref))
    gp = torch.autograd.grad(loss, lp)
    gr = torch.autograd.grad(loss_ref, lr)
    assert _worst_leaf_gap(gp, gr) <= 1e-4


def test_one_round_matches_the_reference_round():
    """Noise off, no client clipped: the round's new parameters are the old
    plus the mean of the clients' SGD deltas (the 32-bit field rounds each
    element by ~2e-9), both through one f32 add, compared as changes.  The
    add rounds a norm scale of 1 by up to 6e-8 against changes of ~1e-4 an
    element (6e-4), so the limit is 1e-3; a gradient off by 1% fails."""
    cfg, model, params, batch = _setup("share", seed=3)
    fl = FLConfig(cohort_size=2, local_lr=1.0, clip_norm=1e6,
                  noise_multiplier=0.0, secure_agg_bits=32)
    batch = {k: v[:, None] for k, v in batch.items()}  # one row a client
    paths, p0 = T.flatten(params)
    step = build_round_step(model.loss_fn, fl, cohort_size=2,
                            clients_per_chunk=1, device="cpu")
    state, metrics = step(init_fl_state(params, fl), batch, (1, 2))
    assert float(metrics["clip_fraction"]) == 0.0
    m = ref_config(cfg)
    acc = [torch.zeros_like(x) for x in p0]
    for c in range(2):
        leaves = [x.clone().requires_grad_(True) for x in p0]
        cb = {k: v[c] for k, v in batch.items()}
        grads = torch.autograd.grad(
            ref.loss(m, T.unflatten(paths, leaves), cb), leaves)
        for a, g in zip(acc, grads):
            a.add_(-g / 2)
    got = [a - b for a, b in zip(T.leaves(state.params), p0)]
    acc = [(b + a) - b for a, b in zip(acc, p0)]
    assert _worst_leaf_gap(got, acc) <= 1e-3


def test_shares_sum_to_the_uncut_layer():
    """Granite's MoE at its published counts (72 experts, top-10) in tiny
    widths: the partial outputs of the 9 shares of 8 experts, with the
    shared expert counted once, add up to the uncut reference's layer."""
    cfg = registry.get_config(ARCH, reduced=True).with_overrides(
        d_model=32, num_experts=72, experts_per_token=10, moe_d_ff=16,
        shared_d_ff=24)
    params = M.init_moe((5, 9), cfg, device="cpu")
    u = torch.randn((2, 12, 32), generator=torch.Generator().manual_seed(1))
    m = dict(ref_config(cfg), num_local_experts=72, expert_offset=0)
    want = ref.moe(m, params, u)[0]
    shared = L.apply_mlp(cfg, {k: v[0] for k, v in params["shared"].items()},
                         u)
    total = shared.clone()
    for s in range(9):
        share = cfg.with_overrides(experts_held=8, expert_offset=8 * s)
        ps = dict(params, experts={k: v[8 * s:8 * s + 8]
                                   for k, v in params["experts"].items()})
        total += M.apply_moe(share, ps, u)[0] - shared
    assert float((total - want).abs().max()) <= 1e-5 * float(want.abs().max())
    whole = M.apply_moe(cfg, params, u)[0]  # the drop-free uncut dispatch
    assert float((whole - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_registry_resolves_granite_beside_the_reference_ids():
    from repro.configs import registry as jreg
    assert registry.ARCH_IDS == jreg.ARCH_IDS and ARCH not in registry.ARCH_IDS
    cfg = registry.get_config(ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.num_experts,
            cfg.experts_per_token, cfg.vocab_size) == (40, 4096, 72, 10,
                                                       100_352)
    assert [i for i, k in enumerate(cfg.layer_kinds) if k == "moe"] == \
        [5, 15, 25, 35]
    from repro_torch.models.model import param_shapes
    n = sum(s.numel() for s in T.leaves(param_shapes(cfg)))
    assert n == 32_207_337_984
    # the fields it adds are no field of the reference's configurations
    assert "norm_eps" not in dataclasses.asdict(registry.get_config(
        "qwen2-1.5b"))


def test_train_cli_runs_granite(capsys):
    from repro_torch.launch import train
    session = {}
    assert train.main(["--arch", ARCH, "--device", "cpu", "--rounds", "2",
                       "--cohort", "2", "--seq-len", "16"],
                      session=session) == 0
    assert len(session["metrics"]) == 2
    assert all(torch.isfinite(torch.tensor(m["loss"]))
               for m in session["metrics"])


def test_serve_refuses_the_ssm_moe_block():
    from repro_torch.launch import serve
    with pytest.raises(NotImplementedError, match="ssm_moe"):
        serve.main(["--arch", ARCH, "--device", "cpu"])


def test_spans_and_share_counters():
    """While the default registry records spans: a fenced ``ssm`` span per
    Mamba-2 mixer and ``moe`` per MoE FFN of the forward pass (none for the
    backward), labelled with the layer, and the share's pair counters."""
    cfg, model, params, batch = _setup("share")
    tel = tele.Telemetry(record_spans=True, fence=True)
    prev = tele.set_default(tel)
    try:
        paths, leaves = T.flatten(params)
        lp = [x.requires_grad_(True) for x in leaves]
        loss = model.loss_fn(T.unflatten(paths, lp), batch)[0]
        torch.autograd.grad(loss, lp)
    finally:
        tele.set_default(prev)
    kinds = cfg.layer_kinds
    assert [s.labels["layer"] for s in tel.spans if s.name == "ssm"] == \
        [i for i, k in enumerate(kinds) if k == "ssm_moe"]
    assert [s.labels["layer"] for s in tel.spans if s.name == "moe"] == \
        list(range(cfg.num_layers))
    pairs = 2 * 16 * cfg.experts_per_token * cfg.num_layers
    held, other = tel.value("moe_pairs", held=1), tel.value("moe_pairs",
                                                            held=0)
    assert held + other == pairs and 0 < held < pairs
    assert held / cfg.held_experts <= tel.total("moe_held_load_max") <= held
