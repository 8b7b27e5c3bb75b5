"""Moonlight-16B-A3B (DeepSeek-V3's latent attention and sigmoid router)
through the port's normal path (``build_model``, the round step, the train
CLI) against the plain reference ``plain_moonlight``, at ``reduced()`` size
on the CPU with seeded random weights and a seeded selection bias; the
expert share against the uncut layer; the bias that moves selections but
not gates; the sequence-wise balance loss; the bias left as it was by a
round; the softmax router unchanged; the serve refusal; spans and
counters.

Tolerances, each with its reason: every comparison is f32 against f32 on
the CPU, so what differs is the order of operations (the port's attention
is chunked and scales the queries, not the scores; the MoE combine adds
experts in another order).  That leaves ~1e-6 relative on logits and the
loss and up to ~1e-5 on a gradient leaf; the limits are 10x above.  A
router near-tie would flip a token's expert: the reference computes the
router logits with the same ``x @ W_r`` product, and these seeds have
none.
"""
import math

import pytest
import torch

from repro_torch import tree as T
from repro_torch.configs import registry
from repro_torch.configs.base import FLConfig
from repro_torch.core import telemetry as tele
from repro_torch.core.fl.round import build_round_step, init_fl_state
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.model import build_model, param_shapes
from repro_torch.testing import pin_cpu_threads

import plain_moonlight as ref

pin_cpu_threads()

ARCH = "moonlight-16b-a3b"
BIAS_STD = 0.05


def ref_config(cfg) -> dict:
    """The reference's dict (``config.json`` keys) of a port config."""
    return {
        "hidden_size": cfg.d_model, "num_hidden_layers": cfg.num_layers,
        "first_k_dense_replace": cfg.first_k_dense,
        "num_attention_heads": cfg.num_heads,
        "kv_lora_rank": cfg.kv_lora_rank,
        "qk_nope_head_dim": cfg.qk_nope_head_dim,
        "qk_rope_head_dim": cfg.qk_rope_head_dim,
        "v_head_dim": cfg.v_head_dim, "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.norm_eps, "router_experts": cfg.num_experts,
        "n_routed_experts": cfg.held_experts,
        "expert_offset": cfg.expert_offset,
        "num_experts_per_tok": cfg.experts_per_token,
        "routed_scaling_factor": cfg.routed_scaling,
        "aux_loss_alpha": cfg.router_aux_weight,
        "vocab_size": cfg.vocab_size}


# the reduced stack whole, and holding experts [2, 6) of its 8
CONFIGS = {"whole": {}, "share": {"experts_held": 4, "expert_offset": 2}}


def _setup(which: str, seed: int = 0, B: int = 2, S: int = 16, **over):
    cfg = registry.get_config(ARCH, reduced=True).with_overrides(
        **CONFIGS[which], **over)
    g = torch.Generator().manual_seed(seed)
    bias = torch.randn(M.route_bias_shape(cfg), generator=g) * BIAS_STD
    model = build_model(cfg, device="cpu", route_bias=bias)
    params = model.init((seed, 7))
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


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("which", sorted(CONFIGS))
def test_logits_loss_and_grads_match_the_reference(which, remat):
    cfg, model, params, batch = _setup(which, remat=remat)
    m = ref_config(cfg)
    paths, leaves = T.flatten(params)
    lp = [x.clone().requires_grad_(True) for x in leaves]
    lr = [x.clone().requires_grad_(True) for x in leaves]
    logits, _ = model.apply(T.unflatten(paths, lp), batch)
    want, _ = ref.forward(m, T.unflatten(paths, lr), batch["tokens"],
                          model.route_bias)
    assert float((logits - want).detach().abs().max()) \
        <= 1e-5 * float(want.detach().abs().max())
    loss = model.loss_fn(T.unflatten(paths, lp), batch)[0]
    loss_ref = ref.loss(m, T.unflatten(paths, lr), batch, model.route_bias)
    assert abs(float(loss) - float(loss_ref)) <= 1e-5 * abs(float(loss_ref))
    gp = torch.autograd.grad(loss, lp)
    gr = torch.autograd.grad(loss_ref, lr)
    assert _worst_leaf_gap(gp, gr) <= 1e-4


def test_shares_sum_to_the_uncut_layer():
    """The MoE at Moonlight's published counts (64 experts, top-6) in tiny
    widths: the partial outputs of the 8 shares of 8 experts, with the
    shared experts counted once, add up to the uncut reference's layer."""
    cfg = registry.get_config(ARCH, reduced=True).with_overrides(
        d_model=32, num_experts=64, experts_per_token=6, moe_d_ff=16,
        shared_d_ff=32)
    params = M.init_moe((5, 9), cfg, device="cpu")
    g = torch.Generator().manual_seed(1)
    u = torch.randn((2, 12, 32), generator=g)
    bias = torch.randn((64,), generator=g) * BIAS_STD
    m = dict(ref_config(cfg), n_routed_experts=64, expert_offset=0)
    want = ref.moe(m, params, u, bias)[0]
    shared = L.apply_mlp(cfg, {k: v[0] for k, v in params["shared"].items()},
                         u)
    total = shared.clone()
    for s in range(8):
        share = cfg.with_overrides(experts_held=8, expert_offset=8 * s)
        ps = dict(params, experts={k: v[8 * s:8 * s + 8]
                                   for k, v in params["experts"].items()})
        total += M.apply_moe(share, ps, u, bias=bias)[0] - shared
    assert float((total - want).abs().max()) <= 1e-5 * float(want.abs().max())
    whole = M.apply_moe(cfg, params, u, bias=bias)[0]
    assert float((whole - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_bias_moves_selections_but_not_gates():
    """A bias moves some (token, slot) pairs off the unbiased top-k, and
    counts them; the gates stay the chosen experts' unbiased sigmoid
    scores, renormalised and scaled, as the reference's gate gives them."""
    cfg = registry.get_config(ARCH, reduced=True).with_overrides(
        num_experts=16, experts_per_token=4)
    p = M.init_moe((3, 4), cfg, device="cpu")
    g = torch.Generator().manual_seed(2)
    u = torch.randn((64, cfg.d_model), generator=g)
    bias = torch.randn((16,), generator=g) * 0.2
    tel = tele.Telemetry(record_spans=True)
    prev = tele.set_default(tel)
    try:
        gates, idx, _ = M.route(cfg, p, u, 1, bias)
        plain_gates, plain_idx, _ = M.route(cfg, p, u, 1, None)
    finally:
        tele.set_default(prev)
    moved = ~(idx[:, :, None] == plain_idx[:, None, :]).any(-1)
    assert 0 < int(moved.sum()) < idx.numel()
    assert tel.value("moe_bias_moved") == int(moved.sum())
    scores = torch.sigmoid(u @ p["router"])
    want = scores.gather(1, idx)
    want = want / (want.sum(-1, keepdim=True) + 1e-20) * cfg.routed_scaling
    assert torch.equal(gates, want)
    m = ref_config(cfg)
    _, ridx, rgates = ref.gate(m, p, u, bias)
    assert torch.equal(torch.sort(ridx, -1)[0], torch.sort(idx, -1)[0])
    order = torch.argsort(ridx, -1)
    assert torch.allclose(rgates.gather(1, order),
                          gates.gather(1, torch.argsort(idx, -1)),
                          rtol=1e-6, atol=0)


def test_sequence_wise_balance_loss_at_batch_two():
    """The balance loss is per sequence: at batch 2 it is the reference's
    mean of the two sequences' ``sum_i f_i P_i``, which differs from the
    loss of the two taken as one sequence."""
    cfg = registry.get_config(ARCH, reduced=True)
    p = M.init_moe((6, 1), cfg, device="cpu")
    g = torch.Generator().manual_seed(3)
    u = torch.randn((2, 12, cfg.d_model), generator=g)
    u[1] = u[1] * 3.0 + 1.0  # a second sequence routed otherwise
    _, aux = M.apply_moe(cfg, p, u)
    m = ref_config(cfg)
    scores = torch.sigmoid(u.reshape(-1, cfg.d_model) @ p["router"])
    want = ref.seq_balance(m, scores, 2)
    assert abs(float(aux) / cfg.router_aux_weight - float(want)) \
        <= 1e-6 * float(want)
    assert abs(float(ref.seq_balance(m, scores, 1)) - float(want)) \
        > 1e-3 * float(want)


def test_bias_is_no_parameter_and_a_round_leaves_it():
    """The selection bias is state apart from the parameters: the delta's
    leaves are the parameters' (no bias among them), and after a round of
    clip, TEE noise, the 32-bit field and FedAvg the bias is bit-identical
    while the parameters moved."""
    cfg, model, params, batch = _setup("share", seed=4)
    bias0 = model.route_bias.clone()
    assert len(T.leaves(params)) == len(T.leaves(param_shapes(cfg)))
    assert not any("bias" in "/".join(p) for p in T.flatten(params)[0])
    fl = FLConfig(cohort_size=2, local_lr=1.0, clip_norm=0.1,
                  noise_multiplier=0.3, secure_agg_bits=32)
    batch = {k: v[:, None] for k, v in batch.items()}
    step = build_round_step(model.loss_fn, fl, cohort_size=2,
                            clients_per_chunk=1, device="cpu")
    state, metrics = step(init_fl_state(params, fl), batch, (1, 2))
    assert torch.equal(model.route_bias, bias0)
    assert len(T.leaves(state.params)) == len(T.leaves(params))
    assert float(metrics["clip_fraction"]) == 1.0
    assert any(not torch.equal(a, b) for a, b in
               zip(T.leaves(state.params), T.leaves(params)))


def test_one_round_matches_the_reference_round():
    """Noise off, no client clipped: the round's change of the parameters
    is the mean of the reference's client SGD deltas (limit and reason as
    ``test_torch_granite``'s: the f32 add rounds a norm scale of 1 by up to
    6e-8 against changes of ~1e-4 an element)."""
    cfg, model, params, batch = _setup("share", seed=3)
    fl = FLConfig(cohort_size=2, local_lr=1.0, clip_norm=1e6,
                  noise_multiplier=0.0, secure_agg_bits=32)
    batch = {k: v[:, None] for k, v in batch.items()}
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
            ref.loss(m, T.unflatten(paths, leaves), cb, model.route_bias),
            leaves)
        for a, g in zip(acc, grads):
            a.add_(-g / 2)
    got = [a - b for a, b in zip(T.leaves(state.params), p0)]
    acc = [(b + a) - b for a, b in zip(acc, p0)]
    assert _worst_leaf_gap(got, acc) <= 1e-3


def test_softmax_router_unchanged():
    """Granite's and deepseek-moe's router: softmax, stable top-k,
    renormalised gates, the Switch loss; bit for bit as written out here,
    whatever bias or sequence count is passed."""
    for arch in ("granite-4.0-h-small", "deepseek-moe-16b"):
        cfg = registry.get_config(arch, reduced=True)
        p = M.init_moe((8, 2), cfg, device="cpu")
        u = torch.randn((24, cfg.d_model),
                        generator=torch.Generator().manual_seed(5))
        probs = torch.softmax((u @ p["router"]).float(), dim=-1)
        vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
        k, E = cfg.experts_per_token, cfg.num_experts
        gates, idx = vals[:, :k], order[:, :k]
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        frac = torch.bincount(idx.reshape(-1), minlength=E).float() \
            / torch.tensor(float(24 * k))
        aux = E * torch.sum(frac * probs.mean(0))
        for got in (M.route(cfg, p, u), M.route(cfg, p, u, 2, None)):
            assert torch.equal(got[0], gates) and torch.equal(got[1], idx)
            assert torch.equal(got[2], aux)


def test_registry_widths_and_counts():
    cfg = registry.get_config(ARCH)
    assert ARCH not in registry.ARCH_IDS
    assert (cfg.num_layers, cfg.d_model, cfg.num_experts,
            cfg.experts_per_token, cfg.vocab_size) == (27, 2048, 64, 6,
                                                       163_840)
    assert cfg.layer_kinds == ("mla",) + ("mla_moe",) * 26
    n = sum(s.numel() for s in T.leaves(param_shapes(cfg)))
    assert n == 15_960_108_544
    cut = cfg.with_overrides(experts_held=8, vocab_size=20_480)
    shapes = T.leaves(param_shapes(cut))
    assert (sum(s.numel() for s in shapes), len(shapes)) == \
        (2_777_411_072, 27)
    assert cut.param_count() + cut.d_model == 2_777_411_072
    assert M.route_bias_shape(cut) == (26, 64)


def test_spans_and_counters():
    """While the default registry records spans: a fenced ``mla`` span per
    layer and ``moe`` per MoE FFN of the forward pass (none for the
    backward, remat's recomputation included), labelled with the layer;
    the share's pair counters and ``moe_bias_moved``."""
    cfg, model, params, batch = _setup("share", remat=True)
    tel = tele.Telemetry(record_spans=True, fence=True)
    prev = tele.set_default(tel)
    try:
        paths, leaves = T.flatten(params)
        lp = [x.requires_grad_(True) for x in leaves]
        loss = model.loss_fn(T.unflatten(paths, lp), batch)[0]
        torch.autograd.grad(loss, lp)
    finally:
        tele.set_default(prev)
    assert [s.labels["layer"] for s in tel.spans if s.name == "mla"] == \
        list(range(cfg.num_layers))
    assert [s.labels["layer"] for s in tel.spans if s.name == "moe"] == \
        list(range(1, cfg.num_layers))
    pairs = 2 * 16 * cfg.experts_per_token * (cfg.num_layers - 1)
    held, other = tel.value("moe_pairs", held=1), tel.value("moe_pairs",
                                                            held=0)
    assert held + other == pairs and 0 < held < pairs
    assert 0 < tel.value("moe_bias_moved") < pairs


def test_train_cli_runs_moonlight():
    from repro_torch.launch import train
    session = {}
    assert train.main(["--arch", ARCH, "--device", "cpu", "--rounds", "2",
                       "--cohort", "2", "--seq-len", "16"],
                      session=session) == 0
    assert len(session["metrics"]) == 2
    assert all(math.isfinite(float(m["loss"])) for m in session["metrics"])


def test_serving_is_refused():
    from repro_torch.launch import serve
    with pytest.raises(NotImplementedError, match="mla"):
        serve.main(["--arch", ARCH, "--device", "cpu"])
    cfg, model, params, batch = _setup("whole")
    for call in (lambda: model.init_cache(1, 8),
                 lambda: model.prefill(params, batch, 32),
                 lambda: model.decode_step(params, None, batch["tokens"], 0)):
        with pytest.raises(NotImplementedError, match="mla"):
            call()
