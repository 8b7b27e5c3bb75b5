"""Kimi-Linear-48B-A3B (Kimi Delta Attention beside NoPE latent attention,
a sigmoid-routed MoE) through the port's normal path (``build_model``, the
round step, the train CLI) against the plain reference
``plain_kimi_linear``, at ``reduced()`` size on the CPU with seeded random
weights and a seeded selection bias: the chunked KDA against the token
recurrence (also at the published decay range), the reference's own
chunked form against its recurrence, the whole model's logits, loss and
gradients, one round, the expert share against the uncut layer, the
selection bias reaching every sigmoid-routed MoE kind, the serve refusal,
spans and counters.

Tolerances, each with its reason: what differs between the port and the
references is the order of operations (chunked against token by token,
the attention chunked, the MoE combine in another order).  In f64 that
leaves ~1e-15 relative, ~1e-14 where decays of ~80 a token are formed as
differences of cumulative sums; the limits are 1e-12.  In f32 it leaves
~3e-7 relative on KDA's output and gradients at the default decays and
~1e-5 on the log-decay's gradient at ~80 a token (a cumulative sum of
~-2500 rounds its differences by ~1e-4 absolute, on factors e^-80); the
limits are 1e-5 and 1e-4.  Whole models as ``test_torch_moonlight``'s:
~1e-6 on logits and loss, ~1e-5 on a gradient leaf, limits 10x above.
"""
import math

import pytest
import torch

from repro_torch import tree as T
from repro_torch.configs import registry
from repro_torch.configs.base import FLConfig
from repro_torch.core import telemetry as tele
from repro_torch.core.fl.round import build_round_step, init_fl_state
from repro_torch.models import kda as K
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.model import build_model, param_shapes
from repro_torch.testing import pin_cpu_threads

import plain_kimi_linear as ref

pin_cpu_threads()

ARCH = "kimi-linear-48b-a3b"
BIAS_STD = 0.05
F64, F32 = torch.float64, torch.float32
TOL = {F64: (1e-12, 1e-12), F32: (1e-5, 1e-5)}


def ref_config(cfg) -> dict:
    """The reference's dict (``config.json`` keys) of a port config."""
    return {
        "hidden_size": cfg.d_model, "num_hidden_layers": cfg.num_layers,
        "first_k_dense_replace": cfg.first_k_dense,
        "num_attention_heads": cfg.num_heads,
        "kv_lora_rank": cfg.kv_lora_rank,
        "qk_nope_head_dim": cfg.qk_nope_head_dim,
        "qk_rope_head_dim": cfg.qk_rope_head_dim,
        "v_head_dim": cfg.v_head_dim, "mla_use_nope": cfg.mla_use_nope,
        "linear_attn_config": {
            "kda_layers": list(cfg.kda_layers),
            "full_attn_layers": list(cfg.full_attn_layers),
            "head_dim": cfg.kda_head_dim, "num_heads": cfg.kda_num_heads,
            "short_conv_kernel_size": cfg.kda_conv_width},
        "rms_norm_eps": cfg.norm_eps, "router_experts": cfg.num_experts,
        "num_experts": cfg.held_experts,
        "expert_offset": cfg.expert_offset,
        "num_experts_per_token": cfg.experts_per_token,
        "routed_scaling_factor": cfg.routed_scaling,
        "aux_loss_alpha": cfg.router_aux_weight,
        "vocab_size": cfg.vocab_size}


# the reduced stack whole, and holding experts [2, 6) of its 8
CONFIGS = {"whole": {}, "share": {"experts_held": 4, "expert_offset": 2}}


def _setup(which: str, seed: int = 0, B: int = 2, S: int = 40, **over):
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


def _inputs(dtype, S, scale=1.0, B=2, H=3, dk=8, dv=6, seed=0):
    """KDA's core inputs as the mixer makes them: unit keys, queries of
    norm ``dk ** -0.5``, ``beta`` in (0, 1); log-decays ``-A softplus(z)``
    with ``A`` over [1, ``scale``] and gate inputs ``z`` N(0, 1) (N(3, 2)
    where ``scale`` is the published 16)."""
    g = torch.Generator().manual_seed(seed)

    def randn(*s):
        return torch.randn(s, generator=g, dtype=dtype)
    q = torch.nn.functional.normalize(randn(B, S, H, dk), dim=-1) \
        * dk ** -0.5
    k = torch.nn.functional.normalize(randn(B, S, H, dk), dim=-1)
    A = torch.linspace(1.0, scale, H, dtype=dtype)[:, None]
    z = randn(B, S, H, dk) * (2.0 if scale > 1 else 1.0) \
        + (3.0 if scale > 1 else 0.0)
    gdec = -A * torch.nn.functional.softplus(z)
    beta = torch.sigmoid(randn(B, S, H))
    return [q, k, randn(B, S, H, dv), gdec, beta]


def _core_gaps(dtype, S, chunk, scale, chunked):
    """(output gap, worst input-gradient gap) of ``chunked`` against the
    reference's recurrence, relative to the largest element."""
    ins = _inputs(dtype, S, scale)
    w = torch.randn(ins[2].shape, generator=torch.Generator().manual_seed(9),
                    dtype=dtype)
    a = [x.clone().requires_grad_(True) for x in ins]
    b = [x.clone().requires_grad_(True) for x in ins]
    out = chunked(a)
    want = ref.kda_recurrent(*b)
    assert torch.isfinite(out).all()
    ga = torch.autograd.grad((out * w).sum(), a)
    gb = torch.autograd.grad((want * w).sum(), b)
    assert all(torch.isfinite(x).all() for x in ga)
    gap = float((out - want).detach().abs().max() / want.detach().abs().max())
    grad = max(float((x - y).abs().max() / y.abs().max())
               for x, y in zip(ga, gb))
    return gap, grad


# sequence lengths that are and are not multiples of the chunk, a
# sequence shorter than one chunk, several chunks; chunks of one, two and
# four sub-chunks
SHAPES = [(37, 16), (64, 32), (50, 32), (20, 64), (150, 64)]


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
@pytest.mark.parametrize("S,chunk", SHAPES)
def test_chunked_kda_matches_the_recurrence(S, chunk, dtype):
    gap, grad = _core_gaps(dtype, S, chunk, 1.0, lambda a: K.kda_chunked(
        *a, chunk)[0])
    assert gap <= TOL[dtype][0] and grad <= TOL[dtype][1], (gap, grad)


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
def test_chunked_kda_at_the_published_decay_range(dtype):
    """``A`` up to 16 (``A_log`` log 16) and gate inputs around 3: decays
    of up to ~130 a token, thousands over a chunk.  No factor overflows:
    outputs and gradients stay finite and equal to the recurrence's."""
    gap, grad = _core_gaps(dtype, 70, 64, 16.0, lambda a: K.kda_chunked(
        *a, 64)[0])
    assert gap <= TOL[dtype][0] and grad <= (1e-12 if dtype == F64 else 1e-4)
    state = K.kda_chunked(*_inputs(dtype, 70, 16.0), 64)[1]
    assert torch.isfinite(state).all()


def test_no_negated_cumulative_decay_in_the_module():
    """Every decay is formed as ``e^(G_r - G_s)`` with ``r`` at or after
    ``s``: nowhere in ``models/kda.py``'s code is a cumulative log-decay
    (a name starting with ``G``) negated."""
    import ast
    import inspect
    tree = ast.parse(inspect.getsource(K))
    negated = [ast.unparse(n) for n in ast.walk(tree)
               if isinstance(n, ast.UnaryOp) and isinstance(n.op, ast.USub)
               and any(isinstance(x, ast.Name) and x.id.startswith("G")
                       for x in ast.walk(n.operand))]
    assert not negated, negated


@pytest.mark.parametrize("dtype,scale", [(F64, 1.0), (F32, 1.0),
                                         (F64, 16.0)],
                         ids=["f64", "f32", "f64-published"])
def test_reference_chunked_form_matches_its_recurrence(dtype, scale):
    gap, grad = _core_gaps(dtype, 50, 16, scale,
                           lambda a: ref.kda_chunk(*a, 16))
    assert gap <= TOL[dtype][0] and grad <= TOL[dtype][1], (gap, grad)


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


def test_reference_chunked_model_matches_its_recurrence():
    """The whole reference with KDA in chunks of 16 (the bench copy's path
    on the card) against the same with the recurrence, in f64."""
    cfg, model, params, batch = _setup("share")
    m = ref_config(cfg)
    p = T.tree_map(lambda x: x.double(), params)
    bias = model.route_bias.double()
    a = ref.forward(m, p, batch["tokens"], bias, chunk=16)[0]
    b = ref.forward(m, p, batch["tokens"], bias, chunk=0)[0]
    assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())


def test_one_round_matches_the_reference_round():
    """Noise off, no client clipped: the round's change of the parameters
    is the mean of the reference's client SGD deltas (limit and reason as
    ``test_torch_moonlight``'s)."""
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


def test_shares_sum_to_the_uncut_layer():
    """The MoE at Kimi-Linear's published counts (256 experts, top-8, one
    shared) in tiny widths: the partial outputs of the 32 shares of 8
    experts, with the shared expert counted once, add up to the uncut
    reference's layer."""
    cfg = registry.get_config(ARCH, reduced=True).with_overrides(
        d_model=16, num_experts=256, experts_per_token=8, moe_d_ff=8,
        shared_d_ff=8)
    params = M.init_moe((5, 9), cfg, device="cpu")
    g = torch.Generator().manual_seed(1)
    u = torch.randn((2, 12, 16), generator=g)
    bias = torch.randn((256,), generator=g) * BIAS_STD
    m = dict(ref_config(cfg), num_experts=256, expert_offset=0)
    want = ref.moe(m, params, u, bias)[0]
    shared = L.apply_mlp(cfg, {k: v[0] for k, v in params["shared"].items()},
                         u)
    total = shared.clone()
    for s in range(32):
        share = cfg.with_overrides(experts_held=8, expert_offset=8 * s)
        ps = dict(params, experts={k: v[8 * s:8 * s + 8]
                                   for k, v in params["experts"].items()})
        total += M.apply_moe(share, ps, u, bias=bias)[0] - shared
    assert float((total - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_every_sigmoid_moe_kind_takes_the_selection_bias():
    """The bias reaches ``kda_moe`` as it reaches ``mla_moe``: a large bias
    on one expert moves the routing of both kinds (so the logits change),
    and the port stays equal to the reference given the same bias."""
    cfg, model, params, batch = _setup("whole")
    m = ref_config(cfg)
    tilted = torch.zeros(M.route_bias_shape(cfg))
    tilted[:, 0] = 10.0  # every token's top-3 holds expert 0
    tel = tele.Telemetry(record_spans=True)
    prev = tele.set_default(tel)
    try:
        plain = build_model(cfg, device="cpu").apply(params, batch)[0]
        moved = build_model(cfg, device="cpu", route_bias=tilted).apply(
            params, batch)[0]
    finally:
        tele.set_default(prev)
    assert not torch.allclose(plain, moved)
    kinds = [k for k in cfg.layer_kinds if k in M.MOE_KINDS]
    assert set(kinds) == {"kda_moe", "mla_moe"}
    # each MoE layer's moved pairs: at least the tokens whose unbiased
    # top-3 lacked expert 0
    assert tel.value("moe_bias_moved") > 0
    # every token's largest gate on one expert: its rounding, summed in
    # another order, reaches ~1e-5 of the largest logit here (1e-4 is 10x)
    want = ref.forward(m, params, batch["tokens"], tilted)[0]
    assert float((moved - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_held_experts_no_token_chose_take_zero_gradients():
    """A selection bias that keeps every token off the held experts: the
    port's and the reference's gradients agree, the experts' are zero (the
    reference still runs them, on no rows, so its gradient has them)."""
    cfg, model, params, batch = _setup("share")
    away = torch.zeros(M.route_bias_shape(cfg))
    away[:, 2:6] = -10.0  # the held experts [2, 6) are never chosen
    model = build_model(cfg, device="cpu", route_bias=away)
    paths, leaves = T.flatten(params)
    lp = [x.clone().requires_grad_(True) for x in leaves]
    lr = [x.clone().requires_grad_(True) for x in leaves]
    gp = torch.autograd.grad(model.loss_fn(T.unflatten(paths, lp), batch)[0],
                             lp)
    gr = torch.autograd.grad(ref.loss(ref_config(cfg), T.unflatten(paths, lr),
                                      batch, away), lr)
    experts = [i for i, q in enumerate(paths) if "experts" in q]
    assert experts and all(not gp[i].any() and not gr[i].any()
                           for i in experts)
    assert _worst_leaf_gap(gp, gr) <= 1e-4


def test_softmax_moe_kinds_stay_unbiased():
    """Granite's ``ssm_moe`` and ``moe`` blocks route by softmax: a
    selection bias handed to the stack changes nothing, bit for bit."""
    cfg = registry.get_config("granite-4.0-h-small", reduced=True)
    assert cfg.router_score == "softmax"
    assert "ssm_moe" in cfg.layer_kinds
    model = build_model(cfg, device="cpu")
    assert model.route_bias is None
    params = model.init((4, 2))
    toks = torch.randint(0, cfg.vocab_size, (2, 12),
                         generator=torch.Generator().manual_seed(3))
    bias = torch.randn(M.route_bias_shape(cfg),
                       generator=torch.Generator().manual_seed(4))
    biased = build_model(cfg, device="cpu", route_bias=bias)
    assert torch.equal(model.apply(params, {"tokens": toks})[0],
                       biased.apply(params, {"tokens": toks})[0])


def test_registry_widths_and_counts():
    cfg = registry.get_config(ARCH)
    assert ARCH not in registry.ARCH_IDS
    assert (cfg.num_layers, cfg.d_model, cfg.num_experts,
            cfg.experts_per_token, cfg.vocab_size, cfg.kda_num_heads,
            cfg.kda_head_dim, cfg.kda_chunk) == (27, 2304, 256, 8, 163_840,
                                                 32, 128, 64)
    kinds = cfg.layer_kinds
    assert kinds[0] == "kda"
    assert [i for i, k in enumerate(kinds) if k == "mla_moe"] == \
        [3, 7, 11, 15, 19, 23, 26]
    assert kinds.count("kda_moe") == 19 and len(kinds) == 27
    cut = cfg.with_overrides(experts_held=8, vocab_size=20_480)
    shapes = T.leaves(param_shapes(cut))
    # by hand: 20 KDA mixers of 39,518,368, 7 MLA of 29,114,880, 26 MoE
    # FFNs of 64,290,816 (the router's 256 x 2304, 8 experts, the shared
    # one), the dense FFN of 63,700,992, the embedding and head of
    # 94,371,840, two norms a layer and the final one
    hand = (20 * 39_518_368 + 7 * 29_114_880 + 26 * 64_290_816
            + 63_700_992 + 94_371_840 + 55 * 2304)
    assert hand == 2_823_932_288
    assert sum(s.numel() for s in shapes) == hand
    assert cut.param_count() + cut.d_model == hand
    assert M.route_bias_shape(cut) == (26, 256)


def test_spans_and_counters():
    """While the default registry records spans: a fenced ``kda`` span per
    KDA layer and ``mla`` per MLA layer of the forward pass (none for the
    backward, remat's recomputation included), labelled with the layer;
    ``kda_chunk_steps`` the loop's steps, ceil(S / chunk) a KDA layer's
    forward pass."""
    for S in (40, 64, 70):
        cfg, model, params, batch = _setup("share", S=S, remat=True)
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
        assert [s.labels["layer"] for s in tel.spans if s.name == "kda"] == \
            [i for i, k in enumerate(kinds) if k.startswith("kda")]
        assert [s.labels["layer"] for s in tel.spans if s.name == "mla"] == \
            [i for i, k in enumerate(kinds) if k.startswith("mla")]
        assert [s.labels["layer"] for s in tel.spans if s.name == "moe"] == \
            list(range(1, cfg.num_layers))
        assert tel.value("kda_chunk_steps") == \
            math.ceil(S / cfg.kda_chunk) * sum(k.startswith("kda")
                                               for k in kinds)


def test_train_cli_runs_kimi_linear():
    from repro_torch.launch import train
    session = {}
    assert train.main(["--arch", ARCH, "--device", "cpu", "--rounds", "2",
                       "--cohort", "2", "--seq-len", "16"],
                      session=session) == 0
    assert len(session["metrics"]) == 2
    assert all(math.isfinite(float(m["loss"])) for m in session["metrics"])


def test_serving_is_refused():
    from repro_torch.launch import serve
    with pytest.raises(NotImplementedError, match="kda"):
        serve.main(["--arch", ARCH, "--device", "cpu"])
    cfg, model, params, batch = _setup("whole")
    for call in (lambda: model.init_cache(1, 8),
                 lambda: model.prefill(params, batch, 32),
                 lambda: model.decode_step(params, None, batch["tokens"], 0)):
        with pytest.raises(NotImplementedError, match="kda"):
            call()
