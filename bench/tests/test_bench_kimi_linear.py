"""The Kimi-Linear training cell on the CPU at a small size: the
configuration file against the system's parameter count, the benchmark's
copy of the reference against the test suite's, the work counts against a
hand count, the new readers, and the ``train_lm_ref`` entry's rehearsal
with its span and counter readers."""
import copy
import importlib.util
import math
import sys

import pytest
import torch

from bench import harness as H
from bench import run as R
from bench.reference import kimi_linear as ref
from bench.work import kimi_linear as work

BM = H.benchmark()
CELL = "train.kimi-linear-48b-a3b"
NEW_METRICS = [m["name"] for m in BM["per_layer"]
               if m.get("workloads") == [CELL]]

# every width cut, the published counts kept: 256 router outputs, top-8,
# 8 experts held, one dense layer; 6 layers of the 27 (a whole 3:1 period,
# then KDA and a second MLA), KDA in chunks of 16 over 40 tokens
LAYERS = {"kda_layers": [1, 2, 3, 5], "full_attn_layers": [4, 6]}
SMALL = {"hidden_size": 64, "num_attention_heads": 4, "kv_lora_rank": 32,
         "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
         "intermediate_size": 96, "moe_intermediate_size": 16,
         "vocab_size": 256, "num_hidden_layers": 6, "kda_chunk": 16}
SMALL_PORT = {"d_model": 64, "num_heads": 4, "num_kv_heads": 4,
              "kv_lora_rank": 32, "qk_nope_head_dim": 16,
              "qk_rope_head_dim": 8, "v_head_dim": 16, "d_ff": 96,
              "moe_d_ff": 16, "shared_d_ff": 16, "vocab_size": 256,
              "num_layers": 6, "kda_num_heads": 2, "kda_head_dim": 16,
              "kda_chunk": 16, **LAYERS}


def small_spec() -> dict:
    spec = copy.deepcopy(H.cell_spec(CELL))
    spec["model"].update(SMALL)
    spec["model"]["linear_attn_config"].update(
        LAYERS, num_heads=2, head_dim=16)
    spec["model"]["overrides"] = dict(spec["model"]["overrides"],
                                      **SMALL_PORT)
    spec["traffic"].update(seq_len=40)
    return spec


def test_config_counts_and_cut():
    from repro_torch.models.model import param_shapes
    m = H.cell_spec(CELL)["model"]
    shapes = [s for _, s in H.flatten(param_shapes(H.port_config(m)))]
    n = sum(math.prod(s) for s in shapes)
    assert (n, len(shapes)) == (m["params"], m["leaves"]) \
        == work.param_leaves(m) == (2_823_932_288, 597)
    assert m["reduced"] == ["num_experts", "vocab_size"]
    assert (m["num_experts"], m["vocab_size"], m["router_experts"]) \
        == (8, 20_480, 256)
    assert m["published"] == {"num_experts": 256, "vocab_size": 163_840}
    cfg = H.port_config(m)
    la = m["linear_attn_config"]
    assert (cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
            cfg.v_head_dim, cfg.num_heads, cfg.d_model, cfg.mla_use_nope) \
        == (m["kv_lora_rank"], m["qk_nope_head_dim"], m["qk_rope_head_dim"],
            m["v_head_dim"], m["num_attention_heads"], m["hidden_size"],
            m["mla_use_nope"])
    assert (list(cfg.kda_layers), list(cfg.full_attn_layers),
            cfg.kda_num_heads, cfg.kda_head_dim, cfg.kda_conv_width,
            cfg.kda_chunk) == \
        (la["kda_layers"], la["full_attn_layers"], la["num_heads"],
         la["head_dim"], la["short_conv_kernel_size"], m["kda_chunk"])
    assert (cfg.experts_per_token, cfg.routed_scaling, cfg.norm_eps,
            cfg.router_aux_weight, cfg.first_k_dense, cfg.d_ff,
            cfg.moe_d_ff) == \
        (m["num_experts_per_token"], m["routed_scaling_factor"],
         m["rms_norm_eps"], m["aux_loss_alpha"], m["first_k_dense_replace"],
         m["intermediate_size"], m["moe_intermediate_size"])
    assert cfg.shared_width == m["num_shared_experts"] \
        * m["moe_intermediate_size"]


def _plain():
    spec = importlib.util.spec_from_file_location(
        "plain_kimi_linear", H.ROOT / "tests" / "plain_kimi_linear.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_reference_copy_equals_the_test_suites():
    from repro_torch.models.model import param_shapes
    from repro_torch.models.moe import route_bias_shape
    m = small_spec()["model"]
    cfg = H.port_config(m)
    flat = H.flatten(param_shapes(cfg))
    paths = [p for p, _ in flat]
    gen = torch.Generator().manual_seed(2 ** 31 + 5)
    _, leaves = H.make_params(paths, [tuple(s) for _, s in flat], gen, "cpu",
                              0.02)
    p = H.unflatten(paths, leaves)
    bias = torch.randn(route_bias_shape(cfg), generator=gen) * 0.02
    toks = torch.randint(0, m["vocab_size"], (1, 41), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "loss_mask": torch.ones((1, 40))}
    plain = _plain()
    for chunk in (None, 0):  # the configuration's chunks, the recurrence
        want = plain.forward(m, p, batch["tokens"], bias, chunk)[0]
        assert torch.equal(ref.forward(m, p, batch["tokens"], bias,
                                       chunk)[0], want)
        assert torch.equal(ref.forward(m, p, batch["tokens"], bias, chunk,
                                       remat=True)[0], want)
    assert torch.equal(ref.loss(m, p, batch, bias),
                       plain.loss(m, p, batch, bias))


def test_reference_imports_nothing_of_the_system():
    """The bench copy and the test suite's reference import neither the
    system nor JAX."""
    import subprocess
    code = ("import sys; sys.path[:0] = [{root!r}, {tests!r}]\n"
            "import bench.reference.kimi_linear, plain_kimi_linear\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('repro_torch', 'repro', 'jax', 'jaxlib', 'flax'))\n"
            "print(bad)").format(root=str(H.ROOT),
                                 tests=str(H.ROOT / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "[]"


def test_work_counts_against_a_hand_count():
    m = {"hidden_size": 8, "num_attention_heads": 2, "kv_lora_rank": 4,
         "qk_nope_head_dim": 3, "qk_rope_head_dim": 2, "v_head_dim": 3,
         "linear_attn_config": {"kda_layers": [1, 2], "full_attn_layers": [3],
                                "num_heads": 2, "head_dim": 4,
                                "short_conv_kernel_size": 4},
         "moe_intermediate_size": 5, "intermediate_size": 7,
         "num_shared_experts": 1, "router_experts": 6, "num_experts": 2,
         "first_k_dense_replace": 1, "num_hidden_layers": 3,
         "num_experts_per_token": 3, "vocab_size": 20}
    seq, pairs = 8, 5
    # KDA: q, k, v (8 -> 2 x 4) and out; decay and gate 8 -> 4 -> 8 each;
    # beta 8 -> 2; the recurrence 7 x 4 x 4 a head
    kda = (3 * 2 * 8 * 8 + 2 * 8 * 8 + 2 * 2 * (8 * 4 + 4 * 8) + 2 * 8 * 2
           + 7 * 2 * 4 * 4)
    mla = (2 * 8 * 2 * 5 + 2 * 8 * 6 + 2 * 4 * 2 * 6 + 2 * 2 * 3 * 8
           + 2 * 4 * 2 * 5 + 2 * 4 * 2 * 3)
    dense = 3 * 2 * 8 * 7
    moe = 2 * 8 * 6 + 3 * 2 * 8 * 5
    hand = seq * (2 * kda + mla + dense + 2 * moe + 2 * 8 * 20) \
        + pairs * 3 * 2 * 8 * 5
    assert work.forward_flops(m, seq, pairs) == hand
    assert work.routed_held_pairs(m, seq) == 2 * 8 * 3 * 2 / 6
    w = work.round_work(m, 1000, 4, seq, True, pairs)
    assert w["flops"] == 3 * 4 * hand
    assert w["int_ops"] == (4 * 1000 + 1000) * 20 * 3
    p_kda = (4 * 8 * 8 + 3 * 4 * 8 + 2 * (8 * 4 + 4 * 8) + 8 + 8 * 2 + 2 + 8
             + 4)
    p_mla = 8 * 2 * 5 + 8 * 6 + 4 + 4 * 2 * 6 + 2 * 3 * 8
    p_moe = 8 * 6 + 3 * 8 * 5 * 2 + 3 * 8 * 5
    n = (2 * 20 * 8 + 8 + 3 * 2 * 8 + 2 * p_kda + p_mla + 3 * 8 * 7
         + 2 * p_moe)
    # embed, unembed, final norm; 2 norms a layer; 16 KDA leaves a layer,
    # 5 MLA; the dense SwiGLU's 3; the MoE's 7
    assert work.param_leaves(m) == (n, 3 + 6 + 32 + 5 + 3 + 14)


@pytest.mark.parametrize("metric", NEW_METRICS)
@pytest.mark.parametrize("entry", ["agg", "train", "train_lm", "tier"])
def test_new_readers_read_only_their_entry(metric, entry):
    mod = H.load_module(H.BENCH / "metrics" / f"{metric}.py", "m")
    ctx = {"entry": entry, "spans": [], "window_s": 1.0, "profile": None,
           "work": {}, "cell": None}
    assert mod.read(ctx) is None


def test_rehearsal_and_its_readers():
    from repro_torch.core.telemetry import Telemetry
    spec = small_spec()
    tel = Telemetry(record_spans=True, fence=True)
    run = H.load_entry("train_lm_ref").Cell(spec, 2 ** 31 + 3, "cpu", tel)
    n0 = len(tel.spans)
    run.window(0.5)
    _, per_layer = H.metrics_for(CELL, BM)
    ctx = {"entry": "train_lm_ref", "spans": tel.spans[n0:],
           "window_s": run.window_s, "profile": None, "work": run.work(),
           "cell": run}
    got = H.read_layer_metrics(per_layer, ctx)
    # the cell's limits hold at full width on the card (PERF.md §2); here a
    # leaf can be 16 elements, whose norm rounds by up to ~1e-7 relative
    checks = run.check(spec["cell"]["limits"])
    assert all(v <= 1e-6 for v, _ in checks.values()), checks
    # no profile here, and the CPU draws no uniforms on a card
    assert set(got) == {m["name"] for m in per_layer} \
        - {"idle_share.kimi", "prf_draws.kimi"}
    assert 0 < got["held_pairs.kimi"]["value"] < 100
    assert got["expert_load_max.kimi"]["value"] >= 1
    assert got["uniforms_ms.kimi"]["value"] > 0
    assert 0 < got["bias_moved.kimi"]["value"] < 100
    # ceil(40 / 16) steps a KDA layer's forward pass, 4 KDA layers, a
    # cohort of 4 a round
    assert got["kda_chunk_steps.kimi"]["value"] == 3 * 4 * 4
    assert 0 < got["round_mfu.kimi"]["value"] < 100
    assert got["local_sgd_ms.kimi"]["value"] \
        > got["kda_ms.kimi"]["value"] > 0
    assert got["mla_ms.kimi"]["value"] > 0
    assert got["moe_ms.kimi"]["value"] > 0


def test_run_cell_on_the_cpu():
    out, checks = R.run_cell(CELL, small_spec(), 2 ** 31 + 11, 0.5, False,
                             "cpu")
    # the limits are the card's at full width (PERF.md §2); a 16-element
    # leaf's norm rounds by up to ~1e-7 relative here
    assert all(v <= 1e-6 for v, _ in checks.values()), checks
    assert set(out["checks"]) == set(H.cell_spec(CELL)["cell"]["limits"])
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"round_s", "setup_s"}
