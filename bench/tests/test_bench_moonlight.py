"""The Moonlight training cell on the CPU at a small size: the configuration
file against the system's parameter count, the benchmark's copy of the
reference against the test suite's, the work counts against a hand count,
the new readers, and the ``train_lm_ref`` entry's rehearsal with its
span and counter readers."""
import copy
import importlib.util
import math

import pytest
import torch

from bench import harness as H
from bench import run as R
from bench.reference import moonlight as ref
from bench.work import moonlight as work

BM = H.benchmark()
CELL = "train.moonlight-16b-a3b"
NEW_METRICS = [m["name"] for m in BM["per_layer"]
               if m.get("workloads") == [CELL]]

# every width cut, the published counts kept: 64 router outputs, top-6, 8
# experts held, one dense layer; 3 layers of the 27 for the CPU's time
SMALL = {"hidden_size": 64, "num_attention_heads": 4, "kv_lora_rank": 32,
         "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
         "intermediate_size": 96, "moe_intermediate_size": 16,
         "vocab_size": 256, "num_hidden_layers": 3}
SMALL_PORT = {"d_model": 64, "num_heads": 4, "num_kv_heads": 4,
              "kv_lora_rank": 32, "qk_nope_head_dim": 16,
              "qk_rope_head_dim": 8, "v_head_dim": 16, "d_ff": 96,
              "moe_d_ff": 16, "shared_d_ff": 32, "vocab_size": 256,
              "num_layers": 3}


def small_spec() -> dict:
    spec = copy.deepcopy(H.cell_spec(CELL))
    spec["model"].update(SMALL)
    spec["model"]["overrides"] = dict(spec["model"]["overrides"],
                                      **SMALL_PORT)
    spec["traffic"].update(seq_len=16)
    return spec


def test_config_counts_and_cut():
    from repro_torch.models.model import param_shapes
    m = H.cell_spec(CELL)["model"]
    shapes = [s for _, s in H.flatten(param_shapes(H.port_config(m)))]
    n = sum(math.prod(s) for s in shapes)
    assert (n, len(shapes)) == (m["params"], m["leaves"]) \
        == work.param_leaves(m) == (2_777_411_072, 27)
    assert m["reduced"] == ["n_routed_experts", "vocab_size"]
    assert (m["n_routed_experts"], m["vocab_size"], m["router_experts"]) \
        == (8, 20_480, 64)
    assert m["published"] == {"n_routed_experts": 64, "vocab_size": 163_840}
    cfg = H.port_config(m)
    assert (cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
            cfg.v_head_dim, cfg.num_heads, cfg.d_model) == \
        (m["kv_lora_rank"], m["qk_nope_head_dim"], m["qk_rope_head_dim"],
         m["v_head_dim"], m["num_attention_heads"], m["hidden_size"])
    assert (cfg.experts_per_token, cfg.routed_scaling, cfg.norm_eps,
            cfg.rope_theta, cfg.router_aux_weight) == \
        (m["num_experts_per_tok"], m["routed_scaling_factor"],
         m["rms_norm_eps"], m["rope_theta"], m["aux_loss_alpha"])
    assert cfg.shared_width == m["n_shared_experts"] \
        * m["moe_intermediate_size"]


def _plain():
    spec = importlib.util.spec_from_file_location(
        "plain_moonlight", H.ROOT / "tests" / "plain_moonlight.py")
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
    toks = torch.randint(0, m["vocab_size"], (1, 17), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "loss_mask": torch.ones((1, 16))}
    plain = _plain()
    want = plain.forward(m, p, batch["tokens"], bias)[0]
    assert torch.equal(ref.forward(m, p, batch["tokens"], bias)[0], want)
    assert torch.equal(ref.forward(m, p, batch["tokens"], bias,
                                   remat=True)[0], want)
    assert torch.equal(ref.loss(m, p, batch, bias),
                       plain.loss(m, p, batch, bias))


def test_work_counts_against_a_hand_count():
    m = {"hidden_size": 8, "num_attention_heads": 2, "kv_lora_rank": 4,
         "qk_nope_head_dim": 3, "qk_rope_head_dim": 2, "v_head_dim": 3,
         "moe_intermediate_size": 5, "intermediate_size": 7,
         "n_shared_experts": 2, "router_experts": 6, "n_routed_experts": 2,
         "first_k_dense_replace": 1, "num_hidden_layers": 3,
         "num_experts_per_tok": 3, "vocab_size": 20}
    seq, pairs = 8, 5
    mla = (2 * 8 * 2 * 5 + 2 * 8 * 6 + 2 * 4 * 2 * 6 + 2 * 2 * 3 * 8
           + 2 * 4 * 2 * 5 + 2 * 4 * 2 * 3)
    dense = 3 * 2 * 8 * 7
    moe = 2 * 8 * 6 + 3 * 2 * 8 * 10
    hand = seq * (3 * mla + dense + 2 * moe + 2 * 8 * 20) \
        + pairs * 3 * 2 * 8 * 5
    assert work.forward_flops(m, seq, pairs) == hand
    assert work.routed_held_pairs(m, seq) == 2 * 8 * 3 * 2 / 6
    w = work.round_work(m, 1000, 4, seq, True, pairs)
    assert w["flops"] == 3 * 4 * hand
    assert w["int_ops"] == (4 * 1000 + 1000) * 20 * 3
    p_mla = 8 * 2 * 5 + 8 * 6 + 4 + 4 * 2 * 6 + 2 * 3 * 8
    n = (2 * 20 * 8 + 8 + (p_mla + 3 * 8 * 7 + 16)
         + 2 * (p_mla + 8 * 6 + 3 * 8 * 5 * 2 + 3 * 8 * 10 + 16))
    assert work.param_leaves(m) == (n, 27)


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
    # leaf can be 64 elements, whose norm rounds by up to ~1e-7 relative
    checks = run.check(spec["cell"]["limits"])
    assert all(v <= 1e-6 for v, _ in checks.values()), checks
    # no profile here, and the CPU draws no uniforms on a card
    assert set(got) == {m["name"] for m in per_layer} \
        - {"idle_share.moonlight", "prf_draws.moonlight"}
    assert 0 < got["held_pairs.moonlight"]["value"] < 100
    assert got["expert_load_max.moonlight"]["value"] >= 1
    assert got["uniforms_ms.moonlight"]["value"] > 0
    assert 0 < got["bias_moved.moonlight"]["value"] < 100
    assert 0 < got["round_mfu.moonlight"]["value"] < 100
    assert got["local_sgd_ms.moonlight"]["value"] \
        > got["mla_ms.moonlight"]["value"] > 0
    assert got["moe_ms.moonlight"]["value"] > 0


def test_run_cell_on_the_cpu():
    out, checks = R.run_cell(CELL, small_spec(), 2 ** 31 + 11, 0.5, False,
                             "cpu")
    # the limits are the card's at full width (PERF.md §2); a 64-element
    # leaf's norm rounds by up to ~1e-7 relative here
    assert all(v <= 1e-6 for v, _ in checks.values()), checks
    assert set(out["checks"]) == set(H.cell_spec(CELL)["cell"]["limits"])
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"round_s", "setup_s"}
