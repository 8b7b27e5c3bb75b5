"""The Granite training cell and the four-card tier cell on the CPU at a
small size: the benchmark's copy of the Granite reference against the test
suite's, the work counts against a hand count, the new readers, one
version of the tier at world size 4 over gloo, and the decoder-LM entry's
rehearsal with its span and counter readers."""
import copy
import importlib.util
import math

import pytest
import torch

from bench import harness as H
from bench import run as R
from bench.reference import granite as ref
from bench.tests.small import SMALL_MODELS
from bench.work import granite as work

BM = H.benchmark()
GRANITE = "train.granite-4.0-h-small"
TIER = "tier.mamba2-780m.nccl4"
NEW_METRICS = [m["name"] for m in BM["per_layer"]
               if m.get("workloads") in ([GRANITE], [TIER])]

# every width cut, the published counts kept: 10 layers of the pattern, 72
# router outputs, top-10, 8 experts held
SMALL_GRANITE = {"hidden_size": 64, "num_attention_heads": 4,
                 "num_key_value_heads": 2, "mamba_n_heads": 8,
                 "mamba_d_head": 16, "mamba_d_state": 16,
                 "mamba_chunk_size": 8, "intermediate_size": 16,
                 "shared_intermediate_size": 24, "vocab_size": 256}
SMALL_GRANITE_PORT = {"d_model": 64, "num_heads": 4, "num_kv_heads": 2,
                      "head_dim": 16, "ssm_state_dim": 16, "ssm_head_dim": 16,
                      "ssm_chunk": 8, "moe_d_ff": 16, "shared_d_ff": 24,
                      "vocab_size": 256}


def granite_spec() -> dict:
    spec = copy.deepcopy(H.cell_spec(GRANITE))
    spec["model"].update(SMALL_GRANITE)
    spec["model"]["overrides"] = dict(spec["model"]["overrides"],
                                      **SMALL_GRANITE_PORT)
    spec["traffic"].update(seq_len=16)
    return spec


def tier_spec() -> dict:
    spec = copy.deepcopy(H.cell_spec(TIER))
    cut = SMALL_MODELS["mamba2-780m"]
    spec["model"].update(cut)
    spec["model"]["overrides"] = dict(spec["model"]["overrides"], **cut)
    spec["traffic"].update(chunk_elems=4096)
    return spec


def test_config_counts_and_cut():
    from repro_torch.models.model import param_shapes
    m = H.cell_spec(GRANITE)["model"]
    shapes = [s for _, s in H.flatten(param_shapes(H.port_config(m)))]
    n = sum(math.prod(s) for s in shapes)
    assert (n, len(shapes)) == (m["params"], m["leaves"]) \
        == work.param_leaves(m) == (2_320_321_152, 168)
    assert m["reduced"] == ["num_hidden_layers", "num_local_experts"]
    assert (m["num_hidden_layers"], m["num_local_experts"]) == (10, 8)
    assert m["published"] == {"num_hidden_layers": 40,
                              "num_local_experts": 72}
    assert work.layer_types(m).count("attention") == 1


def _plain_granite():
    spec = importlib.util.spec_from_file_location(
        "plain_granite", H.ROOT / "tests" / "plain_granite.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_reference_copy_equals_the_test_suites():
    from repro_torch.models.model import param_shapes
    spec = granite_spec()
    m = spec["model"]
    flat = H.flatten(param_shapes(H.port_config(m)))
    paths = [p for p, _ in flat]
    shapes = [tuple(s) for _, s in flat]
    gen = torch.Generator().manual_seed(2 ** 31 + 5)
    _, leaves = H.make_params(paths, shapes, gen, "cpu", 0.02)
    p = H.unflatten(paths, leaves)
    toks = torch.randint(0, m["vocab_size"], (1, 17), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "loss_mask": torch.ones((1, 16))}
    plain = _plain_granite()
    want = plain.forward(m, p, batch["tokens"])[0]
    assert torch.equal(ref.forward(m, p, batch["tokens"])[0], want)
    assert torch.equal(ref.forward(m, p, batch["tokens"], remat=True)[0],
                       want)
    assert torch.equal(ref.loss(m, p, batch), plain.loss(m, p, batch))


def test_work_counts_against_a_hand_count():
    m = {"hidden_size": 8, "mamba_expand": 2, "mamba_d_state": 4,
         "mamba_n_heads": 4, "mamba_d_head": 4, "mamba_n_groups": 1,
         "mamba_d_conv": 4, "mamba_chunk_size": 4, "num_attention_heads": 2,
         "num_key_value_heads": 1, "intermediate_size": 6,
         "shared_intermediate_size": 10, "router_experts": 6,
         "num_local_experts": 2, "num_experts_per_tok": 3,
         "num_hidden_layers": 2, "layer_types": ["mamba", "attention", "x"],
         "vocab_size": 20}
    seq, pairs = 8, 5
    mamba = (2 * 8 * (32 + 8 + 4) + 2 * 4 * 24 + 2 * 2 * 4 + 2 * 2 * 16
             + 2 * 2 * 16 * 4 + 2 * 16 * 8)
    attn = 2 * 8 * (4 + 2) * 4 + 2 * 2 * 4 * 2 * 4
    moe = 2 * 8 * 6 + 3 * 2 * 8 * 10
    hand = seq * (mamba + attn + 2 * moe + 2 * 8 * 20) + pairs * 3 * 2 * 8 * 6
    assert work.forward_flops(m, seq, pairs) == hand
    assert work.routed_held_pairs(m, seq) == 2 * 8 * 3 * 2 / 6
    w = work.round_work(m, 1000, 4, seq, True, pairs)
    assert w["flops"] == 3 * 4 * hand
    assert w["int_ops"] == (4 * 1000 + 1000) * 20 * 3


@pytest.mark.parametrize("metric", NEW_METRICS)
@pytest.mark.parametrize("entry", ["agg", "train", "train_lm", "tier"])
def test_new_readers_read_only_their_entry(metric, entry):
    mine = "tier" if metric.endswith(".tier") else "train_lm"
    if entry == mine:
        return
    mod = H.load_module(H.BENCH / "metrics" / f"{metric}.py", "m")
    ctx = {"entry": entry, "spans": [], "window_s": 1.0, "profile": None,
           "work": {}, "cell": None}
    assert mod.read(ctx) is None


def test_tier_one_version_on_a_gloo_world_of_four():
    out, checks = R.run_cell(TIER, tier_spec(), 2 ** 31 + 11, 0.1, False,
                             "cpu")
    assert out["correct"], checks
    assert out["attempted"] == 40 and out["failed"] == 0
    assert out["device"]["count"] == 4


def test_decoder_lm_rehearsal_and_its_readers():
    from repro_torch.core.telemetry import Telemetry
    spec = granite_spec()
    tel = Telemetry(record_spans=True, fence=True)
    run = H.load_entry("train_lm").Cell(spec, 2 ** 31 + 3, "cpu", tel)
    n0 = len(tel.spans)
    run.window(0.5)
    _, per_layer = H.metrics_for(GRANITE, BM)
    ctx = {"entry": "train_lm", "spans": tel.spans[n0:],
           "window_s": run.window_s, "profile": None, "work": run.work(),
           "cell": run}
    got = H.read_layer_metrics(per_layer, ctx)
    # the cell's limits hold at full width on the card (PERF.md §2); here a
    # leaf can be 64 elements, whose norm rounds by up to ~1e-7 relative
    checks = run.check(spec["cell"]["limits"])
    assert all(v <= 1e-6 for v, _ in checks.values()), checks
    assert set(got) == {m["name"] for m in per_layer} - {"idle_share.granite"}
    assert 0 < got["held_pairs.granite"]["value"] < 100
    assert got["expert_load_max.granite"]["value"] >= 1
    assert 0 < got["round_mfu.granite"]["value"] < 100
    assert got["local_sgd_ms.granite"]["value"] \
        > got["ssm_ms.granite"]["value"] > 0
