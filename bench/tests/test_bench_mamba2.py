"""The Mamba-2 training cell on the CPU at a small size: the system's
Mamba-2 LM loss against ``bench/reference/mamba2.py``, the cell's first
rounds through the ``train_lm_ref`` entry against the reference, the work
counts against a hand count, and the new readers."""
import copy
import math

import pytest
import torch

from bench import harness as H
from bench import run as R
from bench.reference import mamba2 as ref
from bench.tests.small import SMALL_MODELS
from bench.work import mamba2 as work

BM = H.benchmark()
CELL = "train.mamba2-780m"
NEW_METRICS = [m["name"] for m in BM["per_layer"]
               if m.get("workloads") == [CELL]]


def small_spec() -> dict:
    spec = copy.deepcopy(H.cell_spec(CELL))
    cut = SMALL_MODELS["mamba2-780m"]
    spec["model"].update(cut)
    spec["model"]["overrides"] = dict(spec["model"]["overrides"], **cut)
    spec["traffic"].update(seq_len=32)
    return spec


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_the_reference(remat):
    from repro_torch.models.model import build_model, param_shapes
    m = small_spec()["model"]
    cfg = H.port_config(m)
    flat = H.flatten(param_shapes(cfg))
    paths = [p for p, _ in flat]
    gen = torch.Generator().manual_seed(2 ** 31 + 7)
    _, leaves = H.make_params(paths, [tuple(s) for _, s in flat], gen, "cpu",
                              0.02)
    toks = torch.randint(0, m["vocab_size"], (2, 33), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "loss_mask": torch.ones((2, 32))}
    lp = [x.clone().requires_grad_(True) for x in leaves]
    lr = [x.clone().requires_grad_(True) for x in leaves]
    net = build_model(cfg, device="cpu")
    loss = net.loss_fn(H.unflatten(paths, lp), batch)[0]
    want = ref.loss(m, H.unflatten(paths, lr), batch, remat)
    assert abs(float(loss.detach()) - float(want.detach())) \
        <= 1e-6 * abs(float(want.detach()))
    gp = torch.autograd.grad(loss, lp)
    gr = torch.autograd.grad(want, lr)
    for a, b in zip(gp, gr):
        assert float((a - b).norm()) <= 1e-4 * max(float(b.norm()), 1e-6)


def test_work_counts_against_a_hand_count():
    m = {"d_model": 8, "ssm_expand": 2, "ssm_state_dim": 4,
         "ssm_head_dim": 4, "ssm_num_groups": 1, "ssm_conv_width": 4,
         "ssm_chunk": 4, "num_layers": 2, "vocab_size": 20}
    layer = (2 * 8 * (32 + 8 + 4) + 2 * 4 * 24 + 2 * 2 * 4 + 2 * 2 * 16
             + 2 * 2 * 16 * 4 + 2 * 16 * 8)
    hand = 8 * (2 * layer + 2 * 8 * 20)
    assert work.forward_flops(m, 8) == hand
    w = work.round_work(m, 1000, 8, 8, True)
    assert w["flops"] == 3 * 8 * hand
    assert w["int_ops"] == (8 * 1000 + 1000) * 20 * 3
    full = H.cell_spec(CELL)["model"]
    assert work.param_leaves(full) == (full["params"], full["leaves"])


@pytest.mark.parametrize("metric", NEW_METRICS)
@pytest.mark.parametrize("entry", ["agg", "train", "train_lm", "tier"])
def test_new_readers_read_only_their_entry(metric, entry):
    mod = H.load_module(H.BENCH / "metrics" / f"{metric}.py", "m")
    ctx = {"entry": entry, "spans": [], "window_s": 1.0, "profile": None,
           "work": {}, "cell": None}
    assert mod.read(ctx) is None


def test_first_rounds_match_the_reference_and_the_readers_read():
    from repro_torch.core.telemetry import Telemetry
    spec = small_spec()
    tel = Telemetry(record_spans=True, fence=True)
    run = H.load_entry("train_lm_ref").Cell(spec, 2 ** 31 + 9, "cpu", tel)
    n0 = len(tel.spans)
    run.window(0.3)
    _, per_layer = H.metrics_for(CELL, BM)
    ctx = {"entry": "train_lm_ref", "spans": tel.spans[n0:],
           "window_s": run.window_s, "profile": None, "work": run.work(),
           "cell": run}
    got = H.read_layer_metrics(per_layer, ctx)
    checks = run.check(spec["cell"]["limits"])
    assert all(v <= 1e-6 for v, _ in checks.values()), checks
    # no profile here, and the CPU draws no uniforms on a card
    assert set(got) == {m["name"] for m in per_layer} \
        - {"idle_share.mamba", "prf_draws.mamba"}
    assert got["uniforms_ms.mamba"]["value"] > 0
    assert 0 < got["round_mfu.mamba"]["value"] < 100
    assert got["local_sgd_ms.mamba"]["value"] > got["ssm_ms.mamba"]["value"] \
        > 0


def test_run_cell_on_the_cpu():
    out, checks = R.run_cell(CELL, small_spec(), 2 ** 31 + 13, 0.3, False,
                             "cpu")
    # the limits are the card's at full width (PERF.md §2); a 64-element
    # leaf's norm rounds by up to ~1e-7 relative here
    assert all(v <= 1e-6 for v, _ in checks.values()), checks
    assert set(out["checks"]) == set(H.cell_spec(CELL)["cell"]["limits"])
    assert out["failed"] == 0 and out["attempted"] > 0
    assert math.isfinite(out["metrics"]["round_s"]["value"])
