"""Quickstart: the paper's full pipeline in public API (port of
``examples/quickstart.py``).

A binary classifier trained with federated learning + differential privacy
on a simulated phone fleet, as the paper deploys it:
  1. Federated analytics learns normalization factors + the label ratio.
  2. The orchestrator selects eligible devices and balances labels via
     sample-submission drop-off.
  3. DP-FL rounds: local SGD -> per-client clip -> secure aggregation ->
     TEE-side Gaussian noise -> FedAvg.
  4. DP metric calculation + RDP privacy accounting.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart \
          [--device cpu] [--rounds 40]

Every key and draw is the reference example's (``kernels.prf``), so it
prints the reference's lines: the FA and policy lines equal, the round
losses and DP metrics to the round's ~1e-5.
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs import mlp as mlp_cfg
from repro_torch.configs.base import FLConfig
from repro_torch.core.analytics import label_balance, normalization
from repro_torch.core.device_sim import DevicePopulation
from repro_torch.core.fl import metrics as fl_metrics
from repro_torch.core.fl.accountant import RDPAccountant
from repro_torch.core.fl.round import build_round_step, init_fl_state
from repro_torch.core.orchestrator import MetadataStore, Orchestrator
from repro_torch.data.synthetic import ClassifierTask
from repro_torch.kernels import prf
from repro_torch.models.model import build_mlp_classifier

COHORT, ROUNDS, POPULATION = 64, 40, 4096
FA_DEVICES, EVAL_DEVICES = 20_000, 4000


def main(argv=None, *, session: Optional[dict] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)

    key = prf.PRNGKey(0)
    cfg = mlp_cfg.CONFIG
    task = ClassifierTask(num_features=cfg.num_features, pos_ratio=0.08,
                          seed=1)
    model = build_mlp_classifier(cfg, device=dev)

    # --- 1. federated analytics (a random device sample) -------------------
    fa_sample = task.sample_devices(FA_DEVICES, rng_seed=99)
    factors = normalization.learn_minmax(
        torch.from_numpy(fa_sample["features_raw"]).to(dev), lo=-4096.0,
        hi=4096.0, rng=key, n_thresholds=128)
    pos_ratio = label_balance.estimate_label_ratio(
        torch.from_numpy(fa_sample["label"]).to(dev), key, flip_prob=0.1)
    print(f"FA: estimated P(y=1) = {pos_ratio:.3f} (true 0.08), "
          f"normalization factors learned from 1-bit reports")

    # --- 2. orchestrator: metadata, eligibility, label balancing -----------
    meta = MetadataStore()
    meta.put("label_pos_ratio", pos_ratio)
    orch = Orchestrator(DevicePopulation(POPULATION, seed=2), meta, seed=2)
    policy = orch.submission_policy(target_pos_ratio=0.5)
    print(f"orchestrator: keep_pos={policy.keep_pos:.2f} "
          f"keep_neg={policy.keep_neg:.3f}")

    # --- 3. DP-FL training ---------------------------------------------------
    fl = FLConfig(cohort_size=COHORT, local_steps=2, local_lr=0.3,
                  clip_norm=1.0, noise_multiplier=0.25,
                  noise_placement="tee", secure_agg_bits=32)
    round_step = build_round_step(model.loss_fn, fl, cohort_size=COHORT,
                                  clients_per_chunk=16, device=dev)
    state = init_fl_state(model.init(key), fl)
    accountant = RDPAccountant()
    losses = []
    for r in range(args.rounds):
        rng = prf.fold_in(key, r)
        cohort_devices = orch.select_cohort(COHORT)
        # devices decide locally whether to SUBMIT their sample (drop-off);
        # the cohort is assembled from submitters, so it stays full-size
        pool = task.sample_devices(COHORT * 16, rng_seed=100 + r)
        labels_pool = torch.from_numpy(pool["label"]).to(dev)
        keep = (label_balance.apply_dropoff(labels_pool, policy, rng)
                > 0).cpu().numpy()
        idx = np.nonzero(keep)[0][:COHORT]
        x = factors.apply(torch.from_numpy(pool["features_raw"][idx]).to(dev))
        labels = labels_pool[torch.from_numpy(idx).to(dev)]
        state, met = round_step(state, {"features": x[:, None, :],
                                        "label": labels[:, None]}, rng)
        orch.finish_round(cohort_devices)
        accountant.step(COHORT / POPULATION, fl.noise_multiplier)
        losses.append(float(met["loss"]))
        if r % 5 == 0 or r == args.rounds - 1:
            print(f"round {r:3d}  loss={float(met['loss']):.4f}  "
                  f"clip%={float(met['clip_fraction']):.2f}  "
                  f"participation={float(met['participation']):.2f}")

    # --- 4. DP metric calculation --------------------------------------------
    ev = task.sample_devices(EVAL_DEVICES, rng_seed=777)
    logit, _ = model.apply(state.params, {"features": factors.apply(
        torch.from_numpy(ev["features_raw"]).to(dev))})
    label_e = torch.from_numpy(ev["label"]).to(dev)
    per = [fl_metrics.local_eval_stats(logit[i:i + 1], label_e[i:i + 1])
           for i in range(EVAL_DEVICES)]
    per_dev = {k: torch.stack([s[k] for s in per]) for k in per[0]}
    agg = fl_metrics.aggregate_stats(per_dev, key, noise_multiplier=1.0)
    derived = fl_metrics.derive_metrics(agg)
    print(f"\nDP-noised eval: acc={float(derived['accuracy']):.3f}  "
          f"auc={float(derived['roc_auc']):.3f}  "
          f"score_skew={float(derived['score_skew']):.3f}")
    print(f"privacy spent: eps = {accountant.epsilon(1e-6):.2f} at "
          f"delta=1e-6")
    print("\nfunnel report (phase, entered, succeeded, drop_rate):")
    for row in orch.logger.dropoff_report():
        print("  ", row)
    if session is not None:
        session.update(losses=losses, state=state, derived=derived,
                       pos_ratio=pos_ratio, policy=policy)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
