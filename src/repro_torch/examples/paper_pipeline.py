"""The paper's lifecycle on a simulated fleet (twin of the pipeline of
``tests/test_system.py``):

  federated analytics on a fresh device sample (minmax normalization
  factors from one threshold-grid CDF vote through K9, the label ratio
  under randomized response) -> the metadata store and the Orchestrator's
  submission drop-off policy -> DP-FL rounds of the paper's MLP classifier
  with label-balanced cohorts (K3, K6, K7 in every round) -> DP metrics on
  a held-out cohort, with RDP accounting.

Run:  PYTHONPATH=src python -m repro_torch.examples.paper_pipeline \
          [--device cpu] [--rounds 40]

Every key and draw is the reference's (``kernels.prf``): the factors, the
label ratio, the policy and every round's keep mask are bit-equal to the
JAX pipeline's, the round losses agree to ~1e-5.
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

# tests/test_system.py's sizes
FA_DEVICES = 20_000
THRESHOLDS = 128
POPULATION = 512
COHORT = 64
CLIENTS_PER_CHUNK = 16
ROUNDS = 40
EVAL_DEVICES = 512


def run(*, rounds: int = ROUNDS, fa_devices: int = FA_DEVICES, device=None,
        log_every: int = 5) -> dict:
    """The pipeline; returns its factors, ``pos_ratio``, ``policy``, every
    round's keep mask and loss, the final state, the derived DP metrics and
    the accountant."""
    dev = _device.resolve(device)
    key = prf.PRNGKey(0)
    cfg = mlp_cfg.CONFIG
    task = ClassifierTask(num_features=cfg.num_features, pos_ratio=0.1, seed=7)
    model = build_mlp_classifier(cfg, device=dev)

    # --- federated analytics phase (fresh device sample, not training) ---
    fa_sample = task.sample_devices(fa_devices, rng_seed=123)
    factors = normalization.learn_minmax(
        torch.from_numpy(fa_sample["features_raw"]).to(dev), lo=-4096.0,
        hi=4096.0, rng=key, n_thresholds=THRESHOLDS)
    pos_ratio = label_balance.estimate_label_ratio(
        torch.from_numpy(fa_sample["label"]).to(dev), key, flip_prob=0.1)

    meta = MetadataStore()
    meta.put("label_pos_ratio", pos_ratio)
    meta.put("normalization", factors)
    orch = Orchestrator(DevicePopulation(POPULATION, seed=11), meta, seed=11)
    policy = orch.submission_policy(target_pos_ratio=0.5)

    fl = FLConfig(cohort_size=COHORT, local_steps=3, local_lr=0.4,
                  clip_norm=1.0, noise_multiplier=0.2, noise_placement="tee")
    step = build_round_step(model.loss_fn, fl, cohort_size=COHORT,
                            clients_per_chunk=CLIENTS_PER_CHUNK, device=dev)
    state = init_fl_state(model.init(key), fl)
    accountant = RDPAccountant()

    losses, keeps = [], []
    for r in range(rounds):
        rng = prf.fold_in(key, r)
        # devices apply the drop-off at submission; the round cohort is
        # assembled from submitters (stays full-size and label-balanced)
        pool = task.sample_devices(COHORT * 16, rng_seed=1000 + r)
        labels_pool = torch.from_numpy(pool["label"]).to(dev)
        keep = (label_balance.apply_dropoff(labels_pool, policy, rng)
                > 0).cpu().numpy()
        keeps.append(keep)
        idx = np.nonzero(keep)[0][:COHORT]
        x = factors.apply(torch.from_numpy(pool["features_raw"][idx]).to(dev))
        labels = labels_pool[torch.from_numpy(idx).to(dev)]
        batch = {"features": x[:, None, :], "label": labels[:, None]}
        state, met = step(state, batch, rng)
        accountant.step(COHORT / POPULATION, fl.noise_multiplier)
        losses.append(float(met["loss"]))
        if log_every and (r % log_every == 0 or r == rounds - 1):
            print(f"round {r:3d} loss={losses[-1]:.4f} "
                  f"kept={int(keep.sum())}/{keep.size}")

    # --- DP metric calculation on a held-out cohort ---
    eval_data = task.sample_devices(EVAL_DEVICES, rng_seed=9999)
    xe = factors.apply(torch.from_numpy(eval_data["features_raw"]).to(dev))
    logit, _ = model.apply(state.params, {"features": xe})
    label_e = torch.from_numpy(eval_data["label"]).to(dev)
    per = [fl_metrics.local_eval_stats(logit[i:i + 1], label_e[i:i + 1])
           for i in range(EVAL_DEVICES)]
    per_dev = {k: torch.stack([s[k] for s in per]) for k in per[0]}
    agg = fl_metrics.aggregate_stats(per_dev, key, noise_multiplier=1.0)
    derived = fl_metrics.derive_metrics(agg)
    return dict(factors=factors, pos_ratio=pos_ratio, policy=policy,
                keeps=keeps, losses=losses, state=state, derived=derived,
                accountant=accountant)


def main(argv=None, *, session: Optional[dict] = None) -> int:
    """The pipeline CLI.  ``session``, if a dict, receives :func:`run`'s
    result."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    args = ap.parse_args(argv)
    res = run(rounds=args.rounds, device=args.device)
    d = {k: float(v) for k, v in res["derived"].items()}
    pol, fac = res["policy"], res["factors"]
    print(f"FA: P(y=1) = {res['pos_ratio']:.4f} -> keep_pos="
          f"{pol.keep_pos:.3f} keep_neg={pol.keep_neg:.3f}; minmax "
          f"shift[:3] {fac.shift[:3].round(1)} scale[:3] "
          f"{fac.scale[:3].round(1)}")
    print(f"loss {res['losses'][0]:.4f} -> {np.mean(res['losses'][-5:]):.4f} "
          f"(mean of the last 5)")
    print("DP metrics: " + " ".join(f"{k}={v:.4f}" for k, v in d.items())
          + f" eps(1e-6)={res['accountant'].epsilon(1e-6):.2f}")
    if session is not None:
        session.update(res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
