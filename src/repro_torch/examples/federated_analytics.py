"""Federated Analytics demo: 1-bit reports -> means, CDFs, percentiles
(port of ``examples/federated_analytics.py``).

Shows the Cormode-Markov bit protocol the paper's FA Server runs:
  - each device reports a single randomized-response-protected bit,
  - the server estimates means and arbitrary percentiles (the CDF vote
    through ``bitagg.threshold_cdf``, K9 on the card),
  - normalization factors and the label ratio are derived and pushed to the
    metadata store, and a NEW Signal Transformer program is issued without
    an app release.

Run:  PYTHONPATH=src python -m repro_torch.examples.federated_analytics \
          [--device cpu]

Every draw is the reference example's, so the estimates it prints are the
reference's; the "true" percentiles come from ``torch.quantile``.
"""
from __future__ import annotations

import argparse
from typing import Optional

import torch

from repro_torch import device as _device
from repro_torch.core.analytics import bitagg, label_balance, normalization
from repro_torch.core.device_sim import DevicePopulation
from repro_torch.core.orchestrator import MetadataStore, Orchestrator
from repro_torch.core.signal_transformer import (
    SignalTransformer, TransformSpec, spec_with_normalization,
)
from repro_torch.data.synthetic import ClassifierTask
from repro_torch.kernels import prf

DEVICES, FEATURES, THRESHOLDS, FLIP = 50_000, 4, 256, 0.1
LO, HI = -4096, 4096
QUANTILES = (0.01, 0.5, 0.99)


def main(argv=None, *, session: Optional[dict] = None) -> int:
    """The demo.  ``session``, if a dict, receives the estimates beside the
    true statistics (numpy arrays and floats)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    out = {} if session is None else session

    key = prf.PRNGKey(0)
    task = ClassifierTask(num_features=FEATURES, pos_ratio=0.12, seed=5)
    sample = task.sample_devices(DEVICES, rng_seed=1)
    vals = torch.from_numpy(sample["features_raw"]).to(dev)

    print("=== 1. mean estimation (1 bit / device / feature) ===")
    bits = bitagg.encode_mean_bits(vals, LO, HI, key, flip_prob=FLIP)
    est = bitagg.estimate_mean(bits, LO, HI, flip_prob=FLIP).cpu().numpy()
    true = vals.mean(0).cpu().numpy()
    print(f"  estimated means: {est.round(2)}")
    print(f"  true means:      {true.round(2)}")
    print(f"  bytes uploaded per device: {vals.shape[1] / 8:.2f}")
    out.update(mean_est=est, mean_true=true)

    print("\n=== 2. percentiles from threshold-grid bits ===")
    thr = bitagg.linspace(LO, HI, THRESHOLDS, device=dev)
    cdf = bitagg.threshold_cdf(vals, thr, key, flip_prob=FLIP)
    out["cdf"] = cdf.cpu().numpy()
    out["percentiles"] = {}
    for q in QUANTILES:
        est_q = bitagg.percentile_from_cdf(cdf, thr, q).cpu().numpy()
        true_q = torch.quantile(vals, q, dim=0).cpu().numpy()
        print(f"  p{int(q * 100):02d}: est {est_q.round(1)}  "
              f"true {true_q.round(1)}")
        out["percentiles"][q] = (est_q, true_q)

    print("\n=== 3. label ratio (label treated as yet another feature) ===")
    ratio = label_balance.estimate_label_ratio(
        torch.from_numpy(sample["label"]).to(dev), key, flip_prob=0.2)
    policy = label_balance.policy_from_ratio(ratio, 0.5)
    print(f"  estimated P(y=1) = {ratio:.3f} (true 0.12) "
          f"-> drop-off: keep_neg={policy.keep_neg:.3f}")
    out.update(ratio=ratio, policy=policy)

    print("\n=== 4. push a new transform program (no app release) ===")
    meta = MetadataStore()
    orch = Orchestrator(DevicePopulation(100, seed=1), meta)
    base_spec = TransformSpec(1, [
        {"op": "clip", "field": "f0", "lo": -4096.0, "hi": 4096.0},
    ])
    factors = normalization.learn_minmax(vals[:, :1], LO, HI, key)
    new_spec = spec_with_normalization(base_spec, factors, ["f0"],
                                       new_version=2)
    orch.push_transform_spec(TransformSpec(1, base_spec.ops))
    orch.push_transform_spec(new_spec)
    st = SignalTransformer(meta.get("transform_spec"))
    raw = float(vals[0, 0])
    normed = float(st.apply({"f0": torch.tensor(raw, device=dev)})["f0"])
    print(f"  device runs v{meta.get('transform_spec').version}: "
          f"raw {raw:.1f} -> normalized {normed:.3f}")
    print("  (feature dev cycle: weeks -> hours, per the paper)")
    out.update(factors=factors, raw=raw, normalized=normed,
               spec_version=meta.get("transform_spec").version)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
