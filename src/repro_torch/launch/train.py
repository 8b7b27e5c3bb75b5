"""FL training driver (port of ``repro.launch.train``): DP-FL rounds with
secure aggregation over a synthetic device population, with RDP privacy
accounting.  Runs on the GPU unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
      --reduced --rounds 20 --cohort 16 --seq-len 64 [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train --classifier \
      --rounds 100 [--device cpu]

Both workloads' weights, every round key and the round's draws are the
reference's (``kernels.prf``).  Training runs the dense family and the
classifier; the other families serve (``launch.serve``) but do not train
yet, and ``--checkpoint-dir`` waits for the checkpoint module.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch import tree as T
from repro_torch.kernels import prf


def main(argv=None, *, session: Optional[dict] = None):
    """The train CLI.  ``session``, if a dict, receives the run's ``model``,
    final ``state`` and every round's ``metrics`` (host floats)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--classifier", action="store_true",
                    help="paper-faithful MLP binary classifier workload")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--cohort", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--local-steps", type=int, default=1)
    ap.add_argument("--local-lr", type=float, default=0.5)
    ap.add_argument("--clip", type=float, default=1.0)
    ap.add_argument("--noise", type=float, default=0.3)
    ap.add_argument("--noise-placement", default="tee",
                    choices=["tee", "device"])
    ap.add_argument("--server-opt", default="fedavg")
    ap.add_argument("--server-lr", type=float, default=1.0)
    ap.add_argument("--population", type=int, default=4096)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.checkpoint_dir:
        raise NotImplementedError(
            "--checkpoint-dir: checkpointing is not ported yet (ROADMAP "
            "Queue 1, item 1, with checkpoint/checkpoint.py)")
    from repro_torch.configs.base import FLConfig
    from repro_torch.core.fl.accountant import RDPAccountant
    from repro_torch.core.fl.round import build_round_step, init_fl_state

    dev = _device.resolve(args.device)
    fl_cfg = FLConfig(
        cohort_size=args.cohort, local_steps=args.local_steps,
        local_lr=args.local_lr, clip_norm=args.clip,
        noise_multiplier=args.noise, noise_placement=args.noise_placement,
        server_opt=args.server_opt, server_lr=args.server_lr,
    )
    key = prf.PRNGKey(args.seed)

    if args.classifier:
        model, make_batch = _classifier_workload(args, dev)
    else:
        model, make_batch = _llm_workload(args, dev)
    params = model.init(key)
    n_params = sum(int(x.numel()) for x in T.leaves(params))
    print(f"model params: {n_params:,}")

    state = init_fl_state(params, fl_cfg)
    del params
    round_step = build_round_step(
        model.loss_fn, fl_cfg, cohort_size=args.cohort,
        clients_per_chunk=min(args.cohort, 8), device=dev)
    accountant = RDPAccountant()
    q = args.cohort / args.population
    history = []

    t0 = time.time()
    for r in range(args.rounds):
        rng = prf.fold_in(key, 10_000 + r)
        batch = make_batch(r)
        state, metrics = round_step(state, batch, rng)
        accountant.step(q, args.noise)
        history.append({k: float(v) for k, v in metrics.items()})
        if r % args.log_every == 0 or r == args.rounds - 1:
            eps = accountant.epsilon(1e-6) if args.noise > 0 else float("inf")
            print(f"round {r:4d} loss={float(metrics['loss']):.4f} "
                  f"clip%={float(metrics['clip_fraction']):.2f} "
                  f"|u|={float(metrics['update_norm']):.3f} "
                  f"eps(1e-6)={eps:.2f} ({time.time() - t0:.1f}s)")
    print(f"done in {time.time() - t0:.1f}s")
    if session is not None:
        session.update(model=model, state=state, metrics=history)
    return 0


def _classifier_workload(args, dev):
    from repro_torch.configs import mlp as mlp_cfg
    from repro_torch.data.synthetic import ClassifierTask
    from repro_torch.models.model import build_mlp_classifier

    cfg = mlp_cfg.CONFIG
    task = ClassifierTask(num_features=cfg.num_features, seed=args.seed)
    mean, std = task.normalization_oracle()
    model = build_mlp_classifier(cfg, device=dev)

    def make_batch(r):
        data = task.sample_devices(args.cohort, rng_seed=args.seed * 977 + r)
        x = ((data["features_raw"] - mean) / np.maximum(std, 1e-6)).astype(
            np.float32)
        return {"features": torch.from_numpy(x)[:, None, :].to(dev),
                "label": torch.from_numpy(data["label"])[:, None].to(dev)}

    return model, make_batch


def _llm_workload(args, dev):
    from repro_torch.configs import registry
    from repro_torch.data.synthetic import fl_token_batch
    from repro_torch.models.model import build_model

    cfg = registry.get_config(args.arch, reduced=args.reduced)
    if cfg.family != "dense" or cfg.block_pattern is not None:
        raise NotImplementedError(
            f"--arch {args.arch}: training the {cfg.family} family is not "
            "ported yet (ROADMAP Queue 1, item 2, with optim/); it serves "
            "through repro_torch.launch.serve")
    cfg = cfg.with_overrides(max_seq_len=max(args.seq_len, 64))
    model = build_model(cfg, device=dev)

    def make_batch(r):
        b = fl_token_batch(args.cohort, args.seq_len, cfg.vocab_size,
                           seed=args.seed * 7919 + r)
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    return model, make_batch


if __name__ == "__main__":
    raise SystemExit(main())
