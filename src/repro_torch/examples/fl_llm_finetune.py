"""Federated DP training of a transformer LM (port of
``examples/fl_llm_finetune.py``).

Trains a reduced registry model (any ``--arch``; ``--d-model`` etc. shrink
the default Qwen2 further) for DP-FL rounds on non-IID client token
streams, with privacy accounting and an optional checkpoint.  One sequence
per device, so per-client clipping is per-example DP-SGD.  ``--masked``
runs the cohort aggregate through pairwise masking; ``--chunk-elems``
carries the model as a multi-chunk ``ParamPlan`` (one mask session per
chunk).

Run:  PYTHONPATH=src python -m repro_torch.examples.fl_llm_finetune \
          [--device cpu] [--rounds 200] [--masked --chunk-elems 65536]

The lines are the reference example's (its weights, batches and round
keys, through ``kernels.prf``).  As the reference does, the run fails
(exit status 1) unless the mean of the last 10 losses is below the first.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch import tree as T
from repro_torch.checkpoint.checkpoint import save
from repro_torch.configs import registry
from repro_torch.configs.base import FLConfig
from repro_torch.core.fl import aggregation as agg
from repro_torch.core.fl.accountant import RDPAccountant
from repro_torch.core.fl.round import build_round_step, init_fl_state
from repro_torch.data.synthetic import fl_token_batch
from repro_torch.kernels import prf
from repro_torch.models.model import build_model


def check_loss_fell(losses) -> None:
    """The reference example's assert: training must improve the loss."""
    if not np.mean(losses[-10:]) < losses[0]:
        raise AssertionError("training must improve the loss")


def main(argv=None, *, session: Optional[dict] = None) -> int:
    """The example; ``session``, if a dict, receives the per-round
    ``losses`` and the final ``state``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-1.5b", choices=registry.ARCH_IDS,
                    help="registry architecture (reduced preset)")
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--cohort", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--noise", type=float, default=0.0)
    ap.add_argument("--masked", action="store_true",
                    help="run the cohort aggregate through pairwise masking")
    ap.add_argument("--chunk-elems", type=int, default=0,
                    help="ParamPlan chunk budget; 0 = single flat chunk")
    ap.add_argument("--secure-agg-bits", type=int, default=32)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)

    if args.noise > 0 and args.cohort < 1024:
        print(f"WARNING: noise={args.noise} with cohort={args.cohort} will "
              f"likely swamp the update signal at this parameter count; "
              f"expect no convergence (use --noise 0 for the CPU-scale demo)")

    cfg = registry.get_config(args.arch, reduced=True)
    if args.arch == "qwen2-1.5b":
        # the width flags shape the default family only
        cfg = cfg.with_overrides(
            num_layers=args.layers, d_model=args.d_model,
            d_ff=4 * args.d_model, num_heads=max(4, args.d_model // 32),
            num_kv_heads=2, head_dim=32, vocab_size=args.vocab,
            max_seq_len=args.seq_len)
    model = build_model(cfg, device=dev)
    key = prf.PRNGKey(0)
    params = model.init(key)
    print(f"arch={args.arch}  params="
          f"{sum(int(x.numel()) for x in T.leaves(params)):,}")

    fl = FLConfig(cohort_size=args.cohort, local_steps=1, local_lr=0.5,
                  clip_norm=4.0, noise_multiplier=args.noise,
                  noise_placement="tee", server_opt="fedavg", server_lr=1.0,
                  secure_agg_masked=args.masked,
                  secure_agg_bits=args.secure_agg_bits,
                  param_chunk_elems=args.chunk_elems)
    plan = agg.plan_for(params, fl)
    print(f"plan: {plan.num_chunks} chunk(s) over {len(plan.shapes)} leaves, "
          f"widths={list(plan.chunk_widths)[:8]}"
          f"{'...' if plan.num_chunks > 8 else ''}  "
          f"masked={args.masked}  bits={args.secure_agg_bits}")
    step = build_round_step(model.loss_fn, fl, cohort_size=args.cohort,
                            clients_per_chunk=args.cohort, device=dev)
    state = init_fl_state(params, fl)
    del params
    acct = RDPAccountant()

    t0 = time.time()
    losses = []
    for r in range(args.rounds):
        rng = prf.fold_in(key, r)
        b = fl_token_batch(args.cohort, args.seq_len, cfg.vocab_size, seed=r)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        state, met = step(state, batch, rng)
        acct.step(args.cohort / 100_000, args.noise)
        losses.append(float(met["loss"]))
        if r % 20 == 0 or r == args.rounds - 1:
            tok_s = args.cohort * args.seq_len * (r + 1) / (time.time() - t0)
            print(f"round {r:4d}  loss={losses[-1]:.4f}  "
                  f"clip%={float(met['clip_fraction']):.2f}  "
                  f"tok/s={tok_s:.0f}  eps={acct.epsilon(1e-6):.2f}")

    print(f"\nloss {losses[0]:.3f} -> {np.mean(losses[-10:]):.3f} "
          f"({args.rounds} rounds, {time.time() - t0:.0f}s)")
    check_loss_fell(losses)
    if args.checkpoint_dir:
        save(f"{args.checkpoint_dir}/step_{args.rounds}",
             {"params": state.params, "opt": state.opt_state},
             step=args.rounds)
        print("checkpointed.")
    if session is not None:
        session.update(losses=losses, state=state)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
