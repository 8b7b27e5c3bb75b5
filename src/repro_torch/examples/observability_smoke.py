"""Observability smoke: chaos a two-level masked tier, export, reconcile
(port of ``examples/observability_smoke.py``).

  1. drive a two-level masked (mask_mode="client") 2-leaf session tree
     through a seeded FaultPlan (client deaths, duplicates, delays,
     reorders, and a mid-ingest leaf death);
  2. replay the identical fault schedule against a fresh tier + registry
     (the decisions replay bit-for-bit, so the telemetry must too);
  3. export a Chrome trace-event JSON, a Prometheus text snapshot and the
     per-round span CSV;
  4. reconcile the funnel: every submitted contribution accounted as
     aggregated, dropped, killed, lost or deferred, with the aggregate
     count cross-checked against the engine's decode counter.

Run:  PYTHONPATH=src python -m repro_torch.examples.observability_smoke \
          [--device cpu] [--out build/obs_smoke]

Exits non-zero on any conservation problem or replay divergence.  The
deltas are the reference example's draws, so the printed ledgers are the
reference's.  ``main(..., params=, delta=, fl_kw=)`` runs the same schedule
on another model (``chip_smoke.py`` passes qwen2-1.5b widths).
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Callable, Optional

import torch

from repro_torch import device as _device
from repro_torch.configs.base import FLConfig
from repro_torch.core.fl.faults import FaultInjector, FaultPlan, FaultSpec
from repro_torch.core.fl.hierarchy import ShardedAsyncServer
from repro_torch.core.obs import (reconcile, write_chrome_trace,
                                  write_prometheus, write_round_csv)
from repro_torch.core.telemetry import Telemetry
from repro_torch.kernels import prf

D = 41
PUSHES = 24
SPEC = FaultSpec(p_client_death=0.1, p_duplicate=0.3, p_delay=0.3,
                 delay_pushes=2, p_reorder=0.3, seed=5,
                 leaf_deaths=(("ingest", 1, 1),))


def default_params(device):
    return {"w": torch.zeros((D,), dtype=torch.float32, device=device),
            "b": torch.zeros((3,), dtype=torch.float32, device=device)}


def default_delta(i: int, seed: int = 0, device=None):
    """The reference example's delta ``i``: ``0.1 * normal`` under
    ``fold_in(PRNGKey(seed), i)`` (and its ``fold_in(., 1)`` for ``b``)."""
    k = prf.fold_in(prf.PRNGKey(seed), i)
    return {"w": 0.1 * prf.normal(k, (D,), device=device),
            "b": 0.1 * prf.normal(prf.fold_in(k, 1), (3,), device=device)}


def run(plan: FaultPlan, *, device, params=None,
        delta: Optional[Callable] = None, fl_kw: Optional[dict] = None):
    """One faulted run of the 2-leaf tree; returns (telemetry, tier,
    injector)."""
    tel = Telemetry(record_spans=True)
    fl = FLConfig(clip_norm=1.0, server_lr=1.0, secure_agg_bits=24,
                  **(fl_kw or {}))
    if params is None:
        params = default_params(device)
    if delta is None:
        def delta(i):
            return default_delta(i, device=device)
    srv = ShardedAsyncServer(params, fl, num_leaves=2, leaf_buffer=2,
                             mask_mode="client", two_level=True,
                             strict=False, telemetry=tel, device=device)
    inj = FaultInjector(srv, plan)
    for i in range(PUSHES):
        inj.push(delta(i), srv.version)
    inj.flush(force=True)
    return tel, srv, inj


def main(argv=None, *, params=None, delta: Optional[Callable] = None,
         fl_kw: Optional[dict] = None, session: Optional[dict] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/obs_smoke",
                    help="output directory for trace.json / metrics.prom / "
                         "rounds.csv")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    os.makedirs(args.out, exist_ok=True)

    kw = dict(device=dev, params=params, delta=delta, fl_kw=fl_kw)
    tel, srv, inj = run(FaultPlan(SPEC), **kw)
    # the replayed schedule must produce the identical ledger
    tel2, srv2, inj2 = run(inj.plan.replayed(), **kw)
    if session is not None:
        session.update(tel=tel, srv=srv, inj=inj, tel2=tel2, srv2=srv2,
                       inj2=inj2)

    write_chrome_trace(tel2, os.path.join(args.out, "trace.json"))
    write_prometheus(tel2, os.path.join(args.out, "metrics.prom"))
    nrows = write_round_csv(tel2, os.path.join(args.out, "rounds.csv"))

    ok = True
    for label, t, s in (("recorded", tel, srv), ("replayed", tel2, srv2)):
        rep = reconcile(t, applied_updates=s._applied_updates)
        print(f"{label}: {rep.totals}")
        for p in rep.problems:
            ok = False
            print(f"{label}: CONSERVATION VIOLATED — {p}", file=sys.stderr)
    r1 = reconcile(tel).totals
    r2 = reconcile(tel2).totals
    if r1 != r2:
        ok = False
        print(f"replay diverged: {r1} != {r2}", file=sys.stderr)
    print(f"exported {len(tel2.spans)} spans, {nrows} round-CSV rows "
          f"-> {args.out}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
