"""Helpers for the port's tests and its multi-process checks (counterpart of
``repro.testing``).

- :func:`pin_cpu_threads` shares the host's cores among pytest-xdist
  workers: every worker's torch otherwise starts one intra-op thread per
  core, and N workers then run N x cores threads on the host's cores.
- :func:`tier_world` is a rank's entry point for ``launch.dist.run``: it
  drives ``ShardedAsyncServer`` sessions and sharded rounds on a leaf mesh
  over the world's process group and returns what each produced, so a
  caller (a test holding the JAX reference, ``chip_smoke.py``) can compare
  the ranks with the one-process tier.  A spawned rank imports this module
  and the package only.
"""
from __future__ import annotations

import hashlib
import os
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch


def pin_cpu_threads() -> int:
    """Give torch's CPU intra-op pool ``cpu_count // workers`` threads (at
    least one), ``workers`` being ``PYTEST_XDIST_WORKER_COUNT`` (1 when
    unset, so a file run alone keeps every core).  Returns the count set.

    Every ``tests/test_torch_*.py`` calls it at import; an xdist worker
    collects every file, so the first such import pins the whole worker.
    """
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 1)
    n = max(1, (os.cpu_count() or 1) // max(1, workers))
    torch.set_num_threads(n)
    return n


# ---------------------------------------------------------------------------
# the tier across ranks
# ---------------------------------------------------------------------------
class NumpySource(NamedTuple):
    """Params and per-index deltas given as nested dicts of numpy arrays."""

    params: Dict
    deltas: Sequence[Dict]

    def build(self, device):
        from repro_torch import convert
        params = convert.params_from_numpy(self.params, device)
        return params, lambda i: convert.params_from_numpy(self.deltas[i],
                                                           device)


class ModelSource(NamedTuple):
    """A registry model's params ``init_params(cfg, seed)`` at ``layers``
    layers, and delta ``i``: per leaf in tree order, ``randn(shape) *
    scale`` from one ``torch.Generator`` on the device seeded
    ``delta_seed + i`` (bit-equal wherever the same device kind draws)."""

    arch: str
    layers: int
    seed: int
    delta_seed: int
    scale: float
    reduced: bool = False

    def build(self, device):
        from repro_torch import tree as T
        from repro_torch.configs import registry
        from repro_torch.models.model import init_params
        cfg = registry.get_config(self.arch, reduced=self.reduced)
        cfg = cfg.with_overrides(num_layers=self.layers)
        params = init_params(cfg, seed=self.seed, device=device)

        def delta(i):
            g = torch.Generator(device=device).manual_seed(
                self.delta_seed + i)
            return T.tree_map(lambda p: torch.randn(
                p.shape, generator=g, device=device) * self.scale, params)

        return params, delta


class TierCase(NamedTuple):
    """One ``ShardedAsyncServer`` run.  ``steps``: ``("push", delta
    indices, client version, slots)`` (client mode: ``encode_push`` then
    ``push_encoded``; else ``push`` of the stacked batch), ``("dead",
    leaf)`` (``mark_leaf_dead``) or ``("flush", rng seed or None)``.
    ``source`` indexes the sources given to :func:`tier_world`."""

    name: str
    mode: str
    two_level: bool
    num_leaves: int
    leaf_buffer: int
    fl: Dict
    steps: Sequence[tuple]
    source: int = 0
    staleness_mode: str = "constant"


class RoundCase(NamedTuple):
    """One ``build_sharded_round_step`` round on the MLP classifier: params
    ``init(PRNGKey(seed))``, features ``normal(fold_in(PRNGKey(data_seed),
    1), (cohort, 2, F))`` labelled by their sign sum, round key
    ``PRNGKey(3)``; run under ``torch.use_deterministic_algorithms``."""

    name: str
    fl: Dict
    cohort: int
    num_leaves: int
    seed: int = 0
    data_seed: int = 0


def classifier_round_inputs(cohort: int, seed: int, device,
                            data_seed: Optional[int] = None):
    """(model, params, batch, rng) of a :class:`RoundCase`."""
    from repro_torch.configs import mlp as mlp_cfg
    from repro_torch.kernels import prf
    from repro_torch.models.model import build_mlp_classifier
    cfg = mlp_cfg.CONFIG
    model = build_mlp_classifier(cfg, device=device)
    params = model.init(prf.PRNGKey(seed))
    key = prf.PRNGKey(seed if data_seed is None else data_seed)
    x = prf.normal(prf.fold_in(key, 1), (cohort, 2, cfg.num_features),
                   device=device)
    batch = {"features": x, "label": (x.sum(-1) > 0).to(torch.float32)}
    return model, params, batch, prf.PRNGKey(3)


def kernel_counts() -> Dict[str, Dict[str, int]]:
    """Launches and plain-version calls of every kernel wrapper."""
    from repro_torch.kernels import bitagg, dp_clip, flash_decode, secure_agg
    return {**secure_agg.counts(), **flash_decode.counts(),
            **dp_clip.counts(), **bitagg.counts()}


def reset_kernel_counts() -> None:
    from repro_torch.kernels import bitagg, dp_clip, flash_decode, secure_agg
    for m in (secure_agg, flash_decode, dp_clip, bitagg):
        m.reset_counts()


def tree_digest(tree) -> str:
    """SHA-256 over every leaf's bytes in the tree's order (equal digests:
    byte-equal trees)."""
    from repro_torch import tree as T
    h = hashlib.sha256()
    for x in T.leaves(tree):
        h.update(x.detach().contiguous().cpu().view(torch.uint8).numpy())
    return h.hexdigest()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _stack(trees):
    from repro_torch import tree as T
    return T.tree_map(lambda *xs: torch.stack(xs), *trees)


class CombineCase(NamedTuple):
    """``hierarchy.combine`` of one int32 partial per rank: rank r's is
    ``RandomState(seed + r)``'s ``n`` values drawn from the int32 range's
    ends, so the sum overflows int32 (the reference: numpy mod 2^32)."""

    name: str
    seed: int
    n: int = 4096


class MeshCase(NamedTuple):
    """``launch.mesh.make_mesh_compat(shape, axes)`` inside the world: a
    ``DeviceMesh`` when the world has ``prod(shape)`` ranks."""

    name: str
    shape: tuple
    axes: tuple


def combine_partial(seed: int, rank: int, n: int) -> np.ndarray:
    rs = np.random.RandomState(seed + rank)
    big = rs.randint(2 ** 31 - 2 ** 20, 2 ** 31, size=n, dtype=np.int64)
    sign = np.where(rs.rand(n) < 0.5, 1, -1)
    return (sign * big).astype(np.int32)


def run_tier_case(case: TierCase, source, *, mesh=None, device=None,
                  telemetry=None):
    """Drive ``case`` on one ``ShardedAsyncServer`` (``source``: the built
    ``(params, delta)``); returns the server."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.core.fl.hierarchy import ShardedAsyncServer
    params, delta = source
    srv = ShardedAsyncServer(
        params, FLConfig(**case.fl), num_leaves=case.num_leaves,
        leaf_buffer=case.leaf_buffer, staleness_mode=case.staleness_mode,
        mask_mode=case.mode, two_level=case.two_level, mesh=mesh,
        telemetry=telemetry, device=device)
    for step in case.steps:
        if step[0] == "push":
            _, idx, version, slots = step
            batch = _stack([delta(i) for i in idx])
            if case.mode == "client":
                cps = srv.encode_push(batch, version, slot=list(slots))
                srv.push_encoded(cps)
            else:
                srv.push(batch, version, slots=list(slots))
            del batch
        elif step[0] == "dead":
            srv.mark_leaf_dead(step[1])
        elif step[0] == "flush":
            from repro_torch.kernels import prf
            srv.flush(rng=None if step[1] is None else prf.PRNGKey(step[1]))
        else:
            raise ValueError(f"step {step!r}")
    return srv


def _run_round(case: RoundCase, mesh, tel):
    from repro_torch.configs.base import FLConfig
    from repro_torch.core.fl.round import (build_sharded_round_step,
                                           init_fl_state)
    with tel.span("round.inputs") as sp:
        model, params, batch, rng = classifier_round_inputs(
            case.cohort, case.seed, mesh.device, case.data_seed)
        sp.fence(batch)
    fl = FLConfig(**case.fl)
    step = build_sharded_round_step(model.loss_fn, fl,
                                    cohort_size=case.cohort,
                                    num_leaves=case.num_leaves, mesh=mesh,
                                    telemetry=tel)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return step(init_fl_state(params, fl), batch, rng)
    finally:
        torch.use_deterministic_algorithms(False)


def tier_world(rank: int, world_size: int, sources: Sequence[Callable],
               cases: Sequence, digest: bool = False) -> Dict[str, Dict]:
    """A rank's part of ``launch.dist.run(tier_world, W, sources, cases)``.

    Each :class:`TierCase` and :class:`RoundCase` runs on
    ``make_leaf_mesh(num_leaves, device, group=WORLD)`` on the device
    ``dist.run`` gave the rank; ``sources[i].build(device)`` gives
    ``(params, delta(i))``, built once and shared by the cases that name
    it.  Returns, per case name: the final params on the CPU (``digest``:
    their :func:`tree_digest` instead), the last metrics, the version, the
    fault counters, this rank's kernel counts, its spans (ms by name:
    ``ingest``, ``encode_push``, ``push_encoded``, ``leaf_partials``,
    ``combine``, ``decode``, ``round.*``), the bytes its combines sent, its
    peak device memory (GiB; NaN on the CPU), and the seconds of the run,
    of building its source and of the digest.  A :class:`CombineCase`
    returns the combined partial, a :class:`MeshCase` the mesh's shape and
    ``DeviceMesh`` axes.
    """
    import torch.distributed as tdist

    from repro_torch import tree as T
    from repro_torch.core import telemetry as tele
    from repro_torch.launch import dist
    from repro_torch.launch.mesh import make_leaf_mesh, make_mesh_compat
    group = tdist.group.WORLD
    device = dist.current_device()
    built: Dict[int, Any] = {}
    out: Dict[str, Dict] = {}
    for case in cases:
        if isinstance(case, MeshCase):
            m = make_mesh_compat(case.shape, case.axes)
            out[case.name] = {"shape": m.shape,
                              "device_mesh": None if m.device_mesh is None
                              else tuple(m.device_mesh.mesh_dim_names)}
            continue
        L = getattr(case, "num_leaves", world_size)  # combine: one a rank
        mesh = make_leaf_mesh(L, device=device, group=group)
        dev = mesh.device
        t0 = time.perf_counter()
        if isinstance(case, TierCase) and case.source not in built:
            built.clear()  # one source alive at a time
            built[case.source] = sources[case.source].build(dev)
            _sync(dev)
        build_s = time.perf_counter() - t0
        tel = tele.Telemetry(record_spans=True, fence=True)
        reset_kernel_counts()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        _sync(dev)
        t0 = time.perf_counter()
        if isinstance(case, CombineCase):
            from repro_torch.core.fl import hierarchy
            part = torch.from_numpy(combine_partial(case.seed, rank, case.n))
            out[case.name] = {"combined": hierarchy.combine(
                [part.to(dev)], mesh, tel)[0].cpu(), "rank": rank}
            continue
        if isinstance(case, TierCase):
            srv = run_tier_case(case, built[case.source], mesh=mesh,
                                telemetry=tel)
            params, metrics = srv.params, srv.last_metrics
            extra = {"version": srv.version,
                     "fault": dict(srv.fault_metrics),
                     "local_rows": [int(b.shape[0]) for b in srv._bufs]}
            del srv
        else:
            state, metrics = _run_round(case, mesh, tel)
            params, extra = state.params, {"round": int(state.round_idx)}
        _sync(dev)
        wall = time.perf_counter() - t0
        spans: Dict[str, List[float]] = {}
        for sp in tel.spans:
            spans.setdefault(sp.name, []).append(sp.dur_ns / 1e6)
        out[case.name] = dict(
            metrics={k: float(v) for k, v in (metrics or {}).items()},
            counts=kernel_counts(), spans=spans, wall_s=wall,
            combine_bytes=sum(v for (n, _), v in tel.counters().items()
                              if n == "combine_bytes"),
            peak_gib=(torch.cuda.max_memory_allocated(dev) / 2 ** 30
                      if dev.type == "cuda" else float("nan")),
            rank=rank, world=world_size, **extra)
        t0 = time.perf_counter()
        out[case.name]["params"] = (tree_digest(params) if digest else
                                    T.tree_map(lambda x: x.detach().cpu(),
                                               params))
        out[case.name].update(build_s=build_s,
                              digest_s=time.perf_counter() - t0)
        del params, metrics
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out
