"""The aggregation entry: a closed loop of client pushes into the system's
``AsyncServer`` (``repro_torch.core.fl.async_fl``) in a masked streaming
mode.

Set-up makes the weights and a pool of client deltas on the device from
the seed.  The upload queue is backlogged (many more clients report than a
session takes), so the server sets the pace: each arrival starts when the
previous acknowledgement returns.  Arrivals cycle through the pool; each
session takes its slots in a seeded order with a seeded staleness per
arrival; with ``absent_per_session`` a seeded slot of each session never
uploads and the session's deadline ``flush()`` recovers it.

``correct``: after the window, the change of the parameters from version 0
to the last published version against the plain reference
(``reference/agg.py``) fed the same pool and the same arrivals.
"""
from __future__ import annotations

import math
import random
import time

import torch

from bench import harness as H
from bench.reference import agg as ref
from bench.reference.common import worst_leaf_diff
from bench.work import counts


class Cell:
    """One run of an aggregation cell: set-up in the constructor."""

    def __init__(self, spec: dict, seed: int, device, tel):
        from repro_torch.configs.base import FLConfig
        from repro_torch.core.fl.async_fl import AsyncServer
        from repro_torch.models.model import param_shapes

        tr, model = spec["traffic"], spec["model"]
        self.tr, self.device, self.tel = tr, device, tel
        self.B = tr["buffer"]
        self.present = self.B - tr["absent_per_session"]
        flat = H.flatten(param_shapes(H.port_config(model)))
        self.paths = [p for p, _ in flat]
        self.shapes = [tuple(s) for _, s in flat]
        self.n = sum(math.prod(s) for s in self.shapes)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        self.p0_flat, leaves = H.make_params(self.paths, self.shapes, gen,
                                             device, model["init_std"])
        params = H.unflatten(self.paths, leaves)
        self.p0_flat = self.p0_flat.clone()  # version 0, kept for the check
        self.p0 = H.views(self.p0_flat, self.shapes)

        # the pool: one normal draw, each row scaled to a whole-model norm
        # from a fixed geometric set between the traffic's bounds (the same
        # sizes on every seed, in a seeded order)
        P = spec["cell"]["pool"]
        lo, hi = tr["delta_norm_range"]
        norms = [lo * (hi / lo) ** (i / max(P - 1, 1)) for i in range(P)]
        rng = random.Random(seed)
        rng.shuffle(norms)
        self.pool_flat = torch.randn((P, self.n), generator=gen,
                                     device=device)
        for p, r in enumerate(norms):
            self.pool_flat[p].mul_(r / self.n ** 0.5)
        self.pool = [H.views(self.pool_flat[p], self.shapes)
                     for p in range(P)]
        self.pool_trees = [H.unflatten(self.paths, x) for x in self.pool]
        self.rng = rng
        self.next_pool = 0
        self.pool_order = list(range(P))
        rng.shuffle(self.pool_order)

        fl = FLConfig(cohort_size=self.B, clip_norm=tr["clip_norm"],
                      noise_multiplier=tr["noise_multiplier"],
                      secure_agg_bits=tr["bits"],
                      param_chunk_elems=tr["chunk_elems"],
                      server_opt=tr["server_opt"], server_lr=tr["server_lr"])
        self.srv = AsyncServer(
            params, fl, buffer_size=self.B,
            staleness_exponent=tr["staleness_exponent"],
            staleness_mode=tr["staleness_mode"], mask_mode=tr["mask_mode"],
            session_seed=seed, telemetry=tel, device=device)
        del params, leaves
        self.log = []         # per published version: [(pool, staleness)]
        self.session = []     # the open session's contributions
        self.queue = []
        self.failed = 0
        self.n_push = 0
        # every shape the window uses: a whole session, with its recovery
        # where the traffic drops a slot
        self._session()
        H.sync(device)

    # -- arrivals -------------------------------------------------------------
    def _new_session(self):
        order = list(range(self.B))
        self.rng.shuffle(order)
        q = []
        for slot in order[:self.present]:
            p = self.pool_order[self.next_pool % len(self.pool_order)]
            self.next_pool += 1
            q.append(("push", p, self.rng.randint(0, self.tr["staleness_max"]),
                      slot))
        if self.present < self.B:
            q.append(("flush", None, None, None))
        return q

    def arrival(self):
        """One arrival (a push, or the session's deadline flush), through
        to its acknowledgement.  Returns (kind, seconds, published)."""
        if not self.queue:
            self.queue = self._new_session()
        kind, p, s, slot = self.queue.pop(0)
        srv = self.srv
        v = srv.version
        t0 = time.perf_counter()
        with self.tel.span(f"bench.{kind}"):
            if kind == "push":
                ok = srv.push(self.pool_trees[p], v - s, slot=slot)
            else:
                ok = srv.flush(force=True)
            H.sync(self.device)
        dt = time.perf_counter() - t0
        if not ok:
            self.failed += 1
        elif kind == "push":
            self.session.append((p, s))
            self.n_push += 1
        published = srv.version != v
        if published:
            self.log.append(self.session)
            self.session = []
        return kind, dt, published

    def _session(self):
        while True:
            if self.arrival()[2]:
                return

    # -- the measured window ----------------------------------------------------
    def window(self, seconds: float) -> dict:
        push_s, publish_s = [], []
        attempted = contribs = 0
        t0 = time.perf_counter()
        t_end = t0 + seconds
        last = None
        # the window closes at ``seconds``, or at its first publish if later
        while time.perf_counter() < t_end or last is None:
            kind, dt, published = self.arrival()
            attempted += 1
            if published:
                publish_s.append(dt)
                contribs += len(self.log[-1])
                last = time.perf_counter()
            elif kind == "push":
                push_s.append(dt)
        self.window_s = last - t0
        self.versions = len(publish_s)
        return {"attempted": attempted, "failed": self.failed,
                "metrics": {
                    "contrib_per_s": contribs / self.window_s,
                    "push_p95_ms": 1e3 * H.percentile(push_s, 0.95),
                    "publish_p95_ms": 1e3 * H.percentile(publish_s, 0.95)}}

    def profile(self):
        """Two whole sessions under the profiler."""
        def run():
            v0, n0 = len(self.log), self.n_push
            self._session()
            self._session()
            return {"versions": len(self.log) - v0,
                    "pushes": self.n_push - n0}
        return H.profile(run, self.device)

    def work(self) -> dict:
        return {"version": counts.version_work(self.n, self.B, self.present),
                "push": counts.push_work(self.n, self.B),
                "k1_push": counts.k1_work(self.n, self.B)}

    # -- correct ----------------------------------------------------------------
    def outputs(self):
        """The last published parameters; frees the rest of the server."""
        srv = self.srv
        final = [x for _, x in H.flatten(srv.params)]
        versions = srv.version
        self.srv = None
        del srv
        return final, versions

    def check(self, limits: dict, control: bool = False) -> dict:
        final, versions = self.outputs()
        prog = [f - p for f, p in zip(final, self.p0)]
        del final
        tr = self.tr
        kw = dict(clip_norm=tr["clip_norm"],
                  exponent=tr["staleness_exponent"], server_lr=tr["server_lr"])
        want = ref.published_change(self.pool, self.log, **kw)
        out = {"param_gap": (worst_leaf_diff(prog, want), limits["param_gap"]),
               "version_gap": (abs(versions - len(self.log)),
                               limits["version_gap"])}
        if control:
            low = ref.published_params_lowp(self.p0, self.pool, self.log, **kw)
            ctrl = [a.float() - b for a, b in zip(low, self.p0)]
            out["control.param_gap"] = (worst_leaf_diff(ctrl, want),
                                        limits["param_gap"])
        return out
