"""The aggregation-tier entry: a closed loop of client pushes into the
system's ``ShardedAsyncServer`` (``repro_torch.core.fl.hierarchy``) over a
world of ranks, one a card, ``launch/dist.py``'s ``start_world``: this
process is rank 0 and spawns the others.

Every rank builds the same weights and pool from the seed and runs the same
arrivals (SPMD): a push is encoded and stored only by the rank whose leaf
holds its slot, and the push that fills the session flushes it on every
rank: each sums its leaf's rows (``leaf_partials``), the ranks' int32
partials meet in the ``combine`` all-reduce, and every rank decodes the same
version.  Before each session rank 0 broadcasts whether there is one, so
the others follow its window.  Sessions take their slots in a seeded order
with a seeded staleness per arrival; each arrival starts when the previous
one is acknowledged.

``push_p95_ms`` is over the pushes rank 0 stores (its leaf's clients'
waits), ``publish_p95_ms`` over the sessions' filling arrivals (the flush
across the cards), ``contrib_per_s`` the published contributions over the
window's time to its last publish.

``correct``: as the ``agg`` entry's, rank 0's change of the parameters from
version 0 to the last published version against ``reference/agg.py`` fed
the same pool and arrivals.
"""
from __future__ import annotations

import importlib
import math
import random
import time

import torch

from bench import harness as H
from bench.reference import agg as ref
from bench.reference.common import worst_leaf_diff

STOP, SESSION = 0, 1


class Rank:
    """One rank's tier and its arrivals."""

    def __init__(self, spec: dict, seed: int, device, tel, group):
        import torch.distributed as tdist

        from repro_torch.configs.base import FLConfig
        from repro_torch.core.fl.hierarchy import ShardedAsyncServer
        from repro_torch.launch.mesh import leaf_range, make_leaf_mesh
        from repro_torch.models.model import param_shapes

        tr, model = spec["traffic"], spec["model"]
        self.tr, self.device, self.tel = tr, device, tel
        self.group = group
        self.rank = tdist.get_rank(group)
        self.L, self.Bl = tr["leaves"], tr["leaf_buffer"]
        self.B = self.L * self.Bl
        flat = H.flatten(param_shapes(H.port_config(model)))
        self.paths = [p for p, _ in flat]
        self.shapes = [tuple(s) for _, s in flat]
        self.n = sum(math.prod(s) for s in self.shapes)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        p0_flat, leaves = H.make_params(self.paths, self.shapes, gen, device,
                                        model["init_std"])
        params = H.unflatten(self.paths, leaves)
        self.p0 = H.views(p0_flat.clone(), self.shapes)

        # the pool, as the agg entry makes it: one normal draw, each row
        # scaled to a whole-model norm from a fixed geometric set
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
        self.pool_order = list(range(P))
        rng.shuffle(self.pool_order)
        self.next_pool = 0

        fl = FLConfig(cohort_size=self.B, clip_norm=tr["clip_norm"],
                      noise_multiplier=tr["noise_multiplier"],
                      secure_agg_bits=tr["bits"],
                      param_chunk_elems=tr["chunk_elems"],
                      server_opt=tr["server_opt"], server_lr=tr["server_lr"])
        mesh = make_leaf_mesh(self.L, device=device, group=group)
        self.srv = ShardedAsyncServer(
            params, fl, num_leaves=self.L, leaf_buffer=self.Bl,
            staleness_exponent=tr["staleness_exponent"],
            staleness_mode=tr["staleness_mode"], mask_mode=tr["mask_mode"],
            session_seed=seed, mesh=mesh, telemetry=tel, device=device)
        del params, leaves, p0_flat
        self.leaves = leaf_range(self.L, mesh)  # this rank's
        self.log = []  # per published version: [(pool, staleness)]
        self.failed = 0
        self._op = torch.zeros((1,), dtype=torch.int64, device=device)

    def op(self, value=None) -> int:
        """Rank 0 sends ``value``; every rank returns it."""
        import torch.distributed as tdist
        if value is not None:
            self._op.fill_(value)
        tdist.broadcast(self._op, src=0, group=self.group)
        return int(self._op.item())

    def session(self):
        """One whole session, arrival by arrival.  Returns [(seconds, local
        slot, published)] of its arrivals."""
        order = list(range(self.B))
        self.rng.shuffle(order)
        srv, out, contribs = self.srv, [], []
        for slot in order:
            p = self.pool_order[self.next_pool % len(self.pool_order)]
            self.next_pool += 1
            s = self.rng.randint(0, self.tr["staleness_max"])
            v = srv.version
            t0 = time.perf_counter()
            with self.tel.span("bench.push", slot=slot):
                srv.push(self.pool_trees[p], v - s, slots=[slot])
                H.sync(self.device)
            dt = time.perf_counter() - t0
            contribs.append((p, s))
            out.append((dt, slot // self.Bl in self.leaves,
                        srv.version != v))
        if not out[-1][2]:
            self.failed += 1
        self.log.append(contribs)
        return out


def rank_main(rank: int, world_size: int, spec: dict, seed: int) -> int:
    """Ranks 1.. of the world: the same tier and arrivals as rank 0, a
    session each time rank 0 asks for one.  Returns the versions."""
    import torch.distributed as tdist

    from repro_torch.core.telemetry import Telemetry
    from repro_torch.launch import dist
    r = Rank(spec, seed, dist.current_device(),
             Telemetry(record_spans=False), tdist.group.WORLD)
    while r.op() == SESSION:
        r.session()
    return r.srv.version


class Cell:
    """One run of a tier cell: set-up in the constructor."""

    def __init__(self, spec: dict, seed: int, device, tel):
        import torch.distributed as tdist

        from repro_torch.launch import dist
        tr = spec["traffic"]
        self.tel = tel
        # the spawned ranks unpickle rank_main from this module's own name
        fn = importlib.import_module("bench.entries.tier").rank_main
        W = spec["chips"]
        self.world = dist.start_world(
            fn, W, spec, seed, device=device,
            threads=max(1, torch.get_num_threads() // W),
            timeout_s=tr["collective_timeout_s"],
            deadline_s=tr["deadline_s"])
        self.r = Rank(spec, seed, dist.current_device(), tel,
                      tdist.group.WORLD)
        self.device = self.r.device
        self.n = self.r.n
        self._session()  # every shape the window uses
        H.sync(self.device)

    def _session(self):
        self.r.op(SESSION)
        return self.r.session()

    # -- the measured window ----------------------------------------------------
    def window(self, seconds: float) -> dict:
        push_s, publish_s = [], []
        attempted = contribs = 0
        t0 = time.perf_counter()
        t_end = t0 + seconds
        v0 = len(self.r.log)
        while time.perf_counter() < t_end or not publish_s:
            arrivals = self._session()
            last = time.perf_counter()
            attempted += len(arrivals)
            for dt, local, published in arrivals:
                if published:
                    publish_s.append(dt)
                elif local:
                    push_s.append(dt)
            contribs += len(self.r.log[-1])
        self.window_s = last - t0
        self.versions = len(self.r.log) - v0
        return {"attempted": attempted, "failed": self.r.failed,
                "metrics": {
                    "contrib_per_s": contribs / self.window_s,
                    "push_p95_ms": 1e3 * H.percentile(push_s, 0.95),
                    "publish_p95_ms": 1e3 * H.percentile(publish_s, 0.95)}}

    def profile(self):
        """Two whole sessions under the profiler (rank 0's card)."""
        def run():
            self._session()
            self._session()
            return {"versions": 2}
        return H.profile(run, self.device)

    def work(self) -> dict:
        return {}

    # -- correct ----------------------------------------------------------------
    def check(self, limits: dict, control: bool = False) -> dict:
        r = self.r
        r.op(STOP)
        versions = r.srv.version
        others = self.world.close()
        final = [x for _, x in H.flatten(r.srv.params)]
        r.srv = None
        prog = [f - p for f, p in zip(final, r.p0)]
        del final
        tr = r.tr
        kw = dict(clip_norm=tr["clip_norm"],
                  exponent=tr["staleness_exponent"], server_lr=tr["server_lr"])
        want = ref.published_change(r.pool, r.log, **kw)
        out = {"param_gap": (worst_leaf_diff(prog, want), limits["param_gap"]),
               "version_gap": (max(abs(v - len(r.log))
                                   for v in [versions] + others),
                               limits["version_gap"])}
        if control:
            low = ref.published_params_lowp(r.p0, r.pool, r.log, **kw)
            ctrl = [a.float() - b for a, b in zip(low, r.p0)]
            out["control.param_gap"] = (worst_leaf_diff(ctrl, want),
                                        limits["param_gap"])
        return out
