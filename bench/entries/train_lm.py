"""The decoder-LM training entry: synchronous DP-FL rounds through the
system's ``build_round_step`` (``repro_torch.core.fl.round``) over a
decoder LM's loss, built as ``repro_torch.launch.train`` builds it.

Set-up makes the weights and a pool of round batches from the seed (each
client one sequence of ids uniform over the vocabulary, the loss mask all
ones, next-token labels), builds one round step with its state, and drives
it through its first three rounds: those are the rounds the plain reference
follows, and they warm every shape.  The window then runs rounds back to
back (a closed loop) on that same step and state.  The system's default
telemetry registry is the run's for the cell's life, so the model's
``ssm`` / ``moe`` spans and the expert share's counters land in it.

``correct``: each of the first three rounds' loss, the first round's change
of the parameters (the noised mean delta) and the change after three
rounds, leaf by leaf, against ``reference/granite.py`` fed the same
weights, batches and keys, client by client.
"""
from __future__ import annotations

import math
import random
import time

import torch

from bench import harness as H
from bench.reference import granite as ref
from bench.reference.common import flatten, plain_f32, worst_norm_gap
from bench.work import granite as work

CHECKED_ROUNDS = 3
TEE_NOISE_TAG = 0xDEE  # the key tag of the system's TEE noise draw


class Cell:
    """One run of a decoder-LM training cell: set-up in the constructor."""

    def __init__(self, spec: dict, seed: int, device, tel):
        from repro_torch.configs.base import FLConfig
        from repro_torch.core import telemetry as tele
        from repro_torch.core.fl.round import build_round_step, init_fl_state
        from repro_torch.models.model import build_model, param_shapes

        tr, model = spec["traffic"], spec["model"]
        self.tr, self.model, self.device, self.tel = tr, model, device, tel
        self._prev_default = tele.set_default(tel)
        cfg = H.port_config(model)
        flat = H.flatten(param_shapes(cfg))
        self.paths = [p for p, _ in flat]
        self.shapes = [tuple(s) for _, s in flat]
        self.n = sum(math.prod(s) for s in self.shapes)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        flat_p, leaves = H.make_params(self.paths, self.shapes, gen, device,
                                       model["init_std"])
        self.p0 = H.unflatten(self.paths, H.views(flat_p.clone(),
                                                  self.shapes))
        params = H.unflatten(self.paths, leaves)

        C, S = tr["cohort"], tr["seq_len"]
        self.batches = []
        for _ in range(tr["batches"]):
            toks = torch.randint(0, model["vocab_size"], (C, 1, S + 1),
                                 generator=gen, device=device)
            self.batches.append({
                "tokens": toks[..., :-1].to(torch.int32),
                "labels": toks[..., 1:].to(torch.int32),
                "loss_mask": torch.ones((C, 1, S), device=device)})
        self.rng = random.Random(seed)

        fl = FLConfig(
            cohort_size=C, local_steps=tr["local_steps"],
            local_lr=tr["local_lr"], clip_norm=tr["clip_norm"],
            noise_multiplier=tr["noise_multiplier"],
            noise_placement=tr["noise_placement"],
            secure_agg_bits=tr["bits"], server_opt=tr["server_opt"],
            server_lr=tr["server_lr"])
        net = build_model(cfg, device=device)
        self.state = init_fl_state(params, fl)
        del params, leaves, flat_p
        self.step = build_round_step(
            net.loss_fn, fl, cohort_size=C,
            clients_per_chunk=tr["clients_per_chunk"], telemetry=tel,
            device=device)
        self.keys, self.round = [], 0

        # the checked rounds: losses, the first change and the change
        # after the last of them, leaf by leaf (host floats)
        p0 = [x for _, x in flatten(self.p0)]
        self.losses = []
        for r in range(CHECKED_ROUNDS):
            self.losses.append(float(self._round()["loss"]))
            if r == 0:
                self.first = self._change_norms(p0)
        self.last = self._change_norms(p0)
        H.sync(device)

    def _change_norms(self, p0) -> list:
        cur = [x for _, x in flatten(self.state.params)]
        return [float(torch.linalg.vector_norm((a - b).double()))
                for a, b in zip(cur, p0)]

    def _round(self):
        key = (self.rng.getrandbits(32), self.rng.getrandbits(32))
        self.keys.append(key)
        batch = self.batches[self.round % len(self.batches)]
        self.round += 1
        self.state, metrics = self.step(self.state, batch, key)
        return metrics

    def _timed_round(self) -> float:
        t0 = time.perf_counter()
        with self.tel.span("bench.round"):
            metrics = self._round()
            H.sync(self.device)
        dt = time.perf_counter() - t0
        if not math.isfinite(float(metrics["loss"])):
            self.failed += 1
        return dt

    # -- the measured window ----------------------------------------------------
    def window(self, seconds: float) -> dict:
        self.failed = 0
        t0 = time.perf_counter()
        t_end = t0 + seconds
        done = 0
        while time.perf_counter() < t_end:
            self._timed_round()
            done += 1
            last = time.perf_counter()
        self.window_s = last - t0
        self.rounds = done
        return {"attempted": done, "failed": self.failed,
                "metrics": {"round_s": self.window_s / done}}

    def profile(self):
        """One round under the profiler."""
        def run():
            self._timed_round()
            return {"rounds": 1}
        return H.profile(run, self.device)

    def held_pairs(self) -> float:
        """(token, slot) pairs on held experts a client's forward pass: the
        system's ``moe_pairs{held=1}`` over every client step the run has
        driven where it counted, else the uniform routing's share."""
        from repro_torch.core import telemetry as tele
        counted = tele.get_default().value("moe_pairs", held=1)
        steps = self.round * self.tr["cohort"] * self.tr["local_steps"]
        if counted and steps:
            return counted / steps
        return work.routed_held_pairs(self.model, self.tr["seq_len"])

    def work(self) -> dict:
        tr = self.tr
        return {"round": work.round_work(
            self.model, self.n, tr["cohort"], tr["seq_len"],
            tr["noise_placement"] == "tee" and tr["noise_multiplier"] > 0,
            self.held_pairs())}

    # -- correct ----------------------------------------------------------------
    def _reference(self, control: str = ""):
        """The reference's first rounds, in f32 with TF32 off, or as a
        control: ``tf32`` (TF32 on) or ``bf16`` (parameters, inputs and
        arithmetic in bf16).  Returns (losses, the first noised change's
        leaf norms, change norms after the last round, which leaves
        count)."""
        tr = self.tr
        p0 = [x for _, x in flatten(self.p0)]
        paths = [q for q, _ in flatten(self.p0)]
        low = control == "bf16"
        cast = (lambda x: x.to(torch.bfloat16)) if low else (lambda x: x)
        p = H.unflatten(paths, [cast(x) for x in p0])
        losses = []
        with plain_f32(control == "tf32"):
            for r in range(CHECKED_ROUNDS):
                batch = dict(self.batches[r],
                             loss_mask=cast(self.batches[r]["loss_mask"]))
                p, loss, noised, clean = ref.sync_round(
                    self.model, p, batch, self.keys[r], cohort=tr["cohort"],
                    lr=tr["local_lr"], clip_norm=tr["clip_norm"],
                    noise_multiplier=tr["noise_multiplier"],
                    server_lr=tr["server_lr"], noise_tag=TEE_NOISE_TAG)
                losses.append(loss)
                if r == 0:
                    first = [float(torch.linalg.vector_norm(
                        tr["server_lr"] * x.double())) for x in noised]
                    med = sorted(clean)[len(clean) // 2]
                    # leaves whose gradient is nought to rounding move by
                    # round-off alone: left out of the change numbers
                    keep = [x >= 1e-3 * med for x in clean]
                del noised
        last = [float(torch.linalg.vector_norm(
            (a.double() - b.double()))) for a, b in
            zip([x for _, x in flatten(p)], p0)]
        return losses, first, last, keep

    def _numbers(self, losses, first, last, want, limits, prefix=""):
        rl, rfirst, rlast, keep = want
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, rl))
        return {prefix + "loss_gap": (loss_gap, limits["loss_gap"]),
                prefix + "first_change_gap": (
                    worst_norm_gap(first, rfirst, keep),
                    limits["first_change_gap"]),
                prefix + "change_gap": (worst_norm_gap(last, rlast, keep),
                                        limits["change_gap"])}

    def check(self, limits: dict, controls=()) -> dict:
        from repro_torch.core import telemetry as tele
        self.state = self.step = None  # the program's state is freed
        tele.set_default(self._prev_default)
        want = self._reference()
        out = self._numbers(self.losses, self.first, self.last, want, limits)
        for c in controls:
            got = self._reference(c)
            out.update(self._numbers(got[0], got[1], got[2], want, limits,
                                     f"control.{c}."))
        return out
