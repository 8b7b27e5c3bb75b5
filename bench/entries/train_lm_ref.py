"""The decoder-LM training entry for any decoder LM of the system's
registry: the synchronous DP-FL rounds of ``entries/train_lm.py`` (whose
window, profile and check this entry reuses), with the plain reference and
the work counts that the cell's workload file names (``"reference"``: a
module of ``bench/reference/``, ``"work"``: one of ``bench/work/``).

Set-up makes the weights from the seed, then, where the configuration
file gives ``route_bias_std``, the sigmoid router's selection bias (one
row a MoE layer, ``N(0, route_bias_std)``), which the system's model and
the reference are both handed and which no round changes (it is no
parameter); then the pool of round batches.  It builds one round step with
its state and drives it through its first three rounds, the rounds the
reference follows, which warm every shape.  The window runs rounds back to
back on that same step and state.  The system's default telemetry registry
is the run's for the cell's life, so the model's spans and counters land
in it.

``correct``: as ``train_lm``'s: each of the first three rounds' loss
(``loss_gap``, where the workload file gives its limit), the first round's
change of the parameters and the change after three rounds, leaf by leaf,
against the reference fed the same weights, bias, batches and keys, client
by client; and ``first_loss_gap``, the first round's loss alone.  The first
round runs on the seed's weights; the later ones on weights the TEE noise
has moved by more than their own size (std ``noise_multiplier * clip_norm
/ cohort`` an element against the weights' ``init_std``), where a model can
be so steep that an f32 rounding of the first round's delta moves the loss
by 1e-4: its own limit keeps the first round's loss as tight as the numbers
allow.  Neither a loss nor a norm of the noised change sees TF32 where the
router breaks near-ties apart in any two f32 orders (each flip moves a
loss as much as TF32 does) and the noise buries the signal, so
``logit_gap`` looks under them: over the first client's tokens, the 10th
percentile of ``|l_t - ref_t| / |ref_t|`` between the system's logits on
the seed's weights and the reference's, a row of the vocabulary a token.
Rounding in another precision moves every token's row alike; a flipped
choice moves its own token's row and, through attention, later rows by
amounts that vary from token to token, so the tokens it has moved least
read the arithmetic alone.
"""
from __future__ import annotations

import importlib
import math
import random

import torch

from bench import harness as H
from bench.reference.common import flatten, plain_f32, worst_norm_gap

train_lm = H.load_entry("train_lm")
CHECKED_ROUNDS = train_lm.CHECKED_ROUNDS
TEE_NOISE_TAG = train_lm.TEE_NOISE_TAG


class Cell(train_lm.Cell):
    """One run of a decoder-LM training cell: set-up in the constructor."""

    def __init__(self, spec: dict, seed: int, device, tel):
        from repro_torch.configs.base import FLConfig
        from repro_torch.core import telemetry as tele
        from repro_torch.core.fl.round import build_round_step, init_fl_state
        from repro_torch.models.model import build_model, param_shapes

        tr, model, cell = spec["traffic"], spec["model"], spec["cell"]
        self.tr, self.model, self.device, self.tel = tr, model, device, tel
        self.ref = importlib.import_module(
            f"bench.reference.{cell['reference']}")
        self.wk = importlib.import_module(f"bench.work.{cell['work']}")
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
        net_kw, self.ref_state = {}, {}
        if "route_bias_std" in model:
            from repro_torch.models.moe import route_bias_shape
            bias = torch.randn(route_bias_shape(cfg), generator=gen,
                               device=device) * model["route_bias_std"]
            net_kw = {"route_bias": bias}
            self.ref_state = {"bias": bias.clone()}

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
        net = build_model(cfg, device=device, **net_kw)
        # the system's logits on the seed's weights for the first client's
        # document, counted in no span or counter of the run
        quiet = tele.set_default(tele.Telemetry(record_spans=False))
        with torch.no_grad():
            self.logits = net.apply(params, {"tokens": self._doc()})[0] \
                .float().cpu()
        tele.set_default(quiet)
        self.state = init_fl_state(params, fl)
        del params, leaves, flat_p
        self.step = build_round_step(
            net.loss_fn, fl, cohort_size=C,
            clients_per_chunk=tr["clients_per_chunk"], telemetry=tel,
            device=device)
        self.keys, self.round = [], 0

        p0 = [x for _, x in flatten(self.p0)]
        self.losses = []
        for r in range(CHECKED_ROUNDS):
            self.losses.append(float(self._round()["loss"]))
            if r == 0:
                self.first = self._change_norms(p0)
        self.last = self._change_norms(p0)
        H.sync(device)

    def held_pairs(self) -> float:
        """(token, slot) pairs on held experts a client's forward pass, as
        ``train_lm`` counts them, by this cell's work module."""
        from repro_torch.core import telemetry as tele
        counted = tele.get_default().value("moe_pairs", held=1)
        steps = self.round * self.tr["cohort"] * self.tr["local_steps"]
        if counted and steps:
            return counted / steps
        return self.wk.routed_held_pairs(self.model, self.tr["seq_len"])

    def work(self) -> dict:
        tr = self.tr
        return {"round": self.wk.round_work(
            self.model, self.n, tr["cohort"], tr["seq_len"],
            tr["noise_placement"] == "tee" and tr["noise_multiplier"] > 0,
            self.held_pairs())}

    def _doc(self):
        """Round 1's first client's document, ``(1, seq_len)`` ids."""
        return self.batches[0]["tokens"][0]

    def _numbers(self, losses, first, last, logits, want, limits,
                 prefix=""):
        rl, rfirst, rlast, keep, rlogits = want
        gaps = [abs(a - b) / abs(b) for a, b in zip(losses, rl)]
        out = {"first_loss_gap": (gaps[0], limits["first_loss_gap"]),
               "first_change_gap": (worst_norm_gap(first, rfirst, keep),
                                    limits["first_change_gap"]),
               "change_gap": (worst_norm_gap(last, rlast, keep),
                              limits["change_gap"]),
               "logit_gap": (token_gap(logits, rlogits),
                             limits["logit_gap"])}
        if "loss_gap" in limits:
            out["loss_gap"] = (max(gaps), limits["loss_gap"])
        return {prefix + k: v for k, v in out.items()}

    def check(self, limits: dict, controls=()) -> dict:
        from repro_torch.core import telemetry as tele
        self.state = self.step = None  # the program's state is freed
        tele.set_default(self._prev_default)
        want = self._reference()
        out = self._numbers(self.losses, self.first, self.last, self.logits,
                            want, limits)
        for c in controls:
            got = self._reference(c)
            out.update(self._numbers(*got[:3], got[4], want, limits,
                                     f"control.{c}."))
        return out

    def _reference(self, control: str = ""):
        """``train_lm``'s reference rounds, by this cell's reference (the
        selection bias, where there is one, as the system was given it and
        in f32 under either control), and its logits on the seed's weights
        for the first client's document (on the host)."""
        tr = self.tr
        p0 = [x for _, x in flatten(self.p0)]
        paths = [q for q, _ in flatten(self.p0)]
        low = control == "bf16"
        cast = (lambda x: x.to(torch.bfloat16)) if low else (lambda x: x)
        p = H.unflatten(paths, [cast(x) for x in p0])
        losses = []
        with plain_f32(control == "tf32"):
            with torch.no_grad():
                out = self.ref.forward(self.model, p, self._doc(),
                                       **self.ref_state)
            # a forward with a balance term returns it beside the logits
            logits = (out[0] if isinstance(out, tuple) else out).float().cpu()
            del out
            for r in range(CHECKED_ROUNDS):
                batch = dict(self.batches[r],
                             loss_mask=cast(self.batches[r]["loss_mask"]))
                p, loss, noised, clean = self.ref.sync_round(
                    self.model, p, batch, self.keys[r], cohort=tr["cohort"],
                    lr=tr["local_lr"], clip_norm=tr["clip_norm"],
                    noise_multiplier=tr["noise_multiplier"],
                    server_lr=tr["server_lr"], noise_tag=TEE_NOISE_TAG,
                    **self.ref_state)
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
        return losses, first, last, keep, logits


def token_gap(prog, ref) -> float:
    """The 10th percentile over tokens of ``|prog_t - ref_t| / |ref_t|``,
    each a row of logits (L2 norms)."""
    prog, ref = prog.double(), ref.double()
    gap = torch.linalg.vector_norm(prog - ref, dim=-1) \
        / torch.linalg.vector_norm(ref, dim=-1).clamp_min(1e-30)
    return float(torch.quantile(gap.reshape(-1), 0.1))
