"""The synchronous DP-FL round step — the paper's training technique (port of
``repro.core.fl.round``).

One round =
  1. every cohort client runs K local SGD steps on its on-device samples
     (``torch.autograd.grad`` of the model's ``loss_fn``);
  2. each client's model delta is L2-clipped by its whole-model norm
     (DP-SGD) and, in ``device`` noise placement, locally noised;
  3. deltas are fixed-point quantized and summed with wraparound int32
     arithmetic — with ``secure_agg_masked`` every cohort slot adds its
     pairwise session mask, which cancels in the sum;
  4. in ``tee`` placement, Gaussian noise is added once to the decoded
     aggregate;
  5. the server optimizer applies the noised mean delta.

The cohort runs in chunks of ``clients_per_chunk`` clients, as the
reference's scan; client ``j`` of chunk ``k`` is cohort member
``j * n_chunks + k`` and draws ``split(rng, cohort)[k * m + j]``, so every
key, uniform and mask is the reference's (``kernels.prf`` rebuilds JAX's
draws).  The kernels of the path run unconditionally and the tensors'
device picks the implementation:

  - ``kernels.dp_clip.sq_norms`` (K3): the clip norms, one launch per leaf
    over the chunk's stacked ``(m, leaf)`` deltas;
  - ``kernels.secure_agg.quantize_mask`` (K6): each client leaf's encode
    (+ its mask), into an int32 accumulator client by client, so no
    ``(m, ...)`` encoding is ever held;
  - ``kernels.secure_agg.dequantize`` (K7): the decode of each summed leaf;
  - ``kernels.dp_clip.scale_accum`` (K8): the ``secure_agg_bits=0``
    round's sum ``Σ_c (clip_c · w_c) · x_c``, the clipped rows never
    written out.

With noise off and no client clipped, the aggregation half (privatize,
encode, mask, sum, decode) is bit-equal to the jitted reference given the
same client deltas; local SGD agrees with JAX's gradients to ~1e-6.  Device
and TEE noise are the reference's ``jax.random.normal`` draws, rebuilt bit
for bit (``kernels.prf.normal``); XLA adds them as one FMA, the port
rounds the product first.  Each round is a
``round.execute`` span with ``round.local_sgd``, ``round.privatize``,
``round.encode`` (and within it ``round.uniforms``), ``round.sum`` and
``round.decode`` spans inside (fenced when the registry fences).
"""
from __future__ import annotations

import itertools
import math
from typing import Any, Callable, List, NamedTuple, Optional

import torch

from repro_torch import device as _device
from repro_torch import tree as T
from repro_torch.core import telemetry as tele
from repro_torch.core.fl import aggregation as agg
from repro_torch.core.fl.server_opt import build_server_opt
from repro_torch.kernels import dp_clip as kdp
from repro_torch.kernels import prf
from repro_torch.kernels import secure_agg as ksa

SESSION_TAG = 0x5E55
TEE_NOISE_TAG = 0xDEE


class FLState(NamedTuple):
    params: Any
    opt_state: Any
    round_idx: torch.Tensor  # int32 scalar


def init_fl_state(params, fl_cfg) -> FLState:
    opt = build_server_opt(fl_cfg)
    dev = T.leaves(params)[0].device
    return FLState(params, opt.init(params),
                   torch.zeros((), dtype=torch.int32, device=dev))


def _local_sgd(loss_fn, params, cbatch, steps: int, direction) -> tuple:
    """``steps`` SGD steps from ``params``: ``p - direction(i, p_i, g_i)``
    per leaf.  Returns (final leaves, first loss)."""
    paths, p0 = T.flatten(params)
    p, first = p0, None
    for _ in range(steps):
        leaves = [x.detach().requires_grad_(True) for x in p]
        loss = loss_fn(T.unflatten(paths, leaves), cbatch)[0]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        if first is None:
            first = loss.detach()
        with torch.no_grad():
            p = [(x.to(torch.float32) - direction(i, x, g)).to(x.dtype)
                 for i, (x, g) in enumerate(zip(leaves, grads))]
        del leaves, grads, loss
    return p, first


def _grad(g, x) -> torch.Tensor:
    return torch.zeros_like(x, dtype=torch.float32) if g is None \
        else g.to(torch.float32)


def build_client_update(loss_fn: Callable, fl_cfg) -> Callable:
    """client_update(params, client_batch, rng, out=None) -> (delta_f32,
    first_loss).

    K local steps of SGD (``fedprox_mu > 0`` adds the proximal pull
    ``mu * (w - w_round)``).  ``out``, a list of f32 tensors in flatten
    order, receives the delta leaves in place (the round writes each
    client's delta straight into its chunk's stacked rows).
    """
    K, lr = fl_cfg.local_steps, fl_cfg.local_lr
    mu = float(getattr(fl_cfg, "fedprox_mu", 0.0))

    def client_update(params, cbatch, rng, out: Optional[List] = None):
        del rng  # local data order is fixed (single sample per device)
        paths, p0 = T.flatten(params)

        def direction(i, x, g):
            g = _grad(g, x)
            if mu > 0.0:
                g = g + mu * (x.to(torch.float32) - p0[i].to(torch.float32))
            return g.mul_(lr)

        pk, loss = _local_sgd(loss_fn, params, cbatch, K, direction)
        with torch.no_grad():
            if out is None:
                out = [torch.empty(x.shape, dtype=torch.float32,
                                   device=x.device) for x in p0]
            for o, a, b in zip(out, pk, p0):
                torch.sub(a.to(torch.float32), b.to(torch.float32), out=o)
        return T.unflatten(paths, out), loss

    return client_update


def build_scaffold_client_update(loss_fn: Callable, fl_cfg) -> Callable:
    """SCAFFOLD local training (Karimireddy et al. 2020, option II).

    ``client_update(params, c_server, c_client, cbatch, rng) ->
    ((delta_x, delta_c), first_loss)``: K local steps along ``g - c_client
    + c_server``, then ``delta_c = -c_server - delta_x / (K * lr)``.
    """
    K, lr = fl_cfg.local_steps, fl_cfg.local_lr

    def client_update(params, c_server, c_client, cbatch, rng):
        del rng
        paths, p0 = T.flatten(params)
        cs, cc = T.leaves(c_server), T.leaves(c_client)

        def direction(i, x, g):
            return lr * (_grad(g, x) - cc[i] + cs[i])

        pk, loss = _local_sgd(loss_fn, params, cbatch, K, direction)
        with torch.no_grad():
            delta = [a.to(torch.float32) - b.to(torch.float32)
                     for a, b in zip(pk, p0)]
            klr = torch.tensor(K * lr, dtype=torch.float32,
                               device=delta[0].device)
            delta_c = [-c - d / klr for c, d in zip(cs, delta)]
        return ((T.unflatten(paths, delta), T.unflatten(paths, delta_c)),
                loss)

    return client_update


def _client_data(batch, i: int):
    return {k: v[i] for k, v in batch.items()}


def build_round_step(loss_fn: Callable, fl_cfg, *, cohort_size: int,
                     client_parallel: bool = True,
                     clients_per_chunk: int = 0,
                     telemetry: Optional["tele.Telemetry"] = None,
                     device=None) -> Callable:
    """Returns round_step(state, batch, rng) -> (state, metrics).

    batch: dict of tensors (or arrays) with leading axis ``cohort_size``
    (per-client data), plus an optional ``'weight'`` (cohort,).  ``rng``:
    the round's ``(k0, k1)`` key words.  The step runs on ``device``
    (default the GPU; ``"cpu"`` when asked).
    """
    dev = _device.resolve(device)
    tel = telemetry if telemetry is not None else tele.get_default()
    with tel.span("round.setup", kind="sync", cohort=cohort_size):
        client_update = build_client_update(loss_fn, fl_cfg)
        server = build_server_opt(fl_cfg)
        spec = agg.make_spec(fl_cfg, cohort_size)
        use_sa = spec.use_secure_agg
        masked = use_sa and getattr(fl_cfg, "secure_agg_masked", False)
        if clients_per_chunk <= 0:
            clients_per_chunk = cohort_size if client_parallel else 1
        m = clients_per_chunk
        assert cohort_size % m == 0
        n_chunks = cohort_size // m
        deferred = getattr(fl_cfg, "deferred_agg", False) and m > 1

    def span(name: str):
        return tel.span(name, kind="sync")

    def round_step(state: FLState, batch, rng):
        params = state.params
        rng = prf.key_words(rng)
        f32 = torch.float32
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        weights = batch.pop("weight", None)
        weights = (torch.ones((cohort_size,), dtype=f32, device=dev)
                   if weights is None else weights.to(f32))
        rngs = prf.split(rng, n_chunks * m)
        plan = agg.plan_for(params, fl_cfg)
        sessions = (agg.plan_sessions(spec, plan,
                                      prf.fold_in(rng, SESSION_TAG))
                    if masked else None)
        paths, pleaves = T.flatten(params)
        lead = (m,) if deferred else ()
        acc = [torch.zeros(lead + tuple(x.shape),
                           dtype=agg.accumulator_dtype(spec), device=dev)
               for x in pleaves]
        zero = torch.zeros((), dtype=f32, device=dev)
        loss_s = norm_s = clip_s = w_s = zero

        for k in range(n_chunks):
            idx = [j * n_chunks + k for j in range(m)]
            w = weights[idx]
            with span("round.local_sgd") as sp:
                stacked = [torch.empty((m,) + tuple(x.shape), dtype=f32,
                                       device=dev) for x in pleaves]
                losses = []
                for j, i in enumerate(idx):
                    _, loss = client_update(params, _client_data(batch, i),
                                            rngs[k * m + j],
                                            out=[s[j] for s in stacked])
                    losses.append(loss.to(f32))
                losses = torch.stack(losses)
                sp.fence(stacked)
            with span("round.privatize") as sp:
                nrm = prf.sqrt_f32(agg.client_sq_norms(stacked))
                scale = agg.clip_scales(nrm, spec.clip_norm)
                was_clipped = (scale < 1.0).to(f32)
                if spec.dev_noise > 0.0:
                    # the reference's dp.add_noise after the clip, in place
                    for j in range(m):
                        keys = prf.split(prf.fold_in(rngs[k * m + j], 1),
                                         len(stacked))
                        for s, nk in zip(stacked, keys):
                            z = prf.normal(nk, s.shape[1:], device=dev)
                            s[j].mul_(scale[j]).add_(spec.dev_noise * z)
                    scale = torch.ones_like(scale)
                sp.fence(scale)
            if use_sa:
                _encode_chunk(stacked, scale, w, idx, k, rngs, acc, deferred,
                              plan, sessions)
            else:
                with span("round.sum") as sp:
                    for i, s in enumerate(stacked):
                        rows = s.reshape(m, -1)
                        if deferred:
                            a = acc[i].view(m, -1)
                            for j in range(m):
                                a[j] += (rows[j] * scale[j]) * w[j]
                        else:
                            acc[i] += kdp.scale_accum(
                                rows, scale * w).view(acc[i].shape)
                    sp.fence(acc)
            del stacked
            loss_s = loss_s + (losses * w).sum()
            norm_s = norm_s + (nrm * w).sum()
            clip_s = clip_s + (was_clipped * w).sum()
            w_s = w_s + w.sum()

        w_total = torch.clamp(w_s, min=1e-9)
        with span("round.decode") as sp:
            if deferred:  # the one cross-slot reduction of the round
                ones = torch.ones((m,), dtype=f32, device=dev)
                acc = [agg.sum_rows(a.view(m, -1)).view(a.shape[1:])
                       if use_sa else
                       kdp.scale_accum(a.view(m, -1), ones).view(a.shape[1:])
                       for a in acc]
            mean_delta = agg.finalize_aggregate(
                T.unflatten(paths, acc), w_s, spec,
                prf.fold_in(rng, TEE_NOISE_TAG))
            del acc
            new_params, new_opt = server.apply(params, state.opt_state,
                                               mean_delta)
            sp.fence(new_params)
        metrics = {
            "loss": loss_s / w_total,
            "update_norm": norm_s / w_total,
            "clip_fraction": clip_s / w_total,
            "participation": w_s / cohort_size,
            "round": state.round_idx,
        }
        return FLState(new_params, new_opt, state.round_idx + 1), metrics

    def _encode_chunk(stacked, scale, w, idx, k, rngs, acc, deferred, plan,
                      sessions):
        """Encode (+ mask) each client leaf through K6, adding it into the
        int32 accumulator: the reference's ``(d * w)`` then ``encode_tree``
        (keyed ``fold_in(crng, 2)`` for one-client chunks, ``crng`` for
        vmapped ones), then ``plan_mask_tree`` of the client's slot."""
        with span("round.encode"):
            for j, slot in enumerate(idx):
                crng = rngs[k * m + j]
                keys = prf.split(prf.fold_in(crng, 2) if m == 1 else crng,
                                 len(stacked))
                for i, s in enumerate(stacked):
                    xw = (s[j].reshape(-1) * scale[j]) * w[j]
                    with span("round.uniforms") as sp:
                        u = prf.uniform(keys[i], xw.numel(), device=dev)
                        sp.fence(u)
                    mask = None
                    if sessions is not None:
                        mask = agg.plan_leaf_mask(
                            plan, sessions, i, slot, (xw.numel(),), dev)
                    q = ksa.quantize_mask(xw, mask, u, spec.sa_scale,
                                          math.inf)
                    del xw, u, mask
                    with span("round.sum") as sp:
                        a = acc[i][j] if deferred else acc[i]
                        agg.add_mod32_(a, q)
                        sp.fence(a)
                    del q

    return _instrument_step(round_step, tel, "sync")


def _instrument_step(round_step: Callable, tel: "tele.Telemetry",
                     kind: str) -> Callable:
    """Wrap a round step with ``round.execute`` spans; the ``call`` label
    is a host-side counter."""
    calls = itertools.count()

    def instrumented_round_step(state, batch, rng):
        with tel.span("round.execute", kind=kind, call=next(calls)) as sp:
            out = round_step(state, batch, rng)
            sp.fence(out[0].params)
        return out

    return instrumented_round_step


def build_sharded_round_step(loss_fn: Callable, fl_cfg, *, cohort_size: int,
                             num_leaves: int, mesh=None,
                             telemetry=None) -> Callable:
    raise NotImplementedError(
        "the cohort-sharded round is ported with the aggregation tier "
        "(ROADMAP Queue 1, item 8)")


def rounds_to_epsilon(fl_cfg, cohort_size: int, population: int,
                      rounds: int) -> float:
    """Convenience wrapper over the RDP accountant (see accountant.py)."""
    from repro_torch.core.fl.accountant import compute_epsilon
    q = cohort_size / population
    return compute_epsilon(q, fl_cfg.noise_multiplier, rounds,
                           fl_cfg.dp_delta)
