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

import functools
import itertools
import math
from typing import Any, Callable, List, NamedTuple, Optional

import torch

from repro_torch import device as _device
from repro_torch import tree as T
from repro_torch.core import telemetry as tele
from repro_torch.core.fl import aggregation as agg
from repro_torch.core.fl import hierarchy
from repro_torch.core.fl.server_opt import build_server_opt
from repro_torch.kernels import dp_clip as kdp
from repro_torch.kernels import prf
from repro_torch.kernels import secure_agg as ksa
from repro_torch.launch.mesh import leaf_range, leaves_per_device

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


def _train_and_privatize(client_update, params, batch, clients, crngs, spec,
                         span, dev):
    """Local SGD of cohort members ``clients`` (keys ``crngs``) into stacked
    ``(m, ...)`` f32 deltas, their clip norms (K3, one launch per leaf) and,
    under device placement, the reference's ``dp.add_noise`` after the
    clip, in place.  Returns (stacked, losses, norms, clip scales,
    was_clipped)."""
    f32 = torch.float32
    pleaves = T.leaves(params)
    m = len(clients)
    with span("round.local_sgd") as sp:
        stacked = [torch.empty((m,) + tuple(x.shape), dtype=f32, device=dev)
                   for x in pleaves]
        losses = torch.stack([
            client_update(params, _client_data(batch, c), crng,
                          out=[s[j] for s in stacked])[1].to(f32)
            for j, (c, crng) in enumerate(zip(clients, crngs))])
        sp.fence(stacked)
    with span("round.privatize") as sp:
        nrm = prf.sqrt_f32(agg.client_sq_norms(stacked))
        scale = agg.clip_scales(nrm, spec.clip_norm)
        was_clipped = (scale < 1.0).to(f32)
        if spec.dev_noise > 0.0:
            for j, crng in enumerate(crngs):
                keys = prf.split(prf.fold_in(crng, 1), len(stacked))
                for s, nk in zip(stacked, keys):
                    z = prf.normal(nk, s.shape[1:], device=dev)
                    s[j].mul_(scale[j]).add_(spec.dev_noise * z)
            scale = torch.ones_like(scale)
        sp.fence(scale)
    return stacked, losses, nrm, scale, was_clipped


def _encode_clients(stacked, scale, w, slots, crngs, acc, plan, sessions,
                    spec, span, dev, *, vmapped: bool,
                    deferred: bool = False):
    """Encode (+ mask) each client leaf through K6, adding it into the int32
    accumulator: the reference's ``(d * w)`` then ``encode_tree`` (keyed
    ``crng`` where the reference vmaps the encode, ``fold_in(crng, 2)`` for
    its one-client chunks), then ``plan_mask_tree`` of the client's slot.
    ``deferred`` adds client ``j`` into ``acc[i][j]``."""
    with span("round.encode"):
        for j, (slot, crng) in enumerate(zip(slots, crngs)):
            keys = prf.split(crng if vmapped else prf.fold_in(crng, 2),
                             len(stacked))
            for i, s in enumerate(stacked):
                xw = (s[j].reshape(-1) * scale[j]) * w[j]
                with span("round.uniforms") as sp:
                    u = prf.uniform(keys[i], xw.numel(), device=dev)
                    sp.fence(u)
                mask = None
                if sessions is not None:
                    mask = agg.plan_leaf_mask(plan, sessions, i, slot,
                                              (xw.numel(),), dev)
                q = ksa.quantize_mask(xw, mask, u, spec.sa_scale, math.inf)
                del xw, u, mask
                with span("round.sum") as sp:
                    a = acc[i][j] if deferred else acc[i]
                    agg.add_mod32_(a, q)
                    sp.fence(a)
                del q


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

    span = tele.stage_spans(tel, {"kind": "sync"})

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
            crngs = rngs[k * m:(k + 1) * m]
            w = weights[idx]
            stacked, losses, nrm, scale, was_clipped = _train_and_privatize(
                client_update, params, batch, idx, crngs, spec, span, dev)
            if use_sa:
                _encode_clients(stacked, scale, w, idx, crngs, acc, plan,
                                sessions, spec, span, dev, vmapped=m > 1,
                                deferred=deferred)
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
                             telemetry: Optional["tele.Telemetry"] = None,
                             device=None) -> Callable:
    """A synchronous round over the aggregation tier's leaves.

    The cohort splits into ``num_leaves`` contiguous shards; leaf ``l``
    trains its ``cohort_size / num_leaves`` clients, clips them (K3 over
    the leaf's stacked deltas), encodes each client leaf (K6, + the GLOBAL
    slot's pairwise mask under ``fl_cfg.secure_agg_masked``: one session
    spans the cohort, so masks pair across leaves) into its own int32
    partial; the root adds the partials mod 2^32 (the reference's
    field-modulus ``psum``), decodes (K7), draws the central noise once and
    applies the server optimizer.  The int32 sums are exact, so the masked
    round is bit-equal to the unmasked one.  Client ``c`` draws
    ``split(rng, cohort_size)[c]`` and encodes under it directly, as the
    fully-vmapped reference does, so the round equals
    ``build_round_step(clients_per_chunk=cohort_size)`` given the same
    deltas.

    Placement: without ``mesh`` (or with a mesh without a process group)
    the leaves run one after another on ``device`` (the GPU by default).
    With a ``launch.mesh.LeafMesh`` over a process group every rank runs
    the same call on the same batch and key, trains and encodes only its
    own leaves' clients on its device, and the ranks' partials meet in
    ``hierarchy.combine``; the per-leaf metric sums are gathered and added
    in leaf order, so every rank returns the one-process round's state
    and metrics bit for bit.
    """
    if mesh is None:
        dev = _device.resolve(device)
    else:
        dev = mesh.device
        leaves_per_device(num_leaves, mesh)  # validates divisibility
    leaves = leaf_range(num_leaves, mesh)
    tel = telemetry if telemetry is not None else tele.get_default()
    with tel.span("round.setup", kind="sharded", cohort=cohort_size,
                  leaves=num_leaves):
        assert cohort_size % num_leaves == 0
        m = cohort_size // num_leaves
        client_update = build_client_update(loss_fn, fl_cfg)
        server = build_server_opt(fl_cfg)
        spec = agg.make_spec(fl_cfg, cohort_size)
        if not spec.use_secure_agg:
            raise ValueError("the sharded tier aggregates in the secure-agg "
                             "integer field: set secure_agg_bits > 0")
        masked = getattr(fl_cfg, "secure_agg_masked", False)

    span = tele.stage_spans(tel, {"kind": "sharded"})

    def round_step(state: FLState, batch, rng):
        params = state.params
        rng = prf.key_words(rng)
        f32 = torch.float32
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        weights = batch.pop("weight", None)
        weights = (torch.ones((cohort_size,), dtype=f32, device=dev)
                   if weights is None else weights.to(f32))
        rngs = prf.split(rng, cohort_size)  # client c -> rngs[c]
        plan = agg.plan_for(params, fl_cfg)
        sessions = (agg.plan_sessions(spec, plan,
                                      prf.fold_in(rng, SESSION_TAG))
                    if masked else None)
        paths, pleaves = T.flatten(params)
        acc = [None] * len(pleaves)
        stats = []
        for leaf in leaves:
            idx = list(range(leaf * m, (leaf + 1) * m))
            crngs = [rngs[c] for c in idx]
            w = weights[idx]
            stacked, losses, nrm, scale, was_clipped = _train_and_privatize(
                client_update, params, batch, idx, crngs, spec, span, dev)
            part = [torch.zeros(tuple(x.shape), dtype=torch.int32,
                                device=dev) for x in pleaves]
            _encode_clients(stacked, scale, w, idx, crngs, part, plan,
                            sessions, spec, span, dev, vmapped=True)
            del stacked
            with span("round.sum") as sp:  # the root's wraparound combine
                acc = [p if a is None else agg.add_mod32_(a, p)
                       for a, p in zip(acc, part)]
                sp.fence(acc)
            stats.append(torch.stack([(losses * w).sum(), (nrm * w).sum(),
                                      (was_clipped * w).sum(), w.sum()]))
        acc = hierarchy.combine(acc, mesh, tel, kind="sharded")
        # every leaf's sums, added in leaf order whatever rank holds it
        cols = hierarchy.gather_slots(mesh, *torch.stack(stats).T)
        loss_s, norm_s, clip_s, w_s = (
            functools.reduce(lambda a, b: a + b, col.unbind())
            for col in cols)
        w_total = torch.clamp(w_s, min=1e-9)
        with span("round.decode") as sp:
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

    return _instrument_step(round_step, tel, "sharded")


def rounds_to_epsilon(fl_cfg, cohort_size: int, population: int,
                      rounds: int) -> float:
    """Convenience wrapper over the RDP accountant (see accountant.py)."""
    from repro_torch.core.fl.accountant import compute_epsilon
    q = cohort_size / population
    return compute_epsilon(q, fl_cfg.noise_multiplier, rounds,
                           fl_cfg.dp_delta)
