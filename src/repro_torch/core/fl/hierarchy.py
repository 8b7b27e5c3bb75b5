"""Hierarchical aggregation tier: masked rounds over many leaf aggregators
(port of ``repro.core.fl.hierarchy``).

Masked secure aggregation is a MODULAR sum (int32 addition wraps mod 2^32,
associative and commutative exactly), so leaf partial sums commute: any
leaf/root tier decodes bit-identically to the single-host engine at
``buffer_size = num_leaves * leaf_buffer``.  Two session topologies share
one state layout, a ``(num_leaves, leaf_buffer, D)`` buffer per chunk:

**One global session** (``two_level=False``): ``num_leaves * leaf_buffer``
slots of ONE mask session.  Each leaf sums its present slots and sweeps a
shard of the session's recovery edges (:func:`_partition_edges`); edges
cross leaves, the sweep needs only the replicated present flags.

**A session tree** (``two_level=True``): every leaf masks its rows under
its OWN ``leaf_buffer``-slot session and flushes a still-masked partial,
plus its root-session mask while it is alive, into a ``num_leaves``-slot
root session.  A client dropout inside leaf l is recovered by leaf l's own
sweep; a dead leaf is one absent root slot, recovered by one root sweep.

Where the leaves live (``mesh``, see ``launch.mesh``):

- one process (``mesh=None``, or a mesh without a process group): every
  leaf on one device, the ``shard_map`` over the leaf axis a loop over
  logical leaves (every kernel of the per-leaf work launches per leaf).
  There ``ShardedAsyncServer``'s flat topology flushes through the flat
  engine's step
  (``async_fl.build_masked_async_buffer_step`` /
  ``build_async_buffer_step``) over the buffer viewed as ``(B, D)``;
- a ``torch.distributed`` group (SPMD, as ``shard_map``): every rank runs
  the same calls on the same inputs and keeps the same host metadata, but
  holds, encodes, sums and sweeps only its contiguous block of leaves on
  its own device; :func:`combine` is the field-modulus ``psum`` (an int64
  ``all_reduce`` of the partials' uint32 words, then mod 2^32), and every
  rank decodes to the same params (the reference's ``out_specs=P()``).

In both, arrival batches are routed by destination leaf on the host
(``_route_by_leaf``) and a leaf encodes only its own rows, with PRF
streams keyed by the GLOBAL slot, so rows are bit-identical to sequential
single-host pushes; session-wide stochastic draws of the batched ``tee``
flush are the global ``(B, D)`` draws, taken per leaf row range.

The kernels run unconditionally, as in the flat engines: K1
(``quantize_mask_prf``) for every uncompressed masked streamed row, K4
(``rotate_quantize_prf``) for sketch rows, K2 (``weighted_quantize_accum``)
per leaf (tree) or per process (flat) in the batched ``tee`` flush, and K5
(``pack_residues``/``unpack_residues``) on the sub-32-bit wire and the
enclave wire.
"""
from __future__ import annotations

import math
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch import tree as T
from repro_torch.core import telemetry as tele
from repro_torch.core.fl import aggregation as agg
from repro_torch.core.fl import secure_agg as sa
from repro_torch.core.fl.async_fl import (FAULT_METRIC_KEYS, ClientPush,
                                          _as_device_tree, batch_count,
                                          build_async_buffer_step,
                                          build_masked_async_buffer_step,
                                          enclave_wire, staleness_weight)
from repro_torch.core.fl.server_opt import build_server_opt
from repro_torch.kernels import prf
from repro_torch.launch.mesh import leaf_range, leaves_per_device

# fold-in tags deriving the session tree's keys from one round key
LEAF_SESSION_TAG = 0x1EAF
ROOT_SESSION_TAG = 0x4007


def leaf_session(spec, session_key, leaf: int,
                 leaf_buffer: int) -> sa.MaskSession:
    """Leaf ``leaf``'s LOCAL mask session of the session tree, keyed
    ``fold_in(fold_in(session_key, LEAF_SESSION_TAG), leaf)``: no stream is
    shared across leaves, so no recovery sweep crosses a leaf boundary."""
    key = prf.fold_in(prf.fold_in(session_key, LEAF_SESSION_TAG), int(leaf))
    return agg.make_mask_session(spec, key, num_slots=leaf_buffer)


def root_session(spec, session_key, num_leaves: int) -> sa.MaskSession:
    """The ROOT session over ``num_leaves`` slots: each alive leaf adds its
    root slot's mask to the partial it flushes upward; a dead leaf is one
    absent root slot."""
    return agg.make_mask_session(
        spec, prf.fold_in(session_key, ROOT_SESSION_TAG),
        num_slots=num_leaves)


def _pad_to(x: torch.Tensor, width: int) -> torch.Tensor:
    """Zero-pad a chunk-sized vector up to its storage width."""
    if x.shape[-1] == width:
        return x
    return torch.nn.functional.pad(x, (0, width - x.shape[-1]))


def _as_chunks(buf) -> tuple:
    return tuple(buf) if isinstance(buf, (tuple, list)) else (buf,)


def _root_add(acc: Optional[torch.Tensor], part: torch.Tensor):
    """The root combine, one leaf partial at a time: the field-modulus psum
    as a wraparound int32 sum (in place, tiled int64)."""
    if acc is None:
        return part.clone()
    return agg.add_mod32_(acc, part)


def _require_field(spec) -> None:
    if not spec.use_secure_agg:
        raise ValueError("the sharded tier aggregates in the secure-agg "
                         "integer field: set secure_agg_bits > 0")


def _require_identity(spec) -> None:
    if not spec.compression.identity:
        raise ValueError(
            f"upload compression ({spec.compression.describe()}) runs on "
            "the STREAMING engines only — this batched step buffers raw "
            "f32 rows, so there is no compressed wire to save. Set "
            "compress_rate=1.0 here or switch to a streaming mode.")


def _finalize_root(params, opt_state, accs, w, norms, clips, staleness,
                   participation, spec, plan, server, rng, ops=None):
    """The root tail every tier flush shares: decode the combined modular
    sums (the wire layout under ``ops``) into the noised mean tree, apply
    the server optimizer, assemble the round metrics.  ``w``: (B,)
    effective per-slot weights; ``participation``: (B,) present (streamed)
    or valid (batched) flags."""
    w_total = w.sum()
    mean = agg.finalize_plan_aggregate(accs, w_total, spec, plan,
                                       prf.fold_in(rng, 0xDEE), ops=ops)
    new_params, new_opt = server.apply(params, opt_state, mean)
    denom = torch.clamp(w_total, min=1e-9)
    metrics = {
        "update_norm": (norms * w).sum() / denom,
        "clip_fraction": (clips * w).sum() / denom,
        "weight_total": w_total,
        "staleness_mean": (staleness * participation).sum()
        / torch.clamp(participation.sum(), min=1.0),
    }
    return new_params, new_opt, metrics


def _present_tensor(present, B: int, device) -> Tuple[List[int], torch.Tensor]:
    pres = sa.present_flags(present)
    if len(pres) != B:
        raise ValueError(f"{len(pres)} presence flags for {B} slots")
    return pres, torch.tensor(pres, dtype=torch.float32, device=device)


def _row_uniforms(rng, B: int, rows: slice, plan, device):
    """Rows ``rows`` of the batched flush's global ``(B, padded)`` uniform
    draws (per-row counter streams, so a row range is generated alone)."""
    r0, r1 = agg.row_uniform_keys(rng, B)
    return tuple(prf.uniform_block(r0[rows], r1[rows], ck.padded,
                                   offset=ck.offset, device=device)
                 for ck in plan.chunks)


def _partition_edges(session: sa.MaskSession, num_shards: int):
    """Split the session mask graph's edge list into ``num_shards`` equal
    shards, padded with weight-0 edges.  Returns (lo, hi, w) host-int
    lists of ``num_shards * per`` edges; shard ``i`` is
    ``[i * per, (i + 1) * per)``.  Any partition of the edges gives the
    same recovery term (partial sums commute mod 2^32)."""
    lo, hi = session.edges()
    E = len(lo)
    per = max(1, -(-E // num_shards))
    pad = num_shards * per - E
    return (list(lo) + [0] * pad, list(hi) + [0] * pad,
            [1] * E + [0] * pad)


def _world(mesh) -> Tuple[int, int]:
    """(this process's axis position, the number of processes) of a mesh
    backed by a process group; (0, 1) otherwise."""
    if mesh is None or mesh.group is None:
        return 0, 1
    return mesh.rank, len(mesh.devices)


def combine(accs: Sequence[torch.Tensor], mesh, telemetry=None,
            **labels) -> List[torch.Tensor]:
    """The root combine of int32 leaf partials across the mesh's ranks, in
    place: each partial's words (int32 bits as uint32 values in int64)
    summed by an int64 ``all_reduce`` (at most ``ranks * 2^32``, exact),
    then taken mod 2^32 back to int32, in tiles.  No collective sums
    signed int32 (its overflow is not defined).  A no-op without a process
    group.  The fenced span ``combine`` carries the bytes each rank sends
    (8 per element)."""
    accs = list(accs)
    if mesh is None or mesh.group is None:
        return accs
    import torch.distributed as tdist
    _, W = _world(mesh)
    tel = telemetry if telemetry is not None else tele.get_default()
    nbytes = 8 * sum(int(a.numel()) for a in accs)
    with tel.span("combine", ranks=W, bytes=nbytes, **labels) as sp:
        for a in accs:
            flat = a.view(-1)
            for s in range(0, flat.numel(), prf.TILE):
                t = slice(s, s + prf.TILE)
                w = prf.words_of(flat[t])
                tdist.all_reduce(w, group=mesh.group)
                flat[t] = prf.to_int32(w)
        sp.fence(accs)
    tel.count("combine_bytes", nbytes, **labels)
    return accs


def gather_slots(mesh, *per_slot: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Per-slot f32 tensors of this process's leaves -> the whole tier's
    ``(B,)`` in leaf order (ranks hold contiguous leaf blocks in rank
    order); the tensors themselves without a process group."""
    flat = tuple(t.reshape(-1).to(torch.float32) for t in per_slot)
    if mesh is None or mesh.group is None:
        return flat
    from repro_torch.launch import dist
    return tuple(dist.all_gather_cat(torch.stack(flat), mesh.group, dim=1))


def _rank_span(tel, mesh, name: str, **labels):
    """A span of a rank's flush stage, under a process group only: the
    one-process tier keeps the reference's span set (which the
    observability twin prints)."""
    if mesh is None or mesh.group is None:
        return tele._NULL_SPAN
    return tel.span(name, **labels)


def _local_leaves(num_leaves: int, mesh, device) -> range:
    """This process's leaves; without a mesh, ``device`` must resolve (the
    GPU unless told otherwise), as for every entry point."""
    if mesh is None:
        _device.resolve(device)
    else:
        leaves_per_device(num_leaves, mesh)  # validates divisibility
    return leaf_range(num_leaves, mesh)


def _buffer_noise(rng, B: int, spec, plan, w_full, rows: slice, device):
    """Rows ``rows`` of the batched flush's device noise, scaled by each
    row's weight (the global ``(B, size)`` draws), or None."""
    if spec.dev_noise <= 0.0:
        return None
    noise, _ = agg.plan_buffer_noise_and_uniforms(
        rng, B, spec._replace(use_secure_agg=False), plan, device)
    return tuple((n * (spec.dev_noise * w_full)[:, None])[rows]
                 for n in noise)


# ---------------------------------------------------------------------------
# One global session (two_level=False) over the leaves
# ---------------------------------------------------------------------------
def build_sharded_masked_step(params, fl_cfg, *, num_leaves: int,
                              leaf_buffer: int, recover: bool = True,
                              masked: bool = True, mesh=None,
                              device=None, telemetry=None):
    """The flush of the STREAMED engines (off / client / tee_stream) over
    ONE GLOBAL mask session: ``step(params, opt_state, mbufs, present,
    weights, staleness, norms, clips, session_key, rng, ops=None)``.

    ``mbufs``: per chunk the ``(n, leaf_buffer, padded)`` int32 rows of
    this process's ``n`` leaves (:func:`launch.mesh.leaf_range`: every leaf
    without a process group); ``weights``/``staleness``/``norms``/``clips``
    those leaves' per-slot values; ``present`` the whole session's ``(B,)``
    flags, replicated.  Each process gates and sums its own slots and, under
    ``recover`` + ``masked``, sweeps its shard of each chunk's edge list
    (:func:`_partition_edges`; an edge's endpoints may live on different
    ranks, the sweep needs only the replicated flags); :func:`combine` adds
    the partials across ranks; every rank then decodes, normalises, draws
    the central noise once and applies the server optimizer, so every rank
    holds the same new params.  Bit-identical to
    ``async_fl.build_masked_async_buffer_step`` at ``buffer_size = B``.
    """
    L, Bl = num_leaves, leaf_buffer
    B = L * Bl
    spec = agg.make_spec(fl_cfg, B)
    _require_field(spec)
    server = build_server_opt(fl_cfg)
    plan = agg.plan_for(params, fl_cfg)
    wire = agg.plan_wire_chunks(spec, plan)
    leaves = _local_leaves(L, mesh, device)
    rank, W = _world(mesh)
    rows = slice(leaves.start * Bl, leaves.stop * Bl)
    tel = telemetry if telemetry is not None else tele.get_default()
    labels = dict(engine="tier", topology="flat")

    def step(params, opt_state, mbufs, present, weights, staleness, norms,
             clips, session_key, rng, ops=None):
        bufs = _as_chunks(mbufs)
        dev = bufs[0].device
        if ops is None:
            ops = agg.plan_operators(spec, plan, session_key, device=dev)
        pres, pres_t = _present_tensor(present, B, dev)
        gate = [p == 1 for p in pres[rows]]
        ckeys = plan.session_keys(session_key)
        accs = []
        with _rank_span(tel, mesh, "leaf_partials", **labels) as sp:
            for c, (wc, buf) in enumerate(zip(wire, bufs)):
                flat = buf.reshape(-1, buf.shape[-1])
                if not recover:  # complete session: masks cancel
                    accs.append(agg.sum_rows(flat))
                    continue
                acc = agg.sum_rows(flat, gate)
                if masked:
                    lo, hi, ew = _partition_edges(
                        agg.make_mask_session(spec, ckeys[c]), W)
                    per = len(lo) // W
                    mine = slice(rank * per, (rank + 1) * per)
                    agg.add_mod32_(acc, _pad_to(sa.recovery_sweep(
                        (wc.size,), pres, lo[mine], hi[mine], ckeys[c],
                        ew[mine], device=dev), wc.padded))
                accs.append(acc)
            sp.fence(accs)
        accs = combine(accs, mesh, tel, **labels)
        wts, stal, nrm, clp = gather_slots(mesh, weights, staleness, norms,
                                            clips)
        return _finalize_root(params, opt_state, accs, wts * pres_t, nrm,
                              clp, stal, pres_t, spec, plan, server, rng,
                              ops=ops)

    return step


def build_sharded_buffer_step(params, fl_cfg, *, num_leaves: int,
                              leaf_buffer: int,
                              staleness_mode: str = "polynomial",
                              staleness_exponent: float = 0.5,
                              mask_mode: str = "off", mesh=None,
                              device=None, telemetry=None):
    """The BATCHED engine (raw f32 rows; "off" or "tee") over ONE GLOBAL
    mask session: ``step(params, opt_state, bufs, staleness, valid, rng)``
    over per-chunk ``(n, leaf_buffer, padded)`` f32 rows of this process's
    leaves and their per-slot staleness and valid flags.

    Each process clips, weights, [noises,] encodes [and masks] its rows
    (``aggregation.encode_plan_rows``: K2 per chunk, under the GLOBAL
    session viewed at ``slot_offset`` = its first slot), :func:`combine`
    adds the partials across ranks, and every rank decodes.  The uniforms
    and the device noise are the global ``(B, padded)`` draws taken at the
    process's rows, so the step is bit-identical to the single-host
    ``async_fl.build_async_buffer_step`` at ``buffer_size = B``.
    """
    if mask_mode not in ("off", "tee"):
        raise ValueError(f"mask_mode {mask_mode!r}: expected 'off' or 'tee'")
    L, Bl = num_leaves, leaf_buffer
    B = L * Bl
    spec = agg.make_spec(fl_cfg, B)
    _require_field(spec)
    _require_identity(spec)
    server = build_server_opt(fl_cfg)
    plan = agg.plan_for(params, fl_cfg)
    leaves = _local_leaves(L, mesh, device)
    rows = slice(leaves.start * Bl, leaves.stop * Bl)
    is_masked = mask_mode == "tee"
    tel = telemetry if telemetry is not None else tele.get_default()
    labels = dict(engine="tier", topology="flat")

    def step(params, opt_state, bufs, staleness, valid, rng):
        bufs = _as_chunks(bufs)
        rng = prf.key_words(rng)
        dev = bufs[0].device
        stal, vld = gather_slots(mesh, staleness, valid)
        w_full = staleness_weight(stal, staleness_mode, staleness_exponent,
                                  device=dev) * vld
        noise = _buffer_noise(rng, B, spec, plan, w_full, rows, dev)
        sessions = (agg.plan_sessions(spec, plan, prf.fold_in(rng, 0x7EE),
                                      slot_offset=rows.start)
                    if is_masked else None)
        with _rank_span(tel, mesh, "leaf_partials", **labels) as sp:
            accs, nrm, clipped = agg.encode_plan_rows(
                tuple(b.reshape(-1, b.shape[-1]) for b in bufs),
                w_full[rows], _row_uniforms(rng, B, rows, plan, dev), noise,
                spec, plan, sessions=sessions)
            sp.fence(accs)
        accs = combine(accs, mesh, tel, **labels)
        nrm, clipped = gather_slots(mesh, nrm, clipped)
        return _finalize_root(params, opt_state, accs, w_full, nrm, clipped,
                              stal, vld, spec, plan, server, rng)

    return step


# ---------------------------------------------------------------------------
# The session tree (two_level=True): leaf sessions -> root session
# ---------------------------------------------------------------------------
def build_two_level_masked_step(params, fl_cfg, *, num_leaves: int,
                                leaf_buffer: int, recover: bool = True,
                                masked: bool = True, mesh=None,
                                device=None, telemetry=None):
    """The session-tree flush of the STREAMED engines (off / client /
    tee_stream): ``step(params, opt_state, mbufs, present, weights,
    staleness, norms, clips, session_key, rng, ops=None)`` over per-chunk
    ``(n, leaf_buffer, padded)`` int32 rows of this process's ``n`` leaves
    (all of them without a process group), masked under per-leaf sessions
    (:func:`leaf_session`), with those leaves' per-slot values and the
    whole session's ``(B,)`` present flags, replicated.

    Leaf tier: the gated modular sum of the leaf's present slots + the
    leaf's OWN recovery sweep (its local edges, its local presence) + its
    root-session mask while the leaf is alive.  Root tier: the wraparound
    sum of the partials (:func:`combine` across ranks) + the root recovery
    of DEAD leaves (one ``num_leaves``-slot sweep), then decode / normalize
    / central noise / server optimizer on every rank.  Bit-identical to the
    single-host engines at ``buffer_size = B``, and to the flat survivor
    aggregate under client and whole-leaf dropout.
    """
    L, Bl = num_leaves, leaf_buffer
    B = L * Bl
    spec = agg.make_spec(fl_cfg, B)
    _require_field(spec)
    server = build_server_opt(fl_cfg)
    plan = agg.plan_for(params, fl_cfg)
    wire = agg.plan_wire_chunks(spec, plan)
    leaves = _local_leaves(L, mesh, device)
    tel = telemetry if telemetry is not None else tele.get_default()
    labels = dict(engine="tier", topology="tree")

    def step(params, opt_state, mbufs, present, weights, staleness, norms,
             clips, session_key, rng, ops=None):
        bufs = _as_chunks(mbufs)
        dev = bufs[0].device
        if ops is None:
            ops = agg.plan_operators(spec, plan, session_key, device=dev)
        pres, pres_t = _present_tensor(present, B, dev)
        leaf_pres = [pres[leaf * Bl:(leaf + 1) * Bl] for leaf in range(L)]
        alive = [int(any(p)) for p in leaf_pres]
        ckeys = plan.session_keys(session_key)
        sweep = recover and masked
        accs = []
        with _rank_span(tel, mesh, "leaf_partials", **labels) as sp:
            for c, (wc, buf) in enumerate(zip(wire, bufs)):
                rsess = root_session(spec, ckeys[c], L) if sweep else None
                acc = None
                for j, leaf in enumerate(leaves):
                    if not recover:  # complete session: masks cancel
                        acc = _root_add(acc, agg.sum_rows(buf[j]))
                        continue
                    part = agg.sum_rows(buf[j],
                                        [p == 1 for p in leaf_pres[leaf]])
                    if masked:
                        # fault isolation: only this leaf's edges, gated
                        # by only this leaf's presence
                        lsess = leaf_session(spec, ckeys[c], leaf, Bl)
                        agg.add_mod32_(part, _pad_to(
                            lsess.recovery((wc.size,), leaf_pres[leaf],
                                           device=dev), wc.padded))
                        if alive[leaf]:
                            agg.add_mod32_(part, _pad_to(
                                rsess.mask((wc.size,), leaf, device=dev),
                                wc.padded))
                    acc = _root_add(acc, part)
                accs.append(acc)
            sp.fence(accs)
        accs = combine(accs, mesh, tel, **labels)
        if sweep:  # a dead leaf is one absent root slot
            for c, wc in enumerate(wire):
                agg.add_mod32_(accs[c], _pad_to(
                    root_session(spec, ckeys[c], L).recovery(
                        (wc.size,), alive, device=dev), wc.padded))
        wts, stal, nrm, clp = gather_slots(mesh, weights, staleness, norms,
                                            clips)
        return _finalize_root(params, opt_state, accs, wts * pres_t, nrm,
                              clp, stal, pres_t, spec, plan, server, rng,
                              ops=ops)

    return step


def build_two_level_buffer_step(params, fl_cfg, *, num_leaves: int,
                                leaf_buffer: int,
                                staleness_mode: str = "polynomial",
                                staleness_exponent: float = 0.5,
                                mesh=None, device=None,
                                telemetry=None):
    """The session-tree BATCHED "tee" engine: ``step(params, opt_state,
    bufs, staleness, valid, rng)`` over per-chunk ``(n, leaf_buffer,
    padded)`` f32 rows of this process's leaves.  Each leaf clips, weights,
    [noises,] encodes and masks its own rows (``aggregation.
    encode_plan_rows``, K2 per chunk) under its OWN local session
    (``num_slots = leaf_buffer``, ``slot_offset = 0``), so K2's PRF lane
    generates only the leaf's pair streams and each leaf's masks cancel in
    its own partial; :func:`combine` adds the partials mod 2^32 across
    ranks.  The device noise and the uniforms are the global ``(B,
    padded)`` draws, taken per leaf row range.  Bit-identical to the
    single-host batched "tee" step."""
    L, Bl = num_leaves, leaf_buffer
    B = L * Bl
    spec = agg.make_spec(fl_cfg, B)
    _require_field(spec)
    _require_identity(spec)
    server = build_server_opt(fl_cfg)
    plan = agg.plan_for(params, fl_cfg)
    leaves = _local_leaves(L, mesh, device)
    tel = telemetry if telemetry is not None else tele.get_default()
    labels = dict(engine="tier", topology="tree")

    def step(params, opt_state, bufs, staleness, valid, rng):
        bufs = _as_chunks(bufs)
        rng = prf.key_words(rng)
        dev = bufs[0].device
        stal, vld = gather_slots(mesh, staleness, valid)
        w_full = staleness_weight(stal, staleness_mode, staleness_exponent,
                                  device=dev) * vld
        ckeys = plan.session_keys(prf.fold_in(rng, 0x7EE))
        mine = slice(leaves.start * Bl, leaves.stop * Bl)
        noise = _buffer_noise(rng, B, spec, plan, w_full, mine, dev)
        accs = [None] * plan.num_chunks
        nrms, clips = [], []
        with _rank_span(tel, mesh, "leaf_partials", **labels) as sp:
            for j, leaf in enumerate(leaves):
                rows = slice(leaf * Bl, (leaf + 1) * Bl)
                u_l = _row_uniforms(rng, B, rows, plan, dev)
                n_l = (None if noise is None
                       else tuple(n[j * Bl:(j + 1) * Bl] for n in noise))
                a, nrm, cl = agg.encode_plan_rows(
                    tuple(b[j] for b in bufs), w_full[rows], u_l, n_l, spec,
                    plan, sessions=tuple(leaf_session(spec, k, leaf, Bl)
                                         for k in ckeys))
                del u_l, n_l
                accs = [_root_add(acc, p) for acc, p in zip(accs, a)]
                nrms.append(nrm)
                clips.append(cl)
            sp.fence(accs)
        accs = combine(accs, mesh, tel, **labels)
        nrm, clipped = gather_slots(mesh, torch.cat(nrms), torch.cat(clips))
        return _finalize_root(params, opt_state, tuple(accs), w_full, nrm,
                              clipped, stal, vld, spec, plan, server, rng)

    return step


class ShardedAsyncServer:
    """Buffered asynchronous aggregation over the leaf/root tier (see the
    JAX class for the protocol).

    State: per-chunk ``(n, leaf_buffer, padded)`` buffers (int32 rows in
    the streamed modes, raw f32 rows in "tee") and ``(n, leaf_buffer)``
    per-slot scalars of the ``n`` leaves this process hosts, updated in
    place.  ``num_leaves``/``leaf_buffer``/``two_level`` default from
    ``FLConfig``.

    Placement (``mesh``): None, or a mesh without a process group — every
    leaf on one device (``device``, default the GPU, or the mesh's), and
    the flat topology flushes through the flat engine.  A
    :class:`launch.mesh.LeafMesh` backed by a process group — SPMD, as the
    JAX tier's ``shard_map``: every rank runs the same calls with
    the same inputs and keeps the same host metadata (slot allocation,
    presence, versions, quorum), but holds, encodes and sums only its own
    contiguous block of leaves (:func:`launch.mesh.leaf_range`) on its own
    device; the flush combines the ranks' partials (:func:`combine`) and
    every rank ends with the same params.  In ``client`` mode
    :meth:`encode_push` then encodes only the rows routed to this rank's
    leaves (the others come back with ``row=None``).

    Session topology (``two_level``): False — ONE mask session over all
    ``num_leaves * leaf_buffer`` global slots (slot ``s`` lives on leaf
    ``s // leaf_buffer``); True — a session tree (per-leaf local sessions
    flushing into a ``num_leaves``-slot root session).

    Arrival batches are DESTINATION-SHARDED: ``push`` of a (K,)-stacked
    batch routes each row to its leaf (host index bookkeeping,
    ``_route_by_leaf``) and each leaf encodes only its own rows, keyed by
    the global slot, so rows are bit-identical to K sequential
    ``AsyncServer`` pushes; ``push_encoded`` lands client-encoded
    ``ClientPush`` rows (unpacked per destination leaf).  Mask modes match
    ``AsyncServer``'s ("off" always streams here).  A leaf marked dead
    (:meth:`mark_leaf_dead`) leaves slot allocation and the quorum
    denominator for the rest of its session.
    """

    def __init__(self, params, fl_cfg, *, num_leaves: Optional[int] = None,
                 leaf_buffer: Optional[int] = None,
                 staleness_exponent: float = 0.5,
                 staleness_mode: str = "polynomial",
                 mask_mode: str = "off", session_seed: int = 0x5A5E,
                 two_level: Optional[bool] = None, mesh=None,
                 strict: bool = True,
                 telemetry: Optional["tele.Telemetry"] = None,
                 device=None):
        if mask_mode not in ("off", "tee", "tee_stream", "client"):
            raise ValueError(f"mask_mode {mask_mode!r}")
        num_leaves = num_leaves or fl_cfg.num_leaves
        leaf_buffer = leaf_buffer or fl_cfg.leaf_buffer
        if not num_leaves or not leaf_buffer:
            raise ValueError(
                "the tier's shape is unset: pass num_leaves/leaf_buffer "
                "or set FLConfig.num_leaves/leaf_buffer")
        if two_level is None:
            two_level = fl_cfg.two_level
        if mesh is None:
            dev = _device.resolve(device)
        else:
            dev = mesh.device
            if device is not None and torch.device(device) != dev:
                raise ValueError(f"device={device!r} but this rank's mesh "
                                 f"position is on {dev}")
            if mesh.group is None:  # one process hosts every leaf
                mesh = None
        self.device = dev
        self.mesh = mesh
        self.params = _as_device_tree(params, dev)
        self.fl_cfg = fl_cfg
        self.num_leaves = L = num_leaves
        self.leaf_buffer = Bl = leaf_buffer
        self.buffer_size = B = L * Bl
        # the leaves this process hosts (every leaf without a process group)
        self._leaves = _local_leaves(L, mesh, dev)
        nl = len(self._leaves)
        self.staleness_exponent = staleness_exponent
        self.staleness_mode = staleness_mode
        self.mask_mode = mask_mode
        self.two_level = two_level
        self.version = 0
        self.last_metrics: Optional[dict] = None
        self._applied_updates = 0
        self._fill = 0
        self.strict = strict
        self.flush_quorum = float(getattr(fl_cfg, "flush_quorum", 0.0))
        self.telemetry = (telemetry if telemetry is not None
                          else tele.get_default())
        self._eid = tele.new_session_id()
        self._tl = {"engine": "tier", "eid": self._eid}
        self.fault_metrics = tele.TelemetryCounterView(
            self.telemetry, FAULT_METRIC_KEYS + ("dead_leaves",), **self._tl)
        self._token_counter = 0
        self._delivered_tokens: set = set()
        self._dead_leaves: set = set()
        self._session_base = prf.PRNGKey(session_seed)
        self._push_base = prf.PRNGKey(0xA5)

        spec = agg.make_spec(fl_cfg, B)
        _require_field(spec)
        self._spec = spec
        self._plan = plan = agg.plan_for(self.params, fl_cfg)
        self._wire = agg.plan_wire_chunks(spec, plan)
        self._opt_state = build_server_opt(fl_cfg).init(self.params)
        # the session's compression operators and row sessions, derived on
        # first use in a session: (version, value)
        self._ops = (None, None)
        self._row_sessions = (None, {})
        ebits = int(getattr(fl_cfg, "enclave_wire_bits", 0))
        self._enclave_bits = ebits if mask_mode in ("tee", "tee_stream") \
            else 0
        self._enclave_seq = 0
        self._enclave_base = prf.PRNGKey(0xE7C)

        def zslot():
            return torch.zeros((nl, Bl), dtype=torch.float32, device=dev)

        self._stal = zslot()
        # per-GLOBAL-slot presence (host metadata)
        self._present = [False] * B
        self._streaming = mask_mode != "tee"
        self._masked = mask_mode not in ("off", "tee")
        tier = dict(num_leaves=L, leaf_buffer=Bl, mesh=mesh, device=dev,
                    telemetry=self.telemetry)
        if self._streaming:
            self._bufs = tuple(
                torch.zeros((nl, Bl, wc.padded), dtype=torch.int32,
                            device=dev) for wc in self._wire)
            self._wts, self._norms, self._clips = zslot(), zslot(), zslot()
            if two_level:
                self._step, self._flush_step = (build_two_level_masked_step(
                    self.params, fl_cfg, recover=r, masked=self._masked,
                    **tier) for r in (False, True))
            elif mesh is not None:
                self._step, self._flush_step = (build_sharded_masked_step(
                    self.params, fl_cfg, recover=r, masked=self._masked,
                    **tier) for r in (False, True))
            else:  # one global session on one device: the flat engine
                self._step, self._flush_step = (
                    build_masked_async_buffer_step(
                        self.params, fl_cfg, buffer_size=B, recover=r,
                        masked=self._masked, device=dev)
                    for r in (False, True))
        else:  # "tee": raw rows, the batched in-enclave mask lane at flush
            self._bufs = tuple(
                torch.zeros((nl, Bl, ck.padded), dtype=torch.float32,
                            device=dev) for ck in plan.chunks)
            self._valid = zslot()
            stal_kw = dict(staleness_mode=staleness_mode,
                           staleness_exponent=staleness_exponent)
            if two_level:
                self._step = build_two_level_buffer_step(
                    self.params, fl_cfg, **stal_kw, **tier)
            elif mesh is not None:
                self._step = build_sharded_buffer_step(
                    self.params, fl_cfg, mask_mode="tee", **stal_kw, **tier)
            else:
                self._step = build_async_buffer_step(
                    self.params, fl_cfg, buffer_size=B, mask_mode="tee",
                    device=dev, **stal_kw)

    # -- plan / buffer views ------------------------------------------------
    @property
    def plan(self) -> "agg.ParamPlan":
        return self._plan

    @property
    def _buf(self):
        """The bare buffer of a single-chunk plan, else the chunk tuple."""
        return self._bufs[0] if len(self._bufs) == 1 else self._bufs

    # -- session bookkeeping ------------------------------------------------
    def _session_key(self):
        return prf.fold_in(self._session_base, self.version)

    def _new_token(self) -> int:
        self._token_counter += 1
        return self._token_counter

    def _span(self, name: str, **labels):
        return self.telemetry.span(
            name, round=self.version,
            topology="tree" if self.two_level else "flat",
            **self._tl, **labels)

    def _operators(self):
        """The session's compression operators (None: identity), keyed by
        the ENGINE session key and shared by every leaf, push and flush."""
        if self._spec.compression.identity:
            return None
        version, ops = self._ops
        if version != self.version:
            self._ops = (None, None)  # free the last session's first
            ops = agg.plan_operators(self._spec, self._plan,
                                     self._session_key(), device=self.device)
            self._ops = (self.version, ops)
        return ops

    def _sessions_for(self, gslot: int):
        """(per-chunk sessions, mask slot) a row at GLOBAL slot ``gslot``
        is masked under: the leaf's local sessions in the tree, the global
        sessions in the flat layout (cached per session)."""
        version, cache = self._row_sessions
        if version != self.version:
            cache = {}
            self._row_sessions = (self.version, cache)
        Bl = self.leaf_buffer
        leaf = gslot // Bl if self.two_level else None
        if leaf not in cache:
            skey = self._session_key()
            if self.two_level:
                cache[leaf] = tuple(leaf_session(self._spec, k, leaf, Bl)
                                    for k in self._plan.session_keys(skey))
            else:
                cache[leaf] = agg.plan_sessions(self._spec, self._plan, skey)
        return cache[leaf], (gslot % Bl if self.two_level else gslot)

    @property
    def live_capacity(self) -> int:
        """Session slots on leaves still alive — the quorum denominator."""
        return self.buffer_size - len(self._dead_leaves) * self.leaf_buffer

    def open_slots(self) -> List[int]:
        """Unfilled session positions on LIVE leaves."""
        Bl = self.leaf_buffer
        return [s for s, p in enumerate(self._present)
                if not p and (s // Bl) not in self._dead_leaves]

    def mark_leaf_dead(self, leaf: int) -> List[int]:
        """Declare one leaf aggregator dead for the rest of this session:
        its buffered contributions are LOST (recovered at flush like client
        dropouts; in the tree by one root sweep) and its slots leave the
        allocator and the quorum denominator.  Returns the lost global
        slots.  Leaves revive at the next session."""
        if not 0 <= leaf < self.num_leaves:
            raise ValueError(f"leaf {leaf} outside the {self.num_leaves}-leaf "
                             "tier")
        if leaf in self._dead_leaves:
            return []
        self._dead_leaves.add(leaf)
        self.fault_metrics["dead_leaves"] += 1
        Bl = self.leaf_buffer
        lost = [s for s in range(leaf * Bl, (leaf + 1) * Bl)
                if self._present[s]]
        for s in lost:
            self._present[s] = False
        self._fill -= len(lost)
        self.fault_metrics["lost_contributions"] += len(lost)
        self.telemetry.gauge("buffered_contributions", self._fill,
                             **self._tl)
        if not self._streaming and leaf in self._leaves:
            # "tee" gates rows by the valid plane
            self._valid[leaf - self._leaves.start] = 0.0
        return lost

    def _take_slots(self, k: int) -> List[int]:
        free = self.open_slots()
        if len(free) < k:
            raise ValueError(
                f"batch of {k} exceeds the session's {len(free)} open slots "
                f"(route arrival batches per session)")
        return free[:k]

    def _slot_open(self, s: int) -> bool:
        return (0 <= s < self.buffer_size and not self._present[s]
                and (s // self.leaf_buffer) not in self._dead_leaves)

    def _check_slots(self, slots) -> None:
        """Every batch slot must be a distinct OPEN session position."""
        if len(set(slots)) != len(slots):
            raise ValueError(f"duplicate slots in batch: {list(slots)}")
        for s in slots:
            if not self._slot_open(s):
                raise ValueError(
                    f"slot {s} is not an open position of session "
                    f"{self.version}")

    def _staleness_of(self, client_version, k: int) -> np.ndarray:
        """(k,) f32 staleness for a scalar or (k,) ``client_version``."""
        if isinstance(client_version, torch.Tensor):
            client_version = client_version.tolist()
        if np.ndim(client_version) == 0:
            return np.full((k,), float(self.version - client_version),
                           np.float32)
        return self.version - np.asarray(client_version, np.float32)

    def _route_by_leaf(self, slots: Sequence[int], stals: np.ndarray
                       ) -> List[List[Tuple[int, int, float]]]:
        """Group one arrival batch by DESTINATION leaf: per leaf, the
        (batch position, local slot, staleness) of each of its arrivals in
        batch order.  Pure host index bookkeeping."""
        Bl = self.leaf_buffer
        per: List[List[Tuple[int, int, float]]] = [
            [] for _ in range(self.num_leaves)]
        for pos, s in enumerate(slots):
            per[s // Bl].append((pos, s % Bl, float(stals[pos])))
        return per

    def _routed(self, slots, stals):
        """(leaf, batch position, local slot, staleness) of each arrival on
        this process's leaves, leaf by leaf (the destination-sharded
        order)."""
        per = self._route_by_leaf(slots, stals)
        for leaf in self._leaves:
            for pos, lslot, st in per[leaf]:
                yield leaf, pos, lslot, st

    def _is_local(self, gslot: int) -> bool:
        return gslot // self.leaf_buffer in self._leaves

    # -- the per-row encode -------------------------------------------------
    def _encode_row(self, delta, gslot: int, staleness: float):
        """One arrival's encode at GLOBAL slot ``gslot``: PRF streams keyed
        ``fold_in(push_key, gslot)`` in both topologies (so the q-streams
        are the single-host pushes'), masked under the row's sessions;
        compression operators keyed by the ENGINE session key.  Returns
        (per-chunk padded wire rows, weight, norm, clipped)."""
        rng = prf.fold_in(prf.fold_in(self._push_base, self.version),
                          int(gslot))
        w = staleness_weight(staleness, self.staleness_mode,
                             self.staleness_exponent, device=self.device)
        if self._masked:
            sessions, mslot = self._sessions_for(int(gslot))
        else:
            sessions, mslot = None, 0
        xs = self._plan.chunk_arrays(_as_device_tree(delta, self.device))
        rows, nrm, clipped = agg.encode_plan_flat(
            xs, w, mslot, self._spec, self._plan, sessions, rng,
            masked=self._masked, ops=self._operators())
        return rows, w, nrm, clipped

    def _write(self, leaf: int, lslot: int, rows, staleness, w, nrm,
               clipped) -> None:
        j = leaf - self._leaves.start
        for b, r in zip(self._bufs, rows):
            b[j, lslot] = r
        self._stal[j, lslot] = float(staleness)
        self._wts[j, lslot] = w
        self._norms[j, lslot] = nrm
        self._clips[j, lslot] = clipped

    def _upload_lane(self) -> str:
        return "packed" if self._spec.compression.identity else "compressed"

    # -- client protocol ----------------------------------------------------
    def pull(self) -> Tuple[Any, int]:
        return self.params, self.version

    def push(self, delta, client_version, rng=None,
             slots: Optional[Sequence[int]] = None,
             push_ids: Optional[Sequence[int]] = None) -> None:
        """Push one raw delta tree — or a (K,)-stacked batch, routed to its
        destination leaves and encoded leaf by leaf.  ``client_version``
        is a scalar or (K,); ``push_ids`` (one token per row) make retried
        or duplicated rows counted no-ops."""
        k = batch_count(delta, self.params)
        if k is None:
            delta = T.tree_map(lambda x: torch.as_tensor(x)[None], delta)
            if slots is not None and not isinstance(slots, (list, tuple)):
                slots = [slots]
            if push_ids is not None and not isinstance(push_ids,
                                                       (list, tuple)):
                push_ids = [push_ids]
        self._push_impl(delta, client_version, rng=rng, slots=slots,
                        push_ids=push_ids)

    def encode_push(self, delta, client_version, rng=None, slot=None):
        """The CLIENT half of mask_mode='client' against a GLOBAL session
        slot: one :class:`ClientPush` for a single delta, a list for a
        (K,)-stacked batch (a scalar ``slot`` then names K consecutive
        slots).  ``rng`` is unused: the per-slot PRF streams are fixed by
        the session."""
        k = batch_count(delta, self.params)
        if k is not None:
            if slot is None:
                slots = None
            elif np.ndim(slot) == 0:
                s0 = int(slot)
                if s0 < 0 or s0 + k > self.buffer_size:
                    raise ValueError(
                        f"scalar slot={s0} with a stacked batch of {k} "
                        f"rows names session slots {s0}..{s0 + k - 1}, "
                        f"outside the session's {self.buffer_size} slots; "
                        f"pass an explicit slot sequence or start lower")
                slots = list(range(s0, s0 + k))
            else:
                slots = [int(s) for s in slot]
            return self._encode_push_impl(delta, client_version, slots=slots)
        cps = self._encode_push_impl(
            T.tree_map(lambda x: torch.as_tensor(x)[None], delta),
            client_version, slots=None if slot is None else [int(slot)])
        return cps[0]

    def push_encoded(self, cp, rng=None) -> int:
        """The SERVER half of mask_mode='client': land one
        :class:`ClientPush` or a list of them; returns the stored count."""
        return self._push_encoded_impl(
            [cp] if isinstance(cp, ClientPush) else list(cp), rng=rng)

    # -- ingest implementations ---------------------------------------------
    def _encode_push_impl(self, deltas, client_version,
                          slots: Optional[Sequence[int]] = None
                          ) -> List[ClientPush]:
        """Encode a (K,)-stacked batch as the session's clients would (pure
        in server state): each row through :meth:`_encode_row`, then each
        chunk's wire ``reduce`` (the packed canonical residues)."""
        if self.mask_mode != "client":
            raise ValueError(
                f"encode_push is the client half of mask_mode='client' "
                f"(server is in mask_mode={self.mask_mode!r})")
        K = batch_count(deltas, self.params)
        if slots is None:
            slots = self._take_slots(K)
        stals = self._staleness_of(client_version, K)
        # every session of the tree shares the engine's field, so any
        # row's sessions decide the wire width
        wire_sessions, _ = self._sessions_for(0)
        out, nbytes = [], 0
        with self._span("encode_push", k=K) as sp:
            for i, s in enumerate(slots):
                row = w = nrm = clipped = None
                if self._is_local(int(s)):  # another rank's clients: not here
                    rows, w, nrm, clipped = self._encode_row(
                        T.tree_map(lambda x: x[i], deltas), int(s),
                        float(stals[i]))
                    rows = tuple(sess.reduce(r)
                                 for sess, r in zip(wire_sessions, rows))
                    nbytes += 4 * sum(int(r.numel()) for r in rows)
                    row = rows[0] if len(rows) == 1 else rows
                out.append(ClientPush(
                    row, w, nrm, clipped, float(stals[i]), self.version,
                    int(s), self._spec.field_modulus, self._new_token(),
                    self._spec.compression))
            sp.fence([cp.row for cp in out if cp.row is not None])
        self.telemetry.count("upload_bytes", nbytes,
                             lane=self._upload_lane(), **self._tl)
        return out

    def _push_encoded_impl(self, cps: Sequence[ClientPush], rng=None) -> int:
        """Land a batch of already-masked rows, each unpacked at its
        destination leaf.  Duplicates of delivered tokens are counted
        no-ops; stale sessions and closed or conflicting slots raise under
        ``strict`` and are counted-and-dropped otherwise."""
        if self.mask_mode != "client":
            raise ValueError(
                f"push_encoded is the server half of mask_mode='client' "
                f"(server is in mask_mode={self.mask_mode!r})")
        for cp in cps:
            if cp.modulus != self._spec.field_modulus:
                raise ValueError(
                    f"ClientPush packed for field modulus {cp.modulus} "
                    f"({sa.wire_bits(cp.modulus)}-bit wire) but the tier's "
                    f"session field is {self._spec.field_modulus} "
                    f"({sa.wire_bits(self._spec.field_modulus)}-bit): the "
                    "residue stream cannot be unpacked — client and tier "
                    "must agree on secure_agg_bits and the session size")
            if cp.compression != self._spec.compression:
                raise ValueError(
                    f"ClientPush encoded under compression "
                    f"{cp.compression.describe()} but the tier's session "
                    f"expects {self._spec.compression.describe()}: the row "
                    "lives in a different sketch domain and would decode "
                    "to garbage — client and tier must agree on "
                    "compress_mode and compress_rate for the session")
        kept: List[ClientPush] = []
        for cp in cps:
            if cp.token and cp.token in self._delivered_tokens:
                self.fault_metrics["duplicate_pushes"] += 1
                continue
            if cp.version != self.version:
                if self.strict:
                    raise ValueError(
                        f"stale ClientPush (session {cp.version} slot "
                        f"{cp.slot}; server at session {self.version}): the "
                        "pairwise mask no longer matches an open session "
                        "position")
                self.fault_metrics["rejected_pushes"] += 1
                continue
            kept.append(cp)
        slots = [cp.slot for cp in kept]
        if self.strict:
            self._check_slots(slots)
        else:
            seen: set = set()
            ok: List[ClientPush] = []
            for cp in kept:
                if cp.slot in seen or not self._slot_open(cp.slot):
                    self.fault_metrics["rejected_pushes"] += 1
                    continue
                seen.add(cp.slot)
                ok.append(cp)
            kept, slots = ok, [cp.slot for cp in ok]
        if not kept:
            return 0
        stals = np.asarray([cp.staleness for cp in kept], np.float32)
        nbytes = 0
        with self._span("push_encoded", k=len(kept)) as sp:
            for leaf, pos, lslot, st in self._routed(slots, stals):
                cp = kept[pos]
                wrows = cp.row if isinstance(cp.row, tuple) else (cp.row,)
                nbytes += 4 * sum(int(w_.numel()) for w_ in wrows)
                rows = tuple(
                    sa.unpack_residues(wr.to(self.device), wc.padded,
                                       self._spec.field_modulus)
                    for wr, wc in zip(wrows, self._wire))
                self._write(leaf, lslot, rows, st, cp.weight, cp.norm,
                            cp.clipped)
            sp.fence(self._bufs)
        self.telemetry.count("upload_bytes", nbytes,
                             lane=self._upload_lane(), **self._tl)
        for cp in kept:
            if cp.token:
                self._delivered_tokens.add(cp.token)
        self._mark(slots, rng)
        return len(kept)

    def _push_impl(self, deltas, client_version, rng=None,
                   slots: Optional[Sequence[int]] = None,
                   push_ids: Optional[Sequence[int]] = None) -> None:
        """Ingest a (K,)-stacked batch of raw deltas (see :meth:`push`)."""
        if self.mask_mode == "client":
            self._push_encoded_impl(
                self._encode_push_impl(deltas, client_version, slots=slots),
                rng=rng)
            return
        K = batch_count(deltas, self.params)
        slot_of = None if slots is None else list(slots)
        pid_of = None if push_ids is None else list(push_ids)
        kept = list(range(K))
        if pid_of is not None:
            fresh = []
            for i in kept:
                if pid_of[i] is not None and pid_of[i] in self._delivered_tokens:
                    self.fault_metrics["duplicate_pushes"] += 1
                else:
                    fresh.append(i)
            kept = fresh
        if slot_of is not None:
            if self.strict:
                self._check_slots([slot_of[i] for i in kept])
            else:
                seen: set = set()
                ok = []
                for i in kept:
                    s = slot_of[i]
                    if s in seen or not self._slot_open(s):
                        self.fault_metrics["rejected_pushes"] += 1
                        continue
                    seen.add(s)
                    ok.append(i)
                kept = ok
        if not kept:
            return
        if isinstance(client_version, torch.Tensor):
            client_version = client_version.tolist()
        if np.ndim(client_version) != 0:
            client_version = np.asarray(client_version)[kept]
        if pid_of is not None:
            for i in kept:
                if pid_of[i] is not None:
                    self._delivered_tokens.add(pid_of[i])
        rows_in = [T.tree_map(lambda x: x[i], deltas) for i in kept]
        K = len(kept)
        slots = (self._take_slots(K) if slot_of is None
                 else [slot_of[i] for i in kept])
        stals = self._staleness_of(client_version, K)
        if self._enclave_bits:
            # the tier ingests the client-side quantization's reconstruction;
            # the packed words are what crossed the wire (one key per row,
            # split from the batch's key; rows of this process's leaves)
            ekey = prf.fold_in(self._enclave_base, self._enclave_seq)
            self._enclave_seq += 1
            nbytes = 0
            for i, k in enumerate(prf.split(ekey, K)):
                if not self._is_local(slots[i]):
                    continue
                rows_in[i], words = enclave_wire(
                    self._plan, rows_in[i], k, self._enclave_bits,
                    float(self.fl_cfg.secure_agg_range), self.device)
                nbytes += 4 * sum(int(w_.numel()) for w_ in words)
            self.telemetry.count("upload_bytes", nbytes, lane="enclave",
                                 **self._tl)
        if not self._streaming:  # "tee": store raw rows, mask lane at flush
            with self._span("ingest", k=K, lane="raw") as sp:
                for leaf, pos, lslot, st in self._routed(slots, stals):
                    rows = self._plan.chunk_arrays(
                        _as_device_tree(rows_in[pos], self.device), pad=True)
                    j = leaf - self._leaves.start
                    for b, r in zip(self._bufs, rows):
                        b[j, lslot] = r
                    self._stal[j, lslot] = st
                    self._valid[j, lslot] = 1.0
                sp.fence(self._bufs)
            self._mark(slots, rng)
            return
        with self._span("ingest", k=K, lane="stream") as sp:
            for leaf, pos, lslot, st in self._routed(slots, stals):
                gslot = leaf * self.leaf_buffer + lslot
                rows, w, nrm, clipped = self._encode_row(rows_in[pos], gslot,
                                                         st)
                self._write(leaf, lslot, rows, st, w, nrm, clipped)
            sp.fence(self._bufs)
        self._mark(slots, rng)

    def _mark(self, slots, rng) -> None:
        for s in slots:
            self._present[s] = True
        self._fill += len(slots)
        self.telemetry.count("stored_contributions", len(slots), **self._tl)
        self.telemetry.gauge("buffered_contributions", self._fill,
                             **self._tl)
        # with dead leaves the session cannot reach buffer_size: the trigger
        # is the LIVE capacity, and _apply then recovers the dead slots
        cap = self.live_capacity
        if cap > 0 and self._fill >= cap:
            self._apply(rng)

    def flush(self, rng=None, force: bool = False) -> bool:
        """Apply a partially-filled session (the dropout-recovery path);
        abstains below ``FLConfig.flush_quorum`` of the LIVE capacity unless
        ``force``.  Returns True when a params update was released."""
        if self._fill <= 0:
            return False
        with self._span("flush", forced=force, fill=self._fill):
            need = math.ceil(self.flush_quorum * max(self.live_capacity, 1))
            if not force and self._fill < need:
                self.fault_metrics["subquorum_deferrals"] += 1
                return False
            self._apply(rng)
        return True

    # -- server step --------------------------------------------------------
    def _apply(self, rng=None) -> None:
        if rng is None:  # deterministic per-version stream
            rng = prf.fold_in(prf.PRNGKey(0xA5), self.version)
        rng = prf.key_words(rng)
        B = self.buffer_size
        recovery = self._fill < B
        # in one process the flat topology's step is the flat engine's:
        # (B, padded) rows
        bufs = (self._bufs if self.two_level or self.mesh is not None
                else tuple(b.view(B, -1) for b in self._bufs))
        with self._span("decode", recovery=recovery, fill=self._fill) as sp:
            if self._streaming:
                step = self._flush_step if recovery else self._step
                self.params, self._opt_state, self.last_metrics = step(
                    self.params, self._opt_state, bufs, list(self._present),
                    self._wts.view(-1), self._stal.view(-1),
                    self._norms.view(-1), self._clips.view(-1),
                    self._session_key(), rng, ops=self._operators())
            else:
                self.params, self._opt_state, self.last_metrics = self._step(
                    self.params, self._opt_state, bufs, self._stal.view(-1),
                    self._valid.view(-1), rng)
                self._valid.zero_()
            sp.fence(self.params)
        self._present = [False] * self.buffer_size
        self.version += 1
        self._ops = (None, None)
        self._row_sessions = (None, {})
        self._applied_updates += self._fill
        self.telemetry.count("aggregated_contributions", self._fill,
                             **self._tl)
        self.telemetry.gauge("buffered_contributions", 0, **self._tl)
        self._fill = 0
        self._dead_leaves.clear()  # restarted leaves join the new session
        self.fault_metrics["released_updates"] += 1
