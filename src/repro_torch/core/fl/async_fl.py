"""Buffered asynchronous FL (FedBuff) — the aggregation server (port).

Port of ``repro.core.fl.async_fl``: ``staleness_weight``, ``batch_count``,
``ClientPush``, the two server steps (``build_async_buffer_step`` for the
batched raw-delta buffer, ``build_masked_async_buffer_step`` for the
streamed int32 buffer) and the ``AsyncServer`` facade in all four mask
modes (see the JAX class for the protocol of each).

PyTorch idiom in place of JAX's: buffers are preallocated on ``device`` and
written in place (one row per arrival), steps are plain functions run
eagerly, and PRNG keys are ``(k0, k1)`` word pairs derived exactly as the
JAX engine derives them — so with the same deltas the port produces the
same ``ClientPush`` words, buffers and parameters.

The streamed engines take compressed uploads (``compress_mode``
"subsample"/"sketch"): the session's operators are derived once per session
on the device and shared by push and flush, and the buffers hold the
operator-domain rows at the wire widths.  ``enclave_wire_bits`` quantizes
the tee/tee_stream uplink onto a packed field wire.

The event-driven simulators follow the server: ``simulate`` (numpy only, so
its :class:`SimResult` is the reference's exactly) and ``simulate_training``
(the same numpy event loop and key schedule, driving the port's round and
``AsyncServer``, optionally behind ``faults.FaultInjector``).
"""
from __future__ import annotations

import heapq
import math
import time
from dataclasses import dataclass
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch import tree as T
from repro_torch.core import telemetry as tele
from repro_torch.core.fl import aggregation as agg
from repro_torch.core.fl import compression as comp
from repro_torch.core.fl import secure_agg as sa
from repro_torch.core.fl.server_opt import build_server_opt
from repro_torch.kernels import prf

FAULT_METRIC_KEYS = ("duplicate_pushes", "rejected_pushes",
                     "subquorum_deferrals", "lost_contributions",
                     "released_updates")


def batch_count(delta, params) -> Optional[int]:
    """None if ``delta`` is one model update, else its stacked batch size."""
    pp, p = T.flatten(params)
    dp_, d = T.flatten(delta)
    if len(p) != len(d):
        raise ValueError(f"delta has {len(d)} leaves, the model has {len(p)}")
    if pp != dp_:
        raise ValueError("delta and model trees have different keys")
    if all(tuple(x.shape) == tuple(y.shape) for x, y in zip(d, p)):
        return None
    if all(len(x.shape) == len(y.shape) + 1
           and tuple(x.shape[1:]) == tuple(y.shape) for x, y in zip(d, p)):
        sizes = {int(x.shape[0]) for x in d}
        if len(sizes) == 1:
            return sizes.pop()
    raise ValueError(
        "delta leaves match neither the model's shapes nor a stacked "
        "(K, ...) batch of them")


def staleness_weight(staleness, mode: str = "polynomial", a: float = 0.5,
                     device=None) -> torch.Tensor:
    """FedBuff staleness discounting ``w = 1/(1+s)^a`` (s clamped at 0).

    ``constant`` mode is exact.  The polynomial weight's f32 ``pow`` may
    differ from XLA's in the last bit (a few hundred of the staleness
    values 0..4095 do), so it is held to a tolerance against the reference.
    """
    s = torch.clamp(torch.as_tensor(staleness, dtype=torch.float32,
                                    device=device), min=0.0)
    if mode == "constant":
        return torch.ones_like(s)
    return torch.pow(1.0 + s, -a)


def _as_device_tree(tree, dev):
    return T.tree_map(lambda x: torch.as_tensor(x).to(dev), tree)


def enclave_wire(plan, delta, key, bits: int, value_range: float, device):
    """The client side of the enclave wire, then the enclave's ingest: per
    chunk (keys ``split(key, num_chunks)``), stochastic quantize ->
    canonical field residues -> packed words (what crosses the wire) ->
    unpack -> dequantize.  Returns (the reconstructed delta tree, the
    per-chunk words)."""
    emod = (1 << bits) if bits < 32 else (1 << 32)
    xs = plan.chunk_arrays(_as_device_tree(delta, device))
    outs, words = [], []
    for x, k in zip(xs, prf.split(key, len(xs))):
        q = sa.quantize(x, bits, value_range, k)
        w = sa.pack_residues(sa.to_field(q, emod), emod)
        q2 = sa.recenter(sa.unpack_residues(w, x.shape[-1], emod), emod)
        outs.append(sa.dequantize(q2, bits, value_range))
        words.append(w)
    return plan.unchunk(outs), tuple(words)


# ---------------------------------------------------------------------------
# Server steps
# ---------------------------------------------------------------------------
def build_async_buffer_step(params, fl_cfg, *, buffer_size: int,
                            staleness_mode: str = "polynomial",
                            staleness_exponent: float = 0.5,
                            mask_mode: str = "off", device=None) -> Callable:
    """``step(params, opt_state, bufs, staleness, valid, rng)`` — the batched
    flush over per-chunk (buffer_size, padded_c) f32 buffers on ``device``
    (default the GPU).

    mask_mode "tee" adds each slot's pairwise session mask inside the fused
    accumulation (``weighted_quantize_accum``'s PRF lane); the masks cancel,
    so the result equals mask_mode "off" bit for bit.
    """
    _device.resolve(device)
    if mask_mode not in ("off", "tee"):
        raise ValueError(f"mask_mode {mask_mode!r}: expected 'off' or 'tee'")
    spec = agg.make_spec(fl_cfg, buffer_size)
    if mask_mode == "tee" and not spec.use_secure_agg:
        raise ValueError("mask_mode='tee' requires secure_agg_bits > 0")
    if not spec.compression.identity:
        raise ValueError(
            f"upload compression ({spec.compression.describe()}) runs on "
            "the STREAMING engines only (mask_mode 'client'/'tee_stream' "
            "or the streamed 'off' encode): the batched buffer step holds "
            "raw f32 deltas, so there is no client-side wire to compress. "
            "Set compress_rate=1.0 here or switch to a streaming mode.")
    server = build_server_opt(fl_cfg)
    plan = agg.plan_for(params, fl_cfg)

    def step(params, opt_state, bufs, staleness, valid, rng):
        bufs = bufs if isinstance(bufs, (tuple, list)) else (bufs,)
        w = staleness_weight(staleness, staleness_mode, staleness_exponent,
                             device=valid.device) * valid
        skey = prf.fold_in(rng, 0x7EE) if mask_mode == "tee" else None
        sessions = agg.plan_sessions(spec, plan, skey)
        mean_delta, stats = agg.aggregate_plan_buffer(
            bufs, w, spec, plan, rng, sessions=sessions)
        new_params, new_opt = server.apply(params, opt_state, mean_delta)
        metrics = {
            "update_norm": stats["update_norm"],
            "clip_fraction": stats["clip_fraction"],
            "weight_total": stats["weight_total"],
            "staleness_mean": (staleness * valid).sum()
            / torch.clamp(valid.sum(), min=1.0),
        }
        return new_params, new_opt, metrics

    return step


def build_masked_async_buffer_step(params, fl_cfg, *, buffer_size: int,
                                   recover: bool = True,
                                   masked: bool = True,
                                   telemetry=None,
                                   device=None) -> Callable:
    """``step(params, opt_state, mbufs, present, weights, staleness, norms,
    clips, session_key, rng, ops=None, labels=None)`` — the flush of the
    streamed int32 buffer on ``device`` (default the GPU).

    ``present`` is the per-slot delivery flags (host list or tensor).
    ``recover=True`` gates absent slots and (``masked``) re-adds their mask
    shares; ``recover=False`` is the complete-session flush.  Under an
    active compression spec the buffers hold operator-domain rows, decoded
    with ``ops`` (derived from ``session_key`` when not given).
    ``telemetry`` (default: the process registry) records the flush's
    fenced stages, each with the call's ``labels``: those of
    ``aggregation.aggregate_plan_masked_buffer``, then ``decode.server``.
    """
    _device.resolve(device)
    spec = agg.make_spec(fl_cfg, buffer_size)
    if not spec.use_secure_agg:
        raise ValueError("client-masked aggregation requires secure_agg_bits > 0")
    server = build_server_opt(fl_cfg)
    plan = agg.plan_for(params, fl_cfg)

    def step(params, opt_state, mbufs, present, weights, staleness, norms,
             clips, session_key, rng, ops=None, labels=None):
        span = tele.stage_spans(telemetry, labels)
        mbufs = mbufs if isinstance(mbufs, (tuple, list)) else (mbufs,)
        pres = torch.as_tensor(sa.present_flags(present), dtype=torch.float32,
                               device=weights.device)
        w = weights * pres
        w_total = w.sum()
        sessions = (agg.plan_sessions(spec, plan, session_key) if masked
                    else None)
        if ops is None:
            ops = agg.plan_operators(spec, plan, session_key,
                                     device=weights.device)
        mean_delta = agg.aggregate_plan_masked_buffer(
            mbufs, present, w_total, spec, plan, sessions, rng,
            recover=recover, masked=masked, ops=ops, telemetry=telemetry,
            labels=labels)
        with span("decode.server") as sp:
            new_params, new_opt = server.apply(params, opt_state, mean_delta)
            sp.fence(new_params)
        denom = torch.clamp(w_total, min=1e-9)
        metrics = {
            "update_norm": (norms * w).sum() / denom,
            "clip_fraction": (clips * w).sum() / denom,
            "weight_total": w_total,
            "staleness_mean": (staleness * pres).sum()
            / torch.clamp(pres.sum(), min=1.0),
        }
        return new_params, new_opt, metrics

    return step


class ClientPush(NamedTuple):
    """A client-side encoded push (see the JAX class).

    ``row`` is the packed wire stream: an int32 tensor holding the uint32
    words' bits (one per chunk in a tuple under a multi-chunk plan).
    ``weight``/``norm``/``clipped`` are 0-dim f32 tensors.
    """

    row: Any
    weight: torch.Tensor
    norm: torch.Tensor
    clipped: torch.Tensor
    staleness: float
    version: int
    slot: int
    modulus: int = 1 << 32
    token: int = 0
    compression: comp.CompressionSpec = comp.CompressionSpec()


def _check_mask_mode(mask_mode: str) -> None:
    if mask_mode not in ("off", "tee", "tee_stream", "client"):
        raise ValueError(f"mask_mode {mask_mode!r}")


class _BufferedSession:
    """The session protocol both aggregation servers share: a buffer of
    ``buffer_size`` slots per pairwise-mask session (= server ``version``),
    the session's keys, tokens, compression operators and spans, ``pull``,
    the ``ClientPush`` wire checks, the quorum ``flush`` and the release of
    a decoded session.  A subclass owns placement and ingest: its buffers,
    the push paths and ``_run_step`` (the server step over its buffers)."""

    _engine = "async"  # the ``engine`` label of counters and spans
    _peer = "server"  # this side's name in wire errors
    _fault_keys = FAULT_METRIC_KEYS

    def __init__(self, params, fl_cfg, buffer_size: int, *,
                 staleness_exponent: float, staleness_mode: str,
                 mask_mode: str, session_seed: int, strict: bool,
                 telemetry: Optional["tele.Telemetry"], device):
        self.device = device
        self.params = _as_device_tree(params, device)
        self.fl_cfg = fl_cfg
        self.buffer_size = buffer_size
        self.staleness_exponent = staleness_exponent
        self.staleness_mode = staleness_mode
        self.mask_mode = mask_mode
        self.version = 0
        self.last_metrics: Optional[dict] = None
        self._applied_updates = 0
        self._fill = 0
        self.strict = strict
        self.flush_quorum = float(getattr(fl_cfg, "flush_quorum", 0.0))
        self.telemetry = (telemetry if telemetry is not None
                          else tele.get_default())
        self._eid = tele.new_session_id()
        self._tl = {"engine": self._engine, "eid": self._eid}
        self.fault_metrics = tele.TelemetryCounterView(
            self.telemetry, self._fault_keys, **self._tl)
        self._token_counter = 0
        self._delivered_tokens: set = set()
        self._present = [False] * buffer_size
        self._session_base = prf.PRNGKey(session_seed)
        self._push_base = prf.PRNGKey(0xA5)
        self._spec = agg.make_spec(fl_cfg, buffer_size)
        self._plan = agg.plan_for(self.params, fl_cfg)
        self._opt_state = build_server_opt(fl_cfg).init(self.params)
        # the session's compression operators: (version, ops), derived on
        # first use in a session and shared by its pushes and its flush
        self._ops = (None, None)
        # enclave quantized wire: tee modes ship packed words of this width
        # instead of the raw f32 delta (FLConfig.enclave_wire_bits)
        ebits = int(getattr(fl_cfg, "enclave_wire_bits", 0))
        self._enclave_bits = ebits if mask_mode in ("tee", "tee_stream") \
            else 0
        self._enclave_seq = 0
        self._enclave_base = prf.PRNGKey(0xE7C)

    @property
    def plan(self) -> "agg.ParamPlan":
        return self._plan

    @property
    def live_capacity(self) -> int:
        """Session slots that can still fill: the quorum denominator."""
        return self.buffer_size

    def open_slots(self) -> List[int]:
        return [i for i, p in enumerate(self._present) if not p]

    def _session_key(self):
        """Key words of the current pairwise-mask session (= buffer round)."""
        return prf.fold_in(self._session_base, self.version)

    def _new_token(self) -> int:
        self._token_counter += 1
        return self._token_counter

    def _operators(self):
        """The session's compression operators (None: identity), keyed by
        the engine's session key and shared by its pushes and its flush."""
        if self._spec.compression.identity:
            return None
        version, ops = self._ops
        if version != self.version:
            self._ops = (None, None)  # free the last session's first
            ops = agg.plan_operators(self._spec, self._plan,
                                     self._session_key(), device=self.device)
            self._ops = (self.version, ops)
        return ops

    def _alloc_buffers(self, slots: Tuple[int, ...]) -> None:
        """The session's buffers on ``device``, one ``slots`` block per
        chunk: int32 wire rows and per-slot weights, norms and clip flags
        when streaming, raw f32 rows and valid flags otherwise; per-slot
        staleness in both."""
        def zeros(*width, dtype=torch.float32):
            return torch.zeros(slots + width, dtype=dtype, device=self.device)

        self._stal = zeros()
        if self._streaming:
            self._wire = agg.plan_wire_chunks(self._spec, self._plan)
            self._bufs = tuple(zeros(wc.padded, dtype=torch.int32)
                               for wc in self._wire)
            self._wts, self._norms, self._clips = zeros(), zeros(), zeros()
        else:
            self._bufs = tuple(zeros(ck.padded) for ck in self._plan.chunks)
            self._valid = zeros()

    def _write_row(self, at, rows, staleness, w=None, nrm=None,
                   clipped=None) -> None:
        """Store one row at buffer index ``at`` (a slot, or a (leaf, slot)
        pair): its wire rows, weight, norm and clip flag when streaming,
        its raw padded chunks (marked valid) otherwise."""
        for b, r in zip(self._bufs, rows):
            b[at] = r
        self._stal[at] = float(staleness)
        if self._streaming:
            self._wts[at] = w
            self._norms[at] = nrm
            self._clips[at] = clipped
        else:
            self._valid[at] = 1.0

    def _upload_lane(self) -> str:
        return "packed" if self._spec.compression.identity else "compressed"

    def _enclave_key(self):
        """The next key of the enclave wire's per-ingest sequence."""
        key = prf.fold_in(self._enclave_base, self._enclave_seq)
        self._enclave_seq += 1
        return key

    def _enclave_wire(self, delta, key):
        """:func:`enclave_wire` at this engine's width and range."""
        return enclave_wire(self._plan, delta, key, self._enclave_bits,
                            float(self.fl_cfg.secure_agg_range), self.device)

    def _topology(self) -> dict:
        """The placement labels of a span, between ``round`` and
        ``engine``."""
        return {}

    def _span_labels(self, **labels) -> Optional[dict]:
        """The labels of this engine's spans in the open session (None
        when the registry records no spans)."""
        if not self.telemetry.record_spans:
            return None
        return dict(round=self.version, **self._topology(), **self._tl,
                    **labels)

    def _span(self, name: str, **labels):
        return tele.stage_spans(self.telemetry,
                                self._span_labels())(name, **labels)

    # -- client protocol ------------------------------------------------------
    def pull(self) -> Tuple[Any, int]:
        return self.params, self.version

    def _require_client_mode(self, call: str, half: str) -> None:
        if self.mask_mode != "client":
            raise ValueError(
                f"{call} is the {half} half of mask_mode='client' "
                f"(server is in mask_mode={self.mask_mode!r})")

    def _batch_slots(self, slot, k: int) -> List[int]:
        """The session slots a stacked ``encode_push`` of ``k`` rows names:
        ``k`` consecutive ones from a scalar ``slot``, else ``slot``'s."""
        if np.ndim(slot) != 0:
            return [int(s) for s in slot]
        s0 = int(slot)
        if s0 < 0 or s0 + k > self.buffer_size:
            raise ValueError(
                f"scalar slot={s0} with a stacked batch of {k} "
                f"rows names session slots {s0}..{s0 + k - 1}, "
                f"outside the session's {self.buffer_size} slots; "
                f"pass an explicit slot sequence or start lower")
        return list(range(s0, s0 + k))

    def _check_wire(self, cp: ClientPush) -> None:
        """Refuse a push packed for another field or encoded under another
        compression spec than the session's."""
        spec, peer = self._spec, self._peer
        if cp.modulus != spec.field_modulus:
            raise ValueError(
                f"ClientPush packed for field modulus {cp.modulus} "
                f"({sa.wire_bits(cp.modulus)}-bit wire) but the {peer}'s "
                f"session field is {spec.field_modulus} "
                f"({sa.wire_bits(spec.field_modulus)}-bit): the "
                f"residue stream cannot be unpacked — client and {peer} "
                "must agree on secure_agg_bits and the session size")
        if cp.compression != spec.compression:
            raise ValueError(
                f"ClientPush encoded under compression "
                f"{cp.compression.describe()} but the {peer}'s session "
                f"expects {spec.compression.describe()}: the row "
                "lives in a different sketch domain and would decode to "
                f"garbage — client and {peer} must agree on compress_mode "
                "and compress_rate for the session")

    def _mark(self, slots, rng) -> None:
        """Count stored rows at ``slots``; apply once the live capacity is
        full (with dead leaves the session cannot reach ``buffer_size``:
        ``_apply`` then recovers the dead slots)."""
        for s in slots:
            self._present[s] = True
        self._fill += len(slots)
        self.telemetry.count("stored_contributions", len(slots), **self._tl)
        self.telemetry.gauge("buffered_contributions", self._fill,
                             **self._tl)
        cap = self.live_capacity
        if cap > 0 and self._fill >= cap:
            self._apply(rng)

    def flush(self, rng=None, force: bool = False) -> bool:
        """Apply a partially-filled session (dropout recovery in the masked
        modes); abstains below ``FLConfig.flush_quorum`` of the live
        capacity unless ``force``.  Returns True when a params update was
        released."""
        if self._fill <= 0:
            return False
        with self._span("flush", forced=force, fill=self._fill):
            need = math.ceil(self.flush_quorum * max(self.live_capacity, 1))
            if not force and self._fill < need:
                self.fault_metrics["subquorum_deferrals"] += 1
                return False
            self._apply(rng)
        return True

    # -- server step ----------------------------------------------------------
    def _apply(self, rng=None) -> None:
        if rng is None:  # deterministic per-version stream
            rng = prf.fold_in(prf.PRNGKey(0xA5), self.version)
        rng = prf.key_words(rng)
        recovery = self._fill < self.buffer_size
        with self._span("decode", recovery=recovery, fill=self._fill) as sp:
            self.params, self._opt_state, self.last_metrics = \
                self._run_step(rng, recovery)
            sp.fence(self.params)
        self._present = [False] * self.buffer_size
        self.version += 1
        self._ops = (None, None)
        self._applied_updates += self._fill
        self.telemetry.count("aggregated_contributions", self._fill,
                             **self._tl)
        self.telemetry.gauge("buffered_contributions", 0, **self._tl)
        self._fill = 0
        self._end_session()
        self.fault_metrics["released_updates"] += 1

    def _run_step(self, rng, recovery: bool):
        """(params, optimizer state, metrics) of the server step over the
        session's buffers."""
        raise NotImplementedError

    def _end_session(self) -> None:
        """Reset the subclass's per-session state on release."""


class AsyncServer(_BufferedSession):
    """Buffered asynchronous aggregation with staleness weighting + DP.

    Mask modes, as in the JAX engine: "off" (streamed unmasked encode into
    an int32 buffer, or ``stream_encode=False`` for the batched raw-delta
    buffer), "tee" (batched; masks added inside the fused accumulation),
    "tee_stream" (streamed masked encode per arrival) and "client"
    (``encode_push`` on the client, ``push_encoded`` on the server, dropout
    recovery on partial flushes).  Buffers live on ``device`` (default the
    GPU; without one, pass ``device="cpu"``) and are updated in place.
    """

    def __init__(self, params, fl_cfg, buffer_size: int = 10,
                 staleness_exponent: float = 0.5,
                 staleness_mode: str = "polynomial",
                 mask_mode: str = "off",
                 session_seed: int = 0x5A5E,
                 stream_encode: Optional[bool] = None,
                 strict: bool = True,
                 telemetry: Optional["tele.Telemetry"] = None,
                 device=None):
        _check_mask_mode(mask_mode)
        super().__init__(
            params, fl_cfg, buffer_size,
            staleness_exponent=staleness_exponent,
            staleness_mode=staleness_mode, mask_mode=mask_mode,
            session_seed=session_seed, strict=strict, telemetry=telemetry,
            device=_device.resolve(device))
        spec = self._spec
        if mask_mode == "off":
            if stream_encode and not spec.use_secure_agg:
                raise ValueError(
                    "stream_encode requires secure_agg_bits > 0 (there is "
                    "no fixed-point field to stream the encode into)")
            streaming = (spec.use_secure_agg if stream_encode is None
                         else stream_encode)
        else:
            streaming = mask_mode in ("client", "tee_stream")
        self._streaming = streaming
        if streaming and not spec.use_secure_agg:
            raise ValueError(
                f"mask_mode={mask_mode!r} requires secure_agg_bits > 0")
        self._alloc_buffers((buffer_size,))
        if streaming:
            self._masked = mask_mode != "off"
            self._step, self._flush_step = (build_masked_async_buffer_step(
                self.params, fl_cfg, buffer_size=buffer_size, recover=r,
                masked=self._masked, telemetry=self.telemetry,
                device=self.device) for r in (False, True))
        else:
            self._step = build_async_buffer_step(
                self.params, fl_cfg, buffer_size=buffer_size,
                staleness_mode=staleness_mode,
                staleness_exponent=staleness_exponent, mask_mode=mask_mode,
                device=self.device)

    # -- the streamed encode and the wire -------------------------------------
    def _masked_encode(self, delta, slot: int, staleness, session_key, rng):
        """The streamed-push encode (client in "client", enclave in
        "tee_stream", server-side and unmasked in streamed "off")."""
        spec, plan = self._spec, self._plan
        w = staleness_weight(staleness, self.staleness_mode,
                             self.staleness_exponent, device=self.device)
        sessions = (agg.plan_sessions(spec, plan, session_key)
                    if self._masked else None)
        delta = _as_device_tree(delta, self.device)
        rows, nrm, clipped = agg.encode_plan_contribution(
            delta, w, slot, spec, plan, sessions, rng, masked=self._masked,
            ops=self._operators(), telemetry=self.telemetry,
            labels=self._span_labels(slot=slot))
        return rows, w, nrm, clipped

    def _wire_pack(self, rows, session_key):
        """Client side: each chunk's session ``reduce``s its row to packed
        canonical field residues."""
        sessions = agg.plan_sessions(self._spec, self._plan, session_key)
        return tuple(s.reduce(r) for s, r in zip(sessions, rows))

    def _wire_unpack(self, wrows):
        """Server side: packed words back to the stored int32 residue rows."""
        return tuple(sa.unpack_residues(wr.to(self.device), wc.padded,
                                        self._spec.field_modulus)
                     for wr, wc in zip(wrows, self._wire))

    # -- client protocol ------------------------------------------------------
    def encode_push(self, delta, client_version: int, rng=None,
                    slot: Optional[int] = None):
        """The CLIENT half of mask_mode='client': encode + mask one delta
        (or a stacked batch -> list of ``ClientPush``)."""
        self._require_client_mode("encode_push", "client")
        k = batch_count(delta, self.params)
        if k is not None:
            slots = (self.open_slots()[:k] if slot is None
                     else self._batch_slots(slot, k))
            if len(slots) < k:
                raise ValueError(
                    f"batched encode_push of {k} rows but only "
                    f"{len(slots)} session slots available")
            return [self.encode_push(T.tree_map(lambda x: x[i], delta),
                                     client_version, rng, slots[i])
                    for i in range(k)]
        staleness = self.version - client_version
        if slot is None:
            slot = self._present.index(False)
        slot = int(slot)
        with self._span("encode_push", slot=slot) as sp:
            rows, w, nrm, clipped = self._encode_for_slot(delta, staleness,
                                                          slot, rng)
            rows = self._wire_pack(rows, self._session_key())
            sp.fence(rows)
        self.telemetry.count(
            "upload_bytes", 4 * sum(int(r.numel()) for r in rows),
            lane=self._upload_lane(), **self._tl)
        row = rows[0] if len(rows) == 1 else rows
        return ClientPush(row, w, nrm, clipped, staleness, self.version,
                          slot, self._spec.field_modulus, self._new_token(),
                          self._spec.compression)

    def _encode_for_slot(self, delta, staleness, slot: int, rng=None):
        if rng is None:
            rng = prf.fold_in(prf.fold_in(self._push_base, self.version),
                              slot)
        return self._masked_encode(delta, slot, staleness,
                                   self._session_key(), prf.key_words(rng))

    def push_encoded(self, cp, rng=None):
        """The SERVER half of mask_mode='client': store one masked row (or a
        list of them; returns the stored count)."""
        self._require_client_mode("push_encoded", "server")
        if isinstance(cp, list):
            return sum(1 for one in cp if self.push_encoded(one, rng))
        with self._span("push_encoded", slot=cp.slot):
            return self._push_encoded_one(cp, rng)

    def _push_encoded_one(self, cp: ClientPush, rng=None) -> bool:
        if cp.token and cp.token in self._delivered_tokens:
            self.fault_metrics["duplicate_pushes"] += 1
            return False
        if (cp.version != self.version or not 0 <= cp.slot < self.buffer_size
                or self._present[cp.slot]):
            if not self.strict:
                self.fault_metrics["rejected_pushes"] += 1
                return False
            raise ValueError(
                f"stale ClientPush (session {cp.version} slot {cp.slot}; "
                f"server at session {self.version}, slot filled="
                f"{self._present[cp.slot] if 0 <= cp.slot < self.buffer_size else 'n/a'}): "
                "the pairwise mask no longer matches an open session position")
        self._check_wire(cp)
        wrows = cp.row if isinstance(cp.row, tuple) else (cp.row,)
        self.telemetry.count(
            "upload_bytes", 4 * sum(int(w_.numel()) for w_ in wrows),
            lane=self._upload_lane(), **self._tl)
        rows = self._wire_unpack(wrows)
        if cp.token:
            self._delivered_tokens.add(cp.token)
        self._store_row(cp.slot, rows, cp.staleness, cp.weight, cp.norm,
                        cp.clipped, rng)
        return True

    def _store_row(self, slot: int, rows, staleness, w, nrm, clipped,
                   rng=None) -> None:
        """Write one encoded row into its session slot (+ apply when full)."""
        with self._span("push.store", slot=slot) as sp:
            self._write_row(slot, rows, staleness, w, nrm, clipped)
            sp.fence(self._bufs)
        self._mark([slot], rng)

    def push(self, delta, client_version: int, rng=None,
             slot: Optional[int] = None, push_id: Optional[int] = None):
        """Push one model delta — or a stacked batch of them."""
        k = batch_count(delta, self.params)
        if k is not None:
            slots = [None] * k if slot is None else list(slot)
            return sum(1 for i in range(k)
                       if self.push(T.tree_map(lambda x: x[i], delta),
                                    client_version, rng, slot=slots[i]))
        with self._span("push", mode=self.mask_mode,
                        slot=self._push_slot(slot)):
            return self._push_one(delta, client_version, rng, slot, push_id)

    def _push_slot(self, slot: Optional[int]) -> int:
        """The traced ``push`` span's ``slot``: the slot the push names,
        else the first open one (-1: none; not looked up untraced)."""
        if slot is not None:
            return int(slot)
        if not self.telemetry.record_spans:
            return -1
        return next((i for i, p in enumerate(self._present) if not p), -1)

    def _push_one(self, delta, client_version: int, rng=None,
                  slot: Optional[int] = None,
                  push_id: Optional[int] = None) -> bool:
        if push_id is not None and push_id in self._delivered_tokens:
            self.fault_metrics["duplicate_pushes"] += 1
            return False
        if slot is not None:
            if not 0 <= slot < self.buffer_size or self._present[slot]:
                if not self.strict:
                    self.fault_metrics["rejected_pushes"] += 1
                    return False
                raise ValueError(
                    f"slot {slot} is not an open position of session "
                    f"{self.version}")
        if self.mask_mode == "client":
            ok = self.push_encoded(
                self.encode_push(delta, client_version, slot=slot), rng)
            if ok and push_id is not None:
                self._delivered_tokens.add(push_id)
            return ok
        staleness = self.version - client_version
        if push_id is not None:
            self._delivered_tokens.add(push_id)
        if self._enclave_bits:
            # the tee ingests the client-side quantization's reconstruction;
            # the packed words are what crossed the wire
            delta, ewords = self._enclave_wire(delta, self._enclave_key())
            self.telemetry.count(
                "upload_bytes", 4 * sum(int(w_.numel()) for w_ in ewords),
                lane="enclave", **self._tl)
        if slot is None:
            slot = self._present.index(False)
        if self._streaming:
            rows, w, nrm, clipped = self._encode_for_slot(delta, staleness,
                                                          slot)
            self._store_row(slot, rows, staleness, w, nrm, clipped, rng)
            return True
        rows = self._plan.chunk_arrays(_as_device_tree(delta, self.device),
                                       pad=True)
        self._write_row(slot, rows, staleness)
        self._mark([slot], rng)
        return True

    # -- server step ----------------------------------------------------------
    def _run_step(self, rng, recovery: bool):
        if self._streaming:
            step = self._flush_step if recovery else self._step
            return step(self.params, self._opt_state, self._bufs,
                        list(self._present), self._wts, self._stal,
                        self._norms, self._clips, self._session_key(), rng,
                        ops=self._operators(), labels=self._span_labels())
        out = self._step(self.params, self._opt_state, self._bufs,
                         self._stal, self._valid, rng)
        self._valid.zero_()
        return out


# ---------------------------------------------------------------------------
# Event-driven wall-clock / network simulation (sync vs async)
# ---------------------------------------------------------------------------
@dataclass
class SimResult:
    wall_clock: float
    bytes_up: float
    bytes_down: float
    applied_updates: int
    server_steps: int

    @property
    def total_bytes(self) -> float:
        return self.bytes_up + self.bytes_down


def _device_times(n: int, seed: int, mu: float = 2.5, sigma: float = 1.2):
    rs = np.random.RandomState(seed)
    return np.exp(rs.normal(mu, sigma, size=n))  # heavy-tailed train times


def simulate(mode: str, *, population: int, cohort: int, target_updates: int,
             model_bytes: float, seed: int = 0, dropout: float = 0.1,
             buffer_size: int = 10, over_select: float = 1.3,
             round_overhead: float = 30.0) -> SimResult:
    """Simulate until ``target_updates`` client updates are applied (see the
    JAX function: sync rounds wait for the cohort-th fastest of an
    over-selected cohort plus a coordination overhead; async devices stream
    continuously and the server applies every ``buffer_size`` arrivals).
    Numpy only, so the result is the reference's exactly."""
    times = _device_times(population, seed)
    rs = np.random.RandomState(seed + 1)

    if mode == "sync":
        t, up, down, applied, steps = 0.0, 0.0, 0.0, 0, 0
        while applied < target_updates:
            n_sel = int(cohort * over_select)
            sel = rs.choice(population, size=n_sel, replace=False)
            alive = sel[rs.uniform(size=n_sel) > dropout]
            down += n_sel * model_bytes  # everyone selected downloads
            finish = np.sort(times[alive])
            if len(finish) < cohort:
                t += (float(finish[-1]) if len(finish) else 1.0) \
                    + round_overhead
                continue
            t += float(finish[cohort - 1]) + round_overhead
            up += len(alive) * model_bytes  # late survivors' uploads wasted
            applied += cohort
            steps += 1
        return SimResult(t, up, down, applied, steps)

    if mode == "async":
        heap: List[Tuple[float, int]] = []
        active = rs.choice(population, size=cohort, replace=False)
        for d in active:
            heapq.heappush(heap, (float(times[d]), int(d)))
        t, applied, steps = 0.0, 0, 0
        down = cohort * model_bytes
        up = 0.0
        buf = 0
        while applied < target_updates:
            t, d = heapq.heappop(heap)
            if rs.uniform() < dropout:
                pass  # dropped mid-training: no upload
            else:
                up += model_bytes
                buf += 1
                applied += 1
                if buf >= buffer_size:
                    buf = 0
                    steps += 1
            nxt = int(rs.randint(population))
            down += model_bytes
            heapq.heappush(heap, (t + float(times[nxt]), nxt))
        return SimResult(t, up, down, applied, steps)

    raise ValueError(mode)


# ---------------------------------------------------------------------------
# Event-driven simulation over the port's engines
# ---------------------------------------------------------------------------
@dataclass
class TrainingSimResult:
    sim: SimResult
    losses: List[float]  # per-applied-update client loss trace
    host_seconds: float  # host wall-clock spent in the engines
    killed: int = 0  # devices that died mid-round (their work is wasted)
    released_updates: int = 0  # server applies that released a params update
    wasted_updates: int = 0  # trained contributions never released
    fault_metrics: Optional[dict] = None  # the engine's degradation counters

    @property
    def final_loss(self) -> float:
        k = max(1, len(self.losses) // 10)
        return float(np.mean(self.losses[-k:]))

    def steps_to_loss(self, target: float) -> Optional[int]:
        """First applied update whose trailing-10 mean loss hits ``target``
        (None if never reached)."""
        xs = np.asarray(self.losses, np.float64)
        for i in range(len(xs)):
            lo = max(0, i - 9)
            if float(xs[lo:i + 1].mean()) <= target:
                return i + 1
        return None


def simulate_training(mode: str, *, loss_fn: Callable, params, fl_cfg,
                      make_client_batch: Callable, target_updates: int,
                      cohort: int, population: int = 1024,
                      buffer_size: int = 10, model_bytes: float = 4e6,
                      seed: int = 0, dropout: float = 0.0,
                      dropout_rate: Optional[float] = None,
                      devices: Optional[Any] = None,
                      mask_mode: str = "off",
                      staleness_exponent: float = 0.5,
                      round_overhead: float = 30.0,
                      faults: Optional[Any] = None,
                      data_by_device: bool = False,
                      telemetry: Optional["tele.Telemetry"] = None,
                      device=None) -> TrainingSimResult:
    """The event-driven fleet simulation driving the port's engines on
    ``device`` (default the GPU).

    The JAX function's contract: ``mode="sync"`` runs cohort-sized rounds of
    ``round.build_round_step`` (wall-clock = each round's straggler + the
    coordination overhead); ``mode="async"`` feeds an ``AsyncServer`` from
    the heterogeneous-fleet event loop, each device training against the
    (stale) version it pulled.  ``dropout_rate`` (alias ``dropout``) kills
    devices mid-round, modulated per device by ``devices``
    (``device_sim.midround_dropout_prob``); a ``ChurnModel`` on ``devices``
    drives availability-weighted arrivals and tiered speeds;
    ``fl_cfg.scaffold`` rides the control variates on the push API (async
    only); ``faults`` (a ``faults.FaultPlan``) wraps the server in a
    ``FaultInjector`` and stretches straggler device times;
    ``data_by_device`` keys client batches by device id.

    ``make_client_batch(client_seed, n_clients)`` returns a batch tree with
    leading axis ``n_clients``.  The event loop is numpy and the keys are
    the reference's (``PRNGKey(seed)``, ``fold_in(key, cseed)`` per client,
    ``fold_in(key, 0x5000 + applied)`` per push, ``fold_in(key, 0x6000)``
    for the deadline flush, ``fold_in(key, step)`` per sync round), so the
    arrival order, kills and flushes are the reference's.
    """
    from repro_torch.core.fl.round import (build_client_update,
                                           build_round_step, init_fl_state)

    dev = _device.resolve(device)
    if dropout_rate is None:
        dropout_rate = dropout
    if getattr(fl_cfg, "scaffold", False) and mode != "async":
        raise ValueError(
            "FLConfig.scaffold=True is the buffered-async drift correction "
            "(control variates ride the async push API); use mode='async'")
    if devices is not None:
        from repro_torch.core.device_sim import midround_dropout_prob
        assert len(devices) >= population

        def kill_prob(d: int) -> float:
            return midround_dropout_prob(devices.devices[d], dropout_rate)
    else:
        def kill_prob(d: int) -> float:
            return dropout_rate

    def on_device(batch):
        return T.tree_map(lambda x: torch.as_tensor(x).to(dev), batch)

    params = _as_device_tree(params, dev)
    times = _device_times(population, seed)
    rs = np.random.RandomState(seed + 1)
    key = prf.PRNGKey(seed)
    losses: List[float] = []

    if mode == "sync":
        step = build_round_step(loss_fn, fl_cfg, cohort_size=cohort,
                                telemetry=telemetry, device=dev)
        state = init_fl_state(params, fl_cfg)
        # a dedicated kill stream keeps device selection independent of it
        rs_kill = np.random.RandomState(seed + 2)
        t, up, down, applied, steps = 0.0, 0.0, 0.0, 0, 0
        host0 = time.perf_counter()
        while applied < target_updates:
            sel = rs.choice(population, size=cohort, replace=False)
            batch = dict(on_device(dict(make_client_batch(steps, cohort))))
            if dropout_rate > 0.0:
                survive = np.asarray(
                    [rs_kill.uniform() >= kill_prob(d) for d in sel],
                    np.float32)
                if survive.sum() == 0.0:
                    survive[0] = 1.0  # degenerate round: keep one survivor
                sv = torch.as_tensor(survive, device=dev)
                prior_w = batch.get("weight")
                batch["weight"] = sv if prior_w is None else sv * prior_w
            else:
                survive = np.ones((cohort,), np.float32)
            state, metrics = step(state, batch, prf.fold_in(key, steps))
            losses.append(float(metrics["loss"]))
            t += float(np.max(times[sel])) + round_overhead
            down += cohort * model_bytes
            up += int(survive.sum()) * model_bytes
            applied += int(survive.sum())
            steps += 1
        host = time.perf_counter() - host0
        return TrainingSimResult(
            SimResult(t, up, down, applied, steps), losses, host)

    if mode == "async":
        scaffold = bool(getattr(fl_cfg, "scaffold", False))
        churn_on = (devices is not None
                    and getattr(devices, "churn", None) is not None)
        if scaffold:
            from repro_torch.core.fl.round import build_scaffold_client_update
            zeros_c = T.tree_map(lambda x: torch.zeros(
                x.shape, dtype=torch.float32, device=dev), params)
            scaffold_update = build_scaffold_client_update(loss_fn, fl_cfg)
            c_scale = buffer_size / population  # the |S|/N variate rate
            ci: dict = {}  # device -> client control variate (lazy zeros)
            srv = AsyncServer({"x": params, "c": zeros_c}, fl_cfg,
                              buffer_size=buffer_size,
                              staleness_exponent=staleness_exponent,
                              mask_mode=mask_mode, telemetry=telemetry,
                              device=dev)
        else:
            client_update = build_client_update(loss_fn, fl_cfg)
            srv = AsyncServer(params, fl_cfg, buffer_size=buffer_size,
                              staleness_exponent=staleness_exponent,
                              mask_mode=mask_mode, telemetry=telemetry,
                              device=dev)
        eng = srv
        if faults is not None:
            from repro_torch.core.fl.faults import FaultInjector
            eng = FaultInjector(srv, faults)

        def round_time(d: int) -> float:
            base = (float(devices.devices[d].speed) if churn_on
                    else float(times[d]))
            if faults is not None:
                base *= faults.straggler_mult(d)
            return base

        def next_device() -> int:
            if churn_on:
                w = np.asarray([devices.availability_weight(devices.devices[i])
                                for i in range(population)], np.float64)
                tot = w.sum()
                if tot > 0.0:
                    return int(rs.choice(population, p=w / tot))
            return int(rs.randint(population))

        # in flight: (finish time, device, client seed, (version, params) at
        # PULL time); the client seed is unique, so the heap never compares
        # the snapshots
        heap: List[Tuple[float, int, int, Tuple[int, Any]]] = []
        for i, d in enumerate(rs.choice(population, size=cohort,
                                        replace=False)):
            params_now, ver_now = eng.pull()
            heapq.heappush(heap, (round_time(int(d)), int(d), i,
                                  (ver_now, params_now)))
        t, applied, n_started, killed = 0.0, 0, cohort, 0
        down, up = cohort * model_bytes, 0.0
        last_ver = srv.version
        host0 = time.perf_counter()
        while applied < target_updates:
            t, d, cseed, (pulled_version, pulled_params) = heapq.heappop(heap)
            if rs.uniform() >= kill_prob(d):
                batch = on_device(make_client_batch(
                    d if data_by_device else cseed, 1))
                cbatch = T.tree_map(lambda x: x[0], batch)
                crng = prf.fold_in(key, cseed)
                if scaffold:
                    cc = ci.get(d)
                    if cc is None:
                        cc = zeros_c
                    (dx, dc), loss = scaffold_update(
                        pulled_params["x"], pulled_params["c"], cc, cbatch,
                        crng)
                    ci[d] = T.tree_map(lambda a, b: a + b, cc, dc)
                    delta = {"x": dx,
                             "c": T.tree_map(lambda v: v * c_scale, dc)}
                else:
                    delta, loss = client_update(pulled_params, cbatch, crng)
                eng.push(delta, pulled_version,
                         rng=prf.fold_in(key, 0x5000 + applied))
                losses.append(float(loss))
                up += model_bytes
                applied += 1
            else:
                killed += 1  # mid-round death: its local work is wasted
            if churn_on and srv.version != last_ver:
                devices.step()  # world time advances once per server apply
                last_ver = srv.version
            nxt = next_device()
            params_now, ver_now = eng.pull()
            heapq.heappush(heap, (t + round_time(nxt), nxt, n_started,
                                  (ver_now, params_now)))
            n_started += 1
            down += model_bytes
        # the deadline flush: a partial buffer is applied (client mode
        # recovers the empty slots' masks); below FLConfig.flush_quorum it
        # abstains
        eng.flush(rng=prf.fold_in(key, 0x6000))
        host = time.perf_counter() - host0
        fm = dict(srv.fault_metrics)
        wasted = (killed + fm["rejected_pushes"] + fm["lost_contributions"]
                  + srv._fill)
        return TrainingSimResult(
            SimResult(t, up, down, applied, srv.version), losses, host,
            killed=killed, released_updates=fm["released_updates"],
            wasted_updates=wasted, fault_metrics=fm)

    raise ValueError(mode)
