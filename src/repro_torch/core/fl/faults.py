"""Seeded fault injection and graceful degradation for the FL engines.

The paper's setting is an unreliable fleet: clients die mid-round, the
network duplicates / delays / reorders pushes, whole aggregator shards
fall over mid-ingest, and stragglers stretch the tail.  This module makes
those faults FIRST-CLASS and deterministic, so any test or benchmark can
inject an exact fault schedule against the real engines and replay it
bit-for-bit:

  :class:`FaultSpec`    — declarative fault rates + the leaf-death schedule.
  :class:`FaultPlan`    — the seeded decision stream.  Every fault decision
                          is drawn from one ``np.random.RandomState`` and
                          recorded in ``plan.trace``; ``plan.replayed()``
                          returns a plan that replays the identical
                          decisions (no resampling), so a failing chaos run
                          reproduces exactly.
  :class:`RetryPolicy`  — capped exponential backoff (in arrival ticks) for
                          deliveries the server rejected.
  :class:`FaultInjector` — wraps ``AsyncServer`` / ``ShardedAsyncServer``
                          at the ``push`` / ``encode_push`` /
                          ``push_encoded`` / ``flush`` boundaries.

The injector pins every submission's session slot AT SUBMIT TIME (encoding
immediately in mask_mode="client", reserving the slot for raw modes).
Because the engines key their per-slot PRF streams by (session, slot),
a pinned contribution is bit-reproducible no matter how delivery is later
delayed, duplicated or reordered — which is exactly the property the
bit-identity chaos tests (tests/test_faults.py) assert: the decoded
aggregate of a faulted session equals a clean replay of its survivors.

The port's copy of ``repro.core.fl.faults`` (numpy and the port's telemetry
only): the same decisions from the same ``FaultSpec``, so ``plan.trace`` is
the reference's, around the port's ``AsyncServer`` and
``ShardedAsyncServer``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import telemetry as tele

__all__ = ["FaultSpec", "FaultPlan", "RetryPolicy", "FaultInjector"]


@dataclass(frozen=True)
class FaultSpec:
    """Declarative fault schedule (all rates are per submitted push).

    ``leaf_deaths`` is a tuple of ``(phase, session_version, leaf)`` events:
    phase "ingest" kills the leaf while arrivals are landing in that
    session (it fires once the leaf holds at least one contribution, so
    the event deterministically loses buffered work), phase "flush" kills
    it at the deadline flush — both exercise the tier's per-leaf
    degradation (dead-slot recovery at the root).  Events target
    :class:`~repro_torch.core.fl.hierarchy.ShardedAsyncServer`; they are
    ignored for the flat single-host server.
    """

    p_client_death: float = 0.0  # trained delta never submitted
    p_duplicate: float = 0.0  # wire duplicates the delivery
    p_delay: float = 0.0  # delivery held back delay_pushes arrivals
    delay_pushes: int = 3
    p_reorder: float = 0.0  # delivery swapped with the previous in-flight one
    straggler_frac: float = 0.0  # fleet fraction with a slow tail
    straggler_mult: float = 5.0
    leaf_deaths: Tuple[Tuple[str, int, int], ...] = ()
    seed: int = 0

    def __post_init__(self):
        for phase, _, _ in self.leaf_deaths:
            if phase not in ("ingest", "flush"):
                raise ValueError(
                    f"leaf-death phase {phase!r}: want 'ingest' or 'flush'")


class FaultPlan:
    """The seeded, deterministic, replayable fault decision stream."""

    def __init__(self, spec: FaultSpec,
                 _replay: Optional[Sequence[Tuple[str, bool]]] = None):
        self.spec = spec
        self._rs = np.random.RandomState(spec.seed & 0x7FFFFFFF)
        # every decision site appends (site, decision); events append
        # (site, payload) — together the full replayable fault trace
        self.trace: List[Tuple[str, Any]] = []
        self._replay = None if _replay is None else list(_replay)
        self._cursor = 0

    def decide(self, site: str, p: float) -> bool:
        """One Bernoulli fault decision, recorded (or replayed)."""
        if self._replay is not None:
            rsite, d = self._replay[self._cursor]
            self._cursor += 1
            if rsite != site:
                raise ValueError(
                    f"fault replay diverged: recorded {rsite!r} at step "
                    f"{self._cursor - 1}, live run asked for {site!r}")
        else:
            d = bool(p > 0.0 and self._rs.uniform() < p)
        self.trace.append((site, d))
        return d

    def record(self, site: str, payload: Any) -> None:
        """Log a non-decision event (delivery, drop, leaf death)."""
        self.trace.append((site, payload))

    def replayed(self) -> "FaultPlan":
        """A fresh plan replaying this run's decisions verbatim."""
        return FaultPlan(self.spec,
                         _replay=[t for t in self.trace
                                  if isinstance(t[1], bool)])

    def time_multiplier(self, device_id: int) -> float:
        """Deterministic straggler tail: a fixed ``straggler_frac`` of
        device ids train ``straggler_mult`` x slower (stable hash, no RNG
        consumption — the decision stream stays event-order independent).
        """
        f = self.spec.straggler_frac
        if f <= 0.0:
            return 1.0
        h = (device_id * 2654435761) % (1 << 32)
        return self.spec.straggler_mult if h < f * (1 << 32) else 1.0

    # alias used by simulate_training
    straggler_mult = time_multiplier


@dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff for rejected deliveries, measured in
    arrival ticks (the injector's clock advances one tick per submitted
    push — simulated transport time, not host time)."""

    max_retries: int = 3
    base_delay: int = 1
    max_delay: int = 8

    def backoff(self, attempt: int) -> int:
        return min(self.max_delay, self.base_delay * (1 << (attempt - 1)))


@dataclass
class _Pending:
    """One in-flight (submitted, not yet delivered) contribution."""

    seq: int  # submission order — the identity the trace refers to
    ready: int  # deliver when the injector clock reaches this tick
    delta: Any  # raw payload, kept for re-encode (retry / leaf re-route)
    client_version: int
    cp: Any = None  # encoded form (mask_mode="client")
    slot: Optional[int] = None  # pinned slot (raw modes)
    push_id: int = 0
    attempts: int = 0
    dup: bool = False  # wire duplicate: delivered once, never re-encoded


class FaultInjector:
    """Chaos proxy over an async aggregation server.

    Exposes the server's ``pull`` / ``push`` / ``flush`` surface so the
    event loop (``simulate_training(faults=...)``) — or a test — drives it
    unchanged, while the plan decides which submissions die, duplicate,
    delay or reorder, and when whole leaves fall over.  The wrapped server
    is forced to ``strict=False`` semantics by construction: the injector
    only ever relies on the count-and-drop contract plus token idempotence.
    """

    def __init__(self, server, plan: FaultPlan,
                 retry: Optional[RetryPolicy] = None,
                 telemetry: Optional["tele.Telemetry"] = None):
        self.server = server
        server.strict = False  # the injector relies on count-and-drop
        self.plan = plan
        self.retry = retry if retry is not None else RetryPolicy()
        # share the wrapped server's registry by default so the funnel
        # reconciler sees both sides of the bridge in one place
        self.telemetry = (telemetry if telemetry is not None
                          else getattr(server, "telemetry", None)
                          or tele.get_default())
        self._eid = tele.new_session_id()
        self._il = {"component": "injector", "eid": self._eid}
        self._tick = 0
        self._seq = 0
        self._pending: List[_Pending] = []
        self._reserved: set = set()
        self._fired_leaf_deaths: set = set()
        self.delivered: List[Tuple[int, int]] = []  # (seq, slot) landings
        self.dropped: List[Tuple[int, str]] = []  # (seq, reason)
        # seq -> terminal ledger state ("landed" / "dropped" / "killed").
        # A submission reaches exactly one terminal state no matter how many
        # wire copies of it exist; "landed" is absorbing (a duplicate copy
        # can land AFTER the original exhausted its retries, in which case
        # the drop is retracted — see _finalize).
        self._terminal: Dict[int, str] = {}
        self._drop_reason: Dict[int, str] = {}
        # what each session ACTUALLY aggregated: version -> {slot: seq}.
        # Deliveries add entries; a leaf death removes the contributions it
        # lost.  The bit-identity tests replay exactly this record against
        # a fresh fault-free server.
        self.survivors: dict = {}

    # -- passthrough surface -------------------------------------------------
    @property
    def params(self):
        return self.server.params

    @property
    def version(self) -> int:
        return self.server.version

    @property
    def fault_metrics(self) -> dict:
        return self.server.fault_metrics

    @property
    def last_metrics(self):
        return self.server.last_metrics

    def pull(self):
        return self.server.pull()

    # -- internals -----------------------------------------------------------
    def _finalize(self, seq: int, state: str,
                  reason: Optional[str] = None) -> None:
        """Move a submission to its terminal ledger state (exactly once).

        ``landed`` is absorbing.  The one legal transition is
        dropped -> landed: the original copy exhausted its retries but a
        wire duplicate later landed, so the submission DID reach the
        aggregate — the drop is retracted (the dropped counter decrements
        under the remembered reason) before counting the landing.
        """
        prev = self._terminal.get(seq)
        if prev is not None:
            if prev == "dropped" and state == "landed":
                self.telemetry.count("dropped_contributions", -1,
                                     reason=self._drop_reason.pop(seq),
                                     **self._il)
            else:
                return
        self._terminal[seq] = state
        if state == "landed":
            self.telemetry.count("landed_contributions", **self._il)
        elif state == "killed":
            self.telemetry.count("killed_contributions", **self._il)
        else:
            self._drop_reason[seq] = reason or "unknown"
            self.telemetry.count("dropped_contributions",
                                 reason=reason or "unknown", **self._il)
        self.telemetry.gauge("in_flight_contributions",
                             self._seq - len(self._terminal), **self._il)

    def _decide(self, site: str, p: float) -> bool:
        fired = self.plan.decide(site, p)
        self.telemetry.count("fault_decisions", site=site, fired=fired,
                             **self._il)
        return fired

    def _event(self, kind: str) -> None:
        self.telemetry.count("fault_events", kind=kind, **self._il)

    def _free_slot(self) -> Optional[int]:
        for s in self.server.open_slots():
            if s not in self._reserved:
                return s
        return None

    def _is_sharded(self) -> bool:
        return hasattr(self.server, "num_leaves")

    def _maybe_kill_leaves(self, phase: str) -> None:
        if not self._is_sharded():
            return
        for event in self.plan.spec.leaf_deaths:
            ephase, ver, leaf = event
            if (ephase != phase or ver != self.server.version
                    or event in self._fired_leaf_deaths):
                continue
            if phase == "ingest":
                # a mid-ingest death only means something once the leaf has
                # ingested: wait until it holds a contribution, so the
                # event deterministically LOSES buffered work
                Bl = self.server.leaf_buffer
                if not any(self.server._present[leaf * Bl:(leaf + 1) * Bl]):
                    continue
            self._fired_leaf_deaths.add(event)
            lost = self.server.mark_leaf_dead(leaf)
            sv = self.survivors.get(self.server.version, {})
            for s in lost:
                sv.pop(s, None)
            self.plan.record("leaf_death",
                             {"phase": phase, "version": ver, "leaf": leaf,
                              "lost_slots": list(lost)})
            self._event("leaf_death")
            self._reroute_dead_leaf(leaf)

    def _reroute_dead_leaf(self, leaf: int) -> None:
        """Re-route queued (undelivered) arrivals addressed to the dead
        leaf onto surviving leaves — re-encoding, because per-slot PRF
        streams pin each encoding to its session position."""
        Bl = self.server.leaf_buffer
        for e in self._pending:
            slot = e.cp.slot if e.cp is not None else e.slot
            if slot is None or slot // Bl != leaf:
                continue
            self._reserved.discard(slot)
            if e.dup or self._terminal.get(e.seq) == "landed":
                # a duplicate copy (or a copy of an already-landed
                # submission): re-encoding it onto a live leaf would
                # double-store the delta
                self.plan.record("duplicate_noop", e.seq)
                e.ready = -1
                continue
            new = self._free_slot()
            if new is None:
                self.dropped.append((e.seq, "dead_leaf_no_capacity"))
                self.plan.record("rerouted_drop", e.seq)
                self._finalize(e.seq, "dropped", "dead_leaf_no_capacity")
                e.ready = -1  # tombstone: drained as a drop below
                continue
            self._reserved.add(new)
            if e.cp is not None:
                e.cp = self.server.encode_push(e.delta, e.client_version,
                                               slot=new)
            else:
                e.slot = new
            self.plan.record("rerouted", {"seq": e.seq, "from_leaf": leaf,
                                          "to_slot": new})
            self._event("rerouted")
        self._pending = [e for e in self._pending if e.ready != -1]

    def _deliver(self, e: _Pending, rng=None) -> None:
        self._maybe_kill_leaves("ingest")
        ver = self.server.version  # the session this delivery lands in
        slot = e.cp.slot if e.cp is not None else e.slot
        if e.cp is not None:
            ok = self.server.push_encoded(e.cp, rng)
        elif self._is_sharded():
            before = self.server.fault_metrics["duplicate_pushes"] \
                + self.server.fault_metrics["rejected_pushes"]
            self.server.push(e.delta, e.client_version, rng,
                             slots=[e.slot], push_ids=[e.push_id])
            after = self.server.fault_metrics["duplicate_pushes"] \
                + self.server.fault_metrics["rejected_pushes"]
            ok = after == before
        else:
            ok = self.server.push(e.delta, e.client_version, rng,
                                  slot=e.slot, push_id=e.push_id)
        self._reserved.discard(slot)
        if ok:
            self.delivered.append((e.seq, slot))
            self.survivors.setdefault(ver, {})[slot] = (e.seq,
                                                        e.client_version)
            self.plan.record("delivered",
                             {"seq": e.seq, "slot": slot, "version": ver})
            self._finalize(e.seq, "landed")
            return
        # rejected (stale session / closed slot) or an idempotent duplicate
        # no-op.  Duplicates are done; rejections go through capped backoff.
        # The terminal-state check covers mask_mode="client", where the
        # duplicate copy carries the encoded ClientPush token rather than
        # the raw push_id — retrying it under a fresh encoding would land
        # the same submission twice.
        if (self._terminal.get(e.seq) == "landed"
                or (e.push_id and e.push_id in getattr(
                    self.server, "_delivered_tokens", set()))):
            self.plan.record("duplicate_noop", e.seq)
            return
        if e.dup:
            # a failed wire duplicate never retries: re-encoding it would
            # give it a fresh token, able to land beside the original
            self.plan.record("duplicate_noop", e.seq)
            return
        e.attempts += 1
        if e.attempts > self.retry.max_retries:
            self.dropped.append((e.seq, "retries_exhausted"))
            self.plan.record("retry_exhausted", e.seq)
            self._finalize(e.seq, "dropped", "retries_exhausted")
            return
        new = self._free_slot()
        if new is None:
            self.dropped.append((e.seq, "no_open_slot"))
            self.plan.record("retry_no_slot", e.seq)
            self._finalize(e.seq, "dropped", "no_open_slot")
            return
        self._reserved.add(new)
        if e.cp is not None:  # re-encode against the CURRENT session —
            # this also re-derives the session's upload-compression
            # operators (sign-flip/selection PRF streams are keyed by the
            # session key, so a roll rotates them with the masks; nothing
            # about the operators is cached on the retry path)
            e.cp = self.server.encode_push(e.delta, e.client_version,
                                           slot=new)
        else:
            e.slot = new
        e.ready = self._tick + self.retry.backoff(e.attempts)
        self._pending.append(e)
        self.plan.record("retry", {"seq": e.seq, "attempt": e.attempts,
                                   "ready": e.ready})
        self._event("retry")

    def _drain(self, rng=None, deadline: bool = False) -> None:
        progressed = True
        while progressed:
            progressed = False
            for e in list(self._pending):
                if not deadline and e.ready > self._tick:
                    continue
                if deadline:
                    # the deadline collapses simulated transport time: every
                    # in-flight delivery lands now (or retries immediately)
                    e.ready = min(e.ready, self._tick)
                if e.ready > self._tick:
                    continue
                self._pending.remove(e)
                self._deliver(e, rng)
                progressed = True

    # -- the faulted push boundary -------------------------------------------
    def push(self, delta, client_version: int, rng=None) -> bool:
        """Submit one contribution through the fault schedule.

        Returns False when the plan killed the client mid-round (the delta
        never reaches the wire); True means the delivery was scheduled —
        possibly delayed, duplicated, reordered, retried or ultimately
        dropped by later faults.
        """
        self._tick += 1
        seq = self._seq
        self._seq += 1
        self.telemetry.count("submitted_contributions", **self._il)
        self.telemetry.gauge("in_flight_contributions",
                             self._seq - len(self._terminal), **self._il)
        self._maybe_kill_leaves("ingest")
        if self._decide("client_death", self.plan.spec.p_client_death):
            self.dropped.append((seq, "client_death"))
            self.plan.record("client_killed", seq)
            self._finalize(seq, "killed")
            self._drain(rng)
            return False
        slot = self._free_slot()
        if slot is None:
            # session saturated by in-flight reservations: count-and-drop
            self.dropped.append((seq, "no_open_slot"))
            self.plan.record("submit_no_slot", seq)
            self._finalize(seq, "dropped", "no_open_slot")
            self._drain(rng)
            return False
        self._reserved.add(slot)
        # push ids live in the server's token namespace; offset them far
        # from the encode-side token counter so the two never collide
        e = _Pending(seq=seq, ready=self._tick, delta=delta,
                     client_version=client_version,
                     push_id=0x100000 + seq)
        if getattr(self.server, "mask_mode", None) == "client":
            # the CLIENT half runs at submit time — the wire object is the
            # encoded ClientPush, whose slot/token pin it to the session
            e.cp = self.server.encode_push(delta, client_version, slot=slot)
        else:
            e.slot = slot
        if self._decide("delay", self.plan.spec.p_delay):
            e.ready = self._tick + self.plan.spec.delay_pushes
            self.plan.record("delayed", {"seq": seq, "ready": e.ready})
            self._event("delayed")
        self._pending.append(e)
        if self._decide("duplicate", self.plan.spec.p_duplicate):
            dup = _Pending(seq=seq, ready=e.ready, delta=delta,
                           client_version=client_version, cp=e.cp,
                           slot=e.slot, push_id=e.push_id, dup=True)
            self._pending.append(dup)
            self.plan.record("duplicated", seq)
            self._event("duplicated")
        if (self._decide("reorder", self.plan.spec.p_reorder)
                and len(self._pending) >= 2):
            self._pending[-1], self._pending[-2] = (self._pending[-2],
                                                    self._pending[-1])
            self.plan.record("reordered", seq)
            self._event("reordered")
        self._drain(rng)
        return True

    def flush(self, rng=None, force: bool = False) -> bool:
        """The deadline: every in-flight delivery lands (delayed pushes
        arrive at the deadline, stale ones retry or drop), scheduled
        mid-flush leaf deaths fire, then the server's quorum flush runs.
        Returns True when the deadline released at least one params update
        (counting sessions the landing arrivals completed themselves)."""
        before = self.server.fault_metrics["released_updates"]
        with self.telemetry.span("injector.flush", forced=force, **self._il):
            self._drain(rng, deadline=True)
            self._maybe_kill_leaves("flush")
            self._drain(rng, deadline=True)  # re-routed arrivals land
            flushed = self.server.flush(rng, force=force)
        self.telemetry.gauge("in_flight_contributions",
                             self._seq - len(self._terminal), **self._il)
        return flushed or self.server.fault_metrics["released_updates"] > before
