"""De-identified funnel logging (paper §Logging).

Dataflow is divided into PHASES, each into STEPS.  The conservation invariant
the paper uses for debugging: successful + failed step outcomes of phase k
must add up to the successes of phase k-1.  Events carry only an ephemeral
session id (random, unlinkable to a user) — never a device/user identifier.

The port's own copy of ``repro.core.funnel_logging`` (the port imports
nothing of the JAX package).
"""
from __future__ import annotations

import re
import secrets
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


def new_session_id() -> str:
    """Ephemeral random id, regenerated per product-surface session."""
    return secrets.token_hex(8)


@dataclass(frozen=True)
class FunnelEvent:
    session_id: str
    phase: str
    step: str
    success: bool
    detail: str = ""  # must never contain identifying information


_FORBIDDEN_KEYS = ("device_id", "user", "email", "phone", "label", "feature")

# Value-shaped identifiers the key scan cannot catch: a detail string (or a
# telemetry label value) that never says "email" can still CONTAIN one.
_VALUE_PATTERNS = (
    (re.compile(r"[\w.+-]+@[\w-]+\.[\w.-]{2,}"), "an email-shaped token"),
    (re.compile(r"\d{9,}"), "a long digit run (phone/IMEI-shaped)"),
)

# Label keys sanctioned to carry an EPHEMERAL random id (new_session_id()):
# unlinkable to a user by construction, and the only identifier-shaped value
# allowed through the de-identification gate.
_EPHEMERAL_LABEL_KEYS = frozenset({"sid", "eid", "session", "session_id"})


def pii_violation(text: str) -> Optional[str]:
    """Why ``text`` may not be logged/exported, or None if it is clean.

    Guards both dimensions of the paper's de-identification contract: the
    forbidden KEY vocabulary (a record must not even talk about device ids,
    users, labels or features) and identifier-shaped VALUES (emails, long
    digit runs) that a key scan alone would miss.
    """
    low = text.lower()
    for bad in _FORBIDDEN_KEYS:
        if bad in low:
            return f"mentions {bad!r}"
    for pat, what in _VALUE_PATTERNS:
        if pat.search(text):
            return f"contains {what}"
    return None


def scrub_label(key: str, value) -> None:
    """De-identification gate for one telemetry/span label.

    Raises ``ValueError`` when either the label key or a string value trips
    :func:`pii_violation`.  Keys in ``_EPHEMERAL_LABEL_KEYS`` may carry
    ephemeral random ids (hex tokens), so their VALUES are exempt — the key
    itself is still checked.
    """
    bad = pii_violation(key)
    if bad is not None:
        raise ValueError(
            f"privacy violation: label key {key!r} {bad} — logging of "
            "identifying information is forbidden")
    if isinstance(value, str) and key not in _EPHEMERAL_LABEL_KEYS:
        bad = pii_violation(value)
        if bad is not None:
            raise ValueError(
                f"privacy violation: label {key}={value!r} {bad} — logging "
                "of identifying information is forbidden")


class FunnelLogger:
    """Server-side sink of de-identified events + integrity checking."""

    def __init__(self, phases: List[str]):
        self.phases = list(phases)
        self.events: List[FunnelEvent] = []
        self._dedup: set = set()

    def log(self, session_id: str, phase: str, step: str, success: bool,
            detail: str = "") -> None:
        if phase not in self.phases:
            raise ValueError(f"unknown phase {phase!r}")
        bad = pii_violation(detail)
        if bad is not None:
            raise ValueError(
                f"privacy violation: detail {bad} — logging of "
                "identifying information is forbidden")
        key = (session_id, phase, step)
        if key in self._dedup:  # session-scoped dedup across use cases
            return
        self._dedup.add(key)
        self.events.append(FunnelEvent(session_id, phase, step, success, detail))

    # --- analysis ---------------------------------------------------------
    def counts(self) -> Dict[str, Dict[str, int]]:
        out: Dict[str, Dict[str, int]] = {
            p: {"success": 0, "failure": 0} for p in self.phases}
        for e in self.events:
            out[e.phase]["success" if e.success else "failure"] += 1
        return out

    def dropoff_report(self) -> List[Tuple[str, int, int, float]]:
        """(phase, entered, succeeded, drop_rate) per phase, in order."""
        c = self.counts()
        report = []
        prev_success: Optional[int] = None
        for p in self.phases:
            entered = c[p]["success"] + c[p]["failure"]
            ok = c[p]["success"]
            rate = 0.0 if entered == 0 else 1.0 - ok / entered
            report.append((p, entered, ok, rate))
            prev_success = ok
        return report

    def check_conservation(self) -> List[str]:
        """Funnel integrity: phase k entries == phase k-1 successes."""
        problems = []
        c = self.counts()
        for prev, cur in zip(self.phases[:-1], self.phases[1:]):
            entered = c[cur]["success"] + c[cur]["failure"]
            if entered > c[prev]["success"]:
                problems.append(
                    f"phase {cur!r} saw {entered} entries but {prev!r} only "
                    f"succeeded {c[prev]['success']} times")
        return problems
