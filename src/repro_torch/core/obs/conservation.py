"""Funnel conservation over the telemetry registry — machine-checked.

The paper's §Logging debugging principle (phase-k entries must equal
phase-(k-1) successes) generalized to the whole push funnel, including
under a :class:`~repro_torch.core.fl.faults.FaultPlan`.  The ledger,
counted at submission (seq) granularity:

  submitted = killed + dropped + landed + in_flight        (injector)
  landed    = stored                                        (bridge)
  stored    = aggregated + lost + buffered                  (engine)

so every pushed contribution is accounted exactly once as aggregated,
dropped (stale / retries exhausted / no capacity / lost with a dead
leaf), killed, or deferred (still in flight or buffered) — and the
headline identity

  submitted = aggregated + (dropped + lost) + killed + (in_flight + buffered)

follows.  Duplicate deliveries and per-attempt rejections are idempotent
no-ops at the engine boundary (they never consume a submission), so they
appear in the report as attempt-level counters, not ledger classes.
``aggregated`` cross-checks the engine's decode count
(``server._applied_updates``) when the caller passes it.

The port's copy of ``repro.core.obs.conservation``, reading the port's
telemetry registry; its reports equal the reference's on the same ledger.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.telemetry import Telemetry


@dataclass
class ConservationReport:
    """The reconciled push-funnel ledger (totals over all label sets)."""

    totals: Dict[str, float] = field(default_factory=dict)
    problems: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.problems


def reconcile(tel: Telemetry,
              applied_updates: Optional[int] = None,
              check_bridge: bool = True) -> ConservationReport:
    """Check funnel conservation over everything ``tel`` recorded.

    ``applied_updates`` (the engine's ``_applied_updates`` decode count)
    adds the exact cross-check between the telemetry ledger and the jitted
    engine's own accounting.  ``check_bridge=False`` skips the
    landed == stored identity for registries where an injector coexists
    with direct (uninjected) server traffic.
    """
    t = {
        "submitted": tel.total("submitted_contributions"),
        "killed": tel.total("killed_contributions"),
        "dropped": tel.total("dropped_contributions"),
        "landed": tel.total("landed_contributions"),
        "in_flight": tel.gauge_total("in_flight_contributions"),
        "stored": tel.total("stored_contributions"),
        "aggregated": tel.total("aggregated_contributions"),
        "lost": tel.total("lost_contributions"),
        "buffered": tel.gauge_total("buffered_contributions"),
        # attempt-level no-ops (informational, not ledger classes)
        "duplicates": tel.total("duplicate_pushes"),
        "rejected": tel.total("rejected_pushes"),
        "deferrals": tel.total("subquorum_deferrals"),
        "releases": tel.total("released_updates"),
    }
    problems: List[str] = []

    def check(label: str, lhs: float, rhs: float) -> None:
        if lhs != rhs:
            problems.append(f"{label}: {lhs} != {rhs}")

    check("engine: stored == aggregated + lost + buffered",
          t["stored"], t["aggregated"] + t["lost"] + t["buffered"])
    if t["submitted"]:
        check("injector: submitted == killed + dropped + landed + in_flight",
              t["submitted"],
              t["killed"] + t["dropped"] + t["landed"] + t["in_flight"])
        if check_bridge:
            check("bridge: landed == stored", t["landed"], t["stored"])
            check("headline: submitted == aggregated + (dropped + lost) + "
                  "killed + (in_flight + buffered)",
                  t["submitted"],
                  t["aggregated"] + t["dropped"] + t["lost"] + t["killed"]
                  + t["in_flight"] + t["buffered"])
    if applied_updates is not None:
        check("decode count: aggregated == server._applied_updates",
              t["aggregated"], float(applied_updates))
    return ConservationReport(totals=t, problems=problems)
