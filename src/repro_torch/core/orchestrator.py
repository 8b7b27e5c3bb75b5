"""Orchestrator — coordinates everything on device outside local training.

Paper tasks: (1) scheduling, (2) eligibility checks, (3) server-to-device
data-flow init, (4) sample-submission control (label balancing), and
(5) funnel logging / perf metrics.  Plus the server-side metadata store the
devices consult (eligibility criteria, model version, label stats, transform
specs, data purpose).

Port of ``repro.core.orchestrator`` over the port's telemetry, funnel
logging, device simulator, label balancing and signal transformer, with the
same counter and span names.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import telemetry as tele
from repro_torch.core.analytics.label_balance import (DropoffPolicy,
                                                     policy_from_ratio)
from repro_torch.core.device_sim import DevicePopulation, DeviceState
from repro_torch.core.funnel_logging import FunnelLogger, new_session_id
from repro_torch.core.signal_transformer import TransformSpec

FUNNEL_PHASES = [
    "scheduled", "eligibility", "data_init", "feature_extraction",
    "training", "submission",
]


@dataclass(frozen=True)
class EligibilityCriteria:
    """Served as metadata; verified ON DEVICE (never with uploaded state)."""

    min_battery: float = 0.4
    require_charging: bool = True
    require_wifi: bool = True
    min_app_version: int = 0
    min_storage_mb: float = 200.0
    cooldown_rounds: int = 5  # participation rate-limit per device


class MetadataStore:
    """Server-side data/metadata serving endpoints (untrusted zone —
    holds only aggregates and configuration, never user data)."""

    def __init__(self):
        self._kv: Dict[str, Any] = {
            "model_version": 0,
            "eligibility": EligibilityCriteria(),
            "label_pos_ratio": None,  # refreshed from federated analytics
            "normalization": None,
            "transform_spec": None,
            "purpose": "fl-training",
        }

    def get(self, key: str) -> Any:
        return self._kv[key]

    def put(self, key: str, value: Any) -> None:
        self._kv[key] = value


class CohortSelection(List[DeviceState]):
    """The selected cohort, plus the selection funnel's bottom line.

    Behaves exactly like the list of participants it always was; the extra
    attributes surface under-full cohorts instead of hiding them:
    ``shortfall`` is how many participants short of ``requested`` the round
    starts, and ``eligibility_rate`` is the measured pass rate the adaptive
    over-selection feeds on.
    """

    requested: int = 0
    shortfall: int = 0
    over_select_used: float = 0.0
    eligibility_rate: float = 1.0


class Orchestrator:
    def __init__(self, population: DevicePopulation, metadata: MetadataStore,
                 logger: Optional[FunnelLogger] = None, seed: int = 0,
                 telemetry: Optional["tele.Telemetry"] = None):
        self.population = population
        self.metadata = metadata
        self.logger = logger or FunnelLogger(FUNNEL_PHASES)
        self.telemetry = (telemetry if telemetry is not None
                          else tele.get_default())
        self._eid = new_session_id()
        self._ol = {"component": "orchestrator", "eid": self._eid}
        self.rs = np.random.RandomState(seed)
        self.round_idx = 0
        # trailing per-round eligibility pass rates -> adaptive over_select
        self._eligibility_rates: deque = deque(maxlen=8)

    # --- eligibility (the carefully crafted heuristics) --------------------
    def check_eligibility(self, d: DeviceState,
                          c: Optional[EligibilityCriteria] = None) -> Tuple[bool, str]:
        c = c or self.metadata.get("eligibility")
        if not d.alive:
            return False, "offline"
        if d.battery < c.min_battery:
            return False, "battery"
        if c.require_charging and not d.charging:
            return False, "not_charging"
        if c.require_wifi and not d.on_wifi:
            return False, "no_wifi"
        if d.app_version < c.min_app_version:
            return False, "app_version"
        if d.storage_free_mb < c.min_storage_mb:
            return False, "storage"
        if self.round_idx - d.last_participation_round < c.cooldown_rounds:
            return False, "cooldown"
        return True, "ok"

    # --- cohort selection ---------------------------------------------------
    def _adaptive_over_select(self) -> float:
        """Over-selection factor from the measured eligibility drop-off.

        First round (no history) keeps the legacy 2.0x.  After that, invert
        the trailing mean pass rate with a 25% safety margin, clamped so a
        dead fleet can't demand an unbounded candidate scan.
        """
        if not self._eligibility_rates:
            return 2.0
        rate = sum(self._eligibility_rates) / len(self._eligibility_rates)
        return float(np.clip(1.25 / max(rate, 1e-3), 1.2, 8.0))

    def select_cohort(self, cohort_size: int,
                      over_select: Optional[float] = None) -> CohortSelection:
        """Schedule candidates, run on-device checks, return participants.

        ``over_select=None`` (the default) adapts the candidate multiplier
        to the eligibility drop-off measured over recent rounds; passing a
        float pins it.  Under-full cohorts are SURFACED, not hidden: the
        returned :class:`CohortSelection` carries the shortfall and the
        round is funnel-logged with a ``cohort_shortfall`` failure entry.
        """
        if over_select is None:
            over_select = self._adaptive_over_select()
        tel = self.telemetry
        with tel.span("cohort_select", round=self.round_idx, **self._ol):
            candidates = self.population.sample(int(cohort_size * over_select))
            cohort = CohortSelection()
            checked = eligible = 0
            for d in candidates:
                sid = new_session_id()
                self.logger.log(sid, "scheduled", "selected", True)
                ok, reason = self.check_eligibility(d)
                self.logger.log(sid, "eligibility", reason, ok)
                checked += 1
                tel.count("cohort_checked", **self._ol)
                if not ok:
                    tel.count("cohort_ineligible", reason=reason, **self._ol)
                    continue
                eligible += 1
                tel.count("cohort_eligible", **self._ol)
                self.logger.log(sid, "data_init", "metadata_fetch", True)
                cohort.append(d)
                if len(cohort) >= cohort_size:
                    break
            rate = eligible / checked if checked else 0.0
            self._eligibility_rates.append(rate)
            cohort.requested = int(cohort_size)
            cohort.shortfall = max(0, cohort_size - len(cohort))
            cohort.over_select_used = float(over_select)
            cohort.eligibility_rate = rate
            tel.gauge("eligibility_rate", rate, **self._ol)
            tel.gauge("over_select_factor", float(over_select), **self._ol)
            if cohort.shortfall > 0:
                tel.count("cohort_shortfall", cohort.shortfall, **self._ol)
                self.logger.log(
                    new_session_id(), "scheduled", "cohort_shortfall", False,
                    detail=f"short={cohort.shortfall}/{cohort_size} "
                           f"pass_rate={rate:.2f} "
                           f"over_select={over_select:.2f}")
        return cohort

    # --- sample submission control (label balancing) ------------------------
    def submission_policy(self, target_pos_ratio: float = 0.5) -> DropoffPolicy:
        """Drop-off rate from the MOST RECENT FA label-ratio estimate."""
        ratio = self.metadata.get("label_pos_ratio")
        if ratio is None:
            return DropoffPolicy(1.0, 1.0, 0.5)  # no FA estimate yet: keep all
        return policy_from_ratio(float(ratio), target_pos_ratio)

    def control_submission(self, label: int, policy: DropoffPolicy) -> bool:
        keep_p = float(policy.keep_pos if label == 1 else policy.keep_neg)
        return bool(self.rs.uniform() < keep_p)

    # --- round bookkeeping ---------------------------------------------------
    def finish_round(self, participants: List[DeviceState]) -> None:
        for d in participants:
            d.last_participation_round = self.round_idx
        self.round_idx += 1
        self.population.step()

    def push_transform_spec(self, spec: TransformSpec) -> None:
        """Server push without an app release (TorchScript analogue)."""
        current = self.metadata.get("transform_spec")
        if current is not None and spec.version <= current.version:
            raise ValueError("transform spec versions must increase")
        self.metadata.put("transform_spec", spec)
