"""Synthetic device population — the fleet the control plane orchestrates.

Models the resource heterogeneity the paper's eligibility heuristics guard
against: battery level, charging, network type, free storage, app version
(slow release cycles: versions follow a long-tailed adoption curve) and
device speed (for the async-FL wall-clock simulation).

The port's own copy of ``repro.core.device_sim`` (numpy only): the
port imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class DeviceState:
    device_id: int
    app_version: int
    battery: float  # 0..1
    charging: bool
    on_wifi: bool
    storage_free_mb: float
    speed: float  # local-train seconds for one round
    last_participation_round: int = -(10 ** 9)
    alive: bool = True  # comes and goes (connectivity)
    tz_offset: int = 0  # timezone, hours east of UTC (diurnal waves)


@dataclass(frozen=True)
class ChurnModel:
    """Fleet availability dynamics beyond the legacy i.i.d. 5% blip.

    Connectivity is a sticky two-state (online/offline) Markov process:
    ``p_offline`` is P(online -> offline) per round and ``p_online`` is
    P(offline -> online) per round, so the mean outage lasts
    ``1 / p_online`` rounds and the stationary offline fraction is
    ``p_offline / (p_offline + p_online)``.  The defaults (0.05 / 0.95)
    reproduce today's marginal rate with near-memoryless outages.

    ``speed_tiers`` partitions the fleet into hardware tiers — a tuple of
    ``(speed_multiplier, population_fraction)`` pairs (fractions need not
    sum to 1; the remainder keeps the base lognormal speed).  A diurnal
    wave (``diurnal_amplitude`` > 0) modulates the transition rates by each
    device's local hour — fewest devices online at local night, per the
    paper's observation that charging+idle devices cluster overnight — with
    ``round_hours`` simulated hours elapsing per round and timezones spread
    over the fleet.  ``charging_bias`` > 0 makes charging+wifi devices
    proportionally stickier online (and weights them higher in the
    async arrival process).
    """

    p_offline: float = 0.05
    p_online: float = 0.95
    speed_tiers: Tuple[Tuple[float, float], ...] = ()
    diurnal_amplitude: float = 0.0
    round_hours: float = 0.0
    charging_bias: float = 0.0

    def __post_init__(self):
        if not 0.0 < self.p_online <= 1.0 or not 0.0 <= self.p_offline <= 1.0:
            raise ValueError(
                f"churn rates are per-round transition probabilities; got "
                f"p_offline={self.p_offline}, p_online={self.p_online}.")
        if not 0.0 <= self.diurnal_amplitude < 1.0:
            raise ValueError(
                f"diurnal_amplitude in [0, 1): got {self.diurnal_amplitude}")

    @property
    def stationary_offline(self) -> float:
        return self.p_offline / (self.p_offline + self.p_online)

    def _availability(self, d: DeviceState, hour: float) -> float:
        """Multiplier in (0, 1+bias] on the online-transition rate."""
        a = 1.0
        if self.diurnal_amplitude > 0.0:
            local = (hour + d.tz_offset) % 24.0
            # 1 at local noon, 1 - amplitude at local midnight
            wave = 0.5 * (1.0 - math.cos(2.0 * math.pi * local / 24.0))
            a *= 1.0 - self.diurnal_amplitude * (1.0 - wave)
        if self.charging_bias > 0.0 and d.charging and d.on_wifi:
            a *= 1.0 + self.charging_bias
        return a

    @classmethod
    def profile(cls, name: str) -> "ChurnModel":
        """Named fleet profiles used by tests and bench_churn."""
        if name == "uniform":
            return cls()
        if name == "diurnal":
            # timezone waves + slow hardware tail + charging-biased arrivals
            return cls(p_offline=0.08, p_online=0.5,
                       speed_tiers=((3.0, 0.3), (0.5, 0.2)),
                       diurnal_amplitude=0.8, round_hours=2.0,
                       charging_bias=1.0)
        if name == "flaky":
            # sticky multi-round outages: same 10% stationary offline mass
            # as p_offline=0.05/p_online=0.45, but outages last ~5 rounds
            return cls(p_offline=0.02, p_online=0.2,
                       speed_tiers=((2.0, 0.5),))
        raise ValueError(f"unknown churn profile {name!r} "
                         f"(want uniform | diurnal | flaky)")


class DevicePopulation:
    """N simulated devices with an evolving resource state."""

    def __init__(self, n: int, seed: int = 0, latest_app_version: int = 10,
                 churn: Optional[ChurnModel] = None):
        self.rs = np.random.RandomState(seed)
        self.latest_app_version = latest_app_version
        self.churn = churn
        self.round = 0
        # long-tailed version adoption: most on recent, a tail far behind
        versions = latest_app_version - self.rs.geometric(p=0.45, size=n).clip(1, 9)
        self.devices: List[DeviceState] = [
            DeviceState(
                device_id=i,
                app_version=int(versions[i]),
                battery=float(self.rs.uniform(0.05, 1.0)),
                charging=bool(self.rs.uniform() < 0.3),
                on_wifi=bool(self.rs.uniform() < 0.6),
                storage_free_mb=float(self.rs.lognormal(6.0, 1.0)),
                speed=float(np.exp(self.rs.normal(2.5, 0.8))),
            )
            for i in range(n)
        ]
        if churn is not None:
            # churn-specific state draws come from a SEPARATE stream so the
            # legacy (churn=None) trajectory is bit-identical for a given
            # seed — the main ``rs`` stream is consumed the same either way.
            crs = np.random.RandomState((seed ^ 0x5EED) & 0x7FFFFFFF)
            tz = crs.randint(0, 24, size=n)
            for d in self.devices:
                d.tz_offset = int(tz[d.device_id])
            if churn.speed_tiers:
                u = crs.uniform(size=n)
                lo = 0.0
                for mult, frac in churn.speed_tiers:
                    hi = lo + frac
                    for d in self.devices:
                        if lo <= u[d.device_id] < hi:
                            d.speed *= mult
                    lo = hi

    def __len__(self) -> int:
        return len(self.devices)

    @property
    def hour(self) -> float:
        """Simulated world-clock hour (diurnal phase)."""
        rh = self.churn.round_hours if self.churn is not None else 0.0
        return self.round * rh

    def step(self) -> None:
        """Advance one round of world time: battery drain/charge, churn."""
        churn = self.churn
        p_off = churn.p_offline if churn is not None else 0.05
        p_on = churn.p_online if churn is not None else 0.95
        hour = self.hour
        for d in self.devices:
            if d.charging:
                d.battery = min(1.0, d.battery + self.rs.uniform(0.0, 0.2))
                if d.battery > 0.95 and self.rs.uniform() < 0.5:
                    d.charging = False
            else:
                d.battery = max(0.0, d.battery - self.rs.uniform(0.0, 0.1))
                if d.battery < 0.3 and self.rs.uniform() < 0.4:
                    d.charging = True
            if self.rs.uniform() < 0.1:
                d.on_wifi = not d.on_wifi
            # sticky two-state connectivity: ONE uniform draw per device
            # whichever state it is in, so the defaults (0.05/0.95) replay
            # the legacy i.i.d. ``u > 0.05`` stream bit-for-bit.
            if churn is not None and (churn.diurnal_amplitude > 0.0
                                      or churn.charging_bias > 0.0):
                a = churn._availability(d, hour)
                eff_on = min(1.0, p_on * a)
                eff_off = min(1.0, p_off / max(a, 1e-9))
            else:
                eff_on, eff_off = p_on, p_off
            thresh = eff_off if d.alive else 1.0 - eff_on
            d.alive = self.rs.uniform() > thresh
            if self.rs.uniform() < 0.02 and d.app_version < self.latest_app_version:
                d.app_version += 1  # slow trickle of app updates
        self.round += 1

    def availability_weight(self, d: DeviceState) -> float:
        """Relative arrival rate of ``d`` in the async event loop (>= 0)."""
        if not d.alive:
            return 0.0
        if self.churn is None:
            return 1.0
        return self.churn._availability(d, self.hour)

    def sample(self, k: int) -> List[DeviceState]:
        idx = self.rs.choice(len(self.devices), size=min(k, len(self.devices)),
                             replace=False)
        return [self.devices[i] for i in idx]


def midround_dropout_prob(device: DeviceState, base_rate: float) -> float:
    """Probability that ``device`` dies mid-round (kills its upload).

    The paper's eligibility heuristics select charging/wifi devices exactly
    because the others abandon rounds: low uncharged battery doubles the
    base rate, cellular adds half again, and a device already offline never
    delivers.  Drives ``simulate_training(dropout_rate=..., devices=...)``
    and, under masked secure aggregation, the dropout-recovery path.
    """
    if not device.alive:
        return 1.0
    p = base_rate
    if device.battery < 0.2 and not device.charging:
        p *= 2.0
    if not device.on_wifi:
        p *= 1.5
    return min(p, 1.0)
