"""Observability exporters + the funnel-conservation reconciler.

Everything here consumes a :class:`repro_torch.core.telemetry.Telemetry`
snapshot; nothing re-validates privacy because the registry's record-time
de-identification gate already did.  The port's copy of
``repro.core.obs``: the same outputs, byte for byte, on the same ledger.
"""
from repro_torch.core.obs.conservation import ConservationReport, reconcile
from repro_torch.core.obs.export import (chrome_trace, prometheus_text,
                                   write_chrome_trace, write_prometheus,
                                   write_round_csv)

__all__ = [
    "ConservationReport", "reconcile", "chrome_trace", "prometheus_text",
    "write_chrome_trace", "write_prometheus", "write_round_csv",
]
