"""Telemetry exporters: Chrome trace-event JSON, Prometheus text, round CSV.

  * :func:`chrome_trace` — the Trace Event Format dict Perfetto /
    chrome://tracing load directly ("X" complete events; nesting is by
    time containment on one track, which holds because spans are
    synchronous and properly nested).
  * :func:`prometheus_text` — the text exposition format (counters,
    gauges, cumulative ``_bucket``/``_sum``/``_count`` histograms).
  * :func:`write_round_csv` — per-round span summaries in the repo's tidy
    CSV shape (one row per (round, span-name)).
"""
from __future__ import annotations

import csv
import json
import re
from typing import Any, Dict, List, Tuple

from repro_torch.core.telemetry import Telemetry

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    n = _NAME_RE.sub("_", name)
    return n if not n[:1].isdigit() else "_" + n


def _prom_labels(labels: Tuple[Tuple[str, Any], ...], extra: str = "") -> str:
    parts = [f'{_prom_name(k)}="{v}"' for k, v in labels]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def chrome_trace(tel: Telemetry) -> Dict[str, Any]:
    """The spans as a Chrome Trace Event Format object (Perfetto-loadable).

    Timestamps are microseconds since the registry epoch (monotonic clock).
    Span labels travel in ``args`` — already de-identified at record time.
    """
    events: List[Dict[str, Any]] = [
        {"name": "process_name", "ph": "M", "pid": 1,
         "args": {"name": f"federation sid={tel.session_id}"}},
        {"name": "thread_name", "ph": "M", "pid": 1, "tid": 1,
         "args": {"name": "spans"}},
    ]
    for s in tel.spans:
        events.append({
            "name": s.name, "cat": "span", "ph": "X", "pid": 1, "tid": 1,
            "ts": s.t0_ns / 1e3, "dur": s.dur_ns / 1e3,
            "args": {**{str(k): v for k, v in s.labels.items()},
                     "sid": s.sid,
                     **({"parent": s.parent} if s.parent is not None
                        else {})},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"session": tel.session_id}}


def write_chrome_trace(tel: Telemetry, path: str) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(tel), f)


def prometheus_text(tel: Telemetry) -> str:
    """Counters + gauges + histograms in the Prometheus text exposition
    format (one ``# TYPE`` header per family, series sorted for stable
    diffs)."""
    by_family: Dict[str, List[str]] = {}

    def fam(name: str, kind: str) -> List[str]:
        pn = _prom_name(name)
        return by_family.setdefault(f"# TYPE {pn} {kind}", [])

    for (name, labels), v in sorted(tel.counters().items()):
        fam(name, "counter").append(
            f"{_prom_name(name)}{_prom_labels(labels)} {v}")
    for (name, labels), v in sorted(tel.gauges().items()):
        fam(name, "gauge").append(
            f"{_prom_name(name)}{_prom_labels(labels)} {v}")
    for (name, labels), h in sorted(tel.histograms().items()):
        pn = _prom_name(name)
        lines = fam(name, "histogram")
        cum = 0
        for bound, c in zip(h.bounds, h.counts):
            cum += c
            le = 'le="%g"' % bound
            lines.append(f"{pn}_bucket{_prom_labels(labels, le)} {cum}")
        inf = 'le="+Inf"'
        lines.append(f"{pn}_bucket{_prom_labels(labels, inf)} {h.n}")
        lines.append(f"{pn}_sum{_prom_labels(labels)} {h.total}")
        lines.append(f"{pn}_count{_prom_labels(labels)} {h.n}")
    out: List[str] = []
    for header in sorted(by_family):
        out.append(header)
        out.extend(by_family[header])
    return "\n".join(out) + "\n"


def write_prometheus(tel: Telemetry, path: str) -> None:
    with open(path, "w") as f:
        f.write(prometheus_text(tel))


def write_round_csv(tel: Telemetry, path: str) -> int:
    """Per-round span summaries: one row per (round, span name) with call
    count and total/max duration.  Spans without a ``round`` label land in
    round="" (setup work, cohort selection before the first round).
    Returns the number of rows written."""
    agg: Dict[Tuple[Any, str], List[float]] = {}
    for s in tel.spans:
        key = (s.labels.get("round", ""), s.name)
        row = agg.setdefault(key, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += s.dur_ns
        row[2] = max(row[2], s.dur_ns)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["round", "span", "calls", "total_ms", "max_ms"])
        for (rnd, name), (calls, tot, mx) in sorted(
                agg.items(), key=lambda kv: (str(kv[0][0]), kv[0][1])):
            w.writerow([rnd, name, calls,
                        f"{tot / 1e6:.3f}", f"{mx / 1e6:.3f}"])
    return len(agg)
