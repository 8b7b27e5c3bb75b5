"""Privacy-aware telemetry spine: counters, gauges, histograms and spans.

One process-wide :class:`Telemetry` registry replaces per-subsystem
counter islands (``fault_metrics`` dicts, bench-local timers, funnel print
logs).  Everything the federation wants to
observe flows through here:

  * **counters / gauges / histograms** — ``count()``, ``gauge()``,
    ``observe()``; histograms use fixed bucket layouts so two processes
    exporting the same metric are mergeable.
  * **spans** — monotonic-clock ``with tel.span("flush", round=r):``
    context managers with parent/child nesting and an optional device
    fence (``sp.fence(out)``, a ``torch.cuda.synchronize`` when the value
    holds CUDA tensors) so asynchronously launched kernels are attributed
    to the span that launched them.
  * **the de-identification gate** — every label key and string value
    passes :func:`repro_torch.core.funnel_logging.scrub_label` (the paper's
    §Logging contract): forbidden key vocabulary AND identifier-shaped
    values are rejected at RECORD time, so no exporter can widen the
    privacy boundary.  The only identifier a record may carry is an
    ephemeral random id (``new_session_id()``) under a sanctioned label
    key (``eid`` / ``sid``).

The default process registry (``get_default()``) records counters and
gauges but NOT spans — engines stay observable at dict-increment cost
until a caller opts into tracing with
``Telemetry(record_spans=True)`` (or ``set_default``).  This is the
port's copy of ``repro.core.telemetry``: the engines emit the same counter
and span names at the same seams.
"""
from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Mapping, MutableMapping, \
    Optional, Tuple

from repro_torch.core.funnel_logging import _EPHEMERAL_LABEL_KEYS, \
    new_session_id, scrub_label

__all__ = [
    "Telemetry", "SpanRecord", "TelemetryCounterView",
    "DURATION_BUCKETS_S", "SIZE_BUCKETS", "get_default", "set_default",
    "stage_spans",
]

# Fixed bucket layouts (histogram upper bounds).  Geometric, so one layout
# spans PRF-mask microseconds to straggler-tail seconds; FIXED, so exports
# from different runs / processes line up bucket-for-bucket.
DURATION_BUCKETS_S: Tuple[float, ...] = tuple(
    1e-6 * 4.0 ** i for i in range(13))  # 1us .. ~67s
SIZE_BUCKETS: Tuple[float, ...] = tuple(
    float(4 ** i) for i in range(12))  # 1 .. ~4.2M (counts / bytes / rows)


def _label_key(labels: Mapping[str, Any]) -> Tuple[Tuple[str, Any], ...]:
    return tuple(sorted(labels.items()))


@dataclass
class SpanRecord:
    """One completed span (times from ``time.perf_counter_ns``; Unix time
    of the start: the registry's ``epoch_unix_ns + t0_ns``)."""

    name: str
    sid: int  # per-registry span id
    parent: Optional[int]  # enclosing span's sid (None at top level)
    t0_ns: int  # start, relative to the registry's epoch
    dur_ns: int
    labels: Dict[str, Any] = field(default_factory=dict)


class _Hist:
    __slots__ = ("bounds", "counts", "total", "n")

    def __init__(self, bounds: Tuple[float, ...]):
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # +1: the +Inf bucket
        self.total = 0.0
        self.n = 0

    def observe(self, value: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, value)] += 1
        self.total += value
        self.n += 1


class _NullSpan:
    """Shared no-op context manager: the no-op recorder's span cost."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def fence(self, value) -> None:
        pass


_NULL_SPAN = _NullSpan()


def _no_span(name: str, **labels):
    return _NULL_SPAN


def _holds_cuda(value) -> bool:
    if isinstance(value, dict):
        return any(_holds_cuda(v) for v in value.values())
    if isinstance(value, (tuple, list)):
        return any(_holds_cuda(v) for v in value)
    return getattr(getattr(value, "device", None), "type", None) == "cuda"


def _block_until_ready(value) -> None:
    """Device fence: wait for the card when ``value`` holds CUDA tensors
    (no-op for CPU tensors and non-tensor values)."""
    if _holds_cuda(value):
        import torch

        torch.cuda.synchronize()


class _Span:
    __slots__ = ("_tel", "name", "labels", "sid", "parent", "_t0", "_fence")

    def __init__(self, tel: "Telemetry", name: str,
                 labels: Dict[str, Any]):
        self._tel = tel
        self.name = name
        self.labels = labels
        self._fence = None

    def fence(self, value) -> None:
        """Block on ``value`` (a device synchronise) before the span
        closes, when the registry has fencing on — device work launched by
        the span is then attributed to it instead of to whoever touches the
        result next."""
        self._fence = value

    def __enter__(self):
        tel = self._tel
        self.parent = tel._stack[-1] if tel._stack else None
        self.sid = tel._next_sid
        tel._next_sid += 1
        tel._stack.append(self.sid)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._fence is not None and self._tel.fence:
            _block_until_ready(self._fence)
        dur = time.perf_counter_ns() - self._t0
        tel = self._tel
        if tel._stack and tel._stack[-1] == self.sid:
            tel._stack.pop()
        tel._finish_span(self, dur)
        return False


class Telemetry:
    """The process-wide metrics + span registry.

    ``record_spans=False`` is the no-op recorder for the tracing side:
    ``span()`` returns a shared null context manager (no clock reads, no
    allocation) while counters/gauges/histograms still record — they are
    load-bearing engine state (quorum deferrals, duplicate idempotence),
    not optional diagnostics.  ``fence=True`` makes ``sp.fence(x)`` block
    on device work at span exit (honest attribution; off by default so
    tracing never changes the engines' async dispatch behaviour).
    """

    def __init__(self, record_spans: bool = True, fence: bool = False,
                 max_spans: int = 200_000):
        self.session_id = new_session_id()  # ephemeral, per paper §Logging
        self.record_spans = record_spans
        self.fence = fence
        self.max_spans = max_spans
        self.epoch_ns = time.perf_counter_ns()
        # the epoch on the Unix clock: a span starts at ``epoch_unix_ns +
        # t0_ns``, which places it on a device trace's clock
        self.epoch_unix_ns = time.time_ns()
        self.spans: List[SpanRecord] = []
        self._stack: List[int] = []
        self._next_sid = 0
        self._counters: Dict[Tuple[str, tuple], float] = {}
        self._gauges: Dict[Tuple[str, tuple], float] = {}
        self._hists: Dict[Tuple[str, tuple], _Hist] = {}
        self._hist_bounds: Dict[str, Tuple[float, ...]] = {}
        # scrub caches: a label key / string value is validated once
        self._ok_keys: set = set()
        self._ok_vals: set = set()

    # -- the de-identification gate -----------------------------------------
    def _check_labels(self, labels: Mapping[str, Any]) -> None:
        for k, v in labels.items():
            if k in self._ok_keys and (
                    not isinstance(v, str) or v in self._ok_vals):
                continue
            scrub_label(k, v)
            self._ok_keys.add(k)
            if isinstance(v, str) and k not in _EPHEMERAL_LABEL_KEYS:
                self._ok_vals.add(v)

    # -- metrics -------------------------------------------------------------
    def count(self, name: str, n: float = 1, **labels) -> None:
        """Add ``n`` to the counter ``name{labels}``."""
        self._check_labels(labels)
        key = (name, _label_key(labels))
        self._counters[key] = self._counters.get(key, 0) + n

    def value(self, name: str, **labels) -> float:
        """Current value of one counter series (0 if never incremented)."""
        return self._counters.get((name, _label_key(labels)), 0)

    def total(self, name: str) -> float:
        """Sum of a counter over ALL label sets (the reconciler's view)."""
        return sum(v for (n, _), v in self._counters.items() if n == name)

    def gauge(self, name: str, value: float, **labels) -> None:
        """Set the gauge ``name{labels}`` to ``value``."""
        self._check_labels(labels)
        self._gauges[(name, _label_key(labels))] = value

    def gauge_total(self, name: str) -> float:
        return sum(v for (n, _), v in self._gauges.items() if n == name)

    def declare_histogram(self, name: str,
                          buckets: Tuple[float, ...]) -> None:
        """Pin a histogram family's bucket layout (default: durations)."""
        prev = self._hist_bounds.setdefault(name, tuple(buckets))
        if prev != tuple(buckets):
            raise ValueError(
                f"histogram {name!r} already declared with a different "
                "bucket layout — layouts are fixed per family")

    def observe(self, name: str, value: float, **labels) -> None:
        """Record ``value`` into the histogram ``name{labels}``."""
        self._check_labels(labels)
        key = (name, _label_key(labels))
        h = self._hists.get(key)
        if h is None:
            bounds = self._hist_bounds.setdefault(name, DURATION_BUCKETS_S)
            h = self._hists[key] = _Hist(bounds)
        h.observe(value)

    # -- spans ---------------------------------------------------------------
    def span(self, name: str, **labels):
        """Monotonic-clock span context manager (nesting via a stack).

        ``with tel.span("flush", round=r) as sp: ...; sp.fence(out)``.
        With ``record_spans=False`` this is the shared no-op recorder.
        """
        if not self.record_spans:
            return _NULL_SPAN
        self._check_labels(labels)
        return _Span(self, name, dict(labels))

    def _finish_span(self, sp: _Span, dur_ns: int) -> None:
        if len(self.spans) < self.max_spans:
            self.spans.append(SpanRecord(
                sp.name, sp.sid, sp.parent, sp._t0 - self.epoch_ns, dur_ns,
                sp.labels))
        else:
            self.count("dropped_spans")
        self.observe("span_duration_seconds", dur_ns * 1e-9, span=sp.name)

    # -- snapshots for exporters ---------------------------------------------
    def counters(self) -> Dict[Tuple[str, tuple], float]:
        return dict(self._counters)

    def gauges(self) -> Dict[Tuple[str, tuple], float]:
        return dict(self._gauges)

    def histograms(self) -> Dict[Tuple[str, tuple], _Hist]:
        return dict(self._hists)


class TelemetryCounterView(MutableMapping):
    """Deprecated dict facade over a fixed family of telemetry counters.

    Engines once exposed degradation counters as plain dict attributes
    (``server.fault_metrics["duplicate_pushes"] += 1``).  The registry is
    now the one source of truth; this view keeps every old read/write
    spelling working — ``dict(view)``, ``view[k] += 1``, equality — while
    routing the numbers through :class:`Telemetry` under the engine's
    ephemeral ``eid`` label.  New code should read the registry directly.
    """

    def __init__(self, tel: Telemetry, keys: Tuple[str, ...], **labels):
        self._tel = tel
        self._keys = tuple(keys)
        self._labels = labels

    def _require(self, k: str) -> None:
        if k not in self._keys:
            raise KeyError(k)

    def __getitem__(self, k: str) -> int:
        self._require(k)
        return int(self._tel.value(k, **self._labels))

    def __setitem__(self, k: str, v: int) -> None:
        self._require(k)
        self._tel.count(k, v - self[k], **self._labels)

    def __delitem__(self, k: str) -> None:
        raise TypeError("fault-metric counters cannot be removed")

    def __iter__(self) -> Iterator[str]:
        return iter(self._keys)

    def __len__(self) -> int:
        return len(self._keys)

    def __repr__(self) -> str:
        return f"TelemetryCounterView({dict(self)!r})"


# --- the process-wide default registry --------------------------------------
_default = Telemetry(record_spans=False)


def get_default() -> Telemetry:
    """The process-wide registry engines fall back to (no-op span recorder,
    live counters)."""
    return _default


def set_default(tel: Telemetry) -> Telemetry:
    """Install ``tel`` as the process-wide default; returns the previous."""
    global _default
    prev, _default = _default, tel
    return prev


def stage_spans(telemetry: Optional[Telemetry] = None,
                labels: Optional[Mapping[str, Any]] = None):
    """``span(name, **more)``: a stage span on ``telemetry`` (default: the
    process registry) carrying the caller's ``labels``, then ``more``.  A
    registry that records no spans gets the shared null span, with no label
    dict built."""
    tel = telemetry if telemetry is not None else get_default()
    if not tel.record_spans:
        return _no_span
    labels = labels or {}

    def span(name: str, **more):
        return tel.span(name, **labels, **more)
    return span
