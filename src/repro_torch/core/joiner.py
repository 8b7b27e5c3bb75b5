"""Joiner — server-side label <-> feature assignment (paper §Architecture).

Joins a label event (click/conversion/human-rater) to the feature row of the
same example key within an attribution window.  The joined pair is what gets
shipped to the device-side feature store, where the Signal Transformer may
augment features and even update the label before training.

The port's own copy of ``repro.core.joiner``: the port imports nothing
of the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Tuple


@dataclass(frozen=True)
class FeatureRow:
    key: str
    timestamp: float
    features: Dict[str, float]


@dataclass(frozen=True)
class LabelEvent:
    key: str
    timestamp: float
    label: int  # binary classification per the paper's scope
    source: str = "server"  # click | conversion | rater | device


@dataclass(frozen=True)
class JoinedExample:
    key: str
    features: Dict[str, float]
    label: int
    label_source: str
    join_delay: float


class Joiner:
    def __init__(self, attribution_window: float = 86_400.0,
                 negative_fill: Optional[int] = 0):
        """negative_fill: label for feature rows with no label event inside
        the window (impression-without-click => negative); None drops them."""
        self.window = attribution_window
        self.negative_fill = negative_fill

    def join(self, rows: Iterable[FeatureRow],
             events: Iterable[LabelEvent]) -> List[JoinedExample]:
        by_key: Dict[str, List[LabelEvent]] = {}
        for e in events:
            by_key.setdefault(e.key, []).append(e)
        out: List[JoinedExample] = []
        for row in rows:
            cands = [e for e in by_key.get(row.key, ())
                     if 0.0 <= e.timestamp - row.timestamp <= self.window]
            if cands:
                e = min(cands, key=lambda e: e.timestamp)  # first attribution
                out.append(JoinedExample(row.key, dict(row.features), e.label,
                                         e.source, e.timestamp - row.timestamp))
            elif self.negative_fill is not None:
                out.append(JoinedExample(row.key, dict(row.features),
                                         self.negative_fill, "negative_fill", -1.0))
        return out

    @staticmethod
    def device_side_update(example: JoinedExample,
                           device_label: Optional[int]) -> JoinedExample:
        """On-device label override (the paper: 'sometimes even update the
        label prior to the training') — real-time product-surface signal."""
        if device_label is None:
            return example
        return JoinedExample(example.key, example.features, int(device_label),
                             "device", example.join_delay)
