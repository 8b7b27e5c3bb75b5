"""Signal Transformer — the on-device ML-infra component (port of
``repro.core.signal_transformer``; paper §Architecture).

Transforms raw device signals into model features:
  - local signal transformation (log1p/clip/bucketize/...)
  - local feature normalization with globally-learned FA factors
  - server-side feature injection (feature origin 1)
  - local value overrides (feature origin 3: device value wins when present)

Transform programs are *data*, not code: a versioned list of primitive ops
(the TorchScript-push analogue) that the server can push to devices without
an app release — collapsing the feature dev cycle from weeks to hours
(paper §Slow release cycles).  Programs are executed by a tiny interpreter
over torch tensors, so a pushed program runs identically on-device (here)
and in server-side validation.  Bucketize is ``searchsorted`` with side
"left", the reference's default.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

import torch


@dataclass(frozen=True)
class TransformSpec:
    """Versioned, serializable transform program."""

    version: int
    ops: Sequence[Dict[str, Any]]  # [{'op': 'log1p', 'field': 'x'}, ...]
    min_app_version: int = 0  # critical functionality stays version-independent

    def to_json(self) -> str:
        return json.dumps({"version": self.version, "ops": list(self.ops),
                           "min_app_version": self.min_app_version})

    @staticmethod
    def from_json(s: str) -> "TransformSpec":
        d = json.loads(s)
        return TransformSpec(d["version"], d["ops"], d.get("min_app_version", 0))


_PRIMITIVES = ("identity", "log1p", "abs", "clip", "scale", "zscore", "minmax",
               "bucketize", "inject_server", "override_with_local", "select")


def validate_spec(spec: TransformSpec) -> None:
    for op in spec.ops:
        if op.get("op") not in _PRIMITIVES:
            raise ValueError(f"unknown transform primitive: {op.get('op')!r}")
        if "field" not in op and op["op"] != "select":
            raise ValueError(f"op missing 'field': {op}")


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """A divisor as a 0-dim tensor on ``like``'s device (a CUDA division by a
    Python scalar is a multiply by its reciprocal)."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


class SignalTransformer:
    """On-device interpreter for pushed TransformSpecs."""

    def __init__(self, spec: TransformSpec):
        validate_spec(spec)
        self.spec = spec

    def apply(self, signals: Dict[str, torch.Tensor],
              server_features: Optional[Dict[str, Any]] = None
              ) -> Dict[str, torch.Tensor]:
        """signals: raw on-device values; server_features: injected via the
        server-to-device data flow.  Returns the feature dict."""
        env: Dict[str, torch.Tensor] = {k: torch.as_tensor(v)
                                        for k, v in signals.items()}
        server = server_features or {}
        for op in self.spec.ops:
            kind = op["op"]
            f = op.get("field")
            if kind == "identity":
                pass
            elif kind == "log1p":
                env[f] = torch.log1p(torch.clamp(env[f], min=0.0))
            elif kind == "abs":
                env[f] = torch.abs(env[f])
            elif kind == "clip":
                env[f] = torch.clamp(env[f], op["lo"], op["hi"])
            elif kind == "scale":
                env[f] = env[f] * op["factor"]
            elif kind == "zscore":
                env[f] = (env[f] - op["mean"]) / _scalar(
                    max(op["std"], 1e-6), env[f])
            elif kind == "minmax":
                env[f] = (env[f] - op["lo"]) / _scalar(
                    max(op["hi"] - op["lo"], 1e-6), env[f])
            elif kind == "bucketize":
                x = env[f]
                bounds = torch.as_tensor(op["boundaries"], dtype=torch.float32,
                                         device=x.device)
                env[f] = torch.searchsorted(bounds, x.to(torch.float32),
                                            side="left").to(torch.float32)
            elif kind == "inject_server":
                # feature origin (1): server-side value shipped to device
                env[f] = torch.as_tensor(server.get(f, op.get("default", 0.0)))
            elif kind == "override_with_local":
                # feature origin (3): device-local value wins when available
                local = op["local_field"]
                if local in signals:
                    env[f] = torch.as_tensor(signals[local])
                elif f not in env:
                    env[f] = torch.as_tensor(
                        server.get(f, op.get("default", 0.0)))
            elif kind == "select":
                order = op["fields"]
                return {k: env[k] for k in order}
        return env

    def feature_vector(self, signals, server_features=None) -> torch.Tensor:
        """Stacked (n_features,) vector in spec `select` order (model input):
        each feature's first element."""
        feats = self.apply(signals, server_features)
        return torch.stack([torch.as_tensor(v, dtype=torch.float32)
                            .reshape(-1)[0] for v in feats.values()])


def spec_with_normalization(spec: TransformSpec, factors, fields: Sequence[str],
                            new_version: int) -> TransformSpec:
    """Re-issue a spec with FA-learned normalization baked in (server push)."""
    ops = [dict(o) for o in spec.ops if o["op"] not in ("zscore", "minmax")]
    select = [o for o in ops if o["op"] == "select"]
    ops = [o for o in ops if o["op"] != "select"]
    for i, f in enumerate(fields):
        if factors.scheme == "zscore":
            ops.append({"op": "zscore", "field": f,
                        "mean": float(factors.shift[i]), "std": float(factors.scale[i])})
        else:
            ops.append({"op": "minmax", "field": f, "lo": float(factors.shift[i]),
                        "hi": float(factors.shift[i] + factors.scale[i])})
    ops.extend(select)
    return TransformSpec(new_version, ops, spec.min_app_version)
