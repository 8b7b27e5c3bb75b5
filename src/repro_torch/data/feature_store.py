"""Local Device Storage / Feature Store (paper §Architecture).

Encrypted, purpose-scoped on-device storage shared by training and inference
("both built on top of the Feature Store as a shared foundation that ensures
computational signal processing equivalence").  Encryption here is a keyed
XOR-stream stand-in — the *interface* (namespaces, purpose binding, TTL,
separation from other storage) is what the architecture specifies.

The port's own copy of ``repro.data.feature_store`` (numpy only): the
port imports nothing of the JAX package.
"""
from __future__ import annotations

import hashlib
import json
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np


def _keystream(key: bytes, nonce: bytes, n: int) -> bytes:
    out = b""
    counter = 0
    while len(out) < n:
        out += hashlib.sha256(key + nonce + counter.to_bytes(8, "little")).digest()
        counter += 1
    return out[:n]


@dataclass
class _Entry:
    nonce: bytes
    blob: bytes
    purpose: str
    expires_at: float


class DeviceFeatureStore:
    """Per-device store keyed by (namespace, key), purpose-bound, with TTL."""

    def __init__(self, device_secret: bytes, default_ttl: float = 7 * 86_400.0,
                 clock=time.time):
        self._secret = device_secret
        self._ttl = default_ttl
        self._clock = clock
        self._data: Dict[str, _Entry] = {}
        self._nonce_counter = 0

    def _k(self, namespace: str, key: str) -> str:
        return f"{namespace}\x00{key}"

    def put(self, namespace: str, key: str, value: Any, purpose: str,
            ttl: Optional[float] = None) -> None:
        payload = json.dumps(value, default=_np_default).encode()
        self._nonce_counter += 1
        nonce = self._nonce_counter.to_bytes(16, "little")
        stream = _keystream(self._secret, nonce, len(payload))
        blob = bytes(a ^ b for a, b in zip(payload, stream))
        self._data[self._k(namespace, key)] = _Entry(
            nonce, blob, purpose, self._clock() + (ttl or self._ttl))

    def get(self, namespace: str, key: str, purpose: str) -> Any:
        e = self._data.get(self._k(namespace, key))
        if e is None:
            raise KeyError((namespace, key))
        if e.purpose != purpose:
            raise PermissionError(
                f"purpose mismatch: stored for {e.purpose!r}, asked {purpose!r}")
        if self._clock() > e.expires_at:
            del self._data[self._k(namespace, key)]
            raise KeyError((namespace, key))
        stream = _keystream(self._secret, e.nonce, len(e.blob))
        return json.loads(bytes(a ^ b for a, b in zip(e.blob, stream)).decode())

    def gc(self) -> int:
        """Expire old entries; returns number collected."""
        now = self._clock()
        dead = [k for k, e in self._data.items() if now > e.expires_at]
        for k in dead:
            del self._data[k]
        return len(dead)

    def __len__(self) -> int:
        return len(self._data)


def _np_default(o):
    if isinstance(o, (np.floating, np.integer)):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(type(o))
