"""Upload-compression spec and wire widths (identity lane only, for now).

Port of the parts of ``repro.core.fl.compression`` the uncompressed engine
needs: the static :class:`CompressionSpec` (rate 1.0 / mode "none"
canonicalize to the identity spec), the per-chunk :class:`WireChunk`
widths and ``compressed_size``.  The active operators (PRF subsampling and
the rotation sketch with its ``rotate_quantize_prf`` kernel) are the next
slice of the port; the engines raise on an active spec.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Sequence, Tuple

COMPRESSION_TAG = 0xCB01
SKETCH_BLOCK = 512

_MODES = ("none", "subsample", "sketch")


@dataclasses.dataclass(frozen=True)
class CompressionSpec:
    """Static per-session upload-compression policy."""

    mode: str = "none"
    rate: float = 1.0

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(
                f"compress_mode {self.mode!r}: want one of {_MODES}")
        if not 0.0 < self.rate <= 1.0:
            raise ValueError(
                f"compress_rate {self.rate} must be in (0, 1] — it is the "
                "kept fraction of each chunk's coordinates")
        if self.mode == "none" or self.rate >= 1.0:
            object.__setattr__(self, "mode", "none")
            object.__setattr__(self, "rate", 1.0)

    @property
    def identity(self) -> bool:
        return self.mode == "none"

    def describe(self) -> str:
        return ("identity" if self.identity
                else f"{self.mode}@rate={self.rate:g}")


class WireChunk(NamedTuple):
    """Wire-domain widths of one plan chunk (size m, padded, full P)."""

    size: int
    padded: int
    full: int


def _ceil_block(n: int) -> int:
    return -(-n // SKETCH_BLOCK) * SKETCH_BLOCK


def compressed_size(cspec: CompressionSpec, size: int) -> int:
    """m: wire coordinates for a logical chunk of ``size`` elements."""
    if cspec.identity:
        return size
    return max(1, math.ceil(cspec.rate * size))


def wire_chunks(cspec: CompressionSpec,
                chunks: Sequence) -> Tuple[WireChunk, ...]:
    """Per-chunk wire widths (identity: the plan's own widths)."""
    out = []
    for ck in chunks:
        if cspec.identity:
            out.append(WireChunk(ck.size, ck.padded, ck.size))
            continue
        full = _ceil_block(ck.size) if cspec.mode == "sketch" else ck.size
        m = compressed_size(cspec, ck.size)
        padded = m if ck.padded == ck.size else _ceil_block(m)
        out.append(WireChunk(m, padded, full))
    return tuple(out)
