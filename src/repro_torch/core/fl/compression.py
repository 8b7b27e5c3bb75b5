"""Upload compression inside the masked field (port).

Port of ``repro.core.fl.compression``: the static :class:`CompressionSpec`
(rate 1.0 / mode "none" canonicalize to the identity spec, which every
consumer treats as the uncompressed path), the per-chunk
:class:`WireChunk` widths, and the two operators a compressed upload runs
through before it enters the secure-agg field:

  ``subsample``  keep ``m = ceil(rate * size)`` coordinates of the chunk,
                 chosen by ranking ``TAG_SELECT`` PRF words;
  ``sketch``     a ``TAG_SIGN`` ±1 diagonal, the orthonormal block
                 Walsh–Hadamard transform (512-wide blocks), then the same
                 subsample.

Both are regenerated at the two ends of the push split from the chunk's
session key (``fold_in(chunk_session_key, COMPRESSION_TAG)``), so nothing
about them travels on the wire, and both are slot-invariant: the server sums
in the operator domain and expands the aggregate once at decode.

Bit-exactness with the jitted reference: the reshape cascade of :func:`fwht`
adds and subtracts in the reference's order, and ranking ties break by
position (a stable sort of the words' int32 view, as ranked there).  Inside
``jit`` XLA folds chains of constant multiplies into one f32 constant; the
decode's ``(1/scale) * (full/m)`` is such a chain, so :func:`expand` takes
the fixed-point reciprocal and applies the folded product, and the sketch
encode multiplies by :func:`sketch_multiplier`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import prf

# fold-in tag deriving a chunk's operator key from its session key
COMPRESSION_TAG = 0xCB01
# Hadamard block width (the 512-element kernel/chunk block)
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


class ChunkOps(NamedTuple):
    """One chunk's realized compression operator (PRF-derived).

    ``idx``: (m,) int64 sorted kept coordinates in ``[0, full)``;
    ``signs``: (full,) ±1 f32 diagonal (sketch only); ``key_words``: the
    operator key, from which ``rotate_quantize_prf`` regenerates the signs
    in-kernel.
    """

    mode: str
    full: int
    m: int
    idx: torch.Tensor
    signs: Optional[torch.Tensor] = None
    key_words: Optional[Tuple[int, int]] = None


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


def chunk_operators(op_key, mode: str, size: int, rate: float, *,
                    device=None) -> ChunkOps:
    """Realize one chunk's operator from its fold-in key, on ``device``.

    The kept set is the first ``m`` positions of a stable ascending sort of
    the ``TAG_SELECT`` words over ``[0, full)`` — equal words keep position
    order, as ``jnp.argsort`` does — sorted back into position order.  The
    reference ranks the words' signed int32 view (its ``stream_block``
    returns int32), so words of 2^31 and above rank first, as here.
    """
    full = _ceil_block(size) if mode == "sketch" else size
    m = max(1, math.ceil(rate * size))
    ow0, ow1 = prf.key_words(op_key)
    ranks = prf.stream_block(ow0, ow1, full, tag=prf.TAG_SELECT,
                             device=device)
    order = torch.sort(ranks, stable=True).indices
    del ranks
    idx = torch.sort(order[:m]).values
    del order
    signs = None
    if mode == "sketch":
        bits = prf.stream_block(ow0, ow1, full, tag=prf.TAG_SIGN,
                                device=device)
        signs = 1.0 - 2.0 * (bits & 1).to(torch.float32)
    return ChunkOps(mode=mode, full=full, m=m, idx=idx, signs=signs,
                    key_words=(ow0, ow1))


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def butterflies(x: torch.Tensor) -> torch.Tensor:
    """The unnormalized Walsh–Hadamard butterflies over the last axis.

    The reference's reshape cascade: at stage ``h`` the last axis is viewed
    as ``(n/(2h), 2, h)`` and the halves become ``(a+b, a-b)``.
    """
    lead, n = tuple(x.shape[:-1]), x.shape[-1]
    if n & (n - 1):
        raise ValueError(f"fwht length {n} must be a power of two")
    h = 1
    while h < n:
        x = x.reshape(lead + (n // (2 * h), 2, h))
        a, b = x[..., 0, :], x[..., 1, :]
        x = torch.stack((a + b, a - b), dim=-2).reshape(lead + (n,))
        h *= 2
    return x


def fwht(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal fast Walsh–Hadamard transform over the last axis."""
    n = x.shape[-1]
    return butterflies(x) * _f32(1.0 / math.sqrt(n), x.device)


def _blocked(fn, x: torch.Tensor) -> torch.Tensor:
    lead, P = tuple(x.shape[:-1]), x.shape[-1]
    y = fn(x.reshape(lead + (P // SKETCH_BLOCK, SKETCH_BLOCK)))
    return y.reshape(lead + (P,))


def block_rotate(x: torch.Tensor, signs: torch.Tensor) -> torch.Tensor:
    """The rotation R = blockFWHT ∘ diag(signs): y = H (s ⊙ x)."""
    return _blocked(fwht, x * signs)


def block_rotate_t(y: torch.Tensor, signs: torch.Tensor) -> torch.Tensor:
    """Rᵀ = R⁻¹: x = s ⊙ H y."""
    return _blocked(fwht, y) * signs


def sketch_multiplier(scale: float) -> float:
    """``f32(f32(1/sqrt(512)) * f32(scale))``: the encode's folded constant.

    The reference encode computes ``block_rotate(x, s) * scale`` inside
    ``jit``, where XLA folds fwht's normalization and the fixed-point
    scale into this one multiply.
    """
    return float(_f32(1.0 / math.sqrt(SKETCH_BLOCK), "cpu")
                 * _f32(scale, "cpu"))


def compress(x: torch.Tensor, ops: ChunkOps) -> torch.Tensor:
    """(…, size) chunk values -> (…, m) operator-domain coordinates."""
    if ops.mode == "none":
        return x
    pad = ops.full - x.shape[-1]
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    if ops.mode == "sketch":
        x = block_rotate(x, ops.signs)
    return x.index_select(-1, ops.idx)


def expand(z: torch.Tensor, ops: ChunkOps, size: int, *,
           descale: Optional[float] = None) -> torch.Tensor:
    """(…, m) operator-domain AGGREGATE -> unbiased (…, size) estimate.

    Applies ``(full/m) · Rᵀ Sᵀ``: scale, scatter the kept coordinates
    back, un-rotate, slice off the Hadamard pad.  ``descale`` (the f32
    reciprocal of the fixed-point scale) joins the first multiply as the
    folded ``f32(f32(descale) * f32(full/m))`` that the jitted reference
    decode computes.
    """
    if ops.mode == "none":
        return z
    c = _f32(ops.full / ops.m, "cpu")
    if descale is not None:
        c = _f32(descale, "cpu") * c
    z = z * c.to(z.device)
    full = torch.zeros(tuple(z.shape[:-1]) + (ops.full,), dtype=z.dtype,
                       device=z.device)
    full[..., ops.idx] = z
    if ops.mode == "sketch":
        full = block_rotate_t(full, ops.signs)
    return full[..., :size]
