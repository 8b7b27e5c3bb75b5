"""Secure aggregation: field codec and pairwise session masks (port).

Port of ``repro.core.fl.secure_agg`` — the parts the buffered-async engine
uses: the fixed-point ``quantize``/``dequantize`` of the enclave wire, the
power-of-two secure-agg field (``field_modulus``/``to_field``/
``recenter``), the packed wire codec (``pack_residues``/``unpack_residues``,
widths 1..32; below 32 bits it is ``kernels.secure_agg``'s K5), the
mask-graph enumeration, the session masks and dropout recovery as one
:class:`MaskSession` value, and the standalone protocol keyed by an integer
seed (``pairwise_mask``, ``mask_update``, ``aggregate_masked``,
``secure_aggregate``).  Every mask is a sum of
counter-based pair streams (``repro_torch.kernels.prf``), bit-identical to
the JAX functions.

Integer arithmetic that must wrap mod 2^32 runs in int64 and is masked back
to 32 bits explicitly; int32 tensors hold the two's-complement bits.
Slots, keys and edge lists are host metadata (Python ints), so no mask
computation synchronises with the device.

Random k-regular session graphs relabel the ring by ``session_perm``, the
reference's ``jax.random.permutation`` rebuilt bit for bit by
``kernels.prf.permutation``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import prf
from repro_torch.kernels import secure_agg as ksa


def quantize(x: torch.Tensor, bits: int, value_range: float,
             rng=None) -> torch.Tensor:
    """Fixed-point encode to int32: x in [-range, range] -> int levels.

    With ``rng`` (PRF key words), stochastic rounding against the
    reference's ``jax.random.uniform(rng, x.shape)`` draw (bit-equal);
    else round half to even.
    """
    dev = x.device
    levels = torch.tensor(2 ** (bits - 1) - 1, dtype=torch.float32,
                          device=dev)
    scale = levels / torch.tensor(value_range, dtype=torch.float32,
                                  device=dev)
    xf = torch.clamp(x.to(torch.float32), -value_range, value_range) * scale
    if rng is not None:
        floor = torch.floor(xf)
        u = prf.uniform(rng, xf.shape, device=dev)
        xf = floor + (u < (xf - floor)).to(torch.float32)
    else:
        xf = torch.round(xf)
    return xf.to(torch.int32)


def dequantize(q: torch.Tensor, bits: int, value_range: float,
               count: int = 1) -> torch.Tensor:
    """Decode an (aggregated) fixed-point tensor back to f32, re-centred in
    the ``field_modulus(bits, count)`` wraparound window."""
    dev = q.device
    levels = torch.tensor(2 ** (bits - 1) - 1, dtype=torch.float32,
                          device=dev)
    step = torch.tensor(value_range, dtype=torch.float32, device=dev) / levels
    return recenter(q, field_modulus(bits, count)).to(torch.float32) * step


def _size(shape) -> int:
    n = 1
    for s in (shape if isinstance(shape, (tuple, list, torch.Size))
              else (shape,)):
        n *= int(s)
    return n


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def field_modulus(bits: int, count: int = 1) -> int:
    """Smallest power of two >= count * 2^bits, capped at 2^32."""
    return min(_next_pow2(count) * (1 << bits), 1 << 32)


def to_field(q: torch.Tensor, modulus: int) -> torch.Tensor:
    """Canonical unsigned residue of int32 ``q`` in the field, as int32."""
    if modulus >= 1 << 32:
        return q.to(torch.int32)
    if modulus & (modulus - 1):
        raise ValueError("field modulus must be a power of two")
    return (q.to(torch.int64) & (modulus - 1)).to(torch.int32)


def recenter(q: torch.Tensor, modulus: int) -> torch.Tensor:
    """Signed wraparound-window representative in ``[-C/2, C/2)``."""
    if modulus >= 1 << 32:
        return q.to(torch.int32)
    half = modulus // 2
    return (((q.to(torch.int64) + half) & (modulus - 1)) - half).to(
        torch.int32)


# ---------------------------------------------------------------------------
# Wire codec — canonical residues bit-packed into a dense 32-bit stream
# ---------------------------------------------------------------------------
def wire_bits(modulus: int) -> int:
    """Residue width of the packed wire format: ``log2(modulus)``."""
    if modulus >= 1 << 32:
        return 32
    if modulus < 2 or modulus & (modulus - 1):
        raise ValueError(f"wire width needs a power-of-two field modulus >= 2,"
                         f" got {modulus}")
    return (modulus - 1).bit_length()


def packed_words(size: int, modulus: int) -> int:
    """32-bit words in the packed stream of ``size`` residues."""
    return -(-size * wire_bits(modulus) // 32)


def pack_residues(q: torch.Tensor, modulus: int) -> torch.Tensor:
    """Bit-pack field residues (last axis) into 32-bit words (int32 bits).

    Element ``e`` occupies stream bits ``[e*w, (e+1)*w)``, word ``k`` holds
    stream bits ``[32k, 32k+32)`` — the JAX package's layout, so the words
    equal its uint32 stream bit for bit.  At the full 2^32 field the stream
    is the row itself; below it the words come from
    ``kernels.secure_agg.pack_residues`` (the CUDA kernel for a CUDA
    tensor, its plain version on the CPU).
    """
    bits = wire_bits(modulus)
    if bits == 32:
        return q.to(torch.int32).clone()
    return ksa.pack_residues(q, bits)


def unpack_residues(words: torch.Tensor, size: int,
                    modulus: int) -> torch.Tensor:
    """Inverse of :func:`pack_residues`: words back to int32 residues."""
    bits = wire_bits(modulus)
    nwords = packed_words(size, modulus)
    if words.shape[-1] != nwords:
        raise ValueError(
            f"packed stream of {words.shape[-1]} words does not match "
            f"{size} residues of a {modulus}-modulus field "
            f"({bits}-bit wire -> {nwords} words); was this row packed "
            f"under a different session field?")
    if bits == 32:
        return words.to(torch.int32).clone()
    return ksa.unpack_residues(words, size, bits)


# ---------------------------------------------------------------------------
# Mask graph
# ---------------------------------------------------------------------------
def effective_degree(num_slots: int, degree: int) -> int:
    """Canonical mask-graph degree: 0 == complete graph."""
    if degree <= 0 or degree >= num_slots - 1:
        return 0
    if degree % 2 != 0:
        raise ValueError(f"ring mask-graph degree must be even, got {degree}")
    return degree


def _perm_list(perm) -> Optional[List[int]]:
    if perm is None:
        return None
    if isinstance(perm, torch.Tensor):
        return [int(v) for v in perm.reshape(-1).tolist()]
    return [int(v) for v in perm]


GRAPH_PERM_TAG = 0x6B52


def session_perm(num_slots: int, key, *, device=None) -> torch.Tensor:
    """The session's random neighbourhood permutation (int32): the
    reference's ``jax.random.permutation(fold_in(key, GRAPH_PERM_TAG),
    num_slots)``, bit for bit.  Relabelling the k-ring by it gives the
    random k-regular graph of a session."""
    return prf.permutation(prf.fold_in(key, GRAPH_PERM_TAG), num_slots,
                           device=device).to(torch.int32)


def _neighbor_slots(slot: int, num_slots: int, degree: int,
                    perm=None) -> List[int]:
    """The slots ``slot`` shares a pairwise mask with (host ints).

    Complete graph: all other slots in order; degree k: the k/2 ring
    neighbours on each side — circulant, or relabelled through ``perm``.
    """
    slot = int(slot)
    k = effective_degree(num_slots, degree)
    if k == 0:
        return [d for d in range(num_slots) if d != slot]
    offs = list(range(1, k // 2 + 1)) + [-j for j in range(1, k // 2 + 1)]
    p = _perm_list(perm)
    if p is None:
        return [(slot + o + num_slots) % num_slots for o in offs]
    inv = {v: i for i, v in enumerate(p)}
    return [p[(inv[slot] + o + num_slots) % num_slots] for o in offs]


def neighbor_table(num_slots: int, degree: int, perm=None,
                   device=None) -> Optional[torch.Tensor]:
    """(num_slots, k) int32 neighbour table, or None for complete graphs."""
    if effective_degree(num_slots, degree) == 0:
        return None
    return torch.tensor(
        [_neighbor_slots(s, num_slots, degree, perm)
         for s in range(num_slots)], dtype=torch.int32, device=device)


def session_pairs(num_slots: int, degree: int = 0,
                  perm=None) -> Tuple[List[int], List[int]]:
    """The mask graph's edge list as (lo, hi) host-int lists.

    Same edges in the same order as the JAX function (complete graph:
    row-major upper triangle; degree k: ring edges by offset).
    """
    k = effective_degree(num_slots, degree)
    if k == 0:
        pairs = [(a, b) for a in range(num_slots)
                 for b in range(a + 1, num_slots)]
    else:
        p = _perm_list(perm) or list(range(num_slots))
        pairs = [(p[s], p[(s + j) % num_slots])
                 for j in range(1, k // 2 + 1) for s in range(num_slots)]
    return [min(a, b) for a, b in pairs], [max(a, b) for a, b in pairs]


# ---------------------------------------------------------------------------
# Session masks and recovery
# ---------------------------------------------------------------------------
def _shape(shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(shape)


def _pair_sum(k0: int, k1: int, lo, hi, gains, shape, device,
              out: Optional[torch.Tensor]) -> torch.Tensor:
    """``prf.signed_pair_sum`` over ``shape``'s elements: a fresh tensor
    shaped ``shape``, or added into ``out``'s first words in place."""
    m = prf.signed_pair_sum(k0, k1, lo, hi, gains, _size(shape),
                            device=device, out=out)
    return m if out is not None else m.reshape(_shape(shape))


def _signed_pair_sum(k0: int, k1: int, slot: int, others: Sequence[int],
                     shape, *, device=None,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``sum_d sign(d - slot) * stream(pair(slot, d))`` over ``others``
    (host ints), mod 2^32, shaped ``shape`` (or added into ``out``).  A
    diagonal entry ``d == slot`` gates itself out with sign 0.  No
    ``(len(others), D)`` block exists (``prf.signed_pair_sum``)."""
    slot = int(slot)
    others = [int(d) for d in others]
    lo = [min(slot, d) for d in others]
    hi = [max(slot, d) for d in others]
    sign = [(d > slot) - (d < slot) for d in others]
    return _pair_sum(k0, k1, lo, hi, sign, shape, device, out)


def pairwise_mask(shape, client_id: int, peer_ids: Sequence[int], seed: int,
                  *, device=None) -> torch.Tensor:
    """Additive int32 mask of ``client_id`` that cancels over all clients.

    ``mask_c = sum_{d > c} PRF(c, d) - sum_{d < c} PRF(d, c)`` keyed by
    ``PRNGKey(seed)``: each unordered pair adds ``+m`` to one endpoint and
    ``-m`` to the other, so the masks of ``peer_ids`` sum to 0 mod 2^32.
    Over ``peer_ids = range(n)`` it is :func:`session_mask` under
    ``PRNGKey(seed)``, bit for bit."""
    k0, k1 = prf.key_words(prf.PRNGKey(seed))
    return _signed_pair_sum(k0, k1, client_id, peer_ids, shape,
                            device=device)


def mask_update(q: torch.Tensor, client_id: int, peer_ids: Sequence[int],
                seed: int) -> torch.Tensor:
    """``q + pairwise_mask(...)``, wrapping mod 2^32."""
    m = pairwise_mask(q.shape, client_id, peer_ids, seed, device=q.device)
    return prf.to_int32(prf.words_of(q) + prf.words_of(m))


def aggregate_masked(masked: Sequence[torch.Tensor]) -> torch.Tensor:
    """Modular (mod 2^32) sum of masked int32 contributions: the masks
    cancel exactly.  Summed row by row in int64."""
    acc = None
    for m in masked:
        w = prf.words_of(m)
        acc = w if acc is None else acc.add_(w)
    return prf.to_int32(acc)


def secure_aggregate(updates: Sequence[torch.Tensor], bits: int,
                     value_range: float, seed: int = 0,
                     rng=None) -> torch.Tensor:
    """The full protocol: quantize -> mask -> modular sum -> dequantize.

    Returns the mean of ``updates`` (f32).  With ``rng`` (key words),
    client ``c`` rounds stochastically under ``fold_in(rng, c)``; its mask
    pairs it with every other client under ``PRNGKey(seed)``.
    """
    n = len(updates)
    peers = list(range(n))
    masked = [mask_update(quantize(u, bits, value_range,
                                   None if rng is None
                                   else prf.fold_in(rng, c)), c, peers, seed)
              for c, u in enumerate(updates)]
    total = aggregate_masked(masked)
    del masked
    return dequantize(total, bits, value_range, count=n) / torch.tensor(
        n, dtype=torch.float32, device=total.device)


def session_mask(shape, slot: int, num_slots: int, key,
                 degree: int = 0, perm=None, *, device=None,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pairwise int32 mask of session position ``slot`` (shape ``shape``;
    with ``out``, added into its first words in place, mod 2^32)."""
    k0, k1 = prf.key_words(key)
    return _signed_pair_sum(k0, k1, slot,
                            _neighbor_slots(slot, num_slots, degree, perm),
                            shape, device=device, out=out)


def session_masks(shape, num_slots: int, key, degree: int = 0, perm=None, *,
                  device=None) -> torch.Tensor:
    """All ``num_slots`` session masks -> (num_slots, *shape) int32."""
    return torch.stack([session_mask(shape, s, num_slots, key, degree, perm,
                                     device=device)
                        for s in range(num_slots)])


def present_flags(present) -> List[int]:
    if isinstance(present, torch.Tensor):
        present = present.reshape(-1).tolist()
    return [1 if bool(p) else 0 for p in present]


def recovery_sweep(shape, present, lo: Sequence[int], hi: Sequence[int], key,
                   w: Optional[Sequence[int]] = None, *, device=None,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum of ``(present[hi] - present[lo]) * stream(lo, hi)`` over edges.

    Only edges with exactly one endpoint present contribute (and ``w``
    zeroes padding edges); each contributing stream is generated once.
    With ``out`` (a contiguous int32 row, e.g. a chunk's padded sum) the
    sweep is added into its first ``prod(shape)`` words in place, mod 2^32,
    and ``out`` is returned.
    """
    pres = present_flags(present)
    k0, k1 = prf.key_words(key)
    wts = [1] * len(lo) if w is None else [int(x) for x in w]
    gains = [(pres[b] - pres[a]) * x for a, b, x in zip(lo, hi, wts)]
    return _pair_sum(k0, k1, lo, hi, gains, shape, device, out)


def recovery_mask(shape, present, num_slots: int, key, degree: int = 0,
                  perm=None, *, device=None,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum of the session masks of the ABSENT slots (dropout shares)."""
    lo, hi = session_pairs(num_slots, degree, perm)
    return recovery_sweep(shape, present, lo, hi, key, device=device,
                          out=out)


@dataclasses.dataclass(frozen=True)
class MaskSession:
    """One pairwise-mask session, as a value (port of the JAX dataclass).

    ``key`` is the session's ``(k0, k1)`` PRF key words; ``perm`` an
    optional random k-regular relabelling (a permutation of
    ``range(num_slots)``); ``slot_offset`` the first slot of the
    consumer's row range; ``modulus`` the secure-agg field.
    """

    key: Tuple[int, int]
    num_slots: int
    degree: int = 0
    perm: Any = None
    slot_offset: int = 0
    modulus: int = 1 << 32

    def key_words(self) -> Tuple[int, int]:
        return prf.key_words(self.key)

    def neighbor_table(self, device=None) -> Optional[torch.Tensor]:
        if self.perm is None:
            return None
        return neighbor_table(self.num_slots, self.degree, self.perm,
                              device=device)

    def edges(self):
        return session_pairs(self.num_slots, self.degree, self.perm)

    def mask(self, shape, slot: int, *, device=None,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
        return session_mask(shape, slot, self.num_slots, self.key,
                            self.degree, self.perm, device=device, out=out)

    def masks(self, shape, *, device=None) -> torch.Tensor:
        return session_masks(shape, self.num_slots, self.key, self.degree,
                             self.perm, device=device)

    def recovery(self, shape, present, *, device=None,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
        return recovery_mask(shape, present, self.num_slots, self.key,
                             self.degree, self.perm, device=device, out=out)

    @property
    def wire_bits(self) -> int:
        return wire_bits(self.modulus)

    def reduce(self, q: torch.Tensor) -> torch.Tensor:
        """``q`` in wire format: canonical field residues, bit-packed."""
        return pack_residues(to_field(q, self.modulus), self.modulus)

    def expand(self, words: torch.Tensor, size: int) -> torch.Tensor:
        """Inverse of :meth:`reduce`."""
        return unpack_residues(words, size, self.modulus)


def make_session(key, num_slots: int, *, degree: int = 0,
                 random_graph: bool = False, slot_offset: int = 0,
                 modulus: int = 1 << 32) -> MaskSession:
    """A :class:`MaskSession` with canonical graph parameters; a random
    k-regular graph draws its ``session_perm`` from the key (host ints)."""
    k = effective_degree(num_slots, degree)
    perm = (tuple(session_perm(num_slots, key).tolist())
            if (k > 0 and random_graph) else None)
    return MaskSession(key=prf.key_words(key), num_slots=num_slots, degree=k,
                       perm=perm, slot_offset=slot_offset, modulus=modulus)
