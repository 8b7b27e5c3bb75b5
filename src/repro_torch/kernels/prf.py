"""Counter-based pairwise-mask PRF — port of ``repro.kernels.prf``.

Bit-identical to the JAX module.  Streams are Threefry-2x32 words keyed by
``(session_key, lo_slot, hi_slot)`` and indexed by flat element position:

  pair key   (pk0, pk1) = threefry(session_key, (lo, hi))
  element e  word       = threefry(pair_key,    (e >> 1, tag))[e & 1]

PyTorch has no unsigned 32-bit arithmetic on the CPU (and C++ signed
overflow is undefined), so every word here is an ``int64`` tensor — or a
Python int — holding a value in ``[0, 2^32)``, and every add or shift is
masked back to 32 bits explicitly.  The CUDA kernels use the same schedule
on ``uint32_t`` (``csrc/prf.cuh``).

Keys are explicit ``(k0, k1)`` word pairs.  ``PRNGKey``/``fold_in`` rebuild
JAX's default (threefry) key derivation: ``PRNGKey(s)`` has key data
``(0, s)`` and ``fold_in(k, d)`` is the full 20-round Threefry of the
counter ``(0, d)`` under ``k`` — so every engine key of the JAX package can
be derived here without JAX.

Host-side generation is TILED over the stream axis (``TILE`` words at a
time): a full-width model chunk has hundreds of millions of positions and an
untiled ``int64`` stream of that size would need tens of GB.  The streams are
counter-based and the sums are mod 2^32, so tiling is bit-identical.

``split``, ``random_bits``, ``uniform``, ``normal`` and ``permutation``
rebuild JAX's own draws (the threefry implementation with
``jax_threefry_partitionable``, JAX's default): element ``i`` of a draw of
shape ``s`` is the 20-round Threefry of the counter ``(i >> 32, i & M32)``
under the key.  ``split``, ``random_bits``, ``uniform`` and
``permutation`` are bit-equal to ``jax.random``; ``normal`` is
``sqrt(2) * erfinv`` of the same uniforms, equal to JAX's to ~2e-5 (the two
libraries' ``erfinv`` differ in the last bits).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

DEFAULT_ROUNDS = 13
JAX_ROUNDS = 20  # JAX's own threefry_2x32 (key derivation)

M32 = 0xFFFFFFFF
_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA

TAG_MASK = 0
TAG_UNIFORM = 1
TAG_SIGN = 2
TAG_SELECT = 3

# int64 words generated per tile of host-side stream generation
TILE = 1 << 22

Key = Tuple[int, int]


def threefry2x32(k0, k1, x0, x1, *, rounds: int = DEFAULT_ROUNDS):
    """Threefry-2x32 on 32-bit words held in Python ints or int64 tensors.

    Inputs broadcast; every value must lie in ``[0, 2^32)``.  ``rounds=20``
    is JAX's ``threefry_2x32``; fewer rounds truncate the schedule (key
    injections after every 4th round), exactly as the JAX package does.
    """
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(rounds):
        x0 = (x0 + x1) & M32
        r = _ROT[i % 8]
        x1 = (((x1 << r) & M32) | (x1 >> (32 - r))) ^ x0
        if (i + 1) % 4 == 0:
            j = (i + 1) // 4
            x0 = (x0 + ks[j % 3]) & M32
            x1 = (x1 + ks[(j + 1) % 3] + j) & M32
    return x0, x1


# --- JAX key helpers ------------------------------------------------------
def PRNGKey(seed: int) -> Key:  # noqa: N802 — mirrors jax.random.PRNGKey
    """Key words of ``jax.random.PRNGKey(seed)`` (threefry implementation)."""
    seed = int(seed)
    return ((seed >> 32) & M32, seed & M32)


def fold_in(key: Key, data: int) -> Key:
    """Key words of ``jax.random.fold_in(key, data)``."""
    k0, k1 = key_words(key)
    return threefry2x32(k0, k1, 0, int(data) & M32, rounds=JAX_ROUNDS)


def key_words(key) -> Key:
    """``(k0, k1)`` Python ints of a key given as a pair or a 2-word array."""
    if isinstance(key, torch.Tensor):
        key = key.reshape(-1).tolist()
    k0, k1 = key
    return int(k0) & M32, int(k1) & M32


def pair_keys(k0, k1, lo, hi, *, rounds: int = DEFAULT_ROUNDS):
    """Per-pair stream keys: one Threefry of the (lo, hi) slot ids."""
    return threefry2x32(k0, k1, lo, hi, rounds=rounds)


# --- tensor conversions ---------------------------------------------------
def as_words(v, device=None) -> torch.Tensor:
    """Python ints / int tensors -> int64 tensor of 32-bit words."""
    return torch.as_tensor(v, dtype=torch.int64, device=device) & M32


def to_int32(words: torch.Tensor) -> torch.Tensor:
    """32-bit words (int64 in [0, 2^32), or any int64 taken mod 2^32) ->
    the int32 tensor with the same two's-complement bits."""
    w = words & M32
    return ((w ^ 0x80000000) - 0x80000000).to(torch.int32)


def words_of(q: torch.Tensor) -> torch.Tensor:
    """int32 tensor -> int64 words in [0, 2^32) (the same bits)."""
    return q.to(torch.int64) & M32


# --- streams --------------------------------------------------------------
def words(pk0, pk1, start: int, stop: int, *, tag: int = TAG_MASK,
          rounds: int = DEFAULT_ROUNDS, device=None) -> torch.Tensor:
    """Raw stream words at element positions ``[start, stop)`` (untiled).

    ``pk0``/``pk1`` may carry leading batch dims; returns int64
    ``(*batch, stop - start)``.  One Threefry evaluation covers two
    consecutive positions (both output lanes are used).
    """
    pk0 = as_words(pk0, device)
    pk1 = as_words(pk1, device)
    lo, hi = start >> 1, (stop + 1) >> 1
    c = torch.arange(lo, hi, dtype=torch.int64, device=pk0.device) & M32
    pk0, pk1 = torch.broadcast_tensors(pk0, pk1)
    y0, y1 = threefry2x32(pk0[..., None], pk1[..., None], c, tag,
                          rounds=rounds)
    batch = tuple(pk0.shape)
    out = torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)
    out = out.reshape(batch + (2 * (hi - lo),))
    first = start - 2 * lo
    return out[..., first:first + (stop - start)]


def stream_at(pk0, pk1, e, *, tag: int = TAG_MASK,
              rounds: int = DEFAULT_ROUNDS) -> torch.Tensor:
    """PRF words at arbitrary element positions ``e`` -> int32."""
    e = as_words(e)
    y0, y1 = threefry2x32(as_words(pk0, e.device), as_words(pk1, e.device),
                          e >> 1, tag, rounds=rounds)
    return to_int32(torch.where((e & 1) == 0, y0, y1))


def _tiled(pk0, pk1, length: int, offset: int, tag: int, rounds: int,
           device, dtype, finish) -> torch.Tensor:
    pk0, pk1 = torch.broadcast_tensors(as_words(pk0, device),
                                       as_words(pk1, device))
    batch = tuple(pk0.shape)
    out = torch.empty(batch + (length,), dtype=dtype, device=pk0.device)
    rows = 1
    for b in batch:
        rows *= b
    step = max(2, (TILE // max(rows, 1)) & ~1)
    for s in range(0, length, step):
        t = min(length, s + step)
        out[..., s:t] = finish(words(pk0, pk1, offset + s, offset + t,
                                     tag=tag, rounds=rounds))
    return out


def stream_block(pk0, pk1, length: int, *, tag: int = TAG_MASK,
                 offset: int = 0, rounds: int = DEFAULT_ROUNDS,
                 device=None) -> torch.Tensor:
    """``stream_at(offset + arange(length))`` as int32, generated in tiles.

    ``pk0``/``pk1`` may carry leading batch dims (the stream axis is
    appended last); ``offset`` shifts the element positions so a chunk of a
    longer stream is bit-identical to that slice of the full block.
    """
    return _tiled(pk0, pk1, length, offset, tag, rounds, device, torch.int32,
                  to_int32)


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """PRF words -> f32 uniforms in [0, 1) (top 24 bits, exact)."""
    return ((bits.to(torch.int64) & M32) >> 8).to(torch.float32) * 2.0 ** -24


def uniform_block(uk0, uk1, length: int, *, offset: int = 0,
                  rounds: int = DEFAULT_ROUNDS, device=None) -> torch.Tensor:
    """f32 uniforms in [0, 1) from the TAG_UNIFORM stream family."""
    return _tiled(uk0, uk1, length, offset, TAG_UNIFORM, rounds, device,
                  torch.float32, bits_to_uniform)


def signed_pair_sum(k0: int, k1: int, lo: Sequence[int], hi: Sequence[int],
                    gains: Sequence[int], length: int, *,
                    device=None) -> torch.Tensor:
    """``sum_p gains[p] * stream(pair_key(lo[p], hi[p]))`` mod 2^32 -> int32.

    The shared core of every host-side mask: a slot's session mask (gains =
    +1 below / -1 above / 0 on the diagonal) and the dropout-recovery sweep
    (gains = present[hi] - present[lo]).  Pairs with gain 0 contribute
    nothing and are skipped.  Generated in tiles of at most ``TILE`` words
    over (pairs x positions), accumulated in int64 and wrapped once.
    """
    sel = [(int(a), int(b), int(g)) for a, b, g in zip(lo, hi, gains)
           if int(g) != 0]
    acc = torch.zeros((length,), dtype=torch.int64, device=device)
    if not sel or length == 0:
        return to_int32(acc)
    keys = [pair_keys(k0, k1, a, b) for a, b, _ in sel]
    pk0 = torch.tensor([k[0] for k in keys], dtype=torch.int64, device=device)
    pk1 = torch.tensor([k[1] for k in keys], dtype=torch.int64, device=device)
    g = torch.tensor([s for _, _, s in sel], dtype=torch.int64, device=device)
    group = max(1, min(len(sel), TILE // 4096))
    step = max(2, (TILE // group) & ~1)
    for p in range(0, len(sel), group):
        q = min(len(sel), p + group)
        for s in range(0, length, step):
            t = min(length, s + step)
            w = words(pk0[p:q], pk1[p:q], s, t)
            acc[s:t] += (g[p:q, None] * w).sum(0)
    return to_int32(acc)


# --- jax.random draws -----------------------------------------------------
def jax_tile(device) -> int:
    """Counters per tile of a ``jax.random`` draw (larger on the card, where
    each torch op of the tile is one kernel launch)."""
    return TILE * 8 if torch.device(device).type == "cuda" else TILE


def _jax_lanes(key, start: int, stop: int, device):
    """Both Threefry-20 lanes at flat counters ``[start, stop)``."""
    k0, k1 = key_words(key)
    i = torch.arange(start, stop, dtype=torch.int64, device=device)
    return threefry2x32(k0, k1, i >> 32, i & M32, rounds=JAX_ROUNDS)


def split(key, num: int = 2) -> list:
    """Key words of ``jax.random.split(key, num)``: key ``i`` is both
    lanes of the Threefry of the counter ``(0, i)``."""
    k0, k1 = key_words(key)
    return [threefry2x32(k0, k1, 0, i, rounds=JAX_ROUNDS)
            for i in range(int(num))]


def _draw(key, shape, device, dtype, finish) -> torch.Tensor:
    shape = (int(shape),) if isinstance(shape, int) else tuple(shape)
    n = math.prod(shape)
    out = torch.empty((n,), dtype=dtype, device=device)
    step = jax_tile(out.device)
    for s in range(0, n, step):
        t = min(n, s + step)
        y0, y1 = _jax_lanes(key, s, t, out.device)
        out[s:t] = finish(y0 ^ y1)
    return out.reshape(shape)


def random_bits(key, shape, *, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) as int64 words."""
    return _draw(key, shape, device, torch.int64, lambda w: w)


def _unit(w: torch.Tensor) -> torch.Tensor:
    # JAX sets the top 23 bits as the mantissa of a float in [1, 2) and
    # subtracts 1: exactly (w >> 9) * 2^-23
    return (w >> 9).to(torch.float32) * 2.0 ** -23


def uniform(key, shape, *, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: f32 in [0, 1), bit-equal."""
    return _draw(key, shape, device, torch.float32, _unit)


def uniform_span(key, start: int, stop: int, *, device=None) -> torch.Tensor:
    """Elements ``[start, stop)`` of the flattened ``jax.random.uniform(key,
    shape)`` of any shape with at least ``stop`` elements (untiled: the
    caller keeps ``stop - start`` within :func:`jax_tile`)."""
    y0, y1 = _jax_lanes(key, start, stop, device)
    return _unit(y0 ^ y1)


# jax.random.normal draws its uniforms on (nextafter(-1, 0), 1)
_NORMAL_LO = -0.99999994039535522461  # f32 nextafter(-1, 0)


def normal(key, shape, *, device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in f32: ``sqrt(2) * erfinv(u)``
    over JAX's uniforms on ``(nextafter(-1, 0), 1)`` (to ~2e-5, the error
    of XLA's f32 ``erf_inv``)."""
    def finish(w):
        lo = torch.tensor(_NORMAL_LO, dtype=torch.float32, device=w.device)
        span = torch.tensor(1.0, dtype=torch.float32, device=w.device) - lo
        u = torch.maximum(lo, _unit(w) * span + lo)
        # erfinv in f64, rounded once: torch's f32 CPU erfinv differs by
        # up to ~7e-5 between its vectorised and scalar paths
        z = torch.erfinv(u.to(torch.float64)).to(torch.float32)
        return z * torch.tensor(math.sqrt(2.0), dtype=torch.float32,
                                device=w.device)
    return _draw(key, shape, device, torch.float32, finish)


def permutation(key, n: int, *, device=None) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` (int64): JAX's ``_shuffle``, a
    stable sort by fresh 32-bit keys, ``ceil(3 ln n / ln(2^32 - 1))``
    rounds, each keyed by the second half of a split."""
    n = int(n)
    x = torch.arange(n, dtype=torch.int64, device=device)
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(M32))
    for _ in range(rounds):
        key, sub = split(key, 2)
        order = torch.sort(random_bits(sub, n, device=x.device),
                           stable=True).indices
        x = x[order]
    return x
