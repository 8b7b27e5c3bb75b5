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

``split``, ``random_bits``, ``uniform``, ``normal``, ``randint`` and
``permutation`` rebuild JAX's own draws (the threefry implementation with
``jax_threefry_partitionable``, JAX's default), bit for bit: element ``i`` of
a draw of shape ``s`` is the 20-round Threefry of the counter
``(i >> 32, i & M32)`` under the key.  ``normal`` rebuilds XLA's f32
``erf_inv`` and ``log1p`` (and XLA CPU's ``log``) op by op, with their FMAs,
in f32 torch ops that give the same bits on the CPU and the card.
"""
from __future__ import annotations

import math
import struct
from typing import Sequence, Tuple

import torch

from repro_torch.device import is_abstract

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


def _r32(v: float) -> float:
    """``v`` rounded to the nearest f32, as a Python float."""
    return struct.unpack("f", struct.pack("f", v))[0]


# jax.random.normal draws its uniforms on (nextafter(-1, 0), 1)
_NORMAL_LO = -0.99999994039535522461  # f32 nextafter(-1, 0)
_SQRT2_F32 = 1.41421354  # f32(sqrt(2)), XLA's constant
# XLA's f32 log1p: the Cephes rational form below |x| < sqrt(2) - 1 (all
# constants are XLA's, rounded to f32)
_LOG1P_SMALL = 0.41421356237309504880
_LOG1P_P = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
            6.5787325942061044846969, 2.9911919328553073277375e1,
            6.0949667980987787057556e1, 5.7112963590585538103336e1,
            2.0039553499201281259648e1)
_LOG1P_Q = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
            2.2176239823732856465394e2, 3.0909872225312059774938e2,
            2.1642788614495947685003e2, 6.0118660497603843919306e1)
# XLA CPU's f32 log (the Cephes logf polynomial in Eigen's form)
_LOG_SQRTHF = 0.707106781186547524
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
# XLA's f32 erf_inv (Giles): Horner coefficients, highest degree first,
# for w < 5 and w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
_LOG1P_SMALL, _LOG_SQRTHF, _LOG_Q1, _LOG_Q2 = (
    _r32(v) for v in (_LOG1P_SMALL, _LOG_SQRTHF, _LOG_Q1, _LOG_Q2))
_LOG1P_P, _LOG1P_Q, _LOG_P, _ERFINV_LT5, _ERFINV_GE5 = (
    tuple(_r32(v) for v in t)
    for t in (_LOG1P_P, _LOG1P_Q, _LOG_P, _ERFINV_LT5, _ERFINV_GE5))


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to f32 (a true FMA, as XLA's CPU code and
    CUDA's ``__fmaf_rn`` compute it) from f32 operands.

    ``b`` and ``c`` may be tensors or Python floats holding f32 values.  The
    product is exact in f64 and the f64 sum rounds once; rounding that sum
    to f32 is a second rounding, which differs from the FMA's only where the
    f64 sum sits exactly halfway between two f32s.  There the sum's exact
    error (TwoSum) picks the side.  Results must lie in f32's normal range.
    """
    def f64(v):
        return v.double() if isinstance(v, torch.Tensor) else v
    p = a.double() * f64(b)
    s = p + f64(c)
    r = s.float()
    tie = (s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000
    if is_abstract(tie) or not bool(tie.any()):  # abstract: no ties to read
        return r
    idx = tie.nonzero(as_tuple=True)
    ps, ss = p[idx], s[idx]
    cs = c.double().expand_as(s)[idx] if isinstance(c, torch.Tensor) else c
    bb = ss - ps
    e = (ps - (ss - bb)) + (cs - bb)
    rs = r[idx]
    up = torch.nextafter(rs, torch.full_like(rs, math.inf))
    down = torch.nextafter(rs, torch.full_like(rs, -math.inf))
    lo = torch.where(rs.double() < ss, rs, down)
    hi = torch.where(rs.double() > ss, rs, up)
    r[idx] = torch.where(e > 0, hi, torch.where(e < 0, lo, rs))
    return r


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root of an f32 tensor, as XLA's
    ``jnp.sqrt`` computes it.

    torch's f32 ``sqrt`` on the CPU is not correctly rounded on every host.
    The f64 root rounded once more to f32 is (f64 carries more than
    2 * 24 + 2 bits, and a root of an f32 never sits that close to an f32
    midpoint; ``tools/sqrt_rounding.py --exhaustive`` checks every f32), so
    the CPU takes that, in tiles of ``TILE`` values.  CUDA's f32 ``sqrt`` is
    IEEE round-to-nearest, so a CUDA tensor takes ``torch.sqrt`` as it is:
    both give the same bits.
    """
    if x.dtype != torch.float32:
        raise TypeError(f"sqrt_f32 takes f32, got {x.dtype}")
    if x.device.type != "cpu":
        return torch.sqrt(x)
    flat = x.reshape(-1)
    out = torch.empty_like(flat)
    for s in range(0, flat.numel(), TILE):
        out[s:s + TILE] = torch.sqrt(flat[s:s + TILE].double())
    return out.view(x.shape)


def _div_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 quotient: the f64 quotient of two f32s,
    rounded again to f32 (f64 carries more than 2 * 24 + 2 bits, so the
    second rounding cannot move it)."""
    return (a.double() / b.double()).float()


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    """Horner's rule with FMA steps from the highest-degree coefficient
    (f32 Python floats)."""
    h = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        h = fma_f32(h, x, c)
    return h


def log_f32(v: torch.Tensor) -> torch.Tensor:
    """XLA CPU's f32 ``log`` for finite ``v > 0`` (f32): Cephes' ``logf``
    polynomial with Eigen's exponent split, its multiply-adds contracted
    into FMAs exactly where XLA's compiled code has them."""
    v = torch.maximum(v, _f32(2.0 ** -126, v))
    bits = v.view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    small = m < _f32(_LOG_SQRTHF, v)
    x = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    e = torch.where(small, e - 1.0, e)
    x2 = x * x
    x3 = x2 * x
    y = _horner(x, _LOG_P[0:3])
    y1 = _horner(x, _LOG_P[3:6])
    y2 = _horner(x, _LOG_P[6:9])
    y = fma_f32(y, x3, y1)
    y = fma_f32(y, x3, y2)
    y = fma_f32(y, x3, e * _LOG_Q1)
    # x - x2/2 and + e*q2 are FMAs of exact products: one rounding each
    t = (x - x2 * 0.5) + y
    return t + e * _LOG_Q2


def log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA CPU's f32 ``log1p`` for ``x > -1`` (f32): ``log(1 + x)`` when
    ``|x| >= sqrt(2) - 1``, else Cephes' rational form
    ``x + (-x^2/2 + x^3 P(x)/Q(x))`` with FMA Horner steps.  The ``log``
    branch is computed only where it is taken."""
    x2 = x * x
    q = _horner(x, _LOG1P_Q)
    p = _horner(x, _LOG1P_P)
    out = x + ((x * x2) * _div_f32(p, q) - x2 * 0.5)
    if is_abstract(x):  # the cost harness: no data to pick the branch by
        return out
    big = (x.abs() >= _LOG1P_SMALL).nonzero(as_tuple=True)
    out[big] = log_f32(x[big] + 1.0)
    return out


def erf_inv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv`` (Giles' polynomial) for ``|x| <= 1`` outside
    the subnormals (which XLA's CPU code flushes to zero):
    ``w = -log1p(-x^2)``, nine Horner coefficients per branch of ``w < 5``
    as FMAs, times ``x``; ``+-inf`` at ``+-1``.  The rare ``w >= 5`` branch
    is computed only where it is taken."""
    w = -log1p_f32(x * -x)
    out = _horner(w - 2.5, _ERFINV_LT5) * x
    if is_abstract(w):  # the cost harness: no data to pick the branch by
        return out
    tail = (w >= 5.0).nonzero(as_tuple=True)
    wt = sqrt_f32(w[tail]) - 3.0
    out[tail] = _horner(wt, _ERFINV_GE5) * x[tail]
    return torch.where(x.abs() == 1.0, x * math.inf, out)


def normal(key, shape, *, device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in f32, bit-equal:
    ``f32(sqrt 2) * erf_inv(u)`` over JAX's uniforms on
    ``(nextafter(-1, 0), 1)``, with XLA's own f32 ``erf_inv`` and ``log1p``
    rebuilt op by op (no library ``log``, ``log1p`` or ``erfinv``)."""
    def finish(w):
        lo = _f32(_NORMAL_LO, w)
        span = _f32(1.0, w) - lo
        u = torch.maximum(lo, _unit(w) * span + lo)
        return erf_inv_f32(u) * _f32(_SQRT2_F32, w)
    return _draw(key, shape, device, torch.float32, finish)


def randint(key, shape, minval: int, maxval: int, *,
            device=None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32), bit-equal:
    JAX's algorithm draws two 32-bit words per element from the two halves
    of ``split(key)`` and folds them into ``[minval, maxval)`` with uint32
    wraparound arithmetic (``hi % span * (2^32 % span) + lo % span``).
    ``minval`` and ``maxval`` are within int32."""
    lo_v, hi_v = int(minval), int(maxval)
    k1, k2 = split(key, 2)
    hi_bits = random_bits(k1, shape, device=device)
    lo_bits = random_bits(k2, shape, device=hi_bits.device)
    span = (hi_v - lo_v) & M32 if hi_v > lo_v else 1
    # JAX squares 2^16 % span in uint32: past a span of 2^16 it wraps to 0
    mult = ((2 ** 16 % span) ** 2 & M32) % span
    off = (((hi_bits % span) * mult) & M32) + lo_bits % span
    off = (off & M32) % span
    return to_int32(off + lo_v)


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
