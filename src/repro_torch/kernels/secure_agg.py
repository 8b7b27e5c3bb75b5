"""Secure-aggregation kernels: fused encode, accumulation and wire codec.

Port of the ``repro.kernels.secure_agg`` Pallas kernels on the
buffered-async engine's path, each as a wrapper plus its plain PyTorch
version:

  ``quantize_mask_prf``        the streamed masked push (client/tee_stream):
                               ``q(x * s) + mask[slot]``, stochastic-rounding
                               uniforms and the slot's pairwise mask both
                               generated from PRF counters;
  ``weighted_quantize_accum``  the batched flush (tee and unstreamed off):
                               ``sum_c q(x[c] * w[c] * s) (+ m_c)`` mod 2^32,
                               with no mask, explicit masks, or in-kernel PRF
                               session masks;
  ``rotate_quantize_prf``      the sketch-compressed push: ``TAG_SIGN`` ±1
                               diagonal, 512-wide Walsh–Hadamard butterflies
                               and the stochastic encode, one Hadamard block
                               at a time;
  ``pack_residues`` /          the packed sub-32-bit wire: field residues
  ``unpack_residues``          <-> a dense little-endian 32-bit word stream;
  ``quantize_mask``            the synchronous round's encode of one leaf:
                               ``q(clip(x, ±vr) * s; u) + mask`` against
                               given uniforms and an optional given mask;
  ``dequantize``               its decode: ``f32(q) * inv``, with the f32
                               multiplier ``inv`` chosen by the caller.

Dispatch is by device, never by a flag: a CPU tensor runs the plain version,
a CUDA tensor launches the hand-written Hopper kernel (``csrc/<name>.cu``;
both codec directions live in ``csrc/pack_residues.cu``, K6 and K7 in
``csrc/quantize_mask.cu``) or raises — there
is no fallback from the card to the plain version.  Each
wrapper counts its kernel launches (``.launches``) and its plain-version
dispatches (``.plain_calls``) as plain integers, so a run can show that the
main path went through the kernels.

The plain versions are the bit-exact spec (they reproduce
``repro.kernels.ref``); the kernels must equal them bit for bit.  Like the
JAX package, this module never imports the protocol layer (it takes only
the Hadamard butterflies from ``core.fl.compression``): sessions arrive as
a :class:`SessionMeta`, codec widths as ``bits``.
"""
from __future__ import annotations

import ctypes
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core.fl import compression as comp
from repro_torch.device import is_abstract
from repro_torch.kernels import prf
from repro_torch.launch import analysis

# neighbours whose pair keys a kernel block stages in shared memory
MAX_KERNEL_NEIGHBORS = 4000


class SessionMeta(NamedTuple):
    """The kernels' view of one pairwise-mask session.

      key_words:   (k0, k1) PRF key words of the session
      num_slots:   session size
      degree:      canonical mask-graph degree (0 = complete)
      slot_offset: first GLOBAL slot of the rows a call encodes
      neighbors:   optional (num_slots, degree) int32 neighbour table of a
                   random k-regular graph (replaces the circulant ring)
    """

    key_words: Any
    num_slots: int
    degree: int = 0
    slot_offset: int = 0
    neighbors: Optional[torch.Tensor] = None


def _counted(fn):
    fn.launches = 0
    fn.plain_calls = 0
    return fn


def _counted_lanes(fn):
    """K2 counts its PRF lane apart: ``prf_launches``/``prf_plain_calls``
    (session masks) beside ``launches``/``plain_calls`` (the other lanes)."""
    fn.prf_launches = 0
    fn.prf_plain_calls = 0
    return _counted(fn)


def _wrappers():
    return (quantize_mask_prf, weighted_quantize_accum, rotate_quantize_prf,
            pack_residues, unpack_residues, quantize_mask, dequantize)


# the name under which counts() reports K2's PRF lane
PRF_LANE = "weighted_quantize_accum[prf]"


def reset_counts() -> None:
    """Zero every wrapper's launch and plain-dispatch counts."""
    for fn in _wrappers():
        fn.launches = 0
        fn.plain_calls = 0
    weighted_quantize_accum.prf_launches = 0
    weighted_quantize_accum.prf_plain_calls = 0


def counts() -> dict:
    """Launches and plain-version dispatches per wrapper; K2's PRF lane
    under :data:`PRF_LANE`, its other lanes under its own name."""
    out = {fn.__name__: {"launches": fn.launches,
                         "plain_calls": fn.plain_calls}
           for fn in _wrappers()}
    out[PRF_LANE] = {
        "launches": weighted_quantize_accum.prf_launches,
        "plain_calls": weighted_quantize_accum.prf_plain_calls}
    return out


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the bit-exact spec; CPU dispatch and card parity)
# ---------------------------------------------------------------------------
def _complete(num_slots: int, degree: int) -> bool:
    return degree <= 0 or degree >= num_slots - 1


def kernel_neighbors(slot: int, session: SessionMeta) -> list:
    """The in-kernel neighbour enumeration of ``slot`` (host ints).

    Complete graph: every slot including ``slot`` itself (its sign is 0);
    even degree k: the circulant ring ``(slot +- j) % n``; a neighbour
    table replaces the ring when given.
    """
    n, degree = session.num_slots, session.degree
    if session.neighbors is not None:
        return [int(v) for v in session.neighbors[slot].tolist()]
    if _complete(n, degree):
        return list(range(n))
    if degree % 2 != 0:
        raise ValueError(f"ring mask-graph degree must be even, got {degree}")
    offs = list(range(1, degree // 2 + 1)) \
        + [-j for j in range(1, degree // 2 + 1)]
    return [(slot + o + n) % n for o in offs]


def session_mask_plain(slot: int, length: int, session: SessionMeta, *,
                       device=None) -> torch.Tensor:
    """The pairwise mask of ``slot`` at positions ``0..length-1`` (int32)."""
    k0, k1 = prf.key_words(session.key_words)
    others = kernel_neighbors(slot, session)
    lo = [min(slot, d) for d in others]
    hi = [max(slot, d) for d in others]
    sign = [(d > slot) - (d < slot) for d in others]
    return prf.signed_pair_sum_plain(k0, k1, lo, hi, sign, length,
                                     device=device)


def stochastic_round(xf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``floor(xf) + [u < frac(xf)]`` as int32 (the fixed-point encode)."""
    floor = torch.floor(xf)
    bit = (u < (xf - floor)).to(torch.float32)
    return (floor + bit).to(torch.int32)


def saturate_int32(v: torch.Tensor) -> torch.Tensor:
    """Integral f32 -> int32 as XLA (and CUDA's ``__float2int_rz``)
    convert: NaN to 0, out-of-range values and infinities saturate."""
    v = torch.where(torch.isnan(v), torch.zeros_like(v), v)
    v = v.clamp(-2.0 ** 31, 2.0 ** 31).to(torch.int64)
    return v.clamp(-2 ** 31, 2 ** 31 - 1).to(torch.int32)


def quantize_mask_plain(x: torch.Tensor, mask: Optional[torch.Tensor],
                        uniforms: torch.Tensor, scale: float,
                        value_range: float) -> torch.Tensor:
    """Plain version of :func:`quantize_mask` (any device)."""
    xf = x.to(torch.float32)
    vr = torch.tensor(value_range, dtype=torch.float32, device=x.device)
    # compares keep NaN, as jnp.clip does
    xf = torch.where(xf < -vr, -vr, xf)
    xf = torch.where(xf > vr, vr, xf)
    xf = xf * torch.tensor(scale, dtype=torch.float32, device=x.device)
    floor = torch.floor(xf)
    q = saturate_int32(floor + (uniforms < (xf - floor)).to(torch.float32))
    if mask is None:
        return q
    return prf.to_int32(prf.words_of(q) + prf.words_of(mask))


def dequantize_plain(q: torch.Tensor, inv: float) -> torch.Tensor:
    """Plain version of :func:`dequantize` (any device)."""
    return q.to(torch.float32) * torch.tensor(inv, dtype=torch.float32,
                                              device=q.device)


def pallas_inverse(scale: float) -> float:
    """The Pallas ``dequantize``'s multiplier: ``1.0 / scale`` in double,
    rounded once to f32."""
    return float(torch.tensor(1.0 / scale, dtype=torch.float32))


def jit_inverse(scale: float) -> float:
    """The multiplier of a jitted ``q / scale`` by a constant: XLA divides
    in f32, ``f32(1) / f32(scale)``."""
    return float(torch.tensor(1.0, dtype=torch.float32)
                 / torch.tensor(scale, dtype=torch.float32))


def quantize_mask_prf_plain(x: torch.Tensor, scale: float, slot: int,
                            uniform_key_words, session: SessionMeta, *,
                            u_offset: int = 0) -> torch.Tensor:
    """Plain version of :func:`quantize_mask_prf` (any device)."""
    (D,) = x.shape
    u0, u1 = prf.key_words(uniform_key_words)
    u = prf.uniform_block(u0, u1, D, offset=int(u_offset), device=x.device)
    q = stochastic_round(x.to(torch.float32) * scale, u)
    m = session_mask_plain(int(slot), D, session, device=x.device)
    return prf.to_int32(prf.words_of(q) + prf.words_of(m))


def weighted_quantize_accum_plain(x: torch.Tensor, weights: torch.Tensor,
                                  uniforms: torch.Tensor, scale: float, *,
                                  masks: Optional[torch.Tensor] = None,
                                  session: Optional[SessionMeta] = None
                                  ) -> torch.Tensor:
    """Plain version of :func:`weighted_quantize_accum` (any device).

    Row by row, so peak memory stays at a few (D,) temporaries.
    """
    C, D = x.shape
    acc = torch.zeros((D,), dtype=torch.int64, device=x.device)
    w = weights.to(torch.float32)
    for c in range(C):
        q = stochastic_round(x[c].to(torch.float32) * w[c] * scale, uniforms[c])
        acc += prf.words_of(q)
        if masks is not None:
            acc += prf.words_of(masks[c])
        elif session is not None:
            row = int(session.slot_offset) + c
            if row < session.num_slots:
                acc += prf.words_of(session_mask_plain(row, D, session,
                                                       device=x.device))
    return prf.to_int32(acc)


def rotate_quantize_prf_plain(x: torch.Tensor, scale: float, op_key_words,
                              uniform_key_words, *, u_offset: int = 0
                              ) -> torch.Tensor:
    """Plain version of :func:`rotate_quantize_prf` (any device).

    ``q(blockFWHT(signs ⊙ x) · scale)`` with fwht's ``1/sqrt(512)`` and
    ``scale`` applied as their folded f32 product (as the jitted reference
    computes it); returns the full operator-domain (ceil(D/512)·512,) int32.
    """
    (D,) = x.shape
    full = -(-D // comp.SKETCH_BLOCK) * comp.SKETCH_BLOCK
    o0, o1 = prf.key_words(op_key_words)
    u0, u1 = prf.key_words(uniform_key_words)
    bits = prf.stream_block(o0, o1, full, tag=prf.TAG_SIGN, device=x.device)
    signs = 1.0 - 2.0 * (bits & 1).to(torch.float32)
    del bits
    y = torch.nn.functional.pad(x.to(torch.float32), (0, full - D)) * signs
    del signs
    y = comp.butterflies(y.reshape(-1, comp.SKETCH_BLOCK)).reshape(full)
    y = y * torch.tensor(comp.sketch_multiplier(scale), dtype=torch.float32,
                         device=x.device)
    u = prf.uniform_block(u0, u1, full, offset=int(u_offset), device=x.device)
    return stochastic_round(y, u)


def pack_residues_plain(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Plain version of :func:`pack_residues`: residues (last axis) ->
    ``ceil(size*bits/32)`` words (int32 bits), any leading axes.

    Element ``e`` occupies stream bits ``[e*bits, (e+1)*bits)`` and word
    ``k`` holds stream bits ``[32k, 32k+32)``, so 32 residues fill exactly
    ``bits`` words; ragged tails pad with zero residues.
    """
    size = q.shape[-1]
    nwords = -(-size * bits // 32)
    v = q.to(torch.int64) & ((1 << bits) - 1)
    groups = -(-size // 32)
    pad = groups * 32 - size
    if pad:
        v = torch.nn.functional.pad(v, (0, pad))
    g = v.reshape(tuple(v.shape[:-1]) + (groups, 32))
    cols = [torch.zeros(g.shape[:-1], dtype=torch.int64, device=q.device)
            for _ in range(bits)]
    for j in range(32):  # each element lands in <= 2 words
        w0, shift = divmod(j * bits, 32)
        cols[w0] |= (g[..., j] << shift) & prf.M32
        if shift + bits > 32:
            cols[w0 + 1] |= g[..., j] >> (32 - shift)
    words = torch.stack(cols, dim=-1).reshape(tuple(g.shape[:-2])
                                              + (groups * bits,))
    return prf.to_int32(words[..., :nwords])


def unpack_residues_plain(words: torch.Tensor, size: int,
                          bits: int) -> torch.Tensor:
    """Plain version of :func:`unpack_residues` (any leading axes)."""
    nwords = -(-size * bits // 32)
    mask = (1 << bits) - 1
    w = prf.words_of(words)
    groups = -(-size // 32)
    pad = groups * bits - nwords
    if pad:
        w = torch.nn.functional.pad(w, (0, pad))
    w = w.reshape(tuple(w.shape[:-1]) + (groups, bits))
    elems = []
    for j in range(32):
        w0, shift = divmod(j * bits, 32)
        v = w[..., w0] >> shift
        if shift + bits > 32:
            v = v | ((w[..., w0 + 1] << (32 - shift)) & prf.M32)
        elems.append(v & mask)
    out = torch.stack(elems, dim=-1).reshape(tuple(w.shape[:-2])
                                             + (groups * 32,))
    return prf.to_int32(out[..., :size])


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------
_c_void_p, _c_i64, _c_i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
_c_u32, _c_u64, _c_f32 = ctypes.c_uint32, ctypes.c_uint64, ctypes.c_float

_SIGNATURES = {
    "quantize_mask_prf": [
        _c_void_p, _c_void_p, _c_i64, _c_f32, _c_u32, _c_u32, _c_u32,
        _c_u32, _c_i32, _c_u64, _c_i32, _c_i32, _c_void_p, _c_i32, _c_i32,
        _c_void_p],
    "weighted_quantize_accum": [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_i64,
        _c_i64, _c_f32, _c_i32, _c_u32, _c_u32, _c_i32, _c_i32, _c_i32,
        _c_void_p, _c_i32, _c_i32, _c_void_p],
    "rotate_quantize_prf": [
        _c_void_p, _c_void_p, _c_i64, _c_i64, _c_f32, _c_u32, _c_u32,
        _c_u32, _c_u32, _c_u64, _c_i32, _c_void_p],
    "pack_residues": [_c_void_p, _c_void_p, _c_i64, _c_i64, _c_i32,
                      _c_void_p],
    "unpack_residues": [_c_void_p, _c_void_p, _c_i64, _c_i32, _c_void_p],
    "quantize_mask": [_c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_i64,
                      _c_f32, _c_f32, _c_i32, _c_void_p],
    "dequantize": [_c_void_p, _c_void_p, _c_i64, _c_f32, _c_i32, _c_void_p],
}
# the csrc/ source (and library) of each launch function
_SOURCE = {"unpack_residues": "pack_residues", "dequantize": "quantize_mask"}


def _launcher(name: str):
    from repro_torch.kernels import _build
    fn = getattr(_build.load(_SOURCE.get(name, name)), f"{name}_launch")
    fn.argtypes = _SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda(t: torch.Tensor, what: str, dtype, ndim: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {ndim}-d tensor, got "
                         f"shape {tuple(t.shape)}")


def _neighbor_meta(session: SessionMeta, device):
    """(device table or None, table width, neighbours per slot)."""
    nb = session.neighbors
    if nb is None:
        count = session.num_slots if _complete(
            session.num_slots, session.degree) else session.degree
        if count != session.num_slots and session.degree % 2:
            raise ValueError("ring mask-graph degree must be even, got "
                             f"{session.degree}")
        return None, 0, count
    if tuple(nb.shape)[0] != session.num_slots:
        raise ValueError(f"neighbour table has {nb.shape[0]} rows for a "
                         f"{session.num_slots}-slot session")
    nb = nb.to(device=device, dtype=torch.int32).contiguous()
    return nb, int(nb.shape[1]), int(nb.shape[1])


def _aligned(*ts: torch.Tensor) -> int:
    """16-byte vector loads and stores: every pointer 16-byte aligned."""
    return int(all(t.data_ptr() % 16 == 0 for t in ts))


def _vec(D: int, *ts: torch.Tensor) -> int:
    """16-byte loads of every row: a row length that is a multiple of 4,
    aligned pointers."""
    return int(D % 4 == 0 and _aligned(*ts))


def _check_u_offset(u_offset: int) -> None:
    """The kernels take the uniform stream offset as a uint64 and form the
    positions ``u_offset + e`` in 64 bits, as the plain versions do."""
    if not 0 <= int(u_offset) < 1 << 63:
        raise ValueError(f"u_offset {u_offset} outside [0, 2^63)")


def _raise_on(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                           f"{status}")


@_counted
def quantize_mask_prf(x: torch.Tensor, scale: float, slot: int,
                      uniform_key_words, session: SessionMeta, *,
                      u_offset: int = 0) -> torch.Tensor:
    """The fused masked-push hot loop: ``q(x * scale) + mask[slot]``.

    x: (D,) f32, already clipped/weighted/noised; ``uniform_key_words``:
    (k0, k1) key of the stochastic-rounding stream, read at GLOBAL
    positions ``u_offset + e``; ``slot``: absolute session position (the
    session's ``slot_offset`` is ignored).  Returns (D,) int32.
    Replaces the Pallas ``quantize_mask_prf``.
    """
    if x.device.type == "cpu":
        quantize_mask_prf.plain_calls += 1
        return quantize_mask_prf_plain(x, scale, slot, uniform_key_words,
                                       session, u_offset=u_offset)
    _check_cuda(x, "x", torch.float32, 1)
    if not 0 <= int(slot) < session.num_slots:
        raise ValueError(f"slot {slot} outside the {session.num_slots}-slot "
                         "session")
    nb, width, count = _neighbor_meta(session, x.device)
    if count > MAX_KERNEL_NEIGHBORS:
        raise ValueError(f"{count} mask neighbours exceed the kernel's "
                         f"{MAX_KERNEL_NEIGHBORS}")
    _check_u_offset(u_offset)
    k0, k1 = prf.key_words(session.key_words)
    u0, u1 = prf.key_words(uniform_key_words)
    out = torch.empty_like(x, dtype=torch.int32)
    status = _launcher("quantize_mask_prf")(
        x.data_ptr(), out.data_ptr(), x.numel(), float(scale), k0, k1, u0,
        u1, int(slot), int(u_offset), session.num_slots,
        session.degree, None if nb is None else nb.data_ptr(), width,
        _aligned(x, out), torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(status, "quantize_mask_prf")
    quantize_mask_prf.launches += 1
    return out


@_counted_lanes
def weighted_quantize_accum(x: torch.Tensor, weights: torch.Tensor,
                            uniforms: torch.Tensor, scale: float, *,
                            masks: Optional[torch.Tensor] = None,
                            session: Optional[SessionMeta] = None
                            ) -> torch.Tensor:
    """Fused buffered-async flush: ``out[d] = sum_c [q(w_c x[c,d] s) + m]``.

    x, uniforms: (C, D) f32; weights: (C,) f32 -> (D,) int32 (mod 2^32).
    Mask lanes (mutually exclusive): ``masks`` — explicit (C, D) int32;
    ``session`` — masks generated in-kernel from the session's PRF key,
    row c at global slot ``session.slot_offset + c`` (rows at or beyond
    ``session.num_slots`` carry no mask).  Replaces the Pallas
    ``weighted_quantize_accum``.
    """
    if masks is not None and session is not None:
        raise ValueError("pass either precomputed `masks` or a PRF "
                         "`session` meta, not both")
    if x.device.type == "cpu":
        if session is not None:
            weighted_quantize_accum.prf_plain_calls += 1
        else:
            weighted_quantize_accum.plain_calls += 1
        return weighted_quantize_accum_plain(x, weights, uniforms, scale,
                                             masks=masks, session=session)
    _check_cuda(x, "x", torch.float32, 2)
    _check_cuda(uniforms, "uniforms", torch.float32, 2)
    _check_cuda(weights, "weights", torch.float32, 1)
    C, D = x.shape
    if tuple(uniforms.shape) != (C, D) or tuple(weights.shape) != (C,):
        raise ValueError(f"shapes x {tuple(x.shape)}, uniforms "
                         f"{tuple(uniforms.shape)}, weights "
                         f"{tuple(weights.shape)} disagree")
    mode, mptr, nb, width, count = 0, None, None, 0, 0
    k0 = k1 = offset = num_slots = degree = 0
    if masks is not None:
        _check_cuda(masks, "masks", torch.int32, 2)
        if tuple(masks.shape) != (C, D):
            raise ValueError(f"masks shape {tuple(masks.shape)} != {(C, D)}")
        mode, mptr = 1, masks.data_ptr()
    elif session is not None:
        mode = 2
        nb, width, count = _neighbor_meta(session, x.device)
        if count > MAX_KERNEL_NEIGHBORS:
            raise ValueError(f"{count} mask neighbours exceed the kernel's "
                             f"{MAX_KERNEL_NEIGHBORS}")
        k0, k1 = prf.key_words(session.key_words)
        offset, num_slots = int(session.slot_offset), session.num_slots
        degree = session.degree
    out = torch.empty((D,), dtype=torch.int32, device=x.device)
    status = _launcher("weighted_quantize_accum")(
        x.data_ptr(), weights.data_ptr(), uniforms.data_ptr(), mptr,
        out.data_ptr(), C, D, float(scale), mode, k0, k1, offset, num_slots,
        degree, None if nb is None else nb.data_ptr(), width,
        _vec(D, x, uniforms, out),
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(status, "weighted_quantize_accum")
    if mode == 2:
        weighted_quantize_accum.prf_launches += 1
    else:
        weighted_quantize_accum.launches += 1
    return out


@_counted
def rotate_quantize_prf(x: torch.Tensor, scale: float, op_key_words,
                        uniform_key_words, *,
                        u_offset: int = 0) -> torch.Tensor:
    """Fused sketch encode: ``q(blockFWHT(signs ⊙ x) · scale)`` -> int32.

    x: (D,) f32, already clipped/weighted; ``op_key_words``: the chunk's
    compression operator key (the ``TAG_SIGN`` diagonal is regenerated
    from it at operator-domain position ``e``); ``uniform_key_words``: the
    stochastic-rounding key, read at ``u_offset + e``.  Returns the full
    operator-domain (ceil(D/512)·512,) vector, Hadamard pad included.
    Replaces the Pallas ``rotate_quantize_prf``.
    """
    if x.device.type == "cpu":
        rotate_quantize_prf.plain_calls += 1
        return rotate_quantize_prf_plain(x, scale, op_key_words,
                                         uniform_key_words, u_offset=u_offset)
    _check_cuda(x, "x", torch.float32, 1)
    (D,) = x.shape
    full = -(-D // comp.SKETCH_BLOCK) * comp.SKETCH_BLOCK
    if full > 1 << 32:
        raise ValueError(f"rotate_quantize_prf takes at most 2^32 operator "
                         f"positions, got D={D}")
    _check_u_offset(u_offset)
    o0, o1 = prf.key_words(op_key_words)
    u0, u1 = prf.key_words(uniform_key_words)
    out = torch.empty((full,), dtype=torch.int32, device=x.device)
    status = _launcher("rotate_quantize_prf")(
        x.data_ptr(), out.data_ptr(), D, full, comp.sketch_multiplier(scale),
        o0, o1, u0, u1, int(u_offset), _aligned(x),
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(status, "rotate_quantize_prf")
    rotate_quantize_prf.launches += 1
    return out


def _check_bits(bits: int) -> None:
    if not 1 <= int(bits) <= 32:
        raise ValueError(f"residue width {bits} outside 1..32")


@_counted
def pack_residues(q: torch.Tensor, bits: int) -> torch.Tensor:
    """(D,) int32 residues -> (ceil(D*bits/32),) words as int32 bits.

    Each residue contributes its low ``bits`` bits to the dense
    little-endian stream.  Replaces the Pallas ``pack_residues``.
    """
    _check_bits(bits)
    if q.device.type == "cpu":
        pack_residues.plain_calls += 1
        return pack_residues_plain(q, bits)
    _check_cuda(q, "q", torch.int32, 1)
    (D,) = q.shape
    nwords = -(-D * bits // 32)
    out = torch.empty((nwords,), dtype=torch.int32, device=q.device)
    status = _launcher("pack_residues")(
        q.data_ptr(), out.data_ptr(), D, nwords, int(bits),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(status, "pack_residues")
    pack_residues.launches += 1
    return out


@_counted
def unpack_residues(words: torch.Tensor, size: int,
                    bits: int) -> torch.Tensor:
    """Inverse of :func:`pack_residues`: words -> (size,) int32 residues.

    Replaces the Pallas ``unpack_residues``.
    """
    _check_bits(bits)
    nwords = -(-size * bits // 32)
    if words.shape[-1] != nwords:
        raise ValueError(f"packed stream of {words.shape[-1]} words does not "
                         f"match {size} residues at {bits}-bit width "
                         f"(expected {nwords})")
    if words.device.type == "cpu":
        unpack_residues.plain_calls += 1
        return unpack_residues_plain(words, size, bits)
    _check_cuda(words, "words", torch.int32, 1)
    out = torch.empty((size,), dtype=torch.int32, device=words.device)
    status = _launcher("unpack_residues")(
        words.data_ptr(), out.data_ptr(), size, int(bits),
        torch.cuda.current_stream(words.device).cuda_stream)
    _raise_on(status, "unpack_residues")
    unpack_residues.launches += 1
    return out




@_counted
def quantize_mask(x: torch.Tensor, mask: Optional[torch.Tensor],
                  uniforms: torch.Tensor, scale: float,
                  value_range: float) -> torch.Tensor:
    """Encode one flat vector: ``floor(xf) + [u < frac(xf)] (+ mask)``.

    x, uniforms: (D,) f32; mask: (D,) int32 or None; ``xf = clip(x, ±
    value_range) * f32(scale)`` (``value_range`` may be ``inf``).  Returns
    (D,) int32, the mask added mod 2^32.  Replaces the Pallas
    ``quantize_mask``.
    """
    if is_abstract(x):
        # the cost harness: no launch, the bound's operations and bytes
        xl = analysis.local(x)
        (D,) = xl.shape
        analysis.record_kernel("quantize_mask", ops=8 * D,
                               nbytes=D * (16 if mask is not None else 12))
        return analysis.shard_like(xl.new_empty((D,), dtype=torch.int32), x,
                                   {0: 0})
    if x.device.type == "cpu":
        quantize_mask.plain_calls += 1
        return quantize_mask_plain(x, mask, uniforms, scale, value_range)
    _check_cuda(x, "x", torch.float32, 1)
    _check_cuda(uniforms, "uniforms", torch.float32, 1)
    (D,) = x.shape
    ts = [x, uniforms]
    if tuple(uniforms.shape) != (D,):
        raise ValueError(f"uniforms shape {tuple(uniforms.shape)} != {(D,)}")
    if mask is not None:
        _check_cuda(mask, "mask", torch.int32, 1)
        if tuple(mask.shape) != (D,):
            raise ValueError(f"mask shape {tuple(mask.shape)} != {(D,)}")
        ts.append(mask)
    out = torch.empty((D,), dtype=torch.int32, device=x.device)
    status = _launcher("quantize_mask")(
        x.data_ptr(), None if mask is None else mask.data_ptr(),
        uniforms.data_ptr(), out.data_ptr(), D, float(scale),
        float(value_range), _vec(D, out, *ts),
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(status, "quantize_mask")
    quantize_mask.launches += 1
    return out


@_counted
def dequantize(q: torch.Tensor, inv: float) -> torch.Tensor:
    """``f32(q) * inv`` for (D,) int32 ``q``; ``inv`` is the f32 multiplier
    (:func:`pallas_inverse` or :func:`jit_inverse` of the scale).  Replaces
    the Pallas ``dequantize``."""
    if is_abstract(q):
        ql = analysis.local(q)
        (D,) = ql.shape
        analysis.record_kernel("dequantize", ops=D, nbytes=8 * D)
        return analysis.shard_like(ql.new_empty((D,), dtype=torch.float32),
                                   q, {0: 0})
    if q.device.type == "cpu":
        dequantize.plain_calls += 1
        return dequantize_plain(q, inv)
    _check_cuda(q, "q", torch.int32, 1)
    (D,) = q.shape
    out = torch.empty((D,), dtype=torch.float32, device=q.device)
    status = _launcher("dequantize")(
        q.data_ptr(), out.data_ptr(), D, float(inv), _vec(D, q, out),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(status, "dequantize")
    dequantize.launches += 1
    return out
