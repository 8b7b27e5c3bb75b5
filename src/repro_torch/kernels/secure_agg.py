"""Secure-aggregation kernels: fused PRF-masked encode and accumulation.

Port of the two ``repro.kernels.secure_agg`` Pallas kernels on the
buffered-async engine's path, each as a wrapper plus its plain PyTorch
version:

  ``quantize_mask_prf``        the streamed masked push (client/tee_stream):
                               ``q(x * s) + mask[slot]``, stochastic-rounding
                               uniforms and the slot's pairwise mask both
                               generated from PRF counters;
  ``weighted_quantize_accum``  the batched flush (tee and unstreamed off):
                               ``sum_c q(x[c] * w[c] * s) (+ m_c)`` mod 2^32,
                               with no mask, explicit masks, or in-kernel PRF
                               session masks.

Dispatch is by device, never by a flag: a CPU tensor runs the plain version,
a CUDA tensor launches the hand-written Hopper kernel
(``csrc/quantize_mask_prf.cu``, ``csrc/weighted_quantize_accum.cu``) or
raises — there is no fallback from the card to the plain version.  Each
wrapper counts its kernel launches (``.launches``) and its plain-version
dispatches (``.plain_calls``) as plain integers, so a run can show that the
main path went through the kernels.

The plain versions are the bit-exact spec (they reproduce
``repro.kernels.ref``); the kernels must equal them bit for bit.  Like the
JAX package, this module never imports the protocol layer: sessions arrive
as a :class:`SessionMeta`.
"""
from __future__ import annotations

import ctypes
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.kernels import prf

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


def reset_counts() -> None:
    """Zero every wrapper's launch and plain-dispatch counts."""
    for fn in (quantize_mask_prf, weighted_quantize_accum):
        fn.launches = 0
        fn.plain_calls = 0


def counts() -> dict:
    return {fn.__name__: {"launches": fn.launches,
                          "plain_calls": fn.plain_calls}
            for fn in (quantize_mask_prf, weighted_quantize_accum)}


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
    return prf.signed_pair_sum(k0, k1, lo, hi, sign, length, device=device)


def stochastic_round(xf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``floor(xf) + [u < frac(xf)]`` as int32 (the fixed-point encode)."""
    floor = torch.floor(xf)
    bit = (u < (xf - floor)).to(torch.float32)
    return (floor + bit).to(torch.int32)


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


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------
_c_void_p, _c_i64, _c_i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
_c_u32, _c_f32 = ctypes.c_uint32, ctypes.c_float

_SIGNATURES = {
    "quantize_mask_prf": [
        _c_void_p, _c_void_p, _c_i64, _c_f32, _c_u32, _c_u32, _c_u32,
        _c_u32, _c_i32, _c_u32, _c_i32, _c_i32, _c_void_p, _c_i32,
        _c_void_p],
    "weighted_quantize_accum": [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_i64,
        _c_i64, _c_f32, _c_i32, _c_u32, _c_u32, _c_i32, _c_i32, _c_i32,
        _c_void_p, _c_i32, _c_void_p],
}


def _launcher(name: str):
    from repro_torch.kernels import _build
    fn = getattr(_build.load(name), f"{name}_launch")
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
    k0, k1 = prf.key_words(session.key_words)
    u0, u1 = prf.key_words(uniform_key_words)
    out = torch.empty_like(x, dtype=torch.int32)
    status = _launcher("quantize_mask_prf")(
        x.data_ptr(), out.data_ptr(), x.numel(), float(scale), k0, k1, u0,
        u1, int(slot), int(u_offset) & prf.M32, session.num_slots,
        session.degree, None if nb is None else nb.data_ptr(), width,
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(status, "quantize_mask_prf")
    quantize_mask_prf.launches += 1
    return out


@_counted
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
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(status, "weighted_quantize_accum")
    weighted_quantize_accum.launches += 1
    return out
