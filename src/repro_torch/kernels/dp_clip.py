"""DP-SGD clip-and-reduce kernels: per-client squared norms and the scaled
client sum (port of ``repro.kernels.dp_clip``).

  ``sq_norms``        K3, ``out[c] = sum_d x[c,d]^2`` — the round's
                      whole-model clip norm, one launch per model leaf over
                      the chunk's stacked ``(clients, leaf)`` deltas;
  ``scale_accum``     K8, ``out[d] = sum_c s[c] * x[c,d]`` — the unmasked
                      (``secure_agg_bits=0``) round's weighted sum with
                      ``s = clip_scale * weight``;
  ``dp_clip_reduce``  K3 -> clip scales -> K8: the sum of per-client
                      clipped rows, which never exist in device memory.

Dispatch is by device, never by a flag: a CPU tensor runs the plain
version, a CUDA tensor launches the hand-written Hopper kernel
(``csrc/dp_clip.cu``) or raises.  Each wrapper counts its kernel launches
(``.launches``) and its plain-version dispatches (``.plain_calls``).  The
Pallas wrappers assert ``C % 8`` and ``D % 512``; these take any shape.

K8 sums in client order with every product and sum rounded on its own, as
its plain version does, so the two are bit-equal.  K3 sums a row in another
order than its plain version (and than XLA): the two agree to a relative
tolerance.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import is_abstract
from repro_torch.kernels import prf
from repro_torch.launch import analysis

# K3 splits a row over this many blocks in all (partial sums), at most
TARGET_BLOCKS = 132 * 8
MAX_ROW_BLOCKS = 4096


def _counted(fn):
    fn.launches = 0
    fn.plain_calls = 0
    return fn


def _wrappers():
    return (sq_norms, scale_accum)


def reset_counts() -> None:
    for fn in _wrappers():
        fn.launches = 0
        fn.plain_calls = 0


def counts() -> dict:
    return {fn.__name__: {"launches": fn.launches,
                          "plain_calls": fn.plain_calls}
            for fn in _wrappers()}


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU dispatch and card parity)
# ---------------------------------------------------------------------------
def sq_norms_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`sq_norms`: each row's ``sum(x * x)``."""
    xf = x.to(torch.float32)
    return torch.stack([torch.sum(r * r) for r in xf]) if len(xf) else \
        torch.zeros((0,), dtype=torch.float32, device=x.device)


def scale_accum_plain(x: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`scale_accum`: ``0 + s0*x0 + s1*x1 + ...``
    in client order, one row at a time."""
    C, D = x.shape
    s = scales.to(torch.float32)
    acc = torch.zeros((D,), dtype=torch.float32, device=x.device)
    for c in range(C):
        acc = acc + s[c] * x[c].to(torch.float32)
    return acc


def clip_scales(nrm: torch.Tensor, clip_norm: float) -> torch.Tensor:
    """``min(1, clip_norm / max(nrm, 1e-12))`` in f32."""
    cn = torch.tensor(clip_norm, dtype=torch.float32, device=nrm.device)
    return torch.clamp(cn / torch.clamp(nrm, min=1e-12), max=1.0)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------
_c_void_p, _c_i64, _c_i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
_SIGNATURES = {
    "sq_norms": [_c_void_p, _c_void_p, _c_void_p, _c_i64, _c_i64, _c_i32,
                 _c_i32, _c_void_p],
    "scale_accum": [_c_void_p, _c_void_p, _c_void_p, _c_i64, _c_i64, _c_i32,
                    _c_void_p],
}


def _launcher(name: str):
    from repro_torch.kernels import _build
    fn = getattr(_build.load("dp_clip"), f"{name}_launch")
    fn.argtypes = _SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda(t: torch.Tensor, what: str, ndim: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{what} must be float32, got {t.dtype}")
    if t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {ndim}-d tensor, got "
                         f"shape {tuple(t.shape)}")


def _vec(D: int, *ts: torch.Tensor) -> int:
    """16-byte loads: every row starts 16-byte aligned."""
    return int(D % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in ts))


def row_blocks(C: int, D: int) -> int:
    """Blocks per row of K3's first pass: ``TARGET_BLOCKS`` in all, at
    least one 1024-element share per block, at most ``MAX_ROW_BLOCKS``."""
    want = -(-TARGET_BLOCKS // max(C, 1))
    return max(1, min(want, -(-D // 1024), MAX_ROW_BLOCKS))


def _raise_on(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                           f"{status}")


@_counted
def sq_norms(x: torch.Tensor) -> torch.Tensor:
    """(C, D) f32 -> (C,) f32 per-row sums of squares.  Replaces the
    Pallas ``sq_norms``."""
    if is_abstract(x):
        # the cost harness: no launch, the bound's operations and bytes
        xl = analysis.local(x)
        C, D = xl.shape
        analysis.record_kernel("sq_norms", ops=2 * C * D,
                               nbytes=C * D * 4 + C * 4)
        return analysis.shard_like(xl.new_empty((C,)), x, {0: 0, 1: None})
    if x.device.type == "cpu":
        sq_norms.plain_calls += 1
        return sq_norms_plain(x)
    _check_cuda(x, "x", 2)
    C, D = x.shape
    nblk = row_blocks(C, D)
    partial = torch.empty((C, nblk), dtype=torch.float32, device=x.device)
    out = torch.empty((C,), dtype=torch.float32, device=x.device)
    status = _launcher("sq_norms")(
        x.data_ptr(), partial.data_ptr(), out.data_ptr(), C, D, nblk,
        _vec(D, x), torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(status, "sq_norms")
    sq_norms.launches += 1
    return out


@_counted
def scale_accum(x: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """``out[d] = sum_c scales[c] * x[c, d]``: (C, D), (C,) f32 -> (D,) f32.
    Replaces the Pallas ``scale_accum``."""
    if is_abstract(x):
        xl = analysis.local(x)
        C, D = xl.shape
        analysis.record_kernel("scale_accum", ops=2 * C * D,
                               nbytes=C * D * 4 + C * 4 + D * 4)
        return analysis.shard_like(xl.new_empty((D,)), x, {0: None, 1: 0})
    if x.device.type == "cpu":
        scale_accum.plain_calls += 1
        return scale_accum_plain(x, scales)
    _check_cuda(x, "x", 2)
    _check_cuda(scales, "scales", 1)
    C, D = x.shape
    if tuple(scales.shape) != (C,):
        raise ValueError(f"scales shape {tuple(scales.shape)} != {(C,)}")
    out = torch.empty((D,), dtype=torch.float32, device=x.device)
    status = _launcher("scale_accum")(
        x.data_ptr(), scales.data_ptr(), out.data_ptr(), C, D,
        _vec(D, x, out), torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(status, "scale_accum")
    scale_accum.launches += 1
    return out


def dp_clip_reduce(deltas: torch.Tensor, clip_norm: float) -> torch.Tensor:
    """(C, D) client deltas -> (D,) sum of the per-client-clipped rows:
    K3, the clip scales, K8."""
    nrm = prf.sqrt_f32(sq_norms(deltas))
    return scale_accum(deltas, clip_scales(nrm, clip_norm))
