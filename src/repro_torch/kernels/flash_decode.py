"""K10 flash decode: one-token GQA attention over a (ring-buffer) KV cache.

Port of the Pallas kernel ``repro.kernels.flash_decode.flash_decode``, the
serving hot spot: ``models.layers.attention_decode`` calls it for every
layer of every decoded token.  ``flash_decode`` is the wrapper and
``flash_decode_plain`` its plain PyTorch version.

Dispatch is by device, never by a flag: a CPU tensor runs the plain
version, a CUDA tensor launches the hand-written Hopper kernel
(``csrc/flash_decode.cu``) or raises.  The wrapper counts its kernel
launches (``.launches``) and its plain-version dispatches (``.plain_calls``).

Semantics are the Pallas kernel's: a slot is valid when
``0 <= slot_pos <= pos`` and, if ``window > 0``, ``pos - slot_pos <
window``; invalid scores are ``-1e30`` (not ``-inf``), so a row with no
valid slot averages ``v`` over the cache where ``repro.kernels.ref`` gives
NaN; the denominator is guarded by ``max(l, 1e-30)``.  Unlike the Pallas
wrapper, any cache depth ``W`` is accepted (the kernel masks the ragged
tail of its last tile).
"""
from __future__ import annotations

import ctypes

import torch

NEG = -1e30
# the kernel's geometry (csrc/flash_decode.cu): 4 warps of 32-slot tiles,
# up to 8 query rows of one kv-head per block
TILE = 32
WARPS = 4
MAX_ROWS = 8
HEAD_DIMS = (32, 64, 128, 256)
# W is split so that a launch has about this many blocks: 64 per SM of an
# H100, so the last wave of blocks is a small part of the run (about 5 fit
# an SM at once; tools/flash_decode_splits.py measures the choice)
TARGET_BLOCKS = 64 * 132


def _counted(fn):
    fn.launches = 0
    fn.plain_calls = 0
    return fn


def reset_counts() -> None:
    flash_decode.launches = 0
    flash_decode.plain_calls = 0


def counts() -> dict:
    return {"flash_decode": {"launches": flash_decode.launches,
                             "plain_calls": flash_decode.plain_calls}}


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       slot_pos: torch.Tensor, pos: int, *,
                       window: int = 0) -> torch.Tensor:
    """Plain version of :func:`flash_decode` (any device)."""
    B, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, KV, H // KV, hd).float()
    scores = torch.einsum("bgrk,bsgk->bgrs", qg, k.float())
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if window > 0:
        valid &= (pos - slot_pos) < window
    scores = scores.masked_fill(~valid, NEG)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    denom = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bgrs,bsgk->bgrk", p, v.float()) / denom
    return out.reshape(B, H, hd)


def splits(B: int, KV: int, rep: int, W: int):
    """(number of W splits, slots per split) of a launch: enough blocks for
    ``TARGET_BLOCKS``, at least one 32-slot tile per warp of each."""
    tiles = -(-W // TILE)
    rows = B * KV * -(-rep // MAX_ROWS)
    want = max(1, min(-(-tiles // WARPS), -(-TARGET_BLOCKS // rows)))
    per = -(-tiles // want)
    return -(-tiles // per), per * TILE


_SIGNATURE = [ctypes.c_void_p] * 7 + [ctypes.c_int32] * 10 + [ctypes.c_void_p]
_launch_fn = None


def _launcher():
    """The library's launch function, bound once (the serve path calls the
    wrapper once per layer per decoded token)."""
    global _launch_fn
    if _launch_fn is None:
        from repro_torch.kernels import _build
        fn = _build.load("flash_decode").flash_decode_launch
        fn.argtypes = _SIGNATURE
        fn.restype = ctypes.c_int
        _launch_fn = fn
    return _launch_fn


def _check(t: torch.Tensor, what: str, dtypes, shape) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{what} must be one of {dtypes}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {tuple(shape)} tensor, "
                         f"got shape {tuple(t.shape)}")
    if t.data_ptr() % 16:
        raise ValueError(f"{what} must be 16-byte aligned")


@_counted
def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 slot_pos: torch.Tensor, pos: int, *,
                 window: int = 0) -> torch.Tensor:
    """One-token decode attention: ``softmax(q k^T | valid) v`` per head.

    q: (B, H, hd) f32, pre-scaled by ``hd**-0.5``; k, v: (B, W, KV, hd) f32
    or bf16 (one dtype); slot_pos: (W,) int32 absolute position of each
    cache slot (-1 = empty); pos: the new token's position (a Python int);
    window: 0 = the whole causal cache, else the sliding window.  Returns
    (B, H, hd) f32.  Replaces the Pallas ``flash_decode``.
    """
    if q.device.type == "cpu":
        flash_decode.plain_calls += 1
        return flash_decode_plain(q, k, v, slot_pos, pos, window=window)
    B, H, hd = q.shape
    _, W, KV, _ = k.shape
    if hd not in HEAD_DIMS or H % KV:
        raise ValueError(f"flash_decode: head_dim {hd} not in {HEAD_DIMS} or "
                         f"{H} heads not a multiple of {KV} kv heads")
    _check(q, "q", (torch.float32,), (B, H, hd))
    _check(k, "k", (torch.float32, torch.bfloat16), (B, W, KV, hd))
    _check(v, "v", (k.dtype,), (B, W, KV, hd))
    _check(slot_pos, "slot_pos", (torch.int32,), (W,))
    rep = H // KV
    nsplit, chunk = splits(B, KV, rep, W)
    if B * KV * -(-rep // MAX_ROWS) > 65535:
        raise ValueError(f"flash_decode: batch {B} x {KV} kv heads exceeds "
                         "the kernel's grid")
    out = torch.empty_like(q)
    part_acc = torch.empty((B, H, nsplit, hd), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((B, H, nsplit, 2), dtype=torch.float32,
                          device=q.device)
    status = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), slot_pos.data_ptr(),
        out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(), B, H, KV, W,
        hd, int(k.dtype == torch.bfloat16), int(pos), int(window), nsplit,
        chunk, torch.cuda.current_stream(q.device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error "
                           f"{status}")
    flash_decode.launches += 1
    return out
