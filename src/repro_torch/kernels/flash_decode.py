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
tail of its last tile).  One call is one kernel launch: the kernel merges
its W splits itself.
"""
from __future__ import annotations

import ctypes
import math

import torch

NEG = -1e30
# the kernel's geometry (csrc/flash_decode.cu): 4 warps, a ring of 16-slot
# K/V tiles, up to 8 query rows of one kv-head per CTA, at most 256 splits
# (which bounds the partials a launch allocates)
TILE = 16
WARPS = 4
MAX_ROWS = 8
MAX_SPLITS = 256
HEAD_DIMS = (32, 64, 128, 256)
# an H100 SXM's SMs, and the kernel's CTAs resident on one at hd <= 128
# (128 threads of up to 128 registers): the defaults of :func:`splits`; a
# launch takes both from the card
SMS = 132
CTAS_PER_SM = 4


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


def row_groups(B: int, KV: int, rep: int) -> int:
    """CTA rows of a launch, one per (b, kv-head, group of up to 8 query
    rows): also the length of its split-merge ticket buffer."""
    return B * KV * -(-rep // MAX_ROWS)


def splits(B: int, KV: int, rep: int, W: int, *, sms: int = SMS,
           per_sm: int = CTAS_PER_SM) -> int:
    """The number of near-equal W ranges (splits) of a launch.

    The grid is ``row_groups x splits`` CTAs.  The least split count that
    makes it a whole number of waves (``sms x per_sm`` CTAs), when each
    split keeps at least a tile of slots and the merge takes that many;
    else at most one wave.
    """
    rows = row_groups(B, KV, rep)
    wave = sms * per_sm
    cap = min(-(-W // TILE), MAX_SPLITS)
    whole = wave // math.gcd(rows, wave)
    if whole <= cap:
        return whole
    return max(1, min(cap, wave // rows))


def split_range(W: int, nsplit: int, i: int):
    """Slots ``[s0, s1)`` of split ``i``, as the kernel computes them."""
    return i * W // nsplit, (i + 1) * W // nsplit


_SIGNATURE = [ctypes.c_void_p] * 8 + [ctypes.c_int32] * 9 + [ctypes.c_void_p]
# what a launch needs once per process: the bound library functions, and
# per device its SM count, the kernel's occupancy per (hd, K/V dtype) and the
# zeroed ticket buffer (each launch leaves it zero; calls queue on one stream)
_bound = {}


def _launcher():
    """The library's launch function, bound once (the serve path calls the
    wrapper once per layer per decoded token)."""
    fn = _bound.get("launch")
    if fn is None:
        from repro_torch.kernels import _build
        lib = _build.load("flash_decode")
        fn = _bound["launch"] = lib.flash_decode_launch
        fn.argtypes = _SIGNATURE
        fn.restype = ctypes.c_int
        occ = _bound["occupancy"] = lib.flash_decode_ctas_per_sm
        occ.argtypes = [ctypes.c_int32, ctypes.c_int32]
        occ.restype = ctypes.c_int
    return fn


def ctas_per_sm(device, hd: int, bf16: bool) -> int:
    """The kernel's CTAs resident on one SM of ``device`` for (hd, K/V
    dtype), from the CUDA occupancy calculator."""
    key = ("occupancy", torch.device(device).index, hd, bool(bf16))
    if key not in _bound:
        _launcher()
        with torch.cuda.device(device):
            n = _bound["occupancy"](hd, int(bool(bf16)))
        if n <= 0:
            raise RuntimeError(f"flash_decode occupancy query failed: CUDA "
                               f"error {-n}")
        _bound[key] = n
    return _bound[key]


def _sms(device) -> int:
    key = ("sms", torch.device(device).index)
    if key not in _bound:
        _bound[key] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _bound[key]


def _tickets(device, n: int) -> torch.Tensor:
    key = ("tickets", torch.device(device).index)
    buf = _bound.get(key)
    if buf is None or buf.numel() < n:
        buf = _bound[key] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                        device=device)
    return buf


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
    rows = row_groups(B, KV, rep)
    if rows > 65535:
        raise ValueError(f"flash_decode: batch {B} x {KV} kv heads exceeds "
                         "the kernel's grid")
    bf16 = k.dtype == torch.bfloat16
    launch = _launcher()
    nsplit = splits(B, KV, rep, W, sms=_sms(q.device),
                    per_sm=ctas_per_sm(q.device, hd, bf16))
    out = torch.empty_like(q)
    part_acc = torch.empty((B, H, nsplit, hd), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((B, H, nsplit, 2), dtype=torch.float32,
                          device=q.device)
    status = launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), slot_pos.data_ptr(),
        out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
        _tickets(q.device, rows).data_ptr(), B, H, KV, W, hd, int(bf16),
        int(pos), int(window), nsplit,
        torch.cuda.current_stream(q.device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error "
                           f"{status}")
    flash_decode.launches += 1
    return out
