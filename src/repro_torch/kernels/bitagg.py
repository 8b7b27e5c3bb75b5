"""K9 bit_counts: the federated-analytics threshold vote (port of
``repro.kernels.bitagg``).

``counts[f, t] = sum_n ([u < p/2] + [u >= p] * [values[n, f] <= thr[t]])``:
the threshold compare, randomized response against given uniforms (``u <
p/2`` forces a 1, ``u`` in ``[p/2, p)`` a 0) and the sum over the device
axis, fused.  ``core.analytics.bitagg.threshold_cdf`` runs every CDF vote of
the port through it, one launch per device tile.

Dispatch is by device, never by a flag: a CPU tensor runs the plain
version, a CUDA tensor launches the hand-written Hopper kernel
(``csrc/bitagg.cu``) or raises.  The wrapper counts its kernel launches
(``.launches``) and its plain-version dispatches (``.plain_calls``).  Unlike
the Pallas wrapper, any N and F are accepted (its ``N % 128`` and ``F % 8``
asserts are TPU tiling).  The kernel counts in integers, so it equals the
plain version bit for bit while N < 2^24.
"""
from __future__ import annotations

import ctypes

import torch

# device-axis splits are chosen so that a launch has about this many blocks
# (8 per SM of an H100), each walking at least MIN_ROWS devices
TARGET_BLOCKS = 132 * 8
MIN_ROWS = 64
MAX_SPLITS = 65535
THREADS = 256


def _counted(fn):
    fn.launches = 0
    fn.plain_calls = 0
    return fn


def reset_counts() -> None:
    bit_counts.launches = 0
    bit_counts.plain_calls = 0


def counts() -> dict:
    return {"bit_counts": {"launches": bit_counts.launches,
                           "plain_calls": bit_counts.plain_calls}}


def rr_thresholds(flip_prob: float, device=None):
    """``f32(p / 2)`` and ``f32(p)`` as 0-dim tensors: the compares'
    thresholds, rounded as the Pallas kernel's weak-typed compares round
    them."""
    f32 = torch.float32
    return (torch.tensor(flip_prob / 2.0, dtype=f32, device=device),
            torch.tensor(flip_prob, dtype=f32, device=device))


def bit_counts_plain(values: torch.Tensor, thresholds: torch.Tensor,
                     uniforms: torch.Tensor, flip_prob: float) -> torch.Tensor:
    """Plain version of :func:`bit_counts` (``repro.kernels.ref``'s
    formula; any device)."""
    f32 = torch.float32
    half, p = rr_thresholds(flip_prob, values.device)
    bits = (values.to(f32)[..., None] <= thresholds.to(f32)).to(f32)
    force1 = (uniforms < half).to(f32)
    keep = (uniforms >= p).to(f32)
    return (force1 + keep * bits).sum(0)


def vote_splits(N: int, F: int, T: int):
    """(device-axis splits, devices per split) of a launch: about
    ``TARGET_BLOCKS`` blocks, at least ``MIN_ROWS`` devices a split."""
    col_blocks = max(1, -(-(F * T) // THREADS))
    want = -(-TARGET_BLOCKS // col_blocks)
    splits = max(1, min(want, N // MIN_ROWS, MAX_SPLITS))
    rows = max(1, -(-N // splits))
    return -(-N // rows) if N else 0, rows


_SIGNATURE = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 3 + [
    ctypes.c_int32, ctypes.c_int64, ctypes.c_float, ctypes.c_float,
    ctypes.c_void_p]


def _launcher():
    from repro_torch.kernels import _build
    fn = _build.load("bitagg").bit_counts_launch
    fn.argtypes = _SIGNATURE
    fn.restype = ctypes.c_int
    return fn


def _check_cuda(t: torch.Tensor, what: str, shape) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{what} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {tuple(shape)} tensor, "
                         f"got shape {tuple(t.shape)}")


@_counted
def bit_counts(values: torch.Tensor, thresholds: torch.Tensor,
               uniforms: torch.Tensor, flip_prob: float) -> torch.Tensor:
    """values (N, F), thresholds (T,), uniforms (N, F, T), all f32 ->
    counts (F, T) f32.  Replaces the Pallas ``bit_counts``."""
    if values.device.type == "cpu":
        bit_counts.plain_calls += 1
        return bit_counts_plain(values, thresholds, uniforms, flip_prob)
    if values.dim() != 2 or thresholds.dim() != 1:
        raise ValueError(
            f"values must be (N, F) and thresholds (T,), got "
            f"{tuple(values.shape)} and {tuple(thresholds.shape)}")
    N, F = values.shape
    (T,) = thresholds.shape
    _check_cuda(values, "values", (N, F))
    _check_cuda(thresholds, "thresholds", (T,))
    _check_cuda(uniforms, "uniforms", (N, F, T))
    if thresholds.device != values.device or uniforms.device != values.device:
        raise ValueError("values, thresholds and uniforms must share a device")
    scratch = torch.empty((F, T), dtype=torch.int32, device=values.device)
    out = torch.empty((F, T), dtype=torch.float32, device=values.device)
    splits, rows = vote_splits(N, F, T)
    status = _launcher()(
        values.data_ptr(), thresholds.data_ptr(), uniforms.data_ptr(),
        scratch.data_ptr(), out.data_ptr(), N, F, T, splits, rows,
        flip_prob / 2.0, flip_prob,
        torch.cuda.current_stream(values.device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"bit_counts kernel launch failed: CUDA error "
                           f"{status}")
    bit_counts.launches += 1
    return out
