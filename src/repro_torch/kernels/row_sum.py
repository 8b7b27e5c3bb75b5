"""The flush's modular row sum: int32 rows summed mod 2^32 (D2).

``sum_rows(rows, gate)`` sums the rows of a ``(B, ...)`` int32 buffer that
the host list ``gate`` keeps (all of them without one) into one int32
result, wrapping mod 2^32.  Every flush of the streamed engines runs it once
a chunk (``core/fl/aggregation.py``), as do the tier's leaf partials
(``core/fl/hierarchy.py``) and the round's deferred sum (``core/fl/round.py``).

Dispatch is by device, never by a flag: a CPU tensor runs the plain version,
an int64 accumulation row by row (``.plain_calls``); a CUDA tensor launches
``csrc/row_sum.cu`` once for every ``ROW_GROUP`` gated rows or raises
(``.launches``, and the process registry's counter ``modsum_device_rows`` by
the rows each launch sums); an abstract tensor records the kernel's bytes
and launches nothing.  The sum is exact mod 2^32, so the kernel and the
plain version agree bit for bit whatever the order.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence

import torch

from repro_torch.core import telemetry as tele
from repro_torch.device import is_abstract
from repro_torch.kernels import prf
from repro_torch.launch import analysis

# gated rows a launch: the kernel takes their base pointers by value
ROW_GROUP = 64


def sum_rows_plain(rows: torch.Tensor,
                   gate: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """Accumulated row by row in int64, so a (B, D) buffer never gets a
    (B, D) int64 copy."""
    acc = torch.zeros(rows.shape[1:], dtype=torch.int64, device=rows.device)
    for b in range(rows.shape[0]):
        if gate is None or gate[b]:
            acc += rows[b]
    return prf.to_int32(acc)


@functools.cache
def _launcher():
    from repro_torch.kernels import _build
    fn = _build.load("row_sum").row_sum_launch
    fn.argtypes = [ctypes.POINTER(ctypes.c_uint64), ctypes.c_int32,
                   ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _rows_are_flat(rows: torch.Tensor) -> bool:
    """Each row's elements lie one word apart: the dims after the first
    are contiguous (the row stride itself may be anything)."""
    want = 1
    for size, stride in zip(reversed(rows.shape[1:]),
                            reversed(rows.stride()[1:])):
        if size != 1 and stride != want:
            return False
        want *= size
    return True


def sum_rows(rows: torch.Tensor, gate: Optional[Sequence[bool]] = None
             ) -> torch.Tensor:
    """Modular (mod 2^32) sum of int32 rows, optionally gated -> int32."""
    picked = [b for b in range(rows.shape[0]) if gate is None or gate[b]]
    D = math.prod(rows.shape[1:])
    if is_abstract(rows):
        for s in range(0, max(len(picked), 1), ROW_GROUP):
            n = len(picked[s:s + ROW_GROUP]) + (s > 0)  # + the carried sum
            analysis.record_kernel("row_sum", ops=0, int_ops=n * D,
                                   nbytes=(n + 1) * D * 4)
        return torch.empty(rows.shape[1:], dtype=torch.int32,
                           device=rows.device)
    if rows.device.type == "cpu":
        sum_rows.plain_calls += 1
        return sum_rows_plain(rows, gate)
    if rows.device.type != "cuda":
        raise ValueError(f"sum_rows runs on the CPU or a CUDA device, got "
                         f"{rows.device}")
    if rows.dtype != torch.int32:
        raise ValueError(f"sum_rows sums int32 rows, got {rows.dtype}")
    if not _rows_are_flat(rows):
        raise ValueError(f"sum_rows needs each row contiguous, got shape "
                         f"{tuple(rows.shape)} strides {rows.stride()}")
    out = torch.empty(rows.shape[1:], dtype=torch.int32, device=rows.device)
    if not D:
        return out
    base, step = rows.data_ptr(), rows.stride(0) * rows.element_size()
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    acc_in = None
    for s in range(0, max(len(picked), 1), ROW_GROUP):
        group = picked[s:s + ROW_GROUP]
        ptrs = (ctypes.c_uint64 * max(len(group), 1))(
            *(base + b * step for b in group))
        status = _launcher()(ptrs, len(group), D, acc_in, out.data_ptr(),
                             stream)
        if status != 0:
            raise RuntimeError(f"row_sum kernel launch failed: CUDA error "
                               f"{status}")
        sum_rows.launches += 1
        tele.get_default().count("modsum_device_rows", len(group))
        acc_in = out.data_ptr()
    return out


sum_rows.launches = 0
sum_rows.plain_calls = 0


def reset_counts() -> None:
    sum_rows.launches = 0
    sum_rows.plain_calls = 0


def counts() -> dict:
    """The row-sum kernel's launches and plain-version calls, under the
    kernel's name."""
    return {"row_sum": {"launches": sum_rows.launches,
                        "plain_calls": sum_rows.plain_calls}}
