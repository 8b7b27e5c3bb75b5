"""The flush's modular row sum (``kernels.row_sum.sum_rows``, D2) on the CPU
and on abstract tensors.

- a CPU tensor takes the plain version: each case equals the Python-int sum
  of its gated rows mod 2^32, counted as a plain call, with no launch and
  no ``modsum_device_rows``;
- every streamed flush of ``AsyncServer`` sums each chunk through it;
- a meta or fake tensor records the kernel's bytes, one call a launch of at
  most 64 gated rows, and launches nothing.

The kernel itself is held against these cases on the card in
``tests/test_torch_cuda.py``.
"""
import pytest
import torch

from repro_torch import testing
from repro_torch.configs.base import FLConfig
from repro_torch.core import telemetry as tele
from repro_torch.core.fl import aggregation as agg
from repro_torch.core.fl.async_fl import AsyncServer
from repro_torch.core.telemetry import Telemetry
from repro_torch.kernels import row_sum
from repro_torch.launch import analysis
from repro_torch.testing import ROW_SUM_CASES, pin_cpu_threads, row_sum_case

pin_cpu_threads()


@pytest.fixture
def registry():
    """A fresh process registry, the previous one restored after."""
    tel = Telemetry(record_spans=False)
    prev = tele.set_default(tel)
    try:
        yield tel
    finally:
        tele.set_default(prev)


def python_sum(rows, gate):
    """The gated rows' sum in Python ints, wrapped to int32."""
    B, width = rows.shape[0], rows.shape[1:].numel()
    flat = rows.reshape(B, width).tolist()
    out = []
    for j in range(width):
        s = sum(flat[b][j] for b in range(B) if gate is None or gate[b])
        out.append((s + 2 ** 31) % 2 ** 32 - 2 ** 31)
    return torch.tensor(out, dtype=torch.int32).reshape(rows.shape[1:])


@pytest.mark.parametrize("name", ROW_SUM_CASES)
def test_sum_rows_is_the_python_int_sum_mod_2_32(registry, name):
    rows, gate = row_sum_case(name)
    launches, plain = row_sum.sum_rows.launches, row_sum.sum_rows.plain_calls
    got = agg.sum_rows(rows, gate)
    assert (got.shape, got.dtype) == (rows.shape[1:], torch.int32)
    assert torch.equal(got, python_sum(rows, gate))
    assert row_sum.sum_rows.plain_calls == plain + 1
    assert row_sum.sum_rows.launches == launches
    assert registry.total("modsum_device_rows") == 0


def test_extremes_wrap():
    """The extremes case wraps: INT32_MIN + INT32_MAX + ... leaves int32."""
    rows, _ = row_sum_case("extremes")
    exact = rows.to(torch.int64).sum(0)
    assert bool((exact < -2 ** 31).any()) and bool((exact >= 2 ** 31).any())


@pytest.mark.parametrize("mode", ["tee_stream", "client", "off"])
def test_streamed_flush_sums_each_chunk_through_the_wrapper(mode):
    """Two flushes (a recovering one, then a full one) of a model in two
    chunks: one ``sum_rows`` a ``decode.sum`` span."""
    B, chunk = 4, 2048
    fl = FLConfig(clip_norm=1.0, server_lr=1.0, secure_agg_bits=32,
                  param_chunk_elems=chunk)
    tel = Telemetry(record_spans=True)
    srv = AsyncServer({"w": torch.zeros(3000), "b": torch.zeros(700)}, fl,
                      buffer_size=B, mask_mode=mode, telemetry=tel,
                      device="cpu")
    g = torch.Generator().manual_seed(0)
    plain = row_sum.sum_rows.plain_calls
    for n in (B - 1, B):
        for _ in range(n):
            srv.push({"w": 0.02 * torch.randn(3000, generator=g),
                      "b": 0.02 * torch.randn(700, generator=g)},
                     srv.version)
        if n < B:
            assert srv.flush(force=True)
    assert srv.version == 2
    sums = sum(1 for s in tel.spans if s.name == "decode.sum")
    assert sums == 2 * 2
    assert row_sum.sum_rows.plain_calls == plain + sums


# (rows, gated rows) -> the launches' gated rows: 64 a launch at most, each
# launch after the first also reading the sum so far
ABSTRACT = [(10, None, [10]), (10, [b % 2 == 0 for b in range(10)], [5]),
            (10, [False] * 10, [0]), (65, None, [64, 1]),
            (130, [b != 7 for b in range(130)], [64, 64, 1])]


@pytest.mark.parametrize("B,gate,groups", ABSTRACT)
@pytest.mark.parametrize("where", ["meta", "fake"])
def test_abstract_sum_rows_records_the_kernel(registry, B, gate, groups,
                                              where):
    from torch._subclasses.fake_tensor import FakeTensorMode
    D = 4099
    launches, plain = row_sum.sum_rows.launches, row_sum.sum_rows.plain_calls
    with analysis.CostMode() as cm:
        if where == "meta":
            rows = torch.empty((B, D), dtype=torch.int32, device="meta")
            got = agg.sum_rows(rows, gate)
        else:
            with FakeTensorMode():
                rows = torch.empty((B, D), dtype=torch.int32)
                got = agg.sum_rows(rows, gate)
    assert (tuple(got.shape), got.dtype) == ((D,), torch.int32)
    read = [n + (i > 0) for i, n in enumerate(groups)]
    assert cm.counts.kernels["row_sum"] == {
        "calls": float(len(groups)), "ops": 0.0,
        "int_ops": float(sum(read) * D),
        "bytes": float(sum(n + 1 for n in read) * D * 4)}
    assert (row_sum.sum_rows.launches,
            row_sum.sum_rows.plain_calls) == (launches, plain)
    assert registry.total("modsum_device_rows") == 0


def test_kernel_counts_hold_the_row_sum_kernel():
    testing.reset_kernel_counts()
    agg.sum_rows(torch.zeros((3, 5), dtype=torch.int32))
    assert testing.kernel_counts()["row_sum"] == {"launches": 0,
                                                  "plain_calls": 1}
    testing.reset_kernel_counts()
    assert testing.kernel_counts()["row_sum"] == {"launches": 0,
                                                  "plain_calls": 0}
