"""The device row-sum reader (``metrics/row_sums.agg.py``) on a small CPU
mamba cell: the CPU sums its rows on the host, so it reads nothing; with
the system's counter present it reads the count a version."""
import pytest

from bench import harness as H
from bench.tests.small import small_spec

BM = H.benchmark()


@pytest.fixture
def registry():
    """A fresh process registry, the previous one restored after."""
    from repro_torch.core import telemetry as tele
    from repro_torch.core.telemetry import Telemetry
    tel = Telemetry(record_spans=False)
    prev = tele.set_default(tel)
    try:
        yield tel
    finally:
        tele.set_default(prev)


def _read(run, tel, entry="agg"):
    ctx = {"entry": entry, "spans": tel.spans, "window_s": run.window_s,
           "profile": None, "work": run.work(), "cell": run}
    _, per_layer = H.metrics_for("agg.mamba2-780m.tee", BM)
    sums = [m for m in per_layer if m["name"] == "row_sums.agg"]
    assert len(sums) == 1
    return H.read_layer_metrics(sums, ctx)


def test_agg_cell_row_sum_reader(registry):
    from repro_torch.core.telemetry import Telemetry
    from repro_torch.kernels import row_sum
    tel = Telemetry(record_spans=True, fence=True)
    plain = row_sum.sum_rows.plain_calls
    run = H.load_entry("agg").Cell(small_spec("agg.mamba2-780m.tee"),
                                   2 ** 33 + 11, "cpu", tel)
    run.window(0.5)
    # on the CPU every flush sums on the host: no device row to read
    assert row_sum.sum_rows.plain_calls > plain
    assert _read(run, tel) == {}
    chunks = run.srv.plan.num_chunks
    registry.count("modsum_device_rows", run.B * chunks * len(run.log))
    got = _read(run, tel)
    assert got == {"row_sums.agg": {"value": float(run.B * chunks),
                                    "unit": "rows"}}
    assert _read(run, tel, entry="train") == {}
