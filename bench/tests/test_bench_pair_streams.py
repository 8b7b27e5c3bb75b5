"""The device pair-stream reader (``metrics/pair_streams.host.py``) on a
small CPU drop cell: the CPU sweeps its pairs in the host tile loop, so it
reads nothing; with the system's counter present it reads the count a
version."""
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
    _, per_layer = H.metrics_for("agg.whisper-tiny.drop", BM)
    pairs = [m for m in per_layer if m["name"] == "pair_streams.host"]
    assert len(pairs) == 1
    return H.read_layer_metrics(pairs, ctx)


def test_drop_cell_pair_stream_reader(registry):
    from repro_torch.core.telemetry import Telemetry
    tel = Telemetry(record_spans=True, fence=True)
    run = H.load_entry("agg").Cell(small_spec("agg.whisper-tiny.drop"),
                                   2 ** 33 + 13, "cpu", tel)
    run.window(0.5)
    # on the CPU every sweep runs the host tile loop: no device pair
    assert registry.total("prf_host_tiles") > 0
    assert _read(run, tel) == {}
    chunks = run.srv.plan.num_chunks
    edges = run.B - 1  # one absent slot of a complete graph
    registry.count("prf_device_pairs", edges * chunks * len(run.log),
                   rounds=13)
    got = _read(run, tel)
    assert got == {"pair_streams.host": {"value": float(edges * chunks),
                                         "unit": "pairs"}}
    assert _read(run, tel, entry="train") == {}
