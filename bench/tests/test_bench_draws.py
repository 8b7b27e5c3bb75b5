"""The device-draw reader (``metrics/prf_draws.train.py``) on a small CPU
train cell: the CPU draws on the host, so it reads nothing; with the
system's counter present it reads the count a round."""
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


def _read(run, tel, entry="train"):
    ctx = {"entry": entry, "spans": tel.spans, "window_s": run.window_s,
           "profile": None, "work": run.work(), "cell": run}
    _, per_layer = H.metrics_for("train.whisper-tiny", BM)
    draws = [m for m in per_layer if m["name"] == "prf_draws.train"]
    assert len(draws) == 1
    return H.read_layer_metrics(draws, ctx)


def test_train_cell_draw_reader(registry):
    from repro_torch.core.telemetry import Telemetry
    tel = Telemetry(record_spans=True, fence=True)
    run = H.load_entry("train").Cell(small_spec("train.whisper-tiny"),
                                     2 ** 33 + 7, "cpu", tel)
    run.window(0.5)
    # on the CPU every draw is a host tile loop: no device draw to read
    assert registry.total("prf_host_tiles") > 0
    assert _read(run, tel) == {}
    registry.count("prf_device_draws", 990 * run.round, rounds=20)
    got = _read(run, tel)
    assert got == {"prf_draws.train": {"value": 990.0, "unit": "draws"}}
    assert _read(run, tel, entry="agg") == {}
