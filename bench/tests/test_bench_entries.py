"""Each entry rehearsed on the CPU at a small size, the result line's shape,
and the refusals: no card, and device metrics asked of a CPU run."""
import json
from unittest import mock

import pytest

from bench import harness as H
from bench import run as R
from bench.tests.small import small_spec

BM = H.benchmark()
CELLS = [w["name"] for w in BM["workloads"]]


def _shape(out, name, trace):
    e2e, per_layer = H.metrics_for(name, BM)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    want = per_layer if trace else e2e
    assert set(out["metrics"]) == {m["name"] for m in want}
    for m in want:
        got = out["metrics"][m["name"]]
        assert got["unit"] == m["unit"] and got["value"] > 0
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for k, v in out["checks"].items():
        assert set(v) == {"value", "limit"}, k
    json.dumps(out)


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_is_correct_and_well_formed(cell):
    out, checks = R.run_cell(cell, small_spec(cell), 2 ** 31 + 11, 1.5,
                             False, "cpu")
    assert out["correct"], checks
    assert out["failed"] == 0 and out["attempted"] > 0
    _shape(out, cell, trace=False)


@pytest.mark.parametrize("cell", ["agg.whisper-tiny.tee",
                                  "train.whisper-tiny"])
def test_device_metrics_on_the_cpu_fail(cell):
    with pytest.raises(RuntimeError, match="CUDA"):
        R.run_cell(cell, small_spec(cell), 7, 1.5, True, "cpu")


def test_no_card_no_result(capsys):
    with mock.patch("torch.cuda.is_available", return_value=False):
        rc = R.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                     "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_same_seed_same_inputs():
    from repro_torch.core.telemetry import Telemetry
    spec = small_spec("agg.whisper-tiny.drop")
    entry = H.load_entry("agg")
    a = entry.Cell(spec, 123456789012, "cpu", Telemetry(record_spans=False))
    b = entry.Cell(spec, 123456789012, "cpu", Telemetry(record_spans=False))
    assert a.pool_flat.equal(b.pool_flat) and a.p0_flat.equal(b.p0_flat)
    assert a.log == b.log


def test_layer_metrics_from_spans():
    """The span-based readers on a CPU run's spans (the trace's readers
    need the card)."""
    from repro_torch.core.telemetry import Telemetry
    tel = Telemetry(record_spans=True, fence=True)
    spec = small_spec("agg.whisper-tiny.drop")
    run = H.load_entry("agg").Cell(spec, 5, "cpu", tel)
    n0 = len(tel.spans)
    run.window(1.5)
    ctx = {"entry": "agg", "spans": tel.spans[n0:], "window_s": run.window_s,
           "profile": None, "work": run.work(), "cell": run}
    _, per_layer = H.metrics_for("agg.whisper-tiny.drop", BM)
    got = H.read_layer_metrics(per_layer, ctx)
    assert {"ingest_ms.host", "decode_ms.host", "agg_mfu.host",
            "ingest_mfu.host"} <= set(got)
    assert "k1_roofline.host" not in got and "idle_share.host" not in got
    assert 0 < got["agg_mfu.host"]["value"] < 100
    assert 0 < got["ingest_mfu.host"]["value"] < 100
