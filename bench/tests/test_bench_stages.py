"""The stage readers (``metrics_stages``) on small CPU cells: the span and
counter readers read what the system records, the idle readers need a
device trace and return None without one, and the idle arithmetic on
intervals made up by hand."""
import pytest

from bench import harness as H
from bench import metrics_stages as S
from bench.tests.small import small_spec

BM = H.benchmark()


NEW = ("clip_ms", "store_ms", "sum_ms", "recovery_ms", "push_idle_ms",
       "decode_idle_ms", "prf_tiles")


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


def _window(cell, seconds=1.5):
    """Set-up and window, then (the open session closed) the new readers
    on a ctx as a traced run builds it, without its profile."""
    from repro_torch.core.telemetry import Telemetry
    tel = Telemetry(record_spans=True, fence=True)
    spec = small_spec(cell)
    entry = spec["traffic"]["entry"]
    run = H.load_entry(entry).Cell(spec, 2 ** 33 + 5, "cpu", tel)
    n0 = len(tel.spans)
    run.window(seconds)
    ctx = {"entry": entry, "spans": tel.spans[n0:], "window_s": run.window_s,
           "profile": None, "work": run.work(), "cell": run}
    if entry == "agg" and run.queue:
        run._session()
    _, per_layer = H.metrics_for(cell, BM)
    new = [m for m in per_layer if m["name"].split(".")[0] in NEW]
    return H.read_layer_metrics(new, ctx), run


def test_drop_cell_stage_readers(registry):
    got, run = _window("agg.whisper-tiny.drop")
    assert set(got) == {"clip_ms.host", "recovery_ms.host", "prf_tiles.host"}
    assert all(m["value"] > 0 for m in got.values())
    # every version draws the same tiles: the run's quotient is one more
    # version's own count
    t0 = registry.total("prf_host_tiles")
    run._session()
    assert got["prf_tiles.host"]["value"] == \
        registry.total("prf_host_tiles") - t0


def test_tee_cell_reads_no_recovery(registry):
    got, _ = _window("agg.whisper-tiny.tee")
    assert set(got) == {"clip_ms.host"}


def test_mamba_cell_stage_readers(registry):
    got, _ = _window("agg.mamba2-780m.tee")
    assert set(got) == {"clip_ms.agg", "store_ms.agg", "sum_ms.agg"}
    assert all(m["value"] > 0 for m in got.values())


def test_train_cell_tile_reader(registry):
    got, run = _window("train.whisper-tiny", seconds=0.5)
    assert set(got) == {"prf_tiles.train"}
    t0 = registry.total("prf_host_tiles")
    run._timed_round()
    assert got["prf_tiles.train"]["value"] == \
        registry.total("prf_host_tiles") - t0 > 0


def test_no_counter_no_tile_reading(registry):
    """A system without the counter (or a run before any tile) reads
    nothing."""
    _, run = _window("agg.whisper-tiny.tee")
    registry._counters.clear()
    assert S.tiles_per_unit({"entry": "agg", "cell": run}, "agg") is None


def test_idle_gaps_and_cover():
    dev = [(0, 10), (5, 12), (20, 30), (40, 41)]
    assert S.idle_gaps(dev) == [(12, 20), (30, 40)]
    spans = [(0, 35, "push"), (14, 18, "push.clip"), (28, 34, "decode"),
             (29, 29.5, "decode.sum")]
    # (12, 20): push, push.clip, push; (30, 40): push and decode, push,
    # no span
    got = S.idle_by_cover(S.idle_gaps(dev), spans)
    assert got == [(2, ("push",)), (4, ("push", "push.clip")),
                   (2, ("push",)), (4, ("push", "decode")),
                   (1, ("push",)), (5, ())]
    ctx = {"idle_profile": {"idle": got, "pushes": 2, "versions": 1}}
    assert S.idle_ms(ctx, "push", "pushes", outside="decode") == \
        pytest.approx(1e-3 * 9 / 2)
    assert S.idle_ms(ctx, "decode", "versions") == pytest.approx(1e-3 * 4)


def test_idle_gap_outside_every_span():
    got = S.idle_by_cover([(0, 10)], [(2, 4, "push")])
    assert got == [(2, ()), (2, ("push",)), (6, ())]
