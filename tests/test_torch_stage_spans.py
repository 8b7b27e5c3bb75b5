"""The stage spans inside the port's aggregation engine, the host Threefry
tile counter, and the span clock's anchor on a profiler trace.

- ``AsyncServer.push`` holds ``push.clip``, ``push.encode`` and
  ``push.store``; its ``decode`` holds one ``decode.sum`` per chunk, one
  ``decode.recover`` per chunk on a recovering masked flush only,
  ``decode.finalize`` and ``decode.server``; every stage carries its
  engine span's ``round`` (and a push's ``slot``);
- ``ShardedAsyncServer``'s ``ingest``/``encode_push``/``push_encoded``,
  ``flush`` and ``decode`` carry ``round, topology, engine, eid`` in that
  order, in both topologies;
- a registry that records no spans records none and changes no bit;
- ``prf_host_tiles{rounds}`` counts each pass of the three host tile loops;
  a ``jax.random`` draw runs its loop on the CPU only (a meta or fake draw
  records the ``jax_random`` kernel's cost instead);
- ``Telemetry.epoch_unix_ns`` puts a span on ``torch.profiler``'s clock.
"""
import time

import pytest
import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core import telemetry as tele
from repro_torch.core.fl.async_fl import AsyncServer
from repro_torch.core.fl.hierarchy import ShardedAsyncServer
from repro_torch.core.telemetry import Telemetry
from repro_torch.kernels import prf
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

B = 4
CHUNK = 2048  # the model's 3700 elements in two chunks
FL = FLConfig(clip_norm=1.0, server_lr=1.0, secure_agg_bits=32,
              param_chunk_elems=CHUNK)
PUSH_STAGES = ["push.clip", "push.encode", "push.store"]


def _params():
    return {"w": torch.zeros(3000), "b": torch.zeros(700)}


def _delta(i):
    g = torch.Generator().manual_seed(i)
    return {"w": 0.02 * torch.randn(3000, generator=g),
            "b": 0.02 * torch.randn(700, generator=g)}


def _run(tel, mode):
    """A session with one absent slot (the deadline flush recovers it),
    then a full one."""
    srv = AsyncServer(_params(), FL, buffer_size=B, mask_mode=mode,
                      telemetry=tel, device="cpu")
    for i in range(B - 1):
        srv.push(_delta(i), srv.version)
    assert srv.flush(force=True)
    for i in range(B):
        srv.push(_delta(10 + i), srv.version)
    assert srv.version == 2
    return srv


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.sid]


def _ancestors(s, by_sid):
    out = []
    while s.parent is not None:
        s = by_sid[s.parent]
        out.append(s.sid)
    return out


@pytest.mark.parametrize("mode", ["tee_stream", "client", "off"])
def test_push_and_flush_stage_spans(mode):
    tel = Telemetry(record_spans=True, fence=True)
    srv = _run(tel, mode)
    spans = tel.spans
    by_sid = {s.sid: s for s in spans}
    pushes = [s for s in spans if s.name == "push"]
    assert len(pushes) == 2 * B - 1
    for p in pushes:
        # client mode encodes under encode_push and stores under
        # push_encoded, both inside the push
        stages = [s for s in spans if s.name in PUSH_STAGES
                  and p.sid in _ancestors(s, by_sid)]
        assert sorted(s.name for s in stages) == PUSH_STAGES
        for s in stages:
            assert (s.labels["round"], s.labels["slot"]) == \
                (p.labels["round"], p.labels["slot"])
    assert len({p.labels["slot"] for p in pushes[:B - 1]}) == B - 1
    decodes = [s for s in spans if s.name == "decode"]
    assert [d.labels["recovery"] for d in decodes] == [True, False]
    chunks = srv.plan.num_chunks
    assert chunks == 2
    for d in decodes:
        kids = _children(spans, d)
        recovers = d.labels["recovery"] and mode != "off"
        want = []
        for c in range(chunks):
            want += ["decode.sum"] + (["decode.recover"] if recovers else [])
        assert [k.name for k in kids] == \
            want + ["decode.finalize", "decode.server"]
        for k in kids:
            assert k.labels["round"] == d.labels["round"]
            assert k.dur_ns <= d.dur_ns
        assert [k.labels["chunk"] for k in kids
                if k.name == "decode.sum"] == list(range(chunks))
    assert all(s.labels["chunks"] == chunks for s in spans
               if s.name == "push.encode")


# the tier's engine spans: each one's own label keys after the session's
TIER_SPAN_KEYS = {"ingest": ("k", "lane"), "encode_push": ("k",),
                  "push_encoded": ("k",), "flush": ("forced", "fill"),
                  "decode": ("recovery", "fill"),
                  "push.clip": ("slot",), "push.encode": ("slot", "chunks")}
TIER_SESSION_KEYS = ("round", "topology", "engine", "eid")


def _stacked(lo, hi):
    ds = [_delta(i) for i in range(lo, hi)]
    return {k: torch.stack([d[k] for d in ds]) for k in ("w", "b")}


@pytest.mark.parametrize("two_level", [False, True], ids=["flat", "tree"])
@pytest.mark.parametrize("mode", ["tee_stream", "client"])
def test_tier_engine_spans_and_label_keys(mode, two_level):
    """``ShardedAsyncServer`` (one process, 2 leaves x 2 slots): a batch
    of 3, the deadline flush, then a batch of 4 that completes the
    session.  Every engine span carries ``round, topology, engine, eid``
    in that order, then its own keys; the one-process tier records no
    per-rank flush stages."""
    tel = Telemetry(record_spans=True, fence=True)
    srv = ShardedAsyncServer(_params(), FL, num_leaves=2, leaf_buffer=2,
                             mask_mode=mode, two_level=two_level,
                             telemetry=tel, device="cpu")
    srv.push(_stacked(0, B - 1), srv.version)
    assert srv.flush(force=True)
    srv.push(_stacked(10, 10 + B), srv.version)
    assert srv.version == 2
    spans = [s for s in tel.spans if s.name in TIER_SPAN_KEYS]
    ingest = ["ingest"] if mode == "tee_stream" else ["encode_push",
                                                      "push_encoded"]
    assert [s.name for s in spans if "." not in s.name] == \
        ingest + ["decode", "flush"] + ingest + ["decode"]
    assert {s.name for s in tel.spans} == set(TIER_SPAN_KEYS) - (
        {"encode_push", "push_encoded"} if mode == "tee_stream"
        else {"ingest"})
    topology = "tree" if two_level else "flat"
    for s in spans:
        assert tuple(s.labels) == TIER_SESSION_KEYS + TIER_SPAN_KEYS[s.name]
        assert (s.labels["topology"], s.labels["engine"],
                s.labels["eid"]) == (topology, "tier", srv._eid)
    rounds = [s.labels["round"] for s in spans if "." not in s.name]
    assert rounds == [0] * (len(ingest) + 2) + [1] * (len(ingest) + 1)
    assert [s.labels["slot"] for s in spans if s.name == "push.clip"] == \
        list(range(B - 1)) + list(range(B))
    decodes = [s for s in spans if s.name == "decode"]
    assert [(d.labels["recovery"], d.labels["fill"]) for d in decodes] == \
        [(True, B - 1), (False, B)]
    flush = next(s for s in spans if s.name == "flush")
    assert (flush.labels["forced"], flush.labels["fill"]) == (True, B - 1)
    assert decodes[0].parent == flush.sid


@pytest.mark.parametrize("mode", ["tee_stream", "client"])
def test_untraced_engine_records_nothing_and_changes_no_bit(mode):
    traced = _run(Telemetry(record_spans=True, fence=True), mode)
    off = Telemetry(record_spans=False)
    quiet = _run(off, mode)
    assert off.spans == []
    assert all(torch.equal(traced.params[k], quiet.params[k]) for k in "wb")
    assert off.value("stored_contributions", engine="async",
                     eid=quiet._eid) == 2 * B - 1


@pytest.fixture
def registry():
    """A fresh process registry, the previous one restored after."""
    tel = Telemetry(record_spans=False)
    prev = tele.set_default(tel)
    try:
        yield tel
    finally:
        tele.set_default(prev)


def _spy(monkeypatch, name):
    calls = []
    real = getattr(prf, name)

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(prf, name, spy)
    return calls


TILE = 1 << 14


@pytest.mark.parametrize("rows,length,want", [
    (1, 50_000, -(-50_000 // TILE)),
    (3, 20_000, -(-20_000 // ((TILE // 3) & ~1)))])
def test_prf_host_tiles_counts_uniform_block_tiles(monkeypatch, registry,
                                                   rows, length, want):
    monkeypatch.setattr(prf, "TILE", TILE)
    calls = _spy(monkeypatch, "words")
    keys = torch.arange(rows, dtype=torch.int64) + 7
    u = prf.uniform_block(keys, keys + 1, length)
    assert u.shape == (rows, length)
    assert registry.value("prf_host_tiles", rounds=13) == want == len(calls)
    assert registry.total("prf_host_tiles") == want


@pytest.mark.parametrize("pairs,length", [(9, 10_000), (3, 40_000)])
def test_prf_host_tiles_counts_signed_pair_sum_tiles(monkeypatch, registry,
                                                     pairs, length):
    monkeypatch.setattr(prf, "TILE", TILE)
    calls = _spy(monkeypatch, "words")
    group = max(1, min(pairs, TILE // 4096))
    step = (TILE // group) & ~1
    want = -(-pairs // group) * -(-length // step)
    lo = list(range(pairs))
    hi = [p + pairs for p in lo]
    prf.signed_pair_sum(5, 6, lo, hi, [1, -1, 1] * (pairs // 3), length)
    assert want > 2
    assert registry.value("prf_host_tiles", rounds=13) == want == len(calls)


@pytest.mark.parametrize("shape", [(3, 7000), (50_000,)])
def test_prf_host_tiles_counts_jax_draw_tiles(monkeypatch, registry, shape):
    monkeypatch.setattr(prf, "TILE", TILE)
    calls = _spy(monkeypatch, "_jax_lanes")
    n = 1
    for d in shape:
        n *= d
    prf.uniform(prf.PRNGKey(3), shape)
    assert registry.value("prf_host_tiles", rounds=20) == -(-n // TILE) \
        == len(calls)
    assert registry.value("prf_host_tiles", rounds=13) == 0


DRAWS = [("random_bits", torch.int64, 0), ("uniform", torch.float32, 2),
         ("normal", torch.float32, 60)]


@pytest.mark.parametrize("name,dtype,_", DRAWS)
def test_cpu_jax_draw_takes_the_plain_path(registry, name, dtype, _):
    """A CPU draw runs the host tile loop: ``plain_calls`` and
    ``prf_host_tiles{rounds=20}`` count it, and no kernel launches."""
    launches, plain = prf._draw.launches, prf._draw.plain_calls
    x = getattr(prf, name)(prf.PRNGKey(5), (3, 7))
    assert (x.shape, x.dtype, x.device.type) == ((3, 7), dtype, "cpu")
    assert prf._draw.plain_calls == plain + 1
    assert prf._draw.launches == launches
    assert registry.value("prf_host_tiles", rounds=20) == 1
    assert registry.total("prf_device_draws") == 0


def test_kernel_counts_hold_the_draw_kernel(registry):
    """``testing.kernel_counts`` reports the draw kernel beside the other
    wrappers (a CPU draw as a plain call), and ``reset_kernel_counts``
    zeroes it."""
    from repro_torch import testing
    testing.reset_kernel_counts()
    prf.normal(prf.PRNGKey(1), (5,))
    prf.randint(prf.PRNGKey(2), (3,), 0, 10)
    assert testing.kernel_counts()["jax_random"] == {"launches": 0,
                                                     "plain_calls": 3}
    testing.reset_kernel_counts()
    assert testing.kernel_counts()["jax_random"] == {"launches": 0,
                                                     "plain_calls": 0}


@pytest.mark.parametrize("name,dtype,flops", DRAWS)
def test_abstract_jax_draw_records_the_kernel(registry, name, dtype, flops):
    """A meta draw records ``jax_random``'s operations (the Threefry-20's
    integer ones and the finish's float ones) and bytes, returns its shape
    and dtype, and neither launches nor runs a host tile."""
    from repro_torch.launch import analysis
    launches, plain = prf._draw.launches, prf._draw.plain_calls
    with analysis.CostMode() as cm:
        x = getattr(prf, name)(prf.PRNGKey(5), (3, 7), device="meta")
    assert (x.shape, x.dtype, x.is_meta) == ((3, 7), dtype, True)
    size = torch.empty((), dtype=dtype).element_size()
    assert cm.counts.kernels["jax_random"] == {
        "calls": 1.0, "ops": 21.0 * flops, "int_ops": 21.0 * 60,
        "bytes": 21.0 * size}
    assert (cm.counts.float_ops, cm.counts.int_ops, cm.counts.bytes) == (
        21.0 * flops, 21.0 * 60, 21.0 * size)
    assert (prf._draw.launches, prf._draw.plain_calls) == (launches, plain)
    assert registry.total("prf_host_tiles") == 0
    assert registry.total("prf_device_draws") == 0


def test_fake_jax_draw_records_the_kernel(registry):
    """Under ``FakeTensorMode`` (the cost harness's tensors) a draw is
    abstract too: the kernel's cost, no launch, no host tile."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import analysis
    with analysis.CostMode() as cm, FakeTensorMode():
        x = prf.randint(prf.PRNGKey(5), (4, 16), 0, 100)
    assert x.shape == (4, 16)
    k = cm.counts.kernels["jax_random"]
    assert k["calls"] == 2.0  # two halves
    assert k["int_ops"] == 2 * 64 * prf.THREEFRY20_OPS
    assert registry.total("prf_host_tiles") == 0


def test_span_clock_places_a_span_on_the_profiler_clock():
    """A span around a large ``torch.mm``, moved onto the profiler's clock
    through ``epoch_unix_ns`` and kineto's ``trace_start_ns``, holds the
    op's event to within 100 us."""
    from torch.profiler import ProfilerActivity, profile
    a, b = torch.randn(768, 768), torch.randn(768, 768)
    torch.mm(a, b)
    tel = Telemetry(record_spans=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        time.sleep(0.005)
        with tel.span("mm"):
            torch.mm(a, b)
        time.sleep(0.005)
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    ev = [e for e in prof.events() if e.name == "aten::mm"]
    assert len(ev) == 1
    (sp,) = tel.spans
    s0 = tel.epoch_unix_ns + sp.t0_ns
    e0 = start_ns + 1000 * ev[0].time_range.start
    e1 = start_ns + 1000 * ev[0].time_range.end
    assert s0 - 100_000 <= e0 < e1 <= s0 + sp.dur_ns + 100_000
