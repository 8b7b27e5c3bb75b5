"""The port's observability exports and funnel reconciler against the JAX
package's (twin of ``tests/test_telemetry.py``'s conservation, exporter and
seam cases, and of ``examples/observability_smoke.py``).

Two kinds of equality, both exact:

- the same chaos schedule (one ``FaultSpec``) over the port's engines and
  the reference's records the same ledger: ``reconcile(...).totals`` are
  equal and report no problem, on the flat server in all four mask modes
  and on the 2-leaf tier with a leaf death (the tier's leaves multiplexed
  onto the one device, as the reference's multidev cases are on eight);
- given one recorded ledger, the port's ``chrome_trace``,
  ``prometheus_text``, ``write_chrome_trace``, ``write_prometheus`` and
  ``write_round_csv`` write the reference's bytes.  Span times come from
  the host clock, so the reference exporters read a copy of the port's
  registry rather than a second run.
"""
import csv
import dataclasses
import importlib.util
import json
import os
import re
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

from repro.configs.base import FLConfig as JFL
from repro.core import obs as jobs
from repro.core import telemetry as jtele
from repro.core.fl import async_fl as jafl
from repro.core.fl import faults as jfaults
from repro.core.fl.hierarchy import ShardedAsyncServer as JTier
from repro_torch.configs.base import FLConfig
from repro_torch.core import obs
from repro_torch.core.fl.async_fl import AsyncServer
from repro_torch.core.fl.faults import FaultInjector, FaultPlan, FaultSpec
from repro_torch.core.fl.hierarchy import ShardedAsyncServer
from repro_torch.core.telemetry import Telemetry
from repro_torch.examples import observability_smoke as smoke
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

REPO = Path(__file__).resolve().parents[1]
D = 41
FL_KW = dict(clip_norm=1.0, server_lr=1.0, secure_agg_bits=24)
FL = FLConfig(**FL_KW)
JFL_ = JFL(**FL_KW)
MODES = ("off", "tee", "tee_stream", "client")
CHAOS_KW = dict(p_client_death=0.1, p_duplicate=0.3, p_delay=0.3,
                delay_pushes=2, p_reorder=0.3, seed=5)


def _params():
    return {"w": torch.zeros(D), "b": torch.zeros(3)}


def _jparams():
    return {"w": jnp.zeros((D,), jnp.float32), "b": jnp.zeros((3,), jnp.float32)}


def _deltas(n):
    return [smoke.default_delta(i, device="cpu") for i in range(n)]


def _jx(tree):
    return {k: jnp.asarray(v.numpy()) for k, v in tree.items()}


def _drive(srv, n, spec, ref=False):
    if ref:
        inj = jfaults.FaultInjector(srv, jfaults.FaultPlan(spec))
    else:
        inj = FaultInjector(srv, FaultPlan(spec))
    for d in _deltas(n):
        inj.push(_jx(d) if ref else d, srv.version)
    inj.flush(force=True)
    return inj


def _to_reference(tel: Telemetry) -> "jtele.Telemetry":
    """A reference registry holding exactly the port registry's ledger."""
    j = jtele.Telemetry(record_spans=True)
    j.session_id = tel.session_id
    j.epoch_ns = tel.epoch_ns
    j._counters = dict(tel._counters)
    j._gauges = dict(tel._gauges)
    j._hist_bounds = dict(tel._hist_bounds)
    for key, h in tel._hists.items():
        jh = jtele._Hist(h.bounds)
        jh.counts, jh.total, jh.n = list(h.counts), h.total, h.n
        j._hists[key] = jh
    j.spans = [jtele.SpanRecord(s.name, s.sid, s.parent, s.t0_ns, s.dur_ns,
                                dict(s.labels)) for s in tel.spans]
    return j


def _assert_exports_equal(tel: Telemetry, tmp_path: Path) -> None:
    j = _to_reference(tel)
    assert obs.chrome_trace(tel) == jobs.chrome_trace(j)
    assert obs.prometheus_text(tel) == jobs.prometheus_text(j)
    for name, port_fn, ref_fn in (
            ("trace.json", obs.write_chrome_trace, jobs.write_chrome_trace),
            ("metrics.prom", obs.write_prometheus, jobs.write_prometheus),
            ("rounds.csv", obs.write_round_csv, jobs.write_round_csv)):
        a, b = tmp_path / f"port-{name}", tmp_path / f"ref-{name}"
        assert port_fn(tel, str(a)) == ref_fn(j, str(b))
        assert a.read_bytes() == b.read_bytes(), name
    rep, jrep = obs.reconcile(tel), jobs.reconcile(j)
    assert (rep.totals, rep.problems) == (jrep.totals, jrep.problems)


# --- funnel conservation: the headline invariant ----------------------------
@pytest.mark.parametrize("mode", MODES)
def test_flat_chaos_conserves(mode, tmp_path):
    spec = FaultSpec(**CHAOS_KW)
    tel = Telemetry(record_spans=True)
    srv = AsyncServer(_params(), FL, buffer_size=4, mask_mode=mode,
                      strict=False, telemetry=tel, device="cpu")
    inj = _drive(srv, 40, spec)
    rep = obs.reconcile(tel, applied_updates=srv._applied_updates)
    assert rep.ok, rep.problems
    assert rep.totals["submitted"] == 40
    assert rep.totals["landed"] == len(inj.delivered)
    assert rep.totals["in_flight"] == 0
    assert rep.totals["buffered"] == 0
    jtel = jtele.Telemetry(record_spans=True)
    jsrv = jafl.AsyncServer(_jparams(), JFL_, buffer_size=4, mask_mode=mode,
                            strict=False, telemetry=jtel)
    _drive(jsrv, 40, jfaults.FaultSpec(**CHAOS_KW), ref=True)
    jrep = jobs.reconcile(jtel, applied_updates=jsrv._applied_updates)
    assert rep.totals == jrep.totals and jrep.ok
    _assert_exports_equal(tel, tmp_path)


@pytest.mark.parametrize("mode", MODES)
def test_flat_chaos_conserves_under_replay(mode):
    spec = FaultSpec(**CHAOS_KW)
    tel = Telemetry(record_spans=True)
    srv = AsyncServer(_params(), FL, buffer_size=4, mask_mode=mode,
                      strict=False, telemetry=tel, device="cpu")
    inj = _drive(srv, 40, spec)
    tel2 = Telemetry(record_spans=True)
    srv2 = AsyncServer(_params(), FL, buffer_size=4, mask_mode=mode,
                       strict=False, telemetry=tel2, device="cpu")
    inj2 = FaultInjector(srv2, inj.plan.replayed())
    for d in _deltas(40):
        inj2.push(d, srv2.version)
    inj2.flush(force=True)
    rep = obs.reconcile(tel2, applied_updates=srv2._applied_updates)
    assert rep.ok, rep.problems
    assert rep.totals == obs.reconcile(tel).totals
    assert inj2.plan.trace == inj.plan.trace
    assert all(torch.equal(srv.params[k], srv2.params[k]) for k in "wb")


def test_duplicates_never_double_land():
    tel = Telemetry()
    srv = AsyncServer(_params(), FL, buffer_size=4, mask_mode="client",
                      strict=False, telemetry=tel, device="cpu")
    inj = _drive(srv, 40, FaultSpec(**CHAOS_KW))
    seqs = [s for s, _ in inj.delivered]
    assert len(seqs) == len(set(seqs))
    assert srv.fault_metrics["duplicate_pushes"] > 0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("two_level", (False, True))
def test_tier_chaos_with_leaf_death_conserves(mode, two_level, tmp_path):
    spec = FaultSpec(**CHAOS_KW, leaf_deaths=(("ingest", 1, 1),))
    tel = Telemetry(record_spans=True)
    srv = ShardedAsyncServer(_params(), FL, num_leaves=2, leaf_buffer=2,
                             mask_mode=mode, two_level=two_level,
                             strict=False, telemetry=tel, device="cpu")
    _drive(srv, 24, spec)
    rep = obs.reconcile(tel, applied_updates=srv._applied_updates)
    assert rep.ok, rep.problems
    assert rep.totals["lost"] > 0  # the leaf death cost something
    assert srv.fault_metrics["dead_leaves"] >= 1
    # the schedule does not depend on the topology: the reference tree's
    # ledger is this one's
    jtel = jtele.Telemetry(record_spans=True)
    jsrv = JTier(_jparams(), JFL_, num_leaves=2, leaf_buffer=2,
                 mask_mode=mode, two_level=True, strict=False,
                 telemetry=jtel)
    _drive(jsrv, 24, jfaults.FaultSpec(
        **CHAOS_KW, leaf_deaths=(("ingest", 1, 1),)), ref=True)
    assert rep.totals == jobs.reconcile(
        jtel, applied_updates=jsrv._applied_updates).totals
    if two_level:
        _assert_exports_equal(tel, tmp_path)


def test_reconcile_flags_imbalance():
    tel, jtel = Telemetry(), jtele.Telemetry()
    for t in (tel, jtel):
        t.count("stored_contributions", 5)
        t.count("aggregated_contributions", 3)  # 2 unaccounted
    rep = obs.reconcile(tel)
    assert not rep.ok
    assert any("stored == aggregated" in p for p in rep.problems)
    assert rep.problems == jobs.reconcile(jtel).problems


def test_decode_count_cross_check():
    tel = Telemetry()
    srv = AsyncServer(_params(), FL, buffer_size=4, strict=False,
                      telemetry=tel, device="cpu")
    for d in _deltas(4):
        srv.push(d, srv.version)
    assert obs.reconcile(tel, applied_updates=srv._applied_updates).ok
    assert not obs.reconcile(tel, applied_updates=99).ok


# --- exporters ------------------------------------------------------------------
def _recorded_run():
    tel = Telemetry(record_spans=True)
    srv = AsyncServer(_params(), FL, buffer_size=4, mask_mode="client",
                      strict=False, telemetry=tel, device="cpu")
    for d in _deltas(6):
        srv.push(d, srv.version)
    srv.flush(force=True)
    return tel, srv


_PROM_LINE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? -?[0-9.e+-]+$")


def test_chrome_trace_schema(tmp_path):
    tel, _ = _recorded_run()
    path = tmp_path / "trace.json"
    obs.write_chrome_trace(tel, str(path))
    doc = json.loads(path.read_text())
    events = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert events
    for e in events:
        assert set(e) >= {"name", "ph", "pid", "tid", "ts", "dur"}
        assert e["ts"] >= 0 and e["dur"] >= 0
    assert {"push", "encode_push", "push_encoded", "decode",
            "flush"} <= {e["name"] for e in events}
    by_sid = {e["args"]["sid"]: e for e in events}
    for e in events:
        p = e["args"].get("parent")
        if p is not None and p in by_sid:
            pe = by_sid[p]
            assert pe["ts"] <= e["ts"]
            assert e["ts"] + e["dur"] <= pe["ts"] + pe["dur"] + 1e-3
    _assert_exports_equal(tel, tmp_path)


def test_prometheus_text_parses(tmp_path):
    tel, _ = _recorded_run()
    path = tmp_path / "metrics.prom"
    obs.write_prometheus(tel, str(path))
    text = path.read_text()
    assert "# TYPE stored_contributions counter" in text
    for line in text.strip().splitlines():
        if line.startswith("#"):
            assert re.match(r"^# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* "
                            r"(counter|gauge|histogram)$", line), line
        else:
            assert _PROM_LINE.match(line), line


def test_prometheus_histogram_cumulative():
    tel, jtel = Telemetry(), jtele.Telemetry()
    for t in (tel, jtel):
        t.observe("lat", 1e-6)
        t.observe("lat", 1.0)
    text = obs.prometheus_text(tel)
    buckets = [int(line.rsplit(" ", 1)[1]) for line in text.splitlines()
               if line.startswith("lat_bucket")]
    assert buckets == sorted(buckets)
    assert buckets[-1] == 2
    assert "lat_count 2" in text
    assert text == jobs.prometheus_text(jtel)


def test_round_csv(tmp_path):
    tel, _ = _recorded_run()
    path = tmp_path / "rounds.csv"
    nrows = obs.write_round_csv(tel, str(path))
    assert nrows > 0
    with open(path) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["round", "span", "calls", "total_ms", "max_ms"]
    assert len(rows) == nrows + 1
    assert "decode" in {r[1] for r in rows[1:]}


# --- seams: round builders, the orchestrator ---------------------------------
def test_round_step_spans():
    from repro_torch.core.fl.round import (build_round_step,
                                           build_sharded_round_step,
                                           init_fl_state)

    def loss_fn(params, batch):
        pred = batch["x"] @ params["w"]
        return torch.mean((pred - batch["y"]) ** 2), {}

    tel = Telemetry(record_spans=True)
    fl = dataclasses.replace(FL, local_steps=1)
    params = {"w": torch.zeros(3)}
    batch = {"x": torch.ones(4, 2, 3), "y": torch.zeros(4, 2)}
    for build, kw in ((build_round_step, {}),
                      (build_sharded_round_step, {"num_leaves": 2})):
        step = build(loss_fn, fl, cohort_size=4, telemetry=tel,
                     device="cpu", **kw)
        state = init_fl_state(params, fl)
        state, _ = step(state, batch, (0, 0))
        state, _ = step(state, batch, (0, 1))
    names = [s.name for s in tel.spans]
    assert names.count("round.setup") == 2
    assert names.count("round.execute") == 4
    calls = [(s.labels["kind"], s.labels["call"]) for s in tel.spans
             if s.name == "round.execute"]
    assert calls == [("sync", 0), ("sync", 1), ("sharded", 0),
                     ("sharded", 1)]


def test_orchestrator_telemetry():
    from repro_torch.core.device_sim import DevicePopulation
    from repro_torch.core.orchestrator import MetadataStore, Orchestrator
    tel = Telemetry(record_spans=True)
    orch = Orchestrator(DevicePopulation(n=64, seed=3), MetadataStore(),
                        seed=0, telemetry=tel)
    cohort = orch.select_cohort(8)
    assert tel.total("cohort_checked") >= len(cohort)
    assert tel.total("cohort_eligible") == \
        tel.total("cohort_checked") - tel.total("cohort_ineligible")
    assert any(s.name == "cohort_select" for s in tel.spans)


# --- the example twin ------------------------------------------------------------
def _reference_example():
    """Load ``examples/observability_smoke.py`` without running it (its
    import sets a default XLA_FLAGS; the environment is restored)."""
    env = dict(os.environ)
    try:
        spec = importlib.util.spec_from_file_location(
            "_ref_obs_smoke", REPO / "examples" / "observability_smoke.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        os.environ.clear()
        os.environ.update(env)
    return mod


def test_observability_smoke_twin_prints_the_reference_ledgers(tmp_path,
                                                               capsys):
    session = {}
    assert smoke.main(["--device", "cpu", "--out", str(tmp_path / "port")],
                      session=session) == 0
    got = capsys.readouterr().out.splitlines()
    ref = _reference_example()
    assert ref.main(["--out", str(tmp_path / "ref")]) == 0
    want = capsys.readouterr().out.splitlines()
    assert got[:2] == want[:2]  # "recorded: {...}", "replayed: {...}"
    assert got[2].startswith("exported ") and want[2].startswith("exported ")
    assert got[2].split()[1:4] == want[2].split()[1:4]  # span/row counts
    for name in ("trace.json", "metrics.prom", "rounds.csv"):
        assert (tmp_path / "port" / name).stat().st_size > 0
    srv, srv2 = session["srv"], session["srv2"]
    assert all(torch.equal(srv.params[k], srv2.params[k]) for k in "wb")
    assert session["inj"].plan.trace == session["inj2"].plan.trace
