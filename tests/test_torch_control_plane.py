"""The port's control plane against the JAX package's, on the same seeds:
twin of ``tests/test_control_plane.py``.

The orchestrator, device simulator, joiner, feature store and funnel logger
are numpy/pure-Python copies (or ports over the port's modules), so every
result is held EQUAL to the reference's: eligibility verdicts, the selected
cohort's device ids, cooldown, the submission policy and its seeded keep
decisions, spec pushes and versioning, the orchestrator's telemetry
counters and gauges, the joiner's joins, the feature store's blobs.  The
signal transformer computes in torch where the reference computes in jnp:
its outputs are held to f32 equality (the same single ops).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import device_sim as jsim
from repro.core import joiner as jjoin
from repro.core import orchestrator as jorch
from repro.core import signal_transformer as jst
from repro.core import telemetry as jtele
from repro.core.analytics.normalization import NormalizationFactors as JNF
from repro.data import feature_store as jfs
from repro_torch.core import device_sim as sim
from repro_torch.core import telemetry as tele
from repro_torch.core.analytics.normalization import NormalizationFactors
from repro_torch.core.funnel_logging import FunnelLogger, new_session_id
from repro_torch.core.joiner import FeatureRow, Joiner, LabelEvent
from repro_torch.core.orchestrator import (
    FUNNEL_PHASES, EligibilityCriteria, MetadataStore, Orchestrator,
)
from repro_torch.core.signal_transformer import (
    SignalTransformer, TransformSpec, spec_with_normalization, validate_spec,
)
from repro_torch.data.feature_store import DeviceFeatureStore


def _pair(n, seed, **kw):
    return (Orchestrator(sim.DevicePopulation(n, seed=seed),
                         MetadataStore(), seed=seed, **kw),
            jorch.Orchestrator(jsim.DevicePopulation(n, seed=seed),
                               jorch.MetadataStore(), seed=seed))


def _state(d):
    return (d.device_id, d.app_version, d.battery, d.charging, d.on_wifi,
            d.storage_free_mb, d.speed, d.last_participation_round, d.alive,
            d.tz_offset)


# --- orchestrator ------------------------------------------------------------
def test_eligibility_heuristics():
    orch, jo = _pair(200, 1)
    for d, jd in zip(orch.population.devices, jo.population.devices):
        assert _state(d) == _state(jd)
        assert orch.check_eligibility(d) == jo.check_eligibility(jd)
    d = orch.population.devices[0]
    d.alive, d.battery, d.charging, d.on_wifi = True, 0.9, True, True
    d.storage_free_mb, d.app_version = 1000.0, 10
    d.last_participation_round = -100
    ok, reason = orch.check_eligibility(d)
    assert ok, reason
    d.battery = 0.1
    assert orch.check_eligibility(d) == (False, "battery")
    d.battery, d.on_wifi = 0.9, False
    assert orch.check_eligibility(d) == (False, "no_wifi")
    d.on_wifi = True
    d.last_participation_round = orch.round_idx
    assert orch.check_eligibility(d) == (False, "cooldown")


@pytest.mark.parametrize("churn", [None, "diurnal"])
def test_cohort_selection_and_cooldown(churn):
    kw = {} if churn is None else {"churn": sim.ChurnModel.profile(churn)}
    jkw = {} if churn is None else {"churn": jsim.ChurnModel.profile(churn)}
    tel, jtel = tele.Telemetry(), jtele.Telemetry()
    orch = Orchestrator(sim.DevicePopulation(2000, seed=2, **kw),
                        MetadataStore(), seed=2, telemetry=tel)
    jo = jorch.Orchestrator(jsim.DevicePopulation(2000, seed=2, **jkw),
                            jorch.MetadataStore(), seed=2, telemetry=jtel)
    for _ in range(3):  # adaptive over-selection from the second round on
        cohort, jcohort = orch.select_cohort(32), jo.select_cohort(32)
        assert [d.device_id for d in cohort] == [d.device_id
                                                 for d in jcohort]
        assert (cohort.requested, cohort.shortfall, cohort.over_select_used,
                cohort.eligibility_rate) == (
            jcohort.requested, jcohort.shortfall, jcohort.over_select_used,
            jcohort.eligibility_rate)
        assert 0 < len(cohort) <= 32
        for d in cohort:
            assert orch.check_eligibility(d)[0]
        orch.finish_round(cohort)
        jo.finish_round(jcohort)
        # the same devices are rate-limited next round (the fleet also
        # stepped, so an earlier check may refuse them first)
        for d, jd in zip(cohort, jcohort):
            assert d.last_participation_round == orch.round_idx - 1
            assert orch.check_eligibility(d) == jo.check_eligibility(jd)
            assert not orch.check_eligibility(d)[0]
    strip = (lambda c: {(n, tuple(x for x in lk if x[0] != "eid")): v
                        for (n, lk), v in c.items()})
    assert strip(tel.counters()) == strip(jtel.counters())
    assert strip(tel.gauges()) == strip(jtel.gauges())
    assert [_state(d) for d in orch.population.devices] == [
        _state(d) for d in jo.population.devices]
    assert orch.logger.counts() == jo.logger.counts()


def test_submission_policy_uses_fa_estimate():
    orch, jo = _pair(50, 3)
    pol = orch.submission_policy()
    assert pol.keep_pos == pol.keep_neg == 1.0  # no FA estimate yet
    orch.metadata.put("label_pos_ratio", 0.05)
    jo.metadata.put("label_pos_ratio", 0.05)
    pol = orch.submission_policy(target_pos_ratio=0.5)
    jpol = jo.submission_policy(target_pos_ratio=0.5)
    assert (pol.keep_pos, pol.keep_neg) == (jpol.keep_pos, jpol.keep_neg)
    assert pol.keep_pos == 1.0
    assert pol.keep_neg == pytest.approx(0.05 / 0.95, rel=1e-6)
    keeps = [orch.control_submission(i % 2, pol) for i in range(5000)]
    assert keeps == [jo.control_submission(i % 2, jpol) for i in range(5000)]
    assert np.mean(keeps[::2]) == pytest.approx(pol.keep_neg, abs=0.03)


def test_transform_spec_push_versioning():
    orch, _ = _pair(10, 4)
    orch.push_transform_spec(TransformSpec(1, [{"op": "log1p", "field": "x"}]))
    with pytest.raises(ValueError):
        orch.push_transform_spec(TransformSpec(1, []))  # non-increasing
    orch.push_transform_spec(TransformSpec(2, []))
    assert orch.metadata.get("transform_spec").version == 2
    assert FUNNEL_PHASES == jorch.FUNNEL_PHASES
    assert EligibilityCriteria() == EligibilityCriteria(
        **vars(jorch.EligibilityCriteria()))


# --- signal transformer --------------------------------------------------------
OPS = [
    {"op": "log1p", "field": "time_spent"},
    {"op": "clip", "field": "scroll_speed", "lo": 0.0, "hi": 10.0},
    {"op": "zscore", "field": "scroll_speed", "mean": 5.0, "std": 2.0},
    {"op": "abs", "field": "delta"},
    {"op": "scale", "field": "delta", "factor": 0.3},
    {"op": "minmax", "field": "age", "lo": 10.0, "hi": 70.0},
    {"op": "bucketize", "field": "dwell", "boundaries": [0.0, 1.0, 5.0, 5.0]},
    {"op": "inject_server", "field": "hist_ctr", "default": 0.1},
    {"op": "inject_server", "field": "missing", "default": 0.25},
    {"op": "override_with_local", "field": "pause_freq",
     "local_field": "pause_freq_local", "default": 0.0},
    {"op": "identity", "field": "age"},
]
SIGNALS = {"time_spent": 99.0, "scroll_speed": 25.0, "delta": -3.7,
           "age": 33.0, "dwell": 5.0, "pause_freq_local": 0.7}
SERVER = {"hist_ctr": 0.33, "pause_freq": 0.2}


@pytest.mark.parametrize("select", [False, True])
def test_signal_transformer_pipeline(select):
    ops = OPS + ([{"op": "select", "fields": ["age", "dwell", "hist_ctr",
                                              "pause_freq"]}]
                 if select else [])
    st, jt = SignalTransformer(TransformSpec(1, ops)), jst.SignalTransformer(
        jst.TransformSpec(1, ops))
    out = st.apply({k: torch.tensor(v) for k, v in SIGNALS.items()}, SERVER)
    jout = jt.apply({k: jnp.asarray(v) for k, v in SIGNALS.items()}, SERVER)
    assert list(out) == list(jout)
    for k in jout:
        np.testing.assert_array_equal(np.asarray(jout[k], np.float32),
                                      out[k].numpy().astype(np.float32))
    assert float(out["time_spent" if not select else "age"]) == \
        pytest.approx(np.log1p(99.0) if not select else (33 - 10) / 60)
    # feature origin (3): the device value wins over the server value
    assert float(out["pause_freq"]) == pytest.approx(0.7)
    np.testing.assert_array_equal(
        np.asarray(jt.feature_vector({k: jnp.asarray(v)
                                      for k, v in SIGNALS.items()}, SERVER)),
        st.feature_vector({k: torch.tensor(v) for k, v in SIGNALS.items()},
                          SERVER).numpy())


def test_bucketize_takes_the_left_side_as_jnp():
    bounds = [0.0, 1.0, 1.0, 5.0]
    x = np.array([-1.0, 0.0, 0.5, 1.0, 4.9, 5.0, 9.0], np.float32)
    spec = [{"op": "bucketize", "field": "x", "boundaries": bounds}]
    got = SignalTransformer(TransformSpec(1, spec)).apply(
        {"x": torch.from_numpy(x)})["x"]
    want = jst.SignalTransformer(jst.TransformSpec(1, spec)).apply(
        {"x": jnp.asarray(x)})["x"]
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_spec_json_roundtrip_and_validation():
    spec = TransformSpec(3, [{"op": "abs", "field": "x"}], min_app_version=2)
    back = TransformSpec.from_json(spec.to_json())
    assert back == spec
    assert spec.to_json() == jst.TransformSpec(
        3, [{"op": "abs", "field": "x"}], min_app_version=2).to_json()
    with pytest.raises(ValueError):
        validate_spec(TransformSpec(1, [{"op": "exec", "field": "x"}]))
    with pytest.raises(ValueError):
        validate_spec(TransformSpec(1, [{"op": "abs"}]))


@pytest.mark.parametrize("scheme", ["zscore", "minmax"])
def test_spec_with_normalization_bakes_factors(scheme):
    spec = TransformSpec(1, [{"op": "log1p", "field": "a"},
                             {"op": "select", "fields": ["a", "b"]}])
    shift, scale = np.asarray([1.0, -2.0]), np.asarray([2.0, 4.0])
    f = NormalizationFactors(scheme, shift, scale)
    spec2 = spec_with_normalization(spec, f, ["a", "b"], new_version=2)
    jspec2 = jst.spec_with_normalization(
        jst.TransformSpec(1, list(spec.ops)), JNF(scheme, shift, scale),
        ["a", "b"], new_version=2)
    assert spec2.to_json() == jspec2.to_json()
    assert spec2.version == 2 and spec2.ops[-1]["op"] == "select"
    out = SignalTransformer(spec2).apply({"a": torch.tensor(np.expm1(5.0)),
                                          "b": torch.tensor(6.0)})
    assert float(out["a"]) == pytest.approx((5.0 - 1.0) / 2.0)
    x = torch.tensor([[3.0, 2.0]])
    np.testing.assert_array_equal(
        np.asarray(JNF(scheme, shift.astype(np.float32),
                       scale.astype(np.float32)).apply(jnp.asarray(x))),
        NormalizationFactors(scheme, shift.astype(np.float32),
                             scale.astype(np.float32)).apply(x).numpy())


# --- joiner --------------------------------------------------------------------
def test_joiner_attribution_window():
    rows = [("k1", 0.0, {"f": 1.0}), ("k2", 0.0, {"f": 2.0}),
            ("k3", 0.0, {"f": 3.0}), ("k4", 10.0, {"f": 4.0})]
    events = [("k1", 50.0, 1), ("k2", 500.0, 1), ("k1", 80.0, 0),
              ("k4", 5.0, 1), ("k4", 60.0, 0, "rater")]
    for fill in (0, None):
        j, jj = Joiner(attribution_window=100.0, negative_fill=fill), \
            jjoin.Joiner(attribution_window=100.0, negative_fill=fill)
        out = j.join([FeatureRow(*r) for r in rows],
                     [LabelEvent(*e) for e in events])
        jout = jj.join([jjoin.FeatureRow(*r) for r in rows],
                       [jjoin.LabelEvent(*e) for e in events])
        assert [vars(o) for o in out] == [vars(o) for o in jout]
    out = {e.key: e for e in Joiner(attribution_window=100.0).join(
        [FeatureRow(*r) for r in rows], [LabelEvent(*e) for e in events])}
    assert out["k1"].label == 1 and out["k1"].label_source == "server"
    assert out["k2"].label == 0 and out["k2"].label_source == "negative_fill"
    assert out["k4"].label == 0 and out["k4"].label_source == "rater"
    # device-side label override (paper: update label prior to training)
    upd = Joiner.device_side_update(out["k1"], device_label=0)
    assert upd.label == 0 and upd.label_source == "device"
    assert Joiner.device_side_update(out["k1"], None) is out["k1"]


# --- feature store ---------------------------------------------------------------
def test_feature_store_encryption_purpose_ttl():
    clock = [0.0]
    store = DeviceFeatureStore(b"secret", default_ttl=10.0,
                               clock=lambda: clock[0])
    jstore = jfs.DeviceFeatureStore(b"secret", default_ttl=10.0,
                                    clock=lambda: clock[0])
    value = {"x": [1.0, 2.0], "n": np.float32(3.5), "v": np.arange(3)}
    for s in (store, jstore):
        s.put("fl", "feats", value, purpose="fl-training")
        s.put("fl", "short", [1], purpose="fl-training", ttl=1.0)
    assert [e.blob for e in store._data.values()] == [
        e.blob for e in jstore._data.values()]
    assert store.get("fl", "feats", "fl-training") == {
        "x": [1.0, 2.0], "n": 3.5, "v": [0, 1, 2]}
    with pytest.raises(PermissionError):
        store.get("fl", "feats", "ads")  # purpose binding
    entry = next(iter(store._data.values()))
    assert b"1.0" not in entry.blob  # raw blob is not plaintext
    clock[0] = 2.0
    assert store.gc() == jstore.gc() == 1 and len(store) == 1
    clock[0] = 11.0
    with pytest.raises(KeyError):
        store.get("fl", "feats", "fl-training")  # TTL expired


# --- funnel logging ----------------------------------------------------------------
def test_funnel_conservation_and_privacy():
    log = FunnelLogger(FUNNEL_PHASES)
    sids = [new_session_id() for _ in range(10)]
    for s in sids:
        log.log(s, "scheduled", "selected", True)
    for s in sids[:8]:
        log.log(s, "eligibility", "ok", True)
    for s in sids[8:]:
        log.log(s, "eligibility", "battery", False)
    for s in sids[:8]:
        log.log(s, "data_init", "metadata_fetch", True)
    assert log.check_conservation() == []
    report = dict((p, (e, ok)) for p, e, ok, _ in log.dropoff_report())
    assert report["scheduled"] == (10, 10)
    assert report["eligibility"] == (10, 8)
    with pytest.raises(ValueError):
        log.log(sids[0], "training", "step", True, detail="device_id=42")
    n = len(log.events)
    log.log(sids[0], "scheduled", "selected", True)
    assert len(log.events) == n
    leak = FunnelLogger(FUNNEL_PHASES)
    leak.log("s1", "scheduled", "selected", True)
    leak.log("s2", "eligibility", "ok", True)  # never scheduled: leak
    leak.log("s3", "eligibility", "ok", True)
    assert leak.check_conservation()


def test_cohort_funnel_is_conserved():
    orch, _ = _pair(300, 5)
    for _ in range(4):
        cohort = orch.select_cohort(40)
        orch.finish_round(cohort)
    assert orch.logger.check_conservation() == []
    assert len({new_session_id() for _ in range(1000)}) == 1000
