"""The port's fault injection against the JAX package's (twin of
``tests/test_faults.py``).

The same ``FaultSpec`` drives the reference's and the port's injector over
the same deltas: the decision stream is one ``np.random.RandomState``, so
``plan.trace`` (every decision, delivery, retry, drop and leaf death) must
equal the reference's exactly.  Within the port, a faulted session decodes
bit-equal to a clean replay of its survivors, on the flat ``AsyncServer``
and on both tier topologies (leaves multiplexed onto the one device, as the
JAX file's multidev cases are on eight).

Held to ``atol=1e-6`` against the reference, each for a stated cause: a
delayed delivery landing in a later session carries staleness >= 1, whose
polynomial weight (f32 ``pow``) may differ from XLA's in the last bit; the
round's local SGD (autograd vs XLA, as ``test_torch_round.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JFL
from repro.core import device_sim as jsim
from repro.core.fl import async_fl as jafl
from repro.core.fl import faults as jfaults
from repro.core.fl import round as jround
from repro.core.fl.hierarchy import ShardedAsyncServer as JTier
from repro.core.orchestrator import EligibilityCriteria as JCriteria
from repro.core.orchestrator import MetadataStore as JMeta
from repro.core.orchestrator import Orchestrator as JOrch
from repro_torch import tree as T
from repro_torch.configs.base import FLConfig
from repro_torch.core import device_sim as sim
from repro_torch.core.fl.async_fl import (AsyncServer, SimResult,
                                          TrainingSimResult,
                                          simulate_training)
from repro_torch.core.fl.faults import (FaultInjector, FaultPlan, FaultSpec,
                                        RetryPolicy)
from repro_torch.core.fl.hierarchy import ShardedAsyncServer
from repro_torch.core.fl.round import (build_client_update,
                                       build_scaffold_client_update)
from repro_torch.core.orchestrator import (CohortSelection,
                                           EligibilityCriteria,
                                           MetadataStore, Orchestrator)
from repro_torch.kernels import prf
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

D = 41
FL_KW = dict(clip_norm=1.0, server_lr=1.0, secure_agg_bits=24)
FL = FLConfig(**FL_KW)
JFL_ = JFL(**FL_KW)
MODES = ("off", "tee", "tee_stream", "client")
CHAOS_KW = dict(p_client_death=0.1, p_duplicate=0.3, p_delay=0.3,
                delay_pushes=2, p_reorder=0.3, seed=5)
CHAOS = FaultSpec(**CHAOS_KW)
JCHAOS = jfaults.FaultSpec(**CHAOS_KW)
ATOL = 1e-6


def _params():
    return {"w": torch.zeros(D), "b": torch.zeros(3)}


def _jparams():
    return {"w": jnp.zeros((D,), jnp.float32), "b": jnp.zeros((3,), jnp.float32)}


def _deltas(n, seed=0):
    """The reference file's deltas (``0.1 * jax.random.normal``), drawn by
    the port's bit-equal ``prf.normal``."""
    key = prf.PRNGKey(seed)
    out = []
    for i in range(n):
        k = prf.fold_in(key, i)
        out.append({"w": 0.1 * prf.normal(k, (D,)),
                    "b": 0.1 * prf.normal(prf.fold_in(k, 1), (3,))})
    return out


def _jx(tree):
    return {k: jnp.asarray(v.numpy()) for k, v in tree.items()}


def _diff(a, b):
    return max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
               for x, y in zip(T.leaves(a), T.leaves(b)))


def _jdiff(ttree, jtree):
    return max(float(np.abs(x.numpy() - np.asarray(jtree[k])).max())
               for k, x in ttree.items())


def _flat(mode, quorum=0.0, buffer_size=4):
    fl = dataclasses.replace(FL, flush_quorum=quorum)
    return AsyncServer(_params(), fl, buffer_size=buffer_size,
                       mask_mode=mode, strict=False, device="cpu")


def _jflat(mode, quorum=0.0, buffer_size=4):
    fl = dataclasses.replace(JFL_, flush_quorum=quorum)
    return jafl.AsyncServer(_jparams(), fl, buffer_size=buffer_size,
                            mask_mode=mode, strict=False)


def _tier(mode, two_level, fl=FL, strict=False):
    return ShardedAsyncServer(_params(), fl, num_leaves=2, leaf_buffer=2,
                              mask_mode=mode, two_level=two_level,
                              strict=strict, device="cpu")


def _replay_survivors(inj, ds, mk):
    """Replay exactly what each faulted session aggregated, fault-free."""
    srv = mk()
    for ver in sorted(inj.survivors):
        assert srv.version == ver, "replay sessions diverged"
        for slot, (seq, cv) in sorted(inj.survivors[ver].items()):
            if hasattr(srv, "num_leaves"):
                srv.push(ds[seq], cv, slots=slot)
            else:
                srv.push(ds[seq], cv, slot=slot)
        if srv.version == ver:  # partial session: deadline flush
            srv.flush(force=True)
    return srv.params


def _chaos(srv, spec, ds):
    inj = FaultInjector(srv, FaultPlan(spec))
    for d in ds:
        inj.push(d, srv.version)
    inj.flush(force=True)
    return inj


def _jchaos(srv, spec, ds):
    inj = jfaults.FaultInjector(srv, jfaults.FaultPlan(spec))
    for d in ds:
        inj.push(_jx(d), srv.version)
    inj.flush(force=True)
    return inj


# --- chaos == clean survivor replay, and == the reference's run -------------
@pytest.mark.parametrize("mode", MODES)
def test_flat_chaos_bit_identity(mode):
    """The chaos schedule fires the same faults as the reference's (trace
    equal), and the decode is bit-equal to a clean survivor replay."""
    ds = _deltas(12)
    srv = _flat(mode)
    inj = _chaos(srv, CHAOS, ds)
    assert inj.fault_metrics["duplicate_pushes"] > 0  # chaos really fired
    assert inj.dropped
    assert _diff(srv.params, _replay_survivors(inj, ds, lambda: _flat(mode))
                 ) == 0.0
    jsrv = _jflat(mode)
    jinj = _jchaos(jsrv, JCHAOS, ds)
    assert inj.plan.trace == jinj.plan.trace
    assert inj.delivered == jinj.delivered and inj.dropped == jinj.dropped
    assert inj.survivors == jinj.survivors
    assert dict(srv.fault_metrics) == dict(jsrv.fault_metrics)
    assert _jdiff(srv.params, jsrv.params) <= ATOL


@pytest.mark.parametrize("two_level", (False, True))
@pytest.mark.parametrize("mode", MODES)
def test_sharded_chaos_bit_identity(mode, two_level):
    """The chaos schedule + one whole-leaf death mid-ingest against the
    tier (2 leaves x 2 slots on the one device): queued arrivals re-route,
    the dead leaf's rows are recovered like dropouts, and the decode is
    bit-equal to the clean survivor replay in both topologies.  The trace
    equals the reference tree's (the schedule does not depend on the
    topology)."""
    spec = dataclasses.replace(CHAOS, leaf_deaths=(("ingest", 1, 1),))
    ds = _deltas(12)
    srv = _tier(mode, two_level)
    inj = _chaos(srv, spec, ds)
    fm = srv.fault_metrics
    assert fm["dead_leaves"] == 1
    assert fm["lost_contributions"] >= 1  # the leaf died holding work
    assert _diff(srv.params, _replay_survivors(
        inj, ds, lambda: _tier(mode, two_level))) == 0.0
    if two_level:
        jspec = dataclasses.replace(JCHAOS, leaf_deaths=(("ingest", 1, 1),))
        jsrv = JTier(_jparams(), JFL_, num_leaves=2, leaf_buffer=2,
                     mask_mode=mode, two_level=True, strict=False)
        jinj = _jchaos(jsrv, jspec, ds)
        assert inj.plan.trace == jinj.plan.trace
        assert inj.survivors == jinj.survivors
        assert _jdiff(srv.params, jsrv.params) <= ATOL


def test_fault_plan_replays_bit_for_bit():
    """replayed() re-runs the recorded decisions: identical faults,
    survivors and params; a diverging replay fails loudly."""
    ds = _deltas(12)

    def run(plan):
        srv = _flat("client")
        inj = FaultInjector(srv, plan)
        for d in ds:
            inj.push(d, srv.version)
        inj.flush(force=True)
        return inj, srv.params

    plan = FaultPlan(CHAOS)
    inj1, p1 = run(plan)
    inj2, p2 = run(plan.replayed())
    assert inj1.delivered == inj2.delivered
    assert inj1.dropped == inj2.dropped
    assert inj1.survivors == inj2.survivors
    assert _diff(p1, p2) == 0.0
    jplan = jfaults.FaultPlan(JCHAOS)
    for site, _ in [t for t in plan.trace if isinstance(t[1], bool)][:8]:
        jplan.decide(site, getattr(CHAOS, "p_" + site))
    assert [t for t in plan.trace if isinstance(t[1], bool)][:8] == \
        jplan.trace
    bad = plan.replayed()
    bad._replay[0] = ("delay", True)
    with pytest.raises(ValueError, match="replay diverged"):
        bad.decide("client_death", 0.5)


def test_straggler_tail_is_deterministic():
    spec = FaultSpec(straggler_frac=0.25, straggler_mult=7.0, seed=1)
    plan = FaultPlan(spec)
    mults = [plan.time_multiplier(d) for d in range(2000)]
    assert set(mults) == {1.0, 7.0}
    assert 0.15 < mults.count(7.0) / len(mults) < 0.35
    jplan = jfaults.FaultPlan(jfaults.FaultSpec(
        straggler_frac=0.25, straggler_mult=7.0, seed=1))
    assert mults == [jplan.time_multiplier(d) for d in range(2000)]
    plan.decide("delay", 0.5)
    assert [plan.time_multiplier(d) for d in range(2000)] == mults
    assert FaultPlan(FaultSpec()).time_multiplier(3) == 1.0


def test_delayed_pushes_land_at_the_deadline():
    srv = _flat("client", buffer_size=2)
    inj = FaultInjector(srv, FaultPlan(FaultSpec(p_delay=1.0,
                                                 delay_pushes=50, seed=0)))
    ds = _deltas(2)
    for d in ds:
        inj.push(d, srv.version)
    assert srv._fill == 0  # nothing delivered yet
    assert inj.flush(force=True)
    assert srv.version == 1
    assert len(inj.delivered) == 2
    assert _diff(srv.params, _replay_survivors(
        inj, ds, lambda: _flat("client", buffer_size=2))) == 0.0


def test_retry_backoff_recovers_a_rejected_push():
    """A delivery whose slot was stolen re-encodes against the current
    session with capped backoff; the trace is the reference's."""
    ds = _deltas(3)

    def run(srv, inj, push):
        push(inj, ds[0])
        srv.push(ds[2] if isinstance(srv, AsyncServer) else _jx(ds[2]),
                 srv.version)
        push(inj, ds[1])
        inj.flush(force=True)
        return inj

    spec = dict(p_delay=1.0, delay_pushes=1, seed=0)
    srv = _flat("client", buffer_size=3)
    inj = run(srv, FaultInjector(srv, FaultPlan(FaultSpec(**spec))),
              lambda i, d: i.push(d, srv.version))
    assert srv.fault_metrics["rejected_pushes"] >= 1
    assert any(site == "retry" for site, _ in inj.plan.trace)
    assert len(inj.delivered) == 2
    assert srv.version == 1
    jsrv = _jflat("client", buffer_size=3)
    jinj = run(jsrv, jfaults.FaultInjector(
        jsrv, jfaults.FaultPlan(jfaults.FaultSpec(**spec))),
        lambda i, d: i.push(_jx(d), jsrv.version))
    assert inj.plan.trace == jinj.plan.trace
    assert RetryPolicy().backoff(3) == jfaults.RetryPolicy().backoff(3) == 4


def test_raw_push_idempotence_and_reorder():
    for order in ((0, 1, 2, 3), (3, 0, 2, 1)):
        srv = _flat("tee_stream")
        ds = _deltas(4)
        for i in order:
            assert srv.push(ds[i], 0, slot=i, push_id=100 + i)
            assert not srv.push(ds[i], 0, slot=i, push_id=100 + i)
        assert srv.fault_metrics["duplicate_pushes"] == 4
        assert srv.version == 1
        if order == (0, 1, 2, 3):
            want = srv.params
    assert _diff(srv.params, want) == 0.0


@pytest.mark.parametrize("engine", ["async", "tier-flat", "tier-tree"])
def test_strict_raises_where_degraded_mode_counts_and_drops(engine):
    """Both engines reject a stale push (raise or count-and-drop) and a
    wrong field modulus (always raise), naming their own side."""
    ds = _deltas(2)
    peer = "server" if engine == "async" else "tier"
    for strict in (True, False):
        if engine == "async":
            srv = AsyncServer(_params(), FL, buffer_size=2,
                              mask_mode="client", strict=strict,
                              device="cpu")
        else:
            srv = _tier("client", engine == "tier-tree", strict=strict)
        cp = srv.encode_push(ds[0], 0, slot=0)
        srv.version += 1  # the session rolls before the push arrives
        if strict:
            with pytest.raises(ValueError, match="stale ClientPush"):
                srv.push_encoded(cp)
        else:
            assert not srv.push_encoded(cp)
            assert srv.fault_metrics["rejected_pushes"] == 1
        with pytest.raises(ValueError, match="field modulus"):
            srv.push_encoded(cp._replace(version=srv.version, modulus=123))
        with pytest.raises(ValueError, match=f"field modulus 256 .* but "
                           f"the {peer}'s session field .* client and "
                           f"{peer} must agree"):
            srv.push_encoded(cp._replace(version=srv.version,
                                         modulus=1 << 8))


# --- quorum / deadline degradation ------------------------------------------
@pytest.mark.parametrize("mode", MODES)
def test_flush_quorum_exact_and_one_below(mode):
    srv = _flat(mode, quorum=0.75)  # need = ceil(0.75 * 4) = 3
    ds = _deltas(4)
    srv.push(ds[0], 0, slot=0)
    srv.push(ds[1], 0, slot=1)
    before = T.tree_map(lambda x: x.clone(), srv.params)
    assert not srv.flush()  # one below quorum
    assert srv.version == 0
    assert srv.fault_metrics["subquorum_deferrals"] == 1
    assert srv.fault_metrics["released_updates"] == 0
    assert _diff(before, srv.params) == 0.0
    srv.push(ds[2], 0, slot=2)
    assert srv.flush()  # exactly at quorum
    assert srv.version == 1
    ref = _flat(mode)
    for i in range(3):
        ref.push(ds[i], 0, slot=i)
    ref.flush(force=True)
    assert _diff(srv.params, ref.params) == 0.0


@pytest.mark.parametrize("two_level", (False, True))
def test_sharded_quorum_counts_live_capacity(two_level):
    """Quorum is a fraction of LIVE capacity: a dead leaf leaves the
    denominator, so the surviving half completes the session."""
    fl = dataclasses.replace(FL, flush_quorum=0.75)
    srv = _tier("client", two_level, fl)
    ds = _deltas(3)
    srv.push(ds[0], 0, slots=0)
    assert not srv.flush()  # 1 < ceil(0.75 * 4)
    assert srv.fault_metrics["subquorum_deferrals"] == 1
    assert srv.mark_leaf_dead(1) == []
    assert srv.live_capacity == 2 and srv.open_slots() == [1]
    assert not srv.flush()  # still 1 < 2
    srv.push(ds[1], 0, slots=1)
    assert srv.version == 1  # reached live capacity: session completed
    assert srv.live_capacity == 4  # the leaf rejoins the next session


# --- churn model --------------------------------------------------------------
def _alive_trace(pop, steps):
    out = []
    for _ in range(steps):
        pop.step()
        out.append([(d.alive, d.battery, d.charging, d.on_wifi,
                     d.app_version) for d in pop.devices])
    return out


def test_default_churn_is_bit_identical_to_legacy():
    a = sim.DevicePopulation(32, seed=3)
    b = sim.DevicePopulation(32, seed=3, churn=sim.ChurnModel())
    j = jsim.DevicePopulation(32, seed=3, churn=jsim.ChurnModel())
    assert _alive_trace(a, 12) == _alive_trace(b, 12) == _alive_trace(j, 12)


def test_sticky_churn_outages_last_longer():
    def mean_outage(pop, steps=400):
        runs, cur = [], [0] * 16
        for _ in range(steps):
            pop.step()
            for i, d in enumerate(pop.devices):
                if not d.alive:
                    cur[i] += 1
                elif cur[i]:
                    runs.append(cur[i])
                    cur[i] = 0
        return float(np.mean(runs)) if runs else 0.0

    flaky = mean_outage(sim.DevicePopulation(
        16, seed=7, churn=sim.ChurnModel.profile("flaky")))
    uniform = mean_outage(sim.DevicePopulation(
        16, seed=7, churn=sim.ChurnModel.profile("uniform")))
    assert flaky > 2.0 * uniform
    assert uniform == pytest.approx(1.05, abs=0.15)
    assert flaky == mean_outage(jsim.DevicePopulation(
        16, seed=7, churn=jsim.ChurnModel.profile("flaky")))


def test_churn_seed_stability_and_diurnal_wave():
    p1 = sim.DevicePopulation(24, seed=5, churn=sim.ChurnModel.profile(
        "diurnal"))
    pj = jsim.DevicePopulation(24, seed=5, churn=jsim.ChurnModel.profile(
        "diurnal"))
    assert _alive_trace(p1, 20) == _alive_trace(pj, 20)
    cm = sim.ChurnModel.profile("diurnal")
    d = p1.devices[0]
    d.tz_offset = 0
    assert cm._availability(d, 12.0) > cm._availability(d, 0.0)
    d.alive = False
    assert p1.availability_weight(d) == 0.0


def test_speed_tiers_partition_the_fleet():
    base = sim.DevicePopulation(400, seed=11)
    tiered = sim.DevicePopulation(400, seed=11,
                                  churn=sim.ChurnModel.profile("diurnal"))
    ratios = [t.speed / b.speed for b, t in zip(base.devices, tiered.devices)]
    assert {round(r, 3) for r in ratios} == {0.5, 1.0, 3.0}
    frac3 = sum(1 for r in ratios if round(r, 3) == 3.0) / len(ratios)
    assert 0.2 < frac3 < 0.4
    jt = jsim.DevicePopulation(400, seed=11,
                               churn=jsim.ChurnModel.profile("diurnal"))
    assert [d.speed for d in tiered.devices] == [d.speed for d in jt.devices]


# --- drift-robust aggregation ------------------------------------------------
def _quad_loss(params, batch):
    r = params["w"] - batch["t"]
    return (r * r).sum(), {}


def _jquad_loss(params, batch):
    r = params["w"] - batch["t"]
    return (r * r).sum(), {}


def test_fedprox_mu_zero_is_bit_identical():
    fl0 = FLConfig(local_steps=3, local_lr=0.1)
    flp = dataclasses.replace(fl0, fedprox_mu=0.0)
    params = {"w": torch.arange(5, dtype=torch.float32)}
    batch = {"t": torch.ones(5)}
    d0, l0 = build_client_update(_quad_loss, fl0)(params, batch, None)
    dp, lp = build_client_update(_quad_loss, flp)(params, batch, None)
    assert float(l0) == float(lp)
    assert _diff(d0, dp) == 0.0
    jd, jl = jround.build_client_update(_jquad_loss, JFL(
        local_steps=3, local_lr=0.1))({"w": jnp.arange(5, dtype=jnp.float32)},
                                      {"t": jnp.ones((5,))},
                                      jax.random.PRNGKey(0))
    assert float(l0) == pytest.approx(float(jl), abs=1e-5)
    assert _jdiff(d0, jd) <= 1e-5


def test_fedprox_bounds_client_drift():
    params = {"w": torch.zeros(5)}
    batch = {"t": 10.0 * torch.ones(5)}

    def drift(mu):
        fl = FLConfig(local_steps=8, local_lr=0.05, fedprox_mu=mu)
        delta, _ = build_client_update(_quad_loss, fl)(params, batch, None)
        return float(torch.linalg.vector_norm(delta["w"]))

    assert drift(5.0) < drift(1.0) < drift(0.0)


def test_scaffold_control_variate_math():
    fl = FLConfig(local_steps=1, local_lr=0.25)
    upd = build_scaffold_client_update(_quad_loss, fl)
    params = {"w": torch.tensor([1.0, -2.0, 0.5])}
    batch = {"t": torch.zeros(3)}
    g = 2.0 * params["w"]
    cs = {"w": torch.tensor([0.3, 0.0, -0.1])}
    cc = {"w": torch.tensor([-0.2, 0.1, 0.0])}
    (dx, dc), loss = upd(params, cs, cc, batch, None)
    np.testing.assert_allclose(dx["w"].numpy(),
                               (-0.25 * (g - cc["w"] + cs["w"])).numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(dc["w"].numpy(), (g - cc["w"]).numpy(),
                               rtol=1e-6)
    assert float(loss) == pytest.approx(float((params["w"] ** 2).sum()))


def test_scaffold_config_validation():
    with pytest.raises(ValueError, match="alternative drift corrections"):
        FLConfig(scaffold=True, fedprox_mu=0.1)
    with pytest.raises(ValueError):
        FLConfig(flush_quorum=1.5)
    with pytest.raises(ValueError):
        FLConfig(fedprox_mu=-0.1)
    with pytest.raises(ValueError, match="async"):
        simulate_training(
            "sync", loss_fn=_quad_loss, params={"w": torch.zeros(3)},
            fl_cfg=FLConfig(scaffold=True),
            make_client_batch=lambda s, n: {"t": torch.zeros(n, 3)},
            target_updates=1, cohort=1, device="cpu")


def test_steps_to_loss_metric():
    losses = [1.0] * 20 + [0.1] * 10
    r = TrainingSimResult(SimResult(0, 0, 0, 30, 3), losses, 0.0)
    jr = jafl.TrainingSimResult(jafl.SimResult(0, 0, 0, 30, 3), losses, 0.0)
    hit = r.steps_to_loss(0.5)
    assert hit is not None and 21 <= hit <= 30
    assert hit == jr.steps_to_loss(0.5)
    assert r.steps_to_loss(0.01) is None
    assert r.final_loss == jr.final_loss


# --- control plane: shortfall surfacing + adaptive over-selection ------------
def _orch(criteria, n=256, seed=0, ref=False):
    pop = (jsim if ref else sim).DevicePopulation(n, seed=seed)
    md = (JMeta if ref else MetadataStore)()
    md.put("eligibility", criteria)
    return (JOrch if ref else Orchestrator)(pop, md, seed=seed)


def test_cohort_shortfall_is_surfaced_not_hidden():
    kw = dict(min_battery=0.99, require_charging=True)
    orch = _orch(EligibilityCriteria(**kw))
    jorch = _orch(JCriteria(**kw), ref=True)
    cohort = orch.select_cohort(64)
    jcohort = jorch.select_cohort(64)
    assert isinstance(cohort, CohortSelection)
    assert cohort.requested == 64
    assert cohort.shortfall == 64 - len(cohort) > 0
    assert cohort.shortfall == jcohort.shortfall
    assert cohort.over_select_used == pytest.approx(2.0)
    assert any(e.step == "cohort_shortfall" and not e.success
               for e in orch.logger.events)
    orch.finish_round(cohort)
    jorch.finish_round(jcohort)
    c2 = orch.select_cohort(64)
    assert c2.over_select_used > 2.0
    assert c2.over_select_used == jorch.select_cohort(64).over_select_used


def test_over_select_adapts_down_for_a_healthy_fleet():
    kw = dict(min_battery=0.0, require_charging=False, require_wifi=False,
              min_storage_mb=0.0, cooldown_rounds=0)
    orch = _orch(EligibilityCriteria(**kw))
    c1 = orch.select_cohort(32)
    assert c1.shortfall == 0
    assert c1.eligibility_rate > 0.8
    orch.finish_round(c1)
    c2 = orch.select_cohort(32)
    assert c2.over_select_used < 2.0
    assert c2.shortfall == 0
    c3 = orch.select_cohort(32, over_select=2.0)
    assert c3.over_select_used == pytest.approx(2.0)
