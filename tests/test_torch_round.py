"""The port's synchronous DP-FL round (``repro_torch.core.fl.round``)
against the JAX package's jitted ``build_round_step``, on the same inputs.

Bit-equal, with noise off and every client inside ``clip_norm`` (so the
clip scale is exactly 1.0): fed the reference's per-client deltas, the
port's privatize, weight, encode (K6's plain version with the reference's
split keys and uniforms), masks, int32 sum and decode (K7's plain version
with the jitted decode's multiplier) give the reference's accumulator, mean
delta and new params, at ``clients_per_chunk`` 1, 2 and 4, deferred or not,
masked or not, over one chunk or a multi-chunk plan.

Held to a tolerance, for a stated cause:
- the whole round with autograd (the MLP classifier, and a 2-layer narrow
  qwen2): 1e-5, since torch's gradients and the f32 sums of K3 and K8
  differ from XLA's in the last bits (one fixed-point level is ~7e-9 at
  bits 32 and a cohort of 4);
- the ``secure_agg_bits=0`` sum (K8): client-order sums against XLA's.

Then twins of ``tests/test_fl.py``'s contracts on the port alone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mlp as jmlp_cfg
from repro.configs import registry as jreg
from repro.configs.base import FLConfig as JFL
from repro.core.fl import accountant as jacc
from repro.core.fl import aggregation as jagg
from repro.core.fl import metrics as jmetrics
from repro.core.fl import round as jround
from repro.core.telemetry import Telemetry as JTelemetry
from repro.data.synthetic import fl_token_batch
from repro.models.model import build_mlp_classifier as jmlp
from repro.models.model import build_model as jbuild
from repro_torch import convert
from repro_torch import tree as T
from repro_torch.configs import mlp as mlp_cfg
from repro_torch.configs import registry as treg
from repro_torch.configs.base import FLConfig
from repro_torch.core import telemetry as tele
from repro_torch.core.fl import aggregation as agg
from repro_torch.core.fl import dp
from repro_torch.core.fl import metrics
from repro_torch.core.fl import round as tround
from repro_torch.kernels import dp_clip as kdp
from repro_torch.kernels import prf
from repro_torch.kernels import secure_agg as ksa
from repro_torch.models.model import build_mlp_classifier

COHORT = 4
TOL = dict(rtol=0, atol=1e-5)


def _kw(key):
    return tuple(int(w) for w in np.asarray(jax.random.key_data(key)))


def _leaves_equal(jtree, ttree):
    for a, b in zip(jax.tree.leaves(jtree), T.leaves(ttree)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _leaves_close(jtree, ttree, tol=TOL):
    for a, b in zip(jax.tree.leaves(jtree), T.leaves(ttree)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), **tol)


# ---------------------------------------------------------------------------
# the aggregation half, bit-equal
# ---------------------------------------------------------------------------
SHAPES = {"emb": (40, 16), "w1": (700,), "w2": (30, 3), "b": (5,)}


def _fake_updates(deltas):
    """Client updates that hand back a fixed per-client delta (by the
    batch's ``cid``), for the reference and for the port."""
    jd = jax.tree.map(jnp.asarray, deltas)

    def jbuild_cu(loss_fn, fl_cfg):
        def cu(params, cbatch, rng):
            return (jax.tree.map(lambda d: d[cbatch["cid"]], jd),
                    jnp.float32(0.0))
        return cu

    tleaves = [torch.from_numpy(np.array(x)) for x in jax.tree.leaves(jd)]

    def tbuild_cu(loss_fn, fl_cfg):
        def cu(params, cbatch, rng, out=None):
            cid = int(cbatch["cid"])
            for o, d in zip(out, tleaves):
                o.copy_(d[cid])
            return None, torch.zeros(())
        return cu

    return jbuild_cu, tbuild_cu


def _spy(store, module, jax_side):
    orig = module.finalize_aggregate

    def spy(acc, w, spec, rng):
        mean = orig(acc, w, spec, rng)
        if jax_side:
            jax.debug.callback(lambda a, m: store.update(acc=a, mean=m),
                               acc, mean)
        else:
            store.update(acc=acc, mean=mean)
        return mean
    return spy


@pytest.mark.parametrize("m,deferred,masked,chunk", [
    (1, False, False, 0), (2, False, True, 0), (4, False, False, 0),
    (4, True, True, 0), (2, True, False, 0), (4, False, True, 1000),
    (1, False, True, 1000)])
def test_aggregation_half_bit_equal_to_reference(monkeypatch, m, deferred,
                                                 masked, chunk):
    rs = np.random.RandomState(m + 10 * chunk)
    params = {k: rs.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    deltas = {k: (rs.randn(COHORT, *s) * 0.01).astype(np.float32)
              for k, s in SHAPES.items()}
    weights = np.array([1.0, 0.5, 0.75, 0.25], np.float32)
    fl = dict(cohort_size=COHORT, clip_norm=1.0, noise_multiplier=0.0,
              secure_agg_bits=32, secure_agg_masked=masked,
              deferred_agg=deferred, param_chunk_elems=chunk)
    jb, tb = _fake_updates(deltas)
    monkeypatch.setattr(jround, "build_client_update", jb)
    monkeypatch.setattr(tround, "build_client_update", tb)
    jstore, tstore = {}, {}
    monkeypatch.setattr(jagg, "finalize_aggregate", _spy(jstore, jagg, True))
    monkeypatch.setattr(agg, "finalize_aggregate", _spy(tstore, agg, False))
    batch = {"cid": np.arange(COHORT, dtype=np.int32), "weight": weights}
    rng = jax.random.PRNGKey(3 + m)

    jstep = jax.jit(jround.build_round_step(
        None, JFL(**fl), cohort_size=COHORT, clients_per_chunk=m,
        telemetry=JTelemetry()))
    jstate = jround.init_fl_state(jax.tree.map(jnp.asarray, params),
                                  JFL(**fl))
    jnew, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                       rng)
    jax.block_until_ready(jnew)
    ksa.reset_counts()
    tstep = tround.build_round_step(None, FLConfig(**fl), cohort_size=COHORT,
                                    clients_per_chunk=m, device="cpu")
    tnew, tmet = tstep(convert.fl_state_from_numpy(jstate), batch, _kw(rng))

    assert ksa.quantize_mask.plain_calls == COHORT * len(SHAPES)
    assert ksa.dequantize.plain_calls == len(SHAPES)
    _leaves_equal(jstore["acc"], tstore["acc"])
    _leaves_equal(jstore["mean"], tstore["mean"])
    _leaves_equal(jnew.params, tnew.params)
    assert int(tnew.round_idx) == 1
    for k in ("update_norm", "participation", "clip_fraction"):
        assert float(tmet[k]) == pytest.approx(float(jmet[k]), rel=1e-6)


def test_float_sum_goes_through_k8(monkeypatch):
    """``secure_agg_bits=0``: one K8 call per leaf and chunk, to the
    reference's mean within the f32 sum order."""
    rs = np.random.RandomState(7)
    params = {k: rs.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    deltas = {k: (rs.randn(COHORT, *s) * 0.01).astype(np.float32)
              for k, s in SHAPES.items()}
    fl = dict(cohort_size=COHORT, clip_norm=1.0, noise_multiplier=0.0,
              secure_agg_bits=0)
    jb, tb = _fake_updates(deltas)
    monkeypatch.setattr(jround, "build_client_update", jb)
    monkeypatch.setattr(tround, "build_client_update", tb)
    batch = {"cid": np.arange(COHORT, dtype=np.int32)}
    rng = jax.random.PRNGKey(5)
    for m in (1, 4):
        jstep = jax.jit(jround.build_round_step(
            None, JFL(**fl), cohort_size=COHORT, clients_per_chunk=m,
            telemetry=JTelemetry()))
        jstate = jround.init_fl_state(jax.tree.map(jnp.asarray, params),
                                      JFL(**fl))
        jnew, _ = jstep(jstate, {"cid": jnp.arange(COHORT)}, rng)
        kdp.reset_counts()
        tstep = tround.build_round_step(None, FLConfig(**fl),
                                        cohort_size=COHORT,
                                        clients_per_chunk=m, device="cpu")
        tnew, _ = tstep(convert.fl_state_from_numpy(jstate), batch, _kw(rng))
        assert kdp.counts()["scale_accum"]["plain_calls"] == \
            len(SHAPES) * (COHORT // m)
        assert kdp.counts()["sq_norms"]["plain_calls"] == \
            len(SHAPES) * (COHORT // m)
        _leaves_close(jnew.params, tnew.params, dict(rtol=0, atol=1e-7))


# ---------------------------------------------------------------------------
# the whole round with autograd, to a tolerance
# ---------------------------------------------------------------------------
def _mlp_setup():
    jm = jmlp(jmlp_cfg.CONFIG)
    tm = build_mlp_classifier(mlp_cfg.CONFIG, device="cpu")
    key = jax.random.PRNGKey(0)
    params = jm.init(key)
    rs = np.random.RandomState(0)
    x = rs.randn(COHORT, 2, mlp_cfg.CONFIG.num_features).astype(np.float32)
    y = (x.sum(-1) > 0).astype(np.float32)
    return jm, tm, params, {"features": x, "label": y}


def _qwen_setup():
    jcfg = jreg.get_config("qwen2-1.5b", reduced=True)
    tcfg = treg.get_config("qwen2-1.5b", reduced=True)
    jm, tm = jbuild(jcfg), None
    from repro_torch.models.model import build_model
    tm = build_model(tcfg, device="cpu")
    params = jm.init(jax.random.PRNGKey(1))
    batch = fl_token_batch(COHORT, 16, jcfg.vocab_size, seed=3)
    return jm, tm, params, batch


@pytest.mark.parametrize("model,m,deferred,bits,masked", [
    ("mlp", 1, False, 32, False), ("mlp", 2, False, 32, True),
    ("mlp", 4, True, 32, False), ("mlp", 4, False, 0, False),
    ("mlp", 2, True, 0, False), ("qwen", 2, False, 32, False),
    ("qwen", 4, True, 32, True), ("qwen", 1, False, 0, False)])
def test_whole_round_matches_reference(model, m, deferred, bits, masked):
    jm, tm, params, batch = _mlp_setup() if model == "mlp" \
        else _qwen_setup()
    fl = dict(cohort_size=COHORT, local_lr=0.2, clip_norm=1.0,
              noise_multiplier=0.0, secure_agg_bits=bits,
              secure_agg_masked=masked, deferred_agg=deferred)
    rng = jax.random.PRNGKey(11)
    jstep = jax.jit(jround.build_round_step(
        jm.loss_fn, JFL(**fl), cohort_size=COHORT, clients_per_chunk=m,
        telemetry=JTelemetry()))
    jstate = jround.init_fl_state(params, JFL(**fl))
    jnew, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                       rng)
    tstep = tround.build_round_step(tm.loss_fn, FLConfig(**fl),
                                    cohort_size=COHORT, clients_per_chunk=m,
                                    device="cpu")
    tnew, tmet = tstep(convert.fl_state_from_numpy(jstate), batch, _kw(rng))
    _leaves_close(jnew.params, tnew.params)
    for k in ("loss", "update_norm", "clip_fraction", "participation"):
        assert float(tmet[k]) == pytest.approx(float(jmet[k]), rel=1e-5,
                                               abs=1e-6)


@pytest.mark.parametrize("opt,slr", [("fedavgm", 0.3), ("fedadam", 0.05),
                                     ("fedadagrad", 0.1)])
def test_server_optimizer_state_carries_across(opt, slr):
    """Two reference rounds, the state converted by
    ``convert.fl_state_from_numpy``, then one more round on each side."""
    jm, tm, params, batch = _mlp_setup()
    fl = dict(cohort_size=COHORT, local_lr=0.2, clip_norm=1.0,
              noise_multiplier=0.3, server_opt=opt, server_lr=slr)
    jstep = jax.jit(jround.build_round_step(
        jm.loss_fn, JFL(**fl), cohort_size=COHORT, clients_per_chunk=2,
        telemetry=JTelemetry()))
    state = jround.init_fl_state(params, JFL(**fl))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for r in range(2):
        state, _ = jstep(state, jb, jax.random.PRNGKey(20 + r))
    tstate = convert.fl_state_from_numpy(state)
    assert int(tstate.round_idx) == 2 and int(tstate.opt_state["step"]) == 2
    jnew, _ = jstep(state, jb, jax.random.PRNGKey(22))
    tstep = tround.build_round_step(tm.loss_fn, FLConfig(**fl),
                                    cohort_size=COHORT, clients_per_chunk=2,
                                    device="cpu")
    tnew, _ = tstep(tstate, batch, _kw(jax.random.PRNGKey(22)))
    _leaves_close(jnew.params, tnew.params)
    _leaves_close(jnew.opt_state, tnew.opt_state)


def test_client_updates_match_reference():
    """FedProx (mu > 0) and SCAFFOLD local training against JAX's."""
    jm, tm, params, batch = _mlp_setup()
    cb = {k: v[1] for k, v in batch.items()}
    tparams = convert.params_from_numpy(params)
    fl = dict(local_steps=3, local_lr=0.2, fedprox_mu=0.5)
    jd, jl = jround.build_client_update(jm.loss_fn, JFL(**fl))(
        params, {k: jnp.asarray(v) for k, v in cb.items()}, None)
    td, tl = tround.build_client_update(tm.loss_fn, FLConfig(**fl))(
        tparams, {k: torch.from_numpy(v) for k, v in cb.items()}, None)
    _leaves_close(jd, td, dict(rtol=1e-5, atol=1e-6))
    assert float(tl) == pytest.approx(float(jl), rel=1e-6)
    rs = np.random.RandomState(2)
    cs = jax.tree.map(lambda p: (rs.randn(*p.shape) * 0.01).astype(
        np.float32), params)
    cc = jax.tree.map(lambda p: (rs.randn(*p.shape) * 0.01).astype(
        np.float32), params)
    (jdx, jdc), _ = jround.build_scaffold_client_update(
        jm.loss_fn, JFL(local_steps=2, local_lr=0.2))(
        params, jax.tree.map(jnp.asarray, cs), jax.tree.map(jnp.asarray, cc),
        {k: jnp.asarray(v) for k, v in cb.items()}, None)
    (tdx, tdc), _ = tround.build_scaffold_client_update(
        tm.loss_fn, FLConfig(local_steps=2, local_lr=0.2))(
        tparams, convert.params_from_numpy(cs),
        convert.params_from_numpy(cc),
        {k: torch.from_numpy(v) for k, v in cb.items()}, None)
    _leaves_close(jdx, tdx, dict(rtol=1e-5, atol=1e-6))
    _leaves_close(jdc, tdc, dict(rtol=1e-5, atol=1e-5))


# ---------------------------------------------------------------------------
# twins of tests/test_fl.py, on the port alone
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def setup():
    cfg = mlp_cfg.CONFIG
    model = build_mlp_classifier(cfg, device="cpu")
    key = prf.PRNGKey(0)
    params = model.init(key)
    wstar = prf.normal(key, (cfg.num_features,))

    def make_batch(rng, cohort):
        x = prf.normal(rng, (cohort, 2, cfg.num_features))
        y = (torch.einsum("cbf,f->cb", x, wstar) > 0).to(torch.float32)
        return {"features": x, "label": y}

    return cfg, model, params, make_batch


def _fl(**kw):
    base = dict(cohort_size=16, local_steps=1, local_lr=0.2, clip_norm=1.0,
                noise_multiplier=0.0, noise_placement="tee")
    base.update(kw)
    return FLConfig(**base)


def _step(model, fl, cohort, m):
    return tround.build_round_step(model.loss_fn, fl, cohort_size=cohort,
                                   clients_per_chunk=m, device="cpu")


def _maxdiff(a, b):
    return max(float((x - y).abs().max())
               for x, y in zip(T.leaves(a), T.leaves(b)))


def test_secure_agg_matches_float_agg(setup):
    cfg, model, params, make_batch = setup
    rng = prf.PRNGKey(1)
    batch = make_batch(rng, 16)
    outs = {}
    for bits in (0, 32):
        fl = _fl(secure_agg_bits=bits)
        new, _ = _step(model, fl, 16, 4)(tround.init_fl_state(params, fl),
                                         dict(batch), rng)
        outs[bits] = new.params
    assert _maxdiff(outs[0], outs[32]) < 1e-4  # quantization granularity


def test_chunking_invariance(setup):
    cfg, model, params, make_batch = setup
    rng = prf.PRNGKey(2)
    batch = make_batch(rng, 16)
    fl = _fl(secure_agg_bits=0)
    outs = [_step(model, fl, 16, m)(tround.init_fl_state(params, fl),
                                    dict(batch), rng)[0].params
            for m in (1, 4, 16)]
    for other in outs[1:]:
        assert _maxdiff(outs[0], other) < 1e-5


def test_deferred_and_masked_rounds_bit_identical(setup):
    """Deferred accumulation and the pairwise masks both leave the int32
    sum unchanged: bit-identical params."""
    cfg, model, params, make_batch = setup
    rng = prf.PRNGKey(7)
    batch = make_batch(rng, 16)
    outs = []
    for kw in ({}, {"deferred_agg": True}, {"secure_agg_masked": True},
               {"secure_agg_masked": True, "secure_agg_degree": 4}):
        fl = _fl(**kw)
        outs.append(_step(model, fl, 16, 4)(
            tround.init_fl_state(params, fl), dict(batch), rng)[0].params)
    for other in outs[1:]:
        assert _maxdiff(outs[0], other) == 0.0


def test_weight_zero_drops_client(setup):
    cfg, model, params, make_batch = setup
    rng = prf.PRNGKey(3)
    batch = make_batch(rng, 8)
    fl = _fl(cohort_size=8, secure_agg_bits=0)
    step = _step(model, fl, 8, 2)
    state = tround.init_fl_state(params, fl)
    poisoned = {k: v.clone() for k, v in batch.items()}
    for v in poisoned.values():
        v[0] = 1e3
    w = torch.ones(8)
    w[0] = 0.0
    s_weighted, met = step(state, {**poisoned, "weight": w}, rng)
    s_ref, _ = step(state, {**batch, "weight": w}, rng)
    assert _maxdiff(s_weighted.params, s_ref.params) < 1e-5
    assert float(met["participation"]) == pytest.approx(7 / 8)


def test_device_noise_noisier_than_tee(setup):
    cfg, model, params, make_batch = setup
    batch = make_batch(prf.PRNGKey(4), 16)

    def update_norm(placement, seed):
        fl = _fl(noise_multiplier=1.0, noise_placement=placement,
                 secure_agg_bits=0)
        new, _ = _step(model, fl, 16, 4)(tround.init_fl_state(params, fl),
                                         dict(batch), prf.PRNGKey(seed))
        delta = T.tree_map(lambda a, b: a - b, new.params, params)
        return float(dp.global_norm(delta))

    tee = np.mean([update_norm("tee", s) for s in range(5)])
    dev = np.mean([update_norm("device", s) for s in range(5)])
    assert dev > tee


def test_clip_fraction_metric(setup):
    cfg, model, params, make_batch = setup
    rng = prf.PRNGKey(5)
    fl = _fl(cohort_size=8, clip_norm=1e-6, local_lr=1.0)
    _, met = _step(model, fl, 8, 4)(tround.init_fl_state(params, fl),
                                    dict(make_batch(rng, 8)), rng)
    assert float(met["clip_fraction"]) == 1.0


@pytest.mark.parametrize("opt,slr", [("fedavg", 1.0), ("fedavgm", 0.3),
                                     ("fedadam", 0.05), ("fedadagrad", 0.1)])
def test_server_optimizers_converge(setup, opt, slr):
    cfg, model, params, make_batch = setup
    fl = _fl(server_opt=opt, server_lr=slr, local_lr=0.2)
    step = _step(model, fl, 16, 4)
    state = tround.init_fl_state(params, fl)
    losses = []
    for r in range(30):
        rng = prf.PRNGKey(100 + r)
        state, met = step(state, make_batch(rng, 16), rng)
        losses.append(float(met["loss"]))
    assert min(losses[-5:]) < losses[0] * 0.9, (opt, losses)


# ---------------------------------------------------------------------------
# spans, accounting, metrics, the entry-point rule
# ---------------------------------------------------------------------------
def test_round_spans_and_kernel_counts(setup):
    cfg, model, params, make_batch = setup
    tel = tele.Telemetry(record_spans=True, fence=True)
    fl = _fl(cohort_size=4, secure_agg_masked=True)
    step = tround.build_round_step(model.loss_fn, fl, cohort_size=4,
                                   clients_per_chunk=4, telemetry=tel,
                                   device="cpu")
    ksa.reset_counts()
    kdp.reset_counts()
    step(tround.init_fl_state(params, fl), make_batch(prf.PRNGKey(9), 4),
         prf.PRNGKey(9))
    names = {s.name for s in tel.spans}
    assert {"round.setup", "round.execute", "round.local_sgd",
            "round.privatize", "round.encode", "round.uniforms", "round.sum",
            "round.decode"} <= names
    n_leaves = len(T.leaves(params))
    assert kdp.sq_norms.plain_calls == n_leaves
    assert ksa.quantize_mask.plain_calls == 4 * n_leaves
    assert ksa.dequantize.plain_calls == n_leaves
    assert kdp.scale_accum.plain_calls == 0


def test_rounds_to_epsilon_and_metrics_match_reference():
    for q_args in ((16, 4096, 100), (64, 1000, 20)):
        fl = dict(noise_multiplier=1.1)
        assert tround.rounds_to_epsilon(FLConfig(**fl), *q_args) == \
            jround.rounds_to_epsilon(JFL(**fl), *q_args)
    assert jacc.compute_epsilon(0.01, 1.0, 50, 1e-6) == pytest.approx(
        __import__("repro_torch.core.fl.accountant",
                   fromlist=["x"]).compute_epsilon(0.01, 1.0, 50, 1e-6))
    rs = np.random.RandomState(0)
    logit = rs.randn(6, 5).astype(np.float32)
    label = (rs.rand(6, 5) > 0.7).astype(np.float32)
    jst = [jmetrics.local_eval_stats(jnp.asarray(a), jnp.asarray(b))
           for a, b in zip(logit, label)]
    tst = [metrics.local_eval_stats(torch.from_numpy(a), torch.from_numpy(b))
           for a, b in zip(logit, label)]
    for a, b in zip(jst, tst):
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), b[k].numpy())
    jstack = {k: jnp.stack([s[k] for s in jst]) for k in jst[0]}
    tstack = {k: torch.stack([s[k] for s in tst]) for k in tst[0]}
    key = jax.random.PRNGKey(4)
    jagg_ = jmetrics.aggregate_stats(jstack, key, noise_multiplier=0.5)
    tagg = metrics.aggregate_stats(tstack, _kw(key), noise_multiplier=0.5)
    for k in jagg_:
        np.testing.assert_array_equal(np.asarray(jagg_[k]), tagg[k].numpy())
    jd = jmetrics.derive_metrics(jagg_)
    td = metrics.derive_metrics(tagg)
    for k in jd:
        assert float(td[k]) == pytest.approx(float(jd[k]), rel=1e-4,
                                             abs=1e-5), k


def test_entry_points_need_a_gpu_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tround.build_round_step(None, FLConfig(), cohort_size=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_mlp_classifier(mlp_cfg.CONFIG)
    with pytest.raises(NotImplementedError, match="item 8"):
        tround.build_sharded_round_step(None, FLConfig(), cohort_size=4,
                                        num_leaves=2)
