"""The paper's pipeline on a simulated fleet, port against reference: twin
of ``tests/test_system.py``'s pipeline, cut to 3 rounds and an FA sample
of 2,000 devices (``repro_torch.examples.paper_pipeline`` runs it at full
size).

Held against the JAX pipeline on the same seeds and keys:
- bit-equal: the minmax factors (one CDF vote through K9's plain version),
  the label ratio, the drop-off policy and every round's keep mask;
- round losses within 1e-5 (the sync round's tolerance: torch's gradients
  and the f32 sums of K3 in another order; the TEE noise is the
  reference's normal draw bit for bit, added without XLA's FMA);
- DP metrics within 1e-4 (the trained models' scores differ by the round's
  1e-5, through ratios and a trapezoid);
- the accountant's epsilon equal (pure Python).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import mlp as mlp_cfg
from repro.configs.base import FLConfig
from repro.core.analytics import label_balance, normalization
from repro.core.device_sim import DevicePopulation
from repro.core.fl import metrics as fl_metrics
from repro.core.fl.accountant import RDPAccountant
from repro.core.fl.round import build_round_step, init_fl_state
from repro.core.orchestrator import MetadataStore, Orchestrator
from repro.data.synthetic import ClassifierTask
from repro.models.model import build_mlp_classifier
from repro_torch.examples import paper_pipeline
from repro_torch.kernels import bitagg as k9
from repro_torch.kernels import dp_clip as kdp

ROUNDS, FA_DEVICES = 3, 2_000


def _reference(rounds, fa_devices):
    """``tests/test_system.py``'s pipeline fixture, cut to size."""
    key = jax.random.PRNGKey(0)
    cfg = mlp_cfg.CONFIG
    task = ClassifierTask(num_features=cfg.num_features, pos_ratio=0.1, seed=7)
    model = build_mlp_classifier(cfg)
    cohort = 64
    fa_sample = task.sample_devices(fa_devices, rng_seed=123)
    factors = normalization.learn_minmax(
        jnp.asarray(fa_sample["features_raw"]), lo=-4096.0, hi=4096.0,
        rng=key, n_thresholds=128)
    pos_ratio = label_balance.estimate_label_ratio(
        jnp.asarray(fa_sample["label"]), key, flip_prob=0.1)
    meta = MetadataStore()
    meta.put("label_pos_ratio", pos_ratio)
    meta.put("normalization", factors)
    orch = Orchestrator(DevicePopulation(512, seed=11), meta, seed=11)
    policy = orch.submission_policy(target_pos_ratio=0.5)
    fl = FLConfig(cohort_size=cohort, local_steps=3, local_lr=0.4,
                  clip_norm=1.0, noise_multiplier=0.2, noise_placement="tee")
    step = jax.jit(build_round_step(model.loss_fn, fl, cohort_size=cohort,
                                    clients_per_chunk=16))
    state = init_fl_state(model.init(key), fl)
    accountant = RDPAccountant()
    losses, keeps = [], []
    for r in range(rounds):
        rng = jax.random.fold_in(key, r)
        pool = task.sample_devices(cohort * 16, rng_seed=1000 + r)
        labels_pool = jnp.asarray(pool["label"])
        keep = np.asarray(label_balance.apply_dropoff(labels_pool, policy,
                                                      rng)) > 0
        keeps.append(keep)
        idx = np.nonzero(keep)[0][:cohort]
        x = factors.apply(jnp.asarray(pool["features_raw"][idx]))
        labels = labels_pool[idx]
        batch = {"features": x[:, None, :], "label": labels[:, None]}
        state, met = step(state, batch, rng)
        accountant.step(cohort / 512, fl.noise_multiplier)
        losses.append(float(met["loss"]))
    eval_data = task.sample_devices(512, rng_seed=9999)
    xe = factors.apply(jnp.asarray(eval_data["features_raw"]))
    logit, _ = model.apply(state.params, {"features": xe})
    per_dev = jax.vmap(fl_metrics.local_eval_stats)(
        logit[:, None], jnp.asarray(eval_data["label"])[:, None])
    agg = fl_metrics.aggregate_stats(per_dev, key, noise_multiplier=1.0)
    return dict(factors=factors, pos_ratio=pos_ratio, policy=policy,
                keeps=keeps, losses=losses, state=state,
                derived=fl_metrics.derive_metrics(agg),
                accountant=accountant)


@pytest.fixture(scope="module")
def both():
    k9.reset_counts()
    kdp.reset_counts()
    port = paper_pipeline.run(rounds=ROUNDS, fa_devices=FA_DEVICES,
                              device="cpu", log_every=0)
    counts = {"bit_counts": k9.bit_counts.plain_calls,
              "sq_norms": kdp.sq_norms.plain_calls}
    return _reference(ROUNDS, FA_DEVICES), port, counts


def test_fa_factors_ratio_and_policy_bit_equal(both):
    ref, port, counts = both
    assert port["factors"].scheme == ref["factors"].scheme == "minmax"
    np.testing.assert_array_equal(ref["factors"].shift, port["factors"].shift)
    np.testing.assert_array_equal(ref["factors"].scale, port["factors"].scale)
    assert port["pos_ratio"] == ref["pos_ratio"]
    assert vars(port["policy"]) == vars(ref["policy"])
    # one CDF vote: 2,000 x 32 x 128 is two CPU device tiles of 1,024
    assert counts["bit_counts"] == 2


def test_round_keep_masks_bit_equal(both):
    ref, port, _ = both
    assert len(port["keeps"]) == ROUNDS
    for a, b in zip(ref["keeps"], port["keeps"]):
        np.testing.assert_array_equal(a, b)


def test_round_losses_match(both):
    ref, port, counts = both
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=0,
                               atol=1e-5)
    # K3 once per leaf per chunk: 6 leaves x 4 chunks of 16 clients
    assert counts["sq_norms"] == ROUNDS * 6 * 4
    for a, b in zip(jax.tree.leaves(ref["state"].params),
                    [port["state"].params[k][w]
                     for k in sorted(port["state"].params)
                     for w in sorted(port["state"].params[k])]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-5)


def test_dp_metrics_and_budget_match(both):
    ref, port, _ = both
    for k, v in ref["derived"].items():
        assert float(port["derived"][k]) == pytest.approx(float(v), abs=1e-4)
    eps = port["accountant"].epsilon(1e-6)
    assert eps == ref["accountant"].epsilon(1e-6)
    assert np.isfinite(eps) and eps > 0


def test_pipeline_cli_prints_its_summary(capsys):
    session = {}
    assert paper_pipeline.main(["--device", "cpu", "--rounds", "1"],
                               session=session) == 0
    out = capsys.readouterr().out
    assert "round   0 loss=" in out and "DP metrics: " in out
    assert "roc_auc=" in out and "eps(1e-6)=" in out
    assert len(session["losses"]) == 1
