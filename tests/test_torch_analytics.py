"""The port's federated analytics against ``repro.core.analytics`` on the
same inputs and keys: every function of ``tests/test_analytics.py``, and
the FA example's twin.

Bit-equal: bits, means, variances, CDFs (the stored bits and the fused
``threshold_cdf`` vote), percentiles, both normalization factors, the label
ratio, the drop-off policy and masks, and ``bisect_percentile``.  Two rules
of the reference's f32 arithmetic are guarded here: ``jnp.mean`` over axis
0 is ``sum * f32(1/N)`` (``test_mean_is_the_sum_times_the_reciprocal``),
and ``jnp.linspace`` is XLA's formula, not ``torch.linspace``
(``test_linspace_is_xla_s_grid``: bit-equal at the reference's grids,
within one ulp of the grid's magnitude elsewhere).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.analytics import bitagg as jfa
from repro.core.analytics import label_balance as jlb
from repro.core.analytics import normalization as jnorm
from repro.data.synthetic import ClassifierTask
from repro_torch.core.analytics import bitagg as fa
from repro_torch.core.analytics import label_balance as lb
from repro_torch.core.analytics import normalization as norm
from repro_torch.kernels import bitagg as k9
from repro_torch.kernels import prf
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()


def _kw(k):
    return tuple(int(w) for w in np.asarray(k))


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy()
                                  if isinstance(b, torch.Tensor) else b)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_mean_estimate_unbiased():
    key = jax.random.PRNGKey(0)
    n = 50_000
    true_means = jnp.asarray([0.2, -1.0, 2.5, 0.0])
    vals = np.asarray(true_means + 0.5 * jax.random.normal(key, (n, 4)))
    jb = jfa.encode_mean_bits(jnp.asarray(vals), -4.0, 4.0, key)
    tb = fa.encode_mean_bits(_t(vals), -4.0, 4.0, _kw(key))
    _eq(jb, tb)
    est = fa.estimate_mean(tb, -4.0, 4.0)
    _eq(jfa.estimate_mean(jb, -4.0, 4.0), est)
    np.testing.assert_allclose(est.numpy(), np.asarray(true_means),
                               atol=0.05)


@pytest.mark.parametrize("flip_prob,seed", [(0.05, 0), (0.17, 9),
                                            (0.4, 2 ** 31 - 1)])
def test_randomized_response_debias(flip_prob, seed):
    key = jax.random.PRNGKey(seed)
    vals = np.full((20_000, 1), 1.3, np.float32)
    jb = jfa.encode_mean_bits(jnp.asarray(vals), -4.0, 4.0, key, flip_prob)
    tb = fa.encode_mean_bits(_t(vals), -4.0, 4.0, _kw(key), flip_prob)
    _eq(jb, tb)
    est = fa.estimate_mean(tb, -4.0, 4.0, flip_prob)
    _eq(jfa.estimate_mean(jb, -4.0, 4.0, flip_prob), est)
    assert float(est[0]) == pytest.approx(1.3, abs=0.2)


def test_estimate_variance_is_keyword_only_and_bit_equal():
    key = jax.random.PRNGKey(2)
    vals = np.asarray(0.3 + 0.1 * jax.random.normal(key, (30_000, 1)))
    k1 = jax.random.fold_in(key, 1)
    jmb = jfa.encode_mean_bits(jnp.asarray(vals), 0.0, 1.0, key)
    jsb = jfa.encode_mean_bits(jnp.square(jnp.asarray(vals)), 0.0, 1.0, k1)
    mb = fa.encode_mean_bits(_t(vals), 0.0, 1.0, _kw(key))
    sb = fa.encode_mean_bits(torch.square(_t(vals)), 0.0, 1.0, _kw(k1))
    _eq(jsb, sb)
    var = fa.estimate_variance(mean_bits=mb, sq_bits=sb, lo=0.0, hi=1.0)
    _eq(jfa.estimate_variance(mean_bits=jmb, sq_bits=jsb, lo=0.0, hi=1.0),
        var)
    assert float(var[0]) == pytest.approx(0.01, abs=0.004)
    with pytest.raises(TypeError):
        fa.estimate_variance(mb, sb)  # positional form must not exist
    with pytest.raises(TypeError):
        fa.estimate_variance(vals.shape, mean_bits=mb, sq_bits=sb)


@pytest.mark.parametrize("n", [3, 7, 64, 999, 20_000, 99_991])
def test_mean_is_the_sum_times_the_reciprocal(n):
    """``jnp.mean(x, 0)`` is ``sum * f32(1/N)`` (XLA multiplies by the
    reciprocal of a constant divisor); ``bitagg.mean0`` computes that."""
    x = (np.random.RandomState(n).rand(n, 64) < 0.37).astype(np.float32)
    _eq(jnp.asarray(x).mean(0), fa.mean0(_t(x)))


def test_true_division_is_not_the_reference_mean():
    """The trap ``mean0`` avoids: ``sum / N`` differs from ``jnp.mean`` in
    some elements at some N."""
    diffs = 0
    for n in (3, 7, 99, 999, 20_000, 99_991):
        x = (np.random.RandomState(n).rand(n, 64) < 0.37).astype(np.float32)
        want = np.asarray(jnp.asarray(x).mean(0))
        diffs += int((want != (_t(x).sum(0) / n).numpy()).sum())
    assert diffs > 0


REFERENCE_GRIDS = [(-4096.0, 4096.0, 64), (-4096.0, 4096.0, 128),
                   (-4096, 4096, 256), (-10.0, 10.0, 64), (-8.0, 10.0, 128),
                   (-3.0, 3.0, 32), (-3, 3, 32)]


@pytest.mark.parametrize("lo,hi,n", REFERENCE_GRIDS + [
    (-8.0, 8.0, 1000), (0.0, 1.0, 7), (-1000.0, 5.0, 333), (2.0, 2.0, 5),
    (1.0, 3.0, 2), (-1.0, 1.0, 1)])
def test_linspace_is_xla_s_grid(lo, hi, n):
    want = np.asarray(jnp.linspace(lo, hi, n))
    got = fa.linspace(lo, hi, n).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    if (lo, hi, n) in REFERENCE_GRIDS or n <= 2:
        np.testing.assert_array_equal(want, got)
    else:
        ulp = np.spacing(np.float32(max(abs(lo), abs(hi))))
        np.testing.assert_allclose(got, want, rtol=0, atol=ulp)
    if (lo, hi, n) == (-4096.0, 4096.0, 128):
        # the trap: torch.linspace is another grid
        assert (torch.linspace(lo, hi, n).numpy() != want).any()


@pytest.mark.parametrize("flip_prob", [0.0, 0.1])
def test_percentile_from_cdf(flip_prob):
    key = jax.random.PRNGKey(1)
    vals = np.asarray(jax.random.normal(key, (40_000, 1)) * 2.0 + 1.0)
    thr = jnp.linspace(-8.0, 10.0, 128)
    jcdf = jfa.estimate_cdf(jfa.encode_threshold_bits(
        jnp.asarray(vals), thr, key, flip_prob), flip_prob)
    cdf = fa.threshold_cdf(_t(vals), _t(thr), _kw(key), flip_prob)
    _eq(jcdf, cdf)
    for q in (0.01, 0.5, 0.9, 0.99):
        _eq(jfa.percentile_from_cdf(jcdf, thr, q),
            fa.percentile_from_cdf(cdf, _t(thr), q))
    p50 = float(fa.percentile_from_cdf(cdf, _t(thr), 0.5)[0])
    p90 = float(fa.percentile_from_cdf(cdf, _t(thr), 0.9)[0])
    assert p50 == pytest.approx(1.0, abs=0.15)
    assert p90 == pytest.approx(1.0 + 2.0 * 1.2816, abs=0.25)


def test_cdf_monotone_under_rr_noise():
    key = jax.random.PRNGKey(2)
    vals = np.asarray(jax.random.normal(key, (500, 2)))
    thr = jnp.linspace(-3, 3, 32)
    jbits = jfa.encode_threshold_bits(jnp.asarray(vals), thr, key, 0.3)
    bits = fa.encode_threshold_bits(_t(vals), _t(thr), _kw(key), 0.3)
    _eq(jbits, bits)
    cdf = fa.estimate_cdf(bits, 0.3)
    _eq(jfa.estimate_cdf(jbits, 0.3), cdf)
    _eq(cdf, fa.threshold_cdf(_t(vals), _t(thr), _kw(key), 0.3))
    assert bool(torch.all(torch.diff(cdf, dim=-1) >= -1e-6))


@pytest.mark.parametrize("flip_prob", [0.0, 0.2])
def test_bisect_percentile(flip_prob):
    """Both protocols see the same fresh samples; each round's vote is
    bit-equal, so every bisection step and the result are equal."""
    draws = [np.random.RandomState(s).normal(2.0, 1.0, size=5000)
             for s in range(12)]
    it_j, it_t = iter(draws), iter(draws)
    want = jfa.bisect_percentile(lambda rng: jnp.asarray(next(it_j)), -10,
                                 10, 0.5, rounds=12,
                                 rng=jax.random.PRNGKey(3),
                                 flip_prob=flip_prob)
    k9.reset_counts()
    got = fa.bisect_percentile(lambda rng: _t(next(it_t)), -10, 10, 0.5,
                               rounds=12, rng=prf.PRNGKey(3),
                               flip_prob=flip_prob)
    assert got == want
    assert got == pytest.approx(2.0, abs=0.1 + flip_prob)
    assert k9.bit_counts.plain_calls == 12  # one vote per round


@pytest.mark.parametrize("flip_prob", [0.0, 0.1])
def test_zscore_normalization_factors(flip_prob):
    task = ClassifierTask(num_features=8, seed=1)
    data = task.sample_devices(60_000, rng_seed=42)
    vals = data["features_raw"]
    key = jax.random.PRNGKey(4)
    jf = jnorm.learn_zscore(jnp.asarray(vals), -4000.0, 4000.0, key,
                            flip_prob)
    f = norm.learn_zscore(_t(vals), -4000.0, 4000.0, _kw(key), flip_prob)
    assert f.scheme == jf.scheme == "zscore"
    np.testing.assert_array_equal(jf.shift, f.shift)
    np.testing.assert_array_equal(jf.scale, f.scale)
    if flip_prob == 0.0:  # the reference test's claim (no local DP noise)
        _, true_std = task.normalization_oracle()
        assert np.corrcoef(f.scale, true_std)[0, 1] > 0.95
    x = vals[:5]
    _eq(jf.apply(jnp.asarray(x)), f.apply(_t(x)))


@pytest.mark.parametrize("flip_prob,n_thr", [(0.0, 128), (0.1, 64)])
def test_minmax_normalization_factors(flip_prob, n_thr):
    task = ClassifierTask(num_features=6, seed=3)
    vals = task.sample_devices(5_000, rng_seed=8)["features_raw"]
    key = jax.random.PRNGKey(6)
    jf = jnorm.learn_minmax(jnp.asarray(vals), -4096.0, 4096.0, key,
                            n_thresholds=n_thr, flip_prob=flip_prob)
    k9.reset_counts()
    f = norm.learn_minmax(_t(vals), -4096.0, 4096.0, _kw(key),
                          n_thresholds=n_thr, flip_prob=flip_prob)
    assert k9.bit_counts.plain_calls >= 1
    np.testing.assert_array_equal(jf.shift, f.shift)
    np.testing.assert_array_equal(jf.scale, f.scale)


# --- label balancing ----------------------------------------------------------
@pytest.mark.parametrize("flip_prob", [0.0, 0.2])
def test_label_ratio_estimate(flip_prob):
    key = jax.random.PRNGKey(5)
    labels = np.asarray((jax.random.uniform(key, (80_000,)) < 0.07)
                        .astype(jnp.int32))
    want = jlb.estimate_label_ratio(jnp.asarray(labels), key, flip_prob)
    got = lb.estimate_label_ratio(_t(labels), _kw(key), flip_prob)
    assert got == want
    assert got == pytest.approx(0.07, abs=0.02)


@pytest.mark.parametrize("pos_ratio,target", [(0.01, 0.2), (0.1, 0.5),
                                              (0.5, 0.5), (0.93, 0.3),
                                              (0.7, 0.8)])
def test_dropoff_policy_hits_target(pos_ratio, target):
    pol = lb.policy_from_ratio(pos_ratio, target)
    jpol = jlb.policy_from_ratio(pos_ratio, target)
    assert (pol.keep_pos, pol.keep_neg, pol.estimated_pos_ratio) == (
        jpol.keep_pos, jpol.keep_neg, jpol.estimated_pos_ratio)
    kept_pos = pol.keep_pos * pos_ratio
    kept_neg = pol.keep_neg * (1.0 - pos_ratio)
    assert kept_pos / (kept_pos + kept_neg) == pytest.approx(target,
                                                             abs=1e-6)
    _eq(jpol.keep_probability(jnp.asarray([0.0, 1.0, 1.0])),
        pol.keep_probability(torch.tensor([0.0, 1.0, 1.0])))


def test_apply_dropoff_weights():
    key = jax.random.PRNGKey(6)
    labels = np.asarray((jax.random.uniform(key, (40_000,)) < 0.1)
                        .astype(jnp.float32))
    jw = jlb.apply_dropoff(jnp.asarray(labels), jlb.policy_from_ratio(0.1),
                           jax.random.PRNGKey(77))
    w = lb.apply_dropoff(_t(labels), lb.policy_from_ratio(0.1),
                         prf.PRNGKey(77))
    _eq(jw, w)
    kept_pos = float((w * _t(labels)).sum())
    kept_neg = float((w * (1 - _t(labels))).sum())
    assert kept_pos / (kept_pos + kept_neg) == pytest.approx(0.5, abs=0.03)


# --- the FA example's twin -----------------------------------------------------
def _reference_example_lines(n):
    """``examples/federated_analytics.py``'s lines at ``n`` devices (its own
    code, with the sample size cut)."""
    from repro.core.device_sim import DevicePopulation
    from repro.core.orchestrator import MetadataStore, Orchestrator
    from repro.core.signal_transformer import (SignalTransformer,
                                               TransformSpec,
                                               spec_with_normalization)
    key = jax.random.PRNGKey(0)
    sample = ClassifierTask(num_features=4, pos_ratio=0.12,
                            seed=5).sample_devices(n, rng_seed=1)
    vals = jnp.asarray(sample["features_raw"])
    bits = jfa.encode_mean_bits(vals, -4096, 4096, key, flip_prob=0.1)
    est = jfa.estimate_mean(bits, -4096, 4096, flip_prob=0.1)
    out = [f"  estimated means: {np.asarray(est).round(2)}",
           f"  true means:      {vals.mean(0).round(2)}"]
    thr = jnp.linspace(-4096, 4096, 256)
    cdf = jfa.estimate_cdf(jfa.encode_threshold_bits(vals, thr, key, 0.1),
                           flip_prob=0.1)
    for q in (0.01, 0.5, 0.99):
        est_q = np.asarray(jfa.percentile_from_cdf(cdf, thr, q))
        true_q = np.asarray(jnp.quantile(vals, q, axis=0))
        out.append(f"  p{int(q * 100):02d}: est {est_q.round(1)}  "
                   f"true {true_q.round(1)}")
    ratio = jlb.estimate_label_ratio(jnp.asarray(sample["label"]), key,
                                     flip_prob=0.2)
    policy = jlb.policy_from_ratio(ratio, 0.5)
    out.append(f"  estimated P(y=1) = {ratio:.3f} (true 0.12) "
               f"-> drop-off: keep_neg={policy.keep_neg:.3f}")
    meta = MetadataStore()
    orch = Orchestrator(DevicePopulation(100, seed=1), meta)
    base = TransformSpec(1, [{"op": "clip", "field": "f0", "lo": -4096.0,
                              "hi": 4096.0}])
    factors = jnorm.learn_minmax(vals[:, :1], -4096, 4096, key)
    orch.push_transform_spec(TransformSpec(1, base.ops))
    orch.push_transform_spec(spec_with_normalization(base, factors, ["f0"],
                                                     new_version=2))
    st = SignalTransformer(meta.get("transform_spec"))
    o = st.apply({"f0": jnp.asarray(float(vals[0, 0]))})
    out.append(f"  device runs v{meta.get('transform_spec').version}: "
               f"raw {float(vals[0, 0]):.1f} -> normalized "
               f"{float(o['f0']):.3f}")
    return out


def test_federated_analytics_example_prints_the_reference_lines(
        monkeypatch, capsys):
    from repro_torch.examples import federated_analytics as ex
    monkeypatch.setattr(ex, "DEVICES", 4_000)
    k9.reset_counts()
    session = {}
    assert ex.main(["--device", "cpu"], session=session) == 0
    # one CDF vote for the percentiles, one for the minmax factors
    assert k9.bit_counts.plain_calls >= 2
    lines = capsys.readouterr().out.splitlines()
    heads = [l for l in lines if l.startswith("===")]
    assert heads == [
        "=== 1. mean estimation (1 bit / device / feature) ===",
        "=== 2. percentiles from threshold-grid bits ===",
        "=== 3. label ratio (label treated as yet another feature) ===",
        "=== 4. push a new transform program (no app release) ==="]
    body = [l for l in lines if l.startswith("  ") and "bytes" not in l
            and "weeks" not in l]
    want = _reference_example_lines(4_000)
    assert len(body) == len(want)
    for got, exp in zip(body, want):
        if "true" in got and "P(y=1)" not in got:
            # the "true" statistics: torch's mean and quantile against
            # jnp's (f32 sums in another order), printed rounded
            assert got.split("true")[0] == exp.split("true")[0]
            g, e = (np.array(x[x.rindex("[") + 1:x.rindex("]")].split(),
                             float) for x in (got, exp))
            np.testing.assert_allclose(g, e, rtol=0, atol=0.11)
        else:
            assert got == exp
    assert session["spec_version"] == 2
