"""The port's rebuilt ``jax.random`` draws (``repro_torch.kernels.prf``)
against ``jax.random`` itself (threefry keys, ``jax_threefry_partitionable``
as this JAX sets it).

Bit-equal: ``split``, ``bits``, ``uniform`` (including a draw past 2^16
elements, generated in several tiles) and ``permutation`` (including sizes
past 1625, where JAX's shuffle takes two sort rounds).  ``normal`` within
3e-5: ``sqrt(2) * erfinv`` of the same uniforms, where XLA's f32
``erf_inv`` is accurate to ~2e-5 and the port's (f64, rounded once) to
~3e-7.
"""
import jax
import numpy as np
import pytest
import torch

from repro_torch.kernels import prf

SEEDS = (0, 1, 0x5A5E, 123_456_789)


def _kw(key):
    return tuple(int(w) for w in np.asarray(jax.random.key_data(key)))


@pytest.mark.parametrize("seed", SEEDS)
def test_split_and_prngkey(seed):
    key = jax.random.PRNGKey(seed)
    assert prf.PRNGKey(seed) == _kw(key)
    for n in (1, 2, 3, 14):
        want = [tuple(int(v) for v in row)
                for row in np.asarray(jax.random.split(key, n))]
        assert prf.split(_kw(key), n) == want
    sub = jax.random.split(key)[1]
    assert prf.split(prf.split(_kw(key))[1], 3) == [
        tuple(int(v) for v in row) for row in np.asarray(
            jax.random.split(sub, 3))]


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (2, 3, 4),
                                   (70_001,)])
def test_bits_and_uniform(shape, monkeypatch):
    # a small tile, so the 70,001-element draw crosses many tile edges
    monkeypatch.setattr(prf, "TILE", 4096)
    for seed in SEEDS[:3]:
        key = jax.random.PRNGKey(seed)
        got = prf.random_bits(_kw(key), shape)
        np.testing.assert_array_equal(
            np.asarray(jax.random.bits(key, shape)).astype(np.int64),
            got.numpy())
        u = prf.uniform(_kw(key), shape)
        assert u.dtype == torch.float32 and tuple(u.shape) == shape
        np.testing.assert_array_equal(np.asarray(jax.random.uniform(key,
                                                                    shape)),
                                      u.numpy())


def test_uniform_past_two_to_the_sixteen_in_one_tile():
    key = jax.random.PRNGKey(99)
    n = (1 << 16) + 3
    np.testing.assert_array_equal(np.asarray(jax.random.uniform(key, (n,))),
                                  prf.uniform(_kw(key), n).numpy())


@pytest.mark.parametrize("n", [1, 2, 5, 10, 100, 1000, 1625, 1626, 2500])
def test_permutation(n):
    for seed in SEEDS[:2]:
        key = jax.random.PRNGKey(seed)
        np.testing.assert_array_equal(
            np.asarray(jax.random.permutation(key, n)),
            prf.permutation(_kw(key), n).numpy())


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_normal_within_3e_5(seed):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.normal(key, (100_000,)))
    got = prf.normal(_kw(key), (100_000,)).numpy()
    assert np.abs(want - got).max() < 3e-5
    assert (want == got).mean() > 0.3
    # the jitted draw is the same
    jit = np.asarray(jax.jit(lambda k: jax.random.normal(k, (4, 25)))(key))
    np.testing.assert_allclose(jit, prf.normal(_kw(key), (4, 25)).numpy(),
                               rtol=0, atol=3e-5)
