"""The port's rebuilt ``jax.random`` draws (``repro_torch.kernels.prf``)
against ``jax.random`` itself (threefry keys, ``jax_threefry_partitionable``
as this JAX sets it).

Bit-equal: ``split``, ``bits``, ``uniform`` (including a draw past 2^16
elements, generated in several tiles), ``permutation`` (including sizes
past 1625, where JAX's shuffle takes two sort rounds), ``randint`` (over
several ranges, the serve prompt's 151,936-token vocabulary among them) and
``normal`` on more than 2^20 draws: XLA's f32 ``erf_inv``, ``log1p`` and
``log`` rebuilt op by op with their FMAs (``prf.fma_f32``), checked at
``log1p``'s branch edge ``|x| = sqrt(2) - 1`` and around ``erf_inv``'s
``w = 5`` split.
"""
import jax
import jax.numpy as jnp
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
    # bit-equal: the port rebuilds XLA's erf_inv (so within 3e-5 too)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.normal(key, (100_000,)))
    np.testing.assert_array_equal(want,
                                  prf.normal(_kw(key), (100_000,)).numpy())
    # the jitted draw is the same
    jit = np.asarray(jax.jit(lambda k: jax.random.normal(k, (4, 25)))(key))
    np.testing.assert_array_equal(jit, prf.normal(_kw(key), (4, 25)).numpy())


@pytest.mark.parametrize("seed,shape", [(0, (1 << 20,)),
                                        (0x5A5E, (1024, 513)),
                                        (123_456_789, (3, 7, 50_001))])
def test_normal_bit_equal_on_many_draws(seed, shape, monkeypatch):
    monkeypatch.setattr(prf, "TILE", 1 << 18)  # several tiles per draw
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 7)
    got = prf.normal(_kw(key), shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(np.asarray(jax.random.normal(key, shape)),
                                  got.numpy())


def _f32_around(x, n):
    """2n + 1 consecutive f32 values centred on f32(x)."""
    c = np.float32(x).view(np.int32)
    return (c + np.arange(-n, n + 1, dtype=np.int32)).view(np.float32)


def test_log1p_and_erf_inv_at_their_branch_edges():
    edge = _f32_around(np.sqrt(2.0) - 1.0, 4096)
    x = np.concatenate([edge, -edge, np.linspace(-0.99, 0.99, 100_001,
                                                 dtype=np.float32)])
    np.testing.assert_array_equal(np.asarray(jax.jit(jnp.log1p)(x)),
                                  prf.log1p_f32(torch.from_numpy(x)).numpy())
    # erf_inv's w = -log1p(-u^2) crosses 5 at u = sqrt(1 - e^-5)
    u = _f32_around(np.sqrt(1.0 - np.exp(-5.0)), 20_000)
    # (XLA's CPU code flushes subnormals; normal's |u| >= 2^-24)
    u = np.concatenate([u, -u, _f32_around(2.0 ** -24, 1000),
                        _f32_around(0.99999994, 200)[:201]])
    np.testing.assert_array_equal(
        np.asarray(jax.jit(jax.scipy.special.erfinv)(u)),
        prf.erf_inv_f32(torch.from_numpy(u)).numpy())
    v = np.concatenate([2.0 ** np.linspace(-40, 0, 50_001),
                        np.linspace(0.01, 0.6, 50_001)]).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(jax.jit(jnp.log)(v)),
                                  prf.log_f32(torch.from_numpy(v)).numpy())


def test_fma_f32_rounds_once_as_xla_contracts():
    f32 = np.float32
    # a*b + c whose f64 sum lands exactly halfway between two f32s while
    # the exact value does not: a second rounding would go the wrong way
    a = np.array([1 + 2 ** -18, -(1 + 2 ** -18), 1 + 2 ** -18, 3.0], f32)
    b = np.array([(1 - 2 ** -18) * 2 ** -24, (1 - 2 ** -18) * 2 ** -24,
                  -(1 - 2 ** -18) * 2 ** -24, 0.5], f32)
    c = np.array([1 + 2 ** -23, 1 + 2 ** -23, -(1 + 2 ** -23), 1.0], f32)
    rs = np.random.RandomState(3)
    n = 200_000
    a = np.concatenate([a, rs.randn(n).astype(f32)])
    b = np.concatenate([b, (rs.randn(n) * 2.0 ** rs.randint(-30, 5, n))
                        .astype(f32)])
    c = np.concatenate([c, rs.randn(n).astype(f32)])
    # XLA's CPU code contracts a jitted a * b + c into one FMA
    want = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    got = prf.fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                      torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(want, got)
    assert got[0] != np.float32(np.float32(a[0] * b[0]) + c[0])


@pytest.mark.parametrize("lo,hi,shape", [(0, 151_936, (8, 2048)),
                                         (0, 10, (1000,)),
                                         (-5, 70_000, (3, 333)),
                                         (0, 65_536, (4097,)),
                                         (100, 65_637, (77,)),
                                         (3, 3, (5,)),
                                         (-2 ** 31, 2 ** 31 - 1, (100,))])
def test_randint(lo, hi, shape):
    for seed in SEEDS[:3]:
        key = jax.random.PRNGKey(seed)
        got = prf.randint(_kw(key), shape, lo, hi)
        assert got.dtype == torch.int32 and tuple(got.shape) == shape
        np.testing.assert_array_equal(
            np.asarray(jax.random.randint(key, shape, lo, hi)), got.numpy())
