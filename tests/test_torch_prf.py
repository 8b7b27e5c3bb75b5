"""The port's counter PRF and key derivation against the JAX package.

Bit-equal: Threefry-2x32 at 13 and 20 rounds, the stream families (tags
0-3) at arbitrary offsets, batched and tiled generation, the uniforms, and
``PRNGKey``/``fold_in`` against ``jax.random``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import prf as jprf
from repro_torch.kernels import prf
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()


def _u32(a):
    return np.asarray(a).astype(np.uint32).astype(np.int64)


@pytest.mark.parametrize("rounds", [13, 20])
def test_threefry_matches_reference(rounds):
    rs = np.random.RandomState(rounds)
    k0, k1, x0, x1 = rs.randint(0, 2 ** 32, size=(4, 2000), dtype=np.uint64)
    want = jprf.threefry2x32(*(jnp.asarray(v.astype(np.uint32))
                               for v in (k0, k1, x0, x1)), rounds=rounds)
    got = prf.threefry2x32(*(torch.from_numpy(v.astype(np.int64))
                             for v in (k0, k1, x0, x1)), rounds=rounds)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(_u32(w), g.numpy())
    # the scalar (Python int) form used for key derivation agrees too
    s = prf.threefry2x32(int(k0[0]), int(k1[0]), int(x0[0]), int(x1[0]),
                         rounds=rounds)
    assert s == (int(_u32(want[0])[0]), int(_u32(want[1])[0]))


@pytest.mark.parametrize("tag", [0, 1, 2, 3])
@pytest.mark.parametrize("offset", [0, 1, 6, 1001])
def test_stream_block_matches_reference(tag, offset, monkeypatch):
    want = np.asarray(jprf.stream_block(jnp.uint32(0x1234), jnp.uint32(99),
                                        777, tag=tag, offset=offset))
    got = prf.stream_block(0x1234, 99, 777, tag=tag, offset=offset)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(want, got.numpy())
    # tiling over the stream axis is bit-identical (tiny tiles force many)
    monkeypatch.setattr(prf, "TILE", 34)
    np.testing.assert_array_equal(
        want, prf.stream_block(0x1234, 99, 777, tag=tag,
                               offset=offset).numpy())


def test_batched_streams_stream_at_and_uniforms(monkeypatch):
    pk0 = np.array([1, 2 ** 32 - 1, 77], np.uint32)
    pk1 = np.array([5, 6, 2 ** 31], np.uint32)
    want = np.asarray(jprf.stream_block(jnp.asarray(pk0), jnp.asarray(pk1),
                                        301, offset=9))
    monkeypatch.setattr(prf, "TILE", 40)
    got = prf.stream_block(torch.tensor(pk0.astype(np.int64)),
                           torch.tensor(pk1.astype(np.int64)), 301, offset=9)
    np.testing.assert_array_equal(want, got.numpy())
    e = np.array([0, 1, 2, 3, 1000, 2 ** 31 + 7], np.int64)
    np.testing.assert_array_equal(
        np.asarray(jprf.stream_at(jnp.uint32(3), jnp.uint32(4),
                                  jnp.asarray(e.astype(np.uint32)), tag=1)),
        prf.stream_at(3, 4, torch.from_numpy(e), tag=1).numpy())
    u = prf.uniform_block(11, 12, 999, offset=123)
    assert u.dtype == torch.float32
    np.testing.assert_array_equal(
        np.asarray(jprf.uniform_block(jnp.uint32(11), jnp.uint32(12), 999,
                                      offset=123)), u.numpy())


@pytest.mark.parametrize("seed", [0, 0x5A5E, 0xA5, 2 ** 32 - 1])
def test_prng_key_and_fold_in_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    words = tuple(int(w) for w in np.asarray(jax.random.key_data(key)))
    assert prf.PRNGKey(seed) == words
    for data in (0, 1, 2, 7, 0x7EE, 0xDEE, 0xC401, 2 ** 32 - 1):
        want = tuple(int(w) for w in np.asarray(
            jax.random.key_data(jax.random.fold_in(key, data))))
        assert prf.fold_in(words, data) == want
    assert prf.key_words(torch.tensor(list(words))) == words


def test_signed_pair_sum_wraps_mod_2_32(monkeypatch):
    """The shared mask core: +/- pair streams summed mod 2^32, tiled."""
    lo, hi, gains = [0, 0, 1, 2], [1, 3, 2, 3], [1, -1, 2, 0]
    k0, k1 = 17, 23
    want = np.zeros(500, np.int64)
    for a, b, g in zip(lo, hi, gains):
        pk0, pk1 = jprf.pair_keys(jnp.uint32(k0), jnp.uint32(k1),
                                  jnp.uint32(a), jnp.uint32(b))
        want += g * _u32(jprf.stream_block(pk0, pk1, 500))
    want = (want % 2 ** 32).astype(np.uint32).view(np.int32)
    monkeypatch.setattr(prf, "TILE", 64)
    got = prf.signed_pair_sum(k0, k1, lo, hi, gains, 500)
    np.testing.assert_array_equal(want, got.numpy())
