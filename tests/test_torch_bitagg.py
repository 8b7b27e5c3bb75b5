"""K9 ``bit_counts`` and the fused CDF vote against the JAX package.

- The plain version of K9 is bit-equal to the Pallas kernel in interpret
  mode where its shape rules allow (N % 128 or N < 128, F % 8 or F < 8),
  and to ``repro.kernels.ref.bit_counts`` at ragged N and F, with
  uniforms exactly at f32(p/2) and f32(p), NaN values and +-inf
  thresholds.  The counts are small integers in f32: exact, so bit-equal.
- ``core.analytics.bitagg.threshold_cdf`` (tiled draws, K9 per device tile)
  is bit-equal to the reference's ``estimate_cdf(encode_threshold_bits(
  ...))`` on the same values and key, over at least three device tiles.

The CUDA kernel is held against this plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.analytics import bitagg as jfa
from repro.kernels import bitagg as jk9
from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch.core.analytics import bitagg as fa
from repro_torch.kernels import bitagg as k9
from repro_torch.kernels import ops
from repro_torch.kernels import prf
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()


def _inputs(N, F, T, seed):
    rs = np.random.RandomState(seed)
    v = rs.randn(N, F).astype(np.float32)
    thr = np.sort(rs.randn(T) * 1.5).astype(np.float32)
    u = rs.rand(N, F, T).astype(np.float32)
    return v, thr, u


def _plain(v, thr, u, p):
    return k9.bit_counts(torch.from_numpy(v), torch.from_numpy(thr),
                         torch.from_numpy(u), p).numpy()


def _boundary(v, thr, u, p, rs):
    """Put uniforms exactly at f32(p/2) and f32(p) (and just beside them),
    NaN values, and +-inf thresholds into a case."""
    u = u.copy()
    flat = u.reshape(-1)
    half, full = np.float32(p / 2.0), np.float32(p)
    picks = rs.choice(flat.size, size=min(flat.size, 24), replace=False)
    edge = [half, full, np.nextafter(half, np.float32(0)),
            np.nextafter(full, np.float32(0)), np.float32(0)]
    flat[picks] = np.resize(np.array(edge, np.float32), picks.size)
    v = v.copy()
    v.reshape(-1)[rs.choice(v.size, size=min(v.size, 3), replace=False)] = \
        np.nan
    thr = thr.copy()
    thr[0] = -np.inf
    if thr.size > 1:
        thr[-1] = np.inf
    return v, thr, u


@pytest.mark.parametrize("p", [0.0, 0.1, 0.5, 1.0])
@pytest.mark.parametrize("T", [1, 16, 64])
@pytest.mark.parametrize("F", [4, 8, 16])
@pytest.mark.parametrize("N", [64, 256])
def test_bit_counts_plain_bit_equal_to_pallas(N, F, T, p):
    rs = np.random.RandomState(N + F + T)
    v, thr, u = _boundary(*_inputs(N, F, T, seed=N * F + T), p, rs)
    want = np.asarray(jk9.bit_counts(jnp.asarray(v), jnp.asarray(thr),
                                     jnp.asarray(u), p, interpret=True))
    k9.reset_counts()
    np.testing.assert_array_equal(want, _plain(v, thr, u, p))
    assert k9.counts() == {"bit_counts": {"launches": 0, "plain_calls": 1}}


@pytest.mark.parametrize("p", [0.0, 0.1, 0.5, 1.0])
@pytest.mark.parametrize("N,F,T", [(1, 1, 1), (7, 3, 5), (130, 9, 17),
                                   (300, 5, 64)])
def test_bit_counts_plain_bit_equal_to_ref_at_ragged_shapes(N, F, T, p):
    rs = np.random.RandomState(N * 7 + F)
    v, thr, u = _boundary(*_inputs(N, F, T, seed=N + 31 * T), p, rs)
    want = np.asarray(ref.bit_counts(jnp.asarray(v), jnp.asarray(thr),
                                     jnp.asarray(u), p))
    np.testing.assert_array_equal(want, _plain(v, thr, u, p))


@pytest.mark.parametrize("p", [0.0, 0.3, 1.0])
def test_ops_fa_bit_counts_matches_the_reference_ops(p):
    v, thr, u = _inputs(128, 16, 32, seed=5)
    want = np.asarray(jops.fa_bit_counts(jnp.asarray(v), jnp.asarray(thr),
                                         jnp.asarray(u), p))
    got = ops.fa_bit_counts(torch.from_numpy(v), torch.from_numpy(thr),
                            torch.from_numpy(u), p)
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("N,F,T", [(0, 3, 4), (1, 1, 1), (1000, 32, 128),
                                   (1 << 16, 32, 128), (1 << 20, 1, 1),
                                   (50_000, 4, 256)])
def test_vote_splits_cover_the_devices(N, F, T):
    splits, rows = k9.vote_splits(N, F, T)
    assert splits * rows >= N and (splits - 1) * rows < max(N, 1)
    assert 0 <= splits <= k9.MAX_SPLITS and rows >= 1
    if N >= k9.MIN_ROWS:
        assert rows >= k9.MIN_ROWS


def _kw(k):
    return tuple(int(w) for w in np.asarray(k))


@pytest.mark.parametrize("p", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("N,F,T", [(100, 3, 8), (257, 2, 33), (40, 1, 1)])
def test_threshold_cdf_bit_equal_to_reference(monkeypatch, N, F, T, p):
    """The issue's probe as a test: the fused vote over >= 3 device tiles
    equals ``estimate_cdf(encode_threshold_bits(...))`` bit for bit."""
    rs = np.random.RandomState(N + T)
    v = (rs.randn(N, F) * 2.0).astype(np.float32)
    v[rs.rand(N, F) < 0.02] = np.nan
    thr = np.array(jnp.linspace(-3.0, 3.0, T))
    key = jax.random.PRNGKey(N * 3 + T)
    want = np.asarray(jfa.estimate_cdf(jfa.encode_threshold_bits(
        jnp.asarray(v), jnp.asarray(thr), key, p), p))
    rows = -(-N // 4)  # four device tiles (the last one ragged)
    monkeypatch.setattr(fa, "VOTE_TILE_CPU", rows * F * T)
    # draw sub-tiles smaller than a device tile, ragged against it
    monkeypatch.setattr(prf, "TILE", 37)
    k9.reset_counts()
    got = fa.threshold_cdf(torch.from_numpy(v), torch.from_numpy(thr),
                           _kw(key), p)
    np.testing.assert_array_equal(want, got.numpy())
    assert k9.bit_counts.plain_calls == -(-N // rows) >= 3


def test_threshold_cdf_draws_are_the_reference_uniforms():
    """K9's single uniform folds the reference's two draws: kept where
    ``u1 >= p``, 0 (a forced 1) or f32(p/2) (a forced 0) where flipped."""
    key = jax.random.PRNGKey(11)
    N, F, T, p = 6, 2, 5, 0.4
    k1, k2 = jax.random.split(key)
    u1 = np.asarray(jax.random.uniform(k1, (N, F, T))).reshape(-1)
    u2 = np.asarray(jax.random.uniform(k2, (N, F, T))).reshape(-1)
    want = np.where(u1 < np.float32(p),
                    np.where(u2 < 0.5, 0.0, np.float32(p / 2)), u1)
    tk1, tk2 = prf.split(_kw(key))
    got = fa._rr_uniforms(tk1, tk2, 12, N * F * T, p, torch.device("cpu"))
    np.testing.assert_array_equal(want[12:].astype(np.float32), got.numpy())
