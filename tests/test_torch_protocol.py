"""The standalone secure-aggregation protocol and the single-row helpers of
the port (``secure_agg.pairwise_mask``/``mask_update``/``aggregate_masked``/
``secure_aggregate``; ``aggregation.encode_contribution``/
``encode_masked_contribution``/``aggregate_masked_buffer``) against the JAX
package, on the same seeded numpy inputs, both on the CPU.

Every comparison is bit for bit: the masks are the same counter streams,
the stochastic rounding draws the reference's uniforms, and the deltas stay
inside the clip norm, so the clip scale is exactly 1 and the norm's
summation order does not reach the encode.  The pre-clip norm itself is
held within 1 ulp (a float sum in another order).  With device noise on,
XLA adds the draw as one FMA where the port rounds the product first, so
those rows agree within one fixed-point level.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JFL
from repro.core.fl import aggregation as jagg
from repro.core.fl import secure_agg as jsa
from repro_torch.configs.base import FLConfig as TFL
from repro_torch.core.fl import aggregation as agg
from repro_torch.core.fl import secure_agg as sa
from repro_torch.kernels import prf
from repro_torch.kernels import secure_agg as ksa
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

SHAPES = [(1,), (7,), (3, 5), (2, 3, 11), (1000,)]


def _np(x):
    return np.asarray(x)


def _words(key):
    return tuple(int(w) for w in np.asarray(jax.random.key_data(key)))


@pytest.mark.parametrize("n", [1, 2, 3, 8, 64])
def test_pairwise_mask_bit_equal_and_equals_session_mask(n):
    rs = np.random.RandomState(n)
    seed = int(rs.randint(0, 2 ** 31 - 1))
    shape = SHAPES[n % len(SHAPES)]
    total = np.zeros(shape, np.int64)
    for c in sorted({0, n // 2, n - 1}):
        want = _np(jsa.pairwise_mask(shape, c, list(range(n)), seed))
        got = sa.pairwise_mask(shape, c, list(range(n)), seed, device="cpu")
        np.testing.assert_array_equal(want, got.numpy())
        np.testing.assert_array_equal(
            got.numpy(), sa.session_mask(shape, c, n, prf.PRNGKey(seed),
                                         device="cpu").numpy())
    for c in range(n):
        total += sa.pairwise_mask(shape, c, list(range(n)), seed,
                                  device="cpu").numpy()
    assert not (total % 2 ** 32).any()  # the masks cancel


def test_pairwise_mask_with_ragged_peer_lists():
    """Peer ids need not be ``range(n)``: gaps, the client itself (sign 0)
    and ids above the client's."""
    for c, peers in ((5, [0, 5, 9, 17]), (0, [3, 1, 2]), (40, [40])):
        np.testing.assert_array_equal(
            _np(jsa.pairwise_mask((3, 7), c, peers, 99)),
            sa.pairwise_mask((3, 7), c, peers, 99, device="cpu").numpy())


def test_pairwise_mask_in_tiles_equals_one_tile(monkeypatch):
    """The pair streams are generated in tiles over (peers x positions);
    the tile size does not change a bit."""
    want = sa.pairwise_mask((5000,), 3, list(range(64)), 7, device="cpu")
    monkeypatch.setattr(prf, "TILE", 1 << 10)
    got = sa.pairwise_mask((5000,), 3, list(range(64)), 7, device="cpu")
    assert torch.equal(want, got)


def test_mask_update_and_aggregate_masked_bit_equal():
    rs = np.random.RandomState(3)
    n, shape = 6, (4, 65)
    qs = [rs.randint(-2 ** 31, 2 ** 31, size=shape, dtype=np.int64).astype(
        np.int32) for _ in range(n)]
    jm = [jsa.mask_update(jnp.asarray(q), c, list(range(n)), seed=7)
          for c, q in enumerate(qs)]
    tm = [sa.mask_update(torch.from_numpy(q), c, list(range(n)), seed=7)
          for c, q in enumerate(qs)]
    for a, b in zip(jm, tm):
        np.testing.assert_array_equal(_np(a), b.numpy())
    got = sa.aggregate_masked(tm)
    np.testing.assert_array_equal(_np(jsa.aggregate_masked(jm)), got.numpy())
    plain = np.sum(np.stack(qs).astype(np.int64), axis=0)
    np.testing.assert_array_equal(
        ((plain + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32), got.numpy())


@pytest.mark.parametrize("bits", [8, 16, 24, 32])
@pytest.mark.parametrize("with_rng", [False, True])
def test_secure_aggregate_bit_equal(bits, with_rng):
    rs = np.random.RandomState(bits)
    ups = [(0.3 * rs.randn(257)).astype(np.float32) for _ in range(8)]
    jrng = jax.random.PRNGKey(bits + 1) if with_rng else None
    want = _np(jsa.secure_aggregate([jnp.asarray(u) for u in ups], bits,
                                    4.0, seed=3, rng=jrng))
    got = sa.secure_aggregate([torch.from_numpy(u) for u in ups], bits, 4.0,
                              seed=3,
                              rng=_words(jrng) if with_rng else None)
    np.testing.assert_array_equal(want.view(np.int32),
                                  got.numpy().view(np.int32))


def _specs(degree=0, bits=32, placement="tee", noise=0.0):
    kw = dict(clip_norm=1.0, secure_agg_bits=bits, secure_agg_degree=degree,
              noise_placement=placement, noise_multiplier=noise)
    return agg.make_spec(TFL(**kw), 8), jagg.make_spec(JFL(**kw), 8)


def _delta(seed, D=1500, scale=0.01):
    return (scale * np.random.RandomState(seed).randn(D)).astype(np.float32)


@pytest.mark.parametrize("degree", [0, 4])
def test_encode_contributions_bit_equal_to_host_and_interpret_paths(degree):
    """Both branches of the port's masked encode (K1's plain version on the
    CPU, and ``_stream_quantize`` + ``session.mask``) equal the reference's
    host path and its Pallas ``quantize_mask_prf`` in interpret mode; the
    unmasked encode equals the reference's."""
    tspec, jspec = _specs(degree)
    x = _delta(degree)
    jsess = jagg.make_mask_session(jspec, jax.random.PRNGKey(77))
    tsess = agg.make_mask_session(tspec, prf.PRNGKey(77))
    jrng = jax.random.PRNGKey(88)
    host = jagg.encode_masked_contribution(jnp.asarray(x), 0.7, 3, jspec,
                                           jsess, jrng, use_pallas=False)
    kern = jagg.encode_masked_contribution(jnp.asarray(x), 0.7, 3, jspec,
                                           jsess, jrng, use_pallas=True)
    np.testing.assert_array_equal(_np(host[0]), _np(kern[0]))
    calls = ksa.quantize_mask_prf.plain_calls
    for use_kernel in (True, False):
        got = agg.encode_masked_contribution(torch.from_numpy(x), 0.7, 3,
                                             tspec, tsess, prf.PRNGKey(88),
                                             use_kernel=use_kernel)
        np.testing.assert_array_equal(_np(host[0]), got[0].numpy())
        np.testing.assert_allclose(float(host[1]), float(got[1]), rtol=2e-7)
        assert float(got[2]) == float(host[2]) == 0.0
    assert ksa.quantize_mask_prf.plain_calls == calls + 1
    want = jagg.encode_contribution(jnp.asarray(x), 0.7, jspec, jrng)
    got = agg.encode_contribution(torch.from_numpy(x), 0.7, tspec,
                                  prf.PRNGKey(88))
    np.testing.assert_array_equal(_np(want[0]), got[0].numpy())


def test_clipped_row_and_device_noise():
    """A clipped row reports the clip (the scale differs by the norm's
    rounding at most, one level of the encode); device noise is the
    reference's ``fold_in(rng, 1)`` draw, added within one level (XLA's
    FMA)."""
    tspec, jspec = _specs(placement="device", noise=0.5)
    assert tspec.dev_noise == jspec.dev_noise > 0
    x = _delta(5, scale=0.2)  # |x| ~ 7.7 > clip 1
    want = jagg.encode_contribution(jnp.asarray(x), 1.0, jspec,
                                    jax.random.PRNGKey(4))
    got = agg.encode_contribution(torch.from_numpy(x), 1.0, tspec,
                                  prf.PRNGKey(4))
    assert float(got[2]) == float(want[2]) == 1.0
    np.testing.assert_allclose(float(want[1]), float(got[1]), rtol=1e-6)
    d = np.abs(_np(want[0]).astype(np.int64) - got[0].numpy())
    assert d.max() <= 1, d.max()


def _rows(tspec, jspec, n, masked):
    """n rows of encoded deltas, slot b keyed fold_in(88, b); masked rows
    through a session of ``n`` slots."""
    jsess = jagg.make_mask_session(jspec, jax.random.PRNGKey(77))
    tsess = agg.make_mask_session(tspec, prf.PRNGKey(77))
    rows = []
    for b in range(n):
        x = torch.from_numpy(_delta(100 + b, D=777))
        rng = prf.fold_in(prf.PRNGKey(88), b)
        if masked:
            rows.append(agg.encode_masked_contribution(
                x, 1.0, b, tspec, tsess, rng)[0])
        else:
            rows.append(agg.encode_contribution(x, 1.0, tspec, rng)[0])
    return torch.stack(rows), tsess, jsess


@pytest.mark.parametrize("recover,masked,dropped", [
    (True, True, (2, 5)), (True, True, ()), (False, True, ()),
    (True, False, (2, 5)), (False, False, ())])
def test_aggregate_masked_buffer_bit_equal_to_the_jitted_reference(
        recover, masked, dropped):
    """The flush of 8 rows (present-gated, the recovery sweep re-adding the
    dropped slots' shares) equals the jitted reference on the same rows;
    with recovery it decodes to the survivors' unmasked aggregate."""
    tspec, jspec = _specs()
    mbuf, tsess, jsess = _rows(tspec, jspec, 8, masked)
    present = [0 if b in dropped else 1 for b in range(8)]
    w = float(sum(present))
    ref = jax.jit(jagg.aggregate_masked_buffer,
                  static_argnames=("spec", "recover", "masked"))
    want = ref(jnp.asarray(mbuf.numpy()), jnp.asarray(present),
               jnp.float32(w), jspec, jsess if masked else None,
               jax.random.PRNGKey(9), recover=recover, masked=masked)
    got = agg.aggregate_masked_buffer(mbuf, present, w, tspec,
                                      tsess if masked else None,
                                      prf.PRNGKey(9), recover=recover,
                                      masked=masked)
    np.testing.assert_array_equal(_np(want), got.numpy())
    if masked and recover:
        plain, _, _ = _rows(tspec, jspec, 8, masked=False)
        assert torch.equal(got, agg.aggregate_masked_buffer(
            plain, present, w, tspec, None, prf.PRNGKey(9), masked=False))


def test_aggregate_masked_buffer_tee_noise():
    """TEE noise on the decoded mean: the reference's ``fold_in(rng,
    0xDEE)`` draw, rescaled to the survivors' weight; XLA adds it as one
    FMA, so within an ulp of the noised value."""
    tspec, jspec = _specs(noise=0.3)
    mbuf, tsess, jsess = _rows(tspec, jspec, 8, True)
    present = [1, 1, 0, 1, 1, 1, 1, 1]
    ref = jax.jit(jagg.aggregate_masked_buffer, static_argnames=("spec",))
    want = ref(jnp.asarray(mbuf.numpy()), jnp.asarray(present),
               jnp.float32(7.0), jspec, jsess, jax.random.PRNGKey(9))
    got = agg.aggregate_masked_buffer(mbuf, present, 7.0, tspec, tsess,
                                      prf.PRNGKey(9))
    np.testing.assert_allclose(_np(want), got.numpy(), rtol=0, atol=1e-6)
    assert float(np.abs(_np(want)).max()) > 1e-3  # the noise is there
