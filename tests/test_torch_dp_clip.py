"""The plain versions of the sync round's kernels against the Pallas kernels
(interpret mode) and the ``repro.kernels.ref`` oracles, and ``kernels.ops``
against ``repro.kernels.ops``.

- K3 ``sq_norms``: rtol 1e-5 (f32 sums of squares in another order: XLA
  adds 512-wide blocks, the plain version whole rows);
- K8 ``scale_accum`` and ``dp_clip_reduce``: rtol 1e-6, atol 2e-6 (the
  Pallas kernel adds 8-client blocks by ``einsum``, the plain version in
  client order: a few f32 ulps of ``sum_c |s_c x_c|``, which is up to ~10
  for these unit-normal rows);
- K6 ``quantize_mask`` and K7 ``dequantize``: bit-equal, with ragged D,
  the edge inputs (+-inf, NaN, out-of-range values that saturate the int32
  conversion) and both of K7's multipliers;
- K9 ``fa_bit_counts`` through ``ops``: bit-equal (its own tests are in
  ``tests/test_torch_bitagg.py``).

Shapes the Pallas wrappers refuse (``C % 8``, ``D % 512``) are held against
``ref.py`` alone; the port takes any shape.  The CUDA kernels are compared
with these plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JFL
from repro.core.fl import aggregation as jagg
from repro.kernels import dp_clip as jdp
from repro.kernels import ops as jops
from repro.kernels import ref
from repro.kernels import secure_agg as jksa
from repro_torch.kernels import dp_clip as kdp
from repro_torch.kernels import ops
from repro_torch.kernels import secure_agg as ksa

RED = dict(rtol=1e-5, atol=0)
SUM = dict(rtol=1e-6, atol=2e-6)


def _x(C, D, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(C, D) * scale).astype(
        np.float32)


@pytest.mark.parametrize("C,D", [(8, 512), (16, 2048), (8, 4096)])
def test_sq_norms_and_scale_accum_match_pallas(C, D):
    x = _x(C, D, seed=C + D)
    s = np.random.RandomState(1).rand(C).astype(np.float32)
    kdp.reset_counts()
    np.testing.assert_allclose(
        np.asarray(jdp.sq_norms(jnp.asarray(x), interpret=True)),
        kdp.sq_norms(torch.from_numpy(x)).numpy(), **RED)
    np.testing.assert_allclose(
        np.asarray(jdp.scale_accum(jnp.asarray(x), jnp.asarray(s),
                                   interpret=True)),
        kdp.scale_accum(torch.from_numpy(x), torch.from_numpy(s)).numpy(),
        **SUM)
    np.testing.assert_allclose(
        np.asarray(jdp.dp_clip_reduce(jnp.asarray(x), 20.0, interpret=True)),
        kdp.dp_clip_reduce(torch.from_numpy(x), 20.0).numpy(), **SUM)
    assert kdp.counts() == {
        "sq_norms": {"launches": 0, "plain_calls": 2},
        "scale_accum": {"launches": 0, "plain_calls": 2}}


@pytest.mark.parametrize("C,D", [(1, 1), (3, 1000), (4, 4099), (5, 7)])
def test_ragged_shapes_match_the_oracles(C, D):
    x = _x(C, D, seed=D)
    s = np.linspace(0.1, 1.0, C).astype(np.float32)
    np.testing.assert_allclose(np.asarray(ref.sq_norms(jnp.asarray(x))),
                               kdp.sq_norms(torch.from_numpy(x)).numpy(),
                               **RED)
    np.testing.assert_allclose(
        np.asarray(ref.clip_scale_accumulate(jnp.asarray(x), jnp.asarray(s))),
        kdp.scale_accum(torch.from_numpy(x), torch.from_numpy(s)).numpy(),
        **SUM)
    # clipping active (norms ~ sqrt(D) > 3) and inactive (clip 1e6)
    for clip in (3.0, 1e6):
        np.testing.assert_allclose(
            np.asarray(ref.dp_clip_reduce(jnp.asarray(x), clip)),
            kdp.dp_clip_reduce(torch.from_numpy(x), clip).numpy(), **SUM)


def test_scale_accum_is_the_client_order_sum():
    """The plain version (and so K8) adds ``s_c * x_c`` in client order,
    each product and sum rounded on its own."""
    x = _x(6, 333, seed=3)
    s = np.random.RandomState(4).rand(6).astype(np.float32)
    want = np.zeros(333, np.float32)
    for c in range(6):
        want = (want + s[c] * x[c]).astype(np.float32)
    np.testing.assert_array_equal(
        want, kdp.scale_accum(torch.from_numpy(x), torch.from_numpy(s)).numpy())


EDGES = np.array([np.inf, -np.inf, np.nan, 3e9, -3e9, 1e30, -0.0, 0.0,
                  2.5, -2.5], np.float32)


@pytest.mark.parametrize("D", [1, 10, 512, 1000, 4099])
@pytest.mark.parametrize("value_range", [4.0, math.inf])
@pytest.mark.parametrize("with_mask", [True, False])
def test_quantize_mask_plain_bit_equal_to_pallas(D, value_range, with_mask):
    rs = np.random.RandomState(D)
    x = (rs.randn(D) * 3).astype(np.float32)
    x[:min(D, EDGES.size)] = EDGES[:min(D, EDGES.size)]
    u = rs.rand(D).astype(np.float32)
    mask = rs.randint(-2 ** 31, 2 ** 31, D, dtype=np.int64).astype(np.int32)
    scale = 131067.5
    jmask = mask if with_mask else np.zeros(D, np.int32)
    want = np.asarray(jksa.quantize_mask(
        jnp.asarray(x), jnp.asarray(jmask), jnp.asarray(u), scale,
        value_range, interpret=True))
    ksa.reset_counts()
    got = ksa.quantize_mask(torch.from_numpy(x),
                            torch.from_numpy(mask) if with_mask else None,
                            torch.from_numpy(u), scale, value_range)
    assert ksa.quantize_mask.plain_calls == 1
    assert ksa.quantize_mask.launches == 0
    np.testing.assert_array_equal(want, got.numpy())
    oracle = np.asarray(ref.quantize_mask(
        jnp.asarray(x), jnp.asarray(jmask), scale, jnp.asarray(u),
        value_range))
    np.testing.assert_array_equal(oracle, got.numpy())


def _scales():
    """Fixed-point scales of the engines: (bits, contributors) pairs."""
    out = []
    for bits in (8, 12, 16, 20, 24, 32):
        for n in (1, 2, 3, 4, 5, 7, 8, 16, 100, 1000):
            out.append(jagg.fixed_point_scale(JFL(secure_agg_bits=bits), n))
    return out


def test_dequantize_plain_matches_pallas_and_the_jitted_decode():
    """K7 takes its multiplier from the caller: the Pallas kernel's
    ``f32(1.0 / scale)`` (``ops.secure_agg_decode``) or the jitted decode's
    ``f32(1) / f32(scale)`` (the round); they differ at some scales."""
    q = np.random.RandomState(0).randint(-2 ** 31, 2 ** 31, 4099,
                                         dtype=np.int64).astype(np.int32)
    q[:3] = (-2 ** 31, 2 ** 31 - 1, 0)
    tq = torch.from_numpy(q)
    differ = 0
    for scale in _scales():
        pallas = np.asarray(jksa.dequantize(jnp.asarray(q), scale,
                                            interpret=True))
        np.testing.assert_array_equal(
            pallas, ksa.dequantize(tq, ksa.pallas_inverse(scale)).numpy())
        jit = np.asarray(jax.jit(lambda a: a.astype(jnp.float32) / scale)(
            jnp.asarray(q)))
        np.testing.assert_array_equal(
            jit, ksa.dequantize(tq, ksa.jit_inverse(scale)).numpy())
        differ += ksa.pallas_inverse(scale) != ksa.jit_inverse(scale)
    assert 0 < differ < len(_scales())


def test_ops_match_the_reference_ops():
    C, D = 8, 1024
    x = _x(C, D, seed=11, scale=0.05)
    np.testing.assert_allclose(
        np.asarray(jops.dp_clip_reduce(jnp.asarray(x), 1.0)),
        ops.dp_clip_reduce(torch.from_numpy(x), 1.0).numpy(), **SUM)
    np.testing.assert_allclose(
        np.asarray(jops.client_sq_norms(jnp.asarray(x))),
        ops.client_sq_norms(torch.from_numpy(x)).numpy(), **RED)
    rs = np.random.RandomState(2)
    v, u = x[0] * 40, rs.rand(D).astype(np.float32)
    m = rs.randint(-2 ** 31, 2 ** 31, D, dtype=np.int64).astype(np.int32)
    enc = np.asarray(jops.secure_agg_encode(jnp.asarray(v), jnp.asarray(m),
                                            jnp.asarray(u), 1e5, 1.0))
    tenc = ops.secure_agg_encode(torch.from_numpy(v), torch.from_numpy(m),
                                 torch.from_numpy(u), 1e5, 1.0)
    np.testing.assert_array_equal(enc, tenc.numpy())
    for scale in (1e5, 131067.5, 33554430.75):
        np.testing.assert_array_equal(
            np.asarray(jops.secure_agg_decode(jnp.asarray(enc), scale)),
            ops.secure_agg_decode(tenc, scale).numpy())
    B, H, KV, hd, W = 2, 4, 2, 32, 512
    q = rs.randn(B, H, hd).astype(np.float32)
    k = rs.randn(B, W, KV, hd).astype(np.float32)
    vv = rs.randn(B, W, KV, hd).astype(np.float32)
    sp = np.arange(W, dtype=np.int32)
    want = jops.flash_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(vv), jnp.asarray(sp),
        300, window=64)
    got = ops.flash_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(vv),
        torch.from_numpy(sp), 300, window=64)
    np.testing.assert_allclose(np.asarray(want), got.numpy(), rtol=1e-5,
                               atol=1e-5)
    # K9 through ops: bit-equal (integer vote counts in f32)
    vals = rs.randn(256, 8).astype(np.float32)
    thr = np.linspace(-2, 2, 16).astype(np.float32)
    uni = rs.rand(256, 8, 16).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jops.fa_bit_counts(jnp.asarray(vals), jnp.asarray(thr),
                                      jnp.asarray(uni), 0.1)),
        ops.fa_bit_counts(torch.from_numpy(vals), torch.from_numpy(thr),
                          torch.from_numpy(uni), 0.1).numpy())
