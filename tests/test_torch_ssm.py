"""The port's Mamba-2 block (``repro_torch.models.ssm``) against the JAX
package's, on the same inputs (weights from the JAX init, activations from
a numpy seed), both on the CPU.

Tolerances: a layer at rtol = atol = 1e-5 (as ``tests/test_torch_serve.py``).
XLA's CPU ``cumsum`` need not sum sequentially and the SSD einsums contract
in another order, so ``ssd_chunked`` is held at the same bound.  The init is
bit-equal but for ``dt_bias`` and ``A_log``, which go through ``exp`` and
``log`` (torch's and XLA's last bits differ): held to 4 ulp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import layers as JL
from repro.models import ssm as JS
from repro_torch import convert
from repro_torch import tree as T
from repro_torch.configs import registry as treg
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TS

LAYER = dict(rtol=1e-5, atol=1e-5)
ULPS = 4
TRANSCENDENTAL = ("dt_bias", "A_log")


def _cfgs(**kw):
    return (jreg.get_config("mamba2-780m", reduced=True).with_overrides(**kw),
            treg.get_config("mamba2-780m", reduced=True).with_overrides(**kw))


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _close(a, b, tol=LAYER):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), **tol)


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def test_softplus_is_logaddexp_without_a_threshold():
    x = np.concatenate([np.linspace(-40, 40, 801, dtype=np.float32),
                        np.float32([-1e4, 1e4, 0.0])])
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = TS.softplus(_t(x)).numpy()
    np.testing.assert_allclose(want, got, rtol=2e-7, atol=0)
    assert got[-2] == 1e4  # no overflow above torch's threshold of 20


def test_rmsnorm_gated():
    rs = np.random.RandomState(0)
    x, z = rs.randn(2, 5, 64).astype(np.float32), \
        rs.randn(2, 5, 64).astype(np.float32)
    scale = (rs.randn(64) + 1).astype(np.float32)
    want = JL.rmsnorm_gated(jnp.asarray(x), jnp.asarray(z), jnp.asarray(scale))
    _close(want, TL.rmsnorm_gated(_t(x), _t(z), _t(scale)))


@pytest.mark.parametrize("nh", [8, 48])  # reduced; mamba2-780m's 48 heads
def test_init_mamba2_against_the_reference(nh):
    jc, tc = _cfgs()
    if nh == 48:
        jc = jc.with_overrides(d_model=1536, ssm_head_dim=64)
        tc = tc.with_overrides(d_model=1536, ssm_head_dim=64)
    assert jc.ssm_num_heads == nh
    key = jax.random.PRNGKey(7)
    want = JS.init_mamba2(key, jc)
    got = TS.init_mamba2(tuple(int(w) for w in np.asarray(key)), tc, "cpu")
    assert sorted(got) == sorted(want)
    assert {k: tuple(v) for k, v in TS.mamba2_shapes(tc).items()} == \
        {k: tuple(v.shape) for k, v in got.items()}
    for name in want:
        if name in TRANSCENDENTAL:
            assert _ulps(want[name], got[name].numpy()) <= ULPS, name
        else:
            np.testing.assert_array_equal(np.asarray(want[name]),
                                          got[name].numpy(), err_msg=name)


def _ssd_inputs(rs, b, S, nh, hd, ds):
    x = rs.randn(b, S, nh, hd).astype(np.float32)
    dt = np.log1p(np.exp(rs.randn(b, S, nh))).astype(np.float32) * 0.1
    A = -np.linspace(1.0, 4.0, nh).astype(np.float32)
    B = rs.randn(b, S, 1, ds).astype(np.float32)
    C = rs.randn(b, S, 1, ds).astype(np.float32)
    return x, dt, A, B, C


# S a multiple of the chunk (4 chunks), and not one (the reference then
# takes one chunk of S)
@pytest.mark.parametrize("S,chunk", [(64, 16), (40, 16), (8, 32)])
def test_ssd_chunked(S, chunk):
    args = _ssd_inputs(np.random.RandomState(S), 2, S, 4, 8, 16)
    jy, jstate = JS.ssd_chunked(*(jnp.asarray(a) for a in args), chunk)
    ty, tstate = TS.ssd_chunked(*(_t(a) for a in args), chunk)
    _close(jy, ty)
    _close(jstate, tstate)


def test_causal_conv():
    rs = np.random.RandomState(1)
    x = rs.randn(2, 9, 12).astype(np.float32)
    w = rs.randn(4, 12).astype(np.float32)
    b = rs.randn(12).astype(np.float32)
    _close(JS._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)),
           TS._causal_conv(_t(x), _t(w), _t(b)))


def _params(jc):
    jp = JS.init_mamba2(jax.random.PRNGKey(3), jc)
    return jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("S", [64, 37])
def test_apply_mamba2_and_its_cache(S):
    jc, tc = _cfgs()
    jp, tp = _params(jc)
    x = np.random.RandomState(2).randn(2, S, jc.d_model).astype(np.float32)
    jy, jcache = JS.apply_mamba2(jc, jp, jnp.asarray(x), return_cache=True)
    ty, tcache = TS.apply_mamba2(tc, tp, _t(x), return_cache=True)
    _close(jy, ty)
    assert sorted(tcache) == ["conv", "ssm"]
    for k in tcache:
        _close(jcache[k], tcache[k])
    _close(JS.apply_mamba2(jc, jp, jnp.asarray(x)),
           TS.apply_mamba2(tc, tp, _t(x)))


def test_decode_mamba2_over_several_steps():
    """From the reference's prefill cache (carried into the port), six
    single-token steps: outputs and the in-place state against the
    reference's step by step, and the steps against the full forward."""
    jc, tc = _cfgs()
    jp, tp = _params(jc)
    S, n = 40, 6
    x = np.random.RandomState(4).randn(2, S + n, jc.d_model).astype(
        np.float32)
    full = JS.apply_mamba2(jc, jp, jnp.asarray(x))
    _, jcache = JS.apply_mamba2(jc, jp, jnp.asarray(x[:, :S]),
                                return_cache=True)
    tcache = convert.cache_from_numpy(jax.tree.map(np.asarray, jcache))
    held = tcache["ssm"]
    for t in range(S, S + n):
        jy, jcache = JS.decode_mamba2(jc, jp, jnp.asarray(x[:, t:t + 1]),
                                      jcache)
        ty, tcache = TS.decode_mamba2(tc, tp, _t(x[:, t:t + 1]), tcache)
        _close(jy, ty)
        _close(full[:, t:t + 1], ty, dict(rtol=0, atol=1e-4))
        for k in ("conv", "ssm"):
            _close(jcache[k], tcache[k])
    assert tcache["ssm"] is held  # updated in place


def test_init_mamba2_cache():
    jc, tc = _cfgs()
    want = JS.init_mamba2_cache(jc, 3)
    got = TS.init_mamba2_cache(tc, 3, device="cpu")
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(want[k]), got[k].numpy())
    assert T.flatten(got)[0] == [("conv",), ("ssm",)]
