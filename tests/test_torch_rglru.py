"""The port's RG-LRU block (``repro_torch.models.rglru``) against the JAX
package's, on the same inputs (weights from the JAX init, activations from
a numpy seed), both on the CPU.

Tolerances: a layer at rtol = atol = 1e-5 (as ``tests/test_torch_serve.py``);
the port's log-depth scan multiplies in another tree than
``jax.lax.associative_scan``, so the scan is held at the same bound.  The
init is bit-equal (the ``uniform`` draw too) but for ``lambda``:
``log(u^(1/8) / (1 - u^(1/8)))`` takes XLA's f32 ``pow``, which torch's
misses by an ulp on ~0.1% of inputs, and ``1 - u^(1/8)`` (down to 1.3e-4)
cancels, so one ulp of the root moves ``lambda`` by up to
``ulp(u^(1/8)) / (1 - u^(1/8))``: held at rtol 1e-4 (about 100 ulp).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import rglru as JR
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.kernels import prf
from repro_torch.models import rglru as TR
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

LAYER = dict(rtol=1e-5, atol=1e-5)
LAMBDA = dict(rtol=1e-4, atol=0)


def _cfgs(**kw):
    return (jreg.get_config("recurrentgemma-2b", reduced=True)
            .with_overrides(**kw),
            treg.get_config("recurrentgemma-2b", reduced=True)
            .with_overrides(**kw))


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _close(a, b, tol=LAYER):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), **tol)


def _params(jc, seed=3):
    jp = JR.init_rglru_block(jax.random.PRNGKey(seed), jc)
    return jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp))


def test_uniform_in_a_range_bit_equal():
    key = jax.random.PRNGKey(11)
    want = jax.random.uniform(key, (4097,), jnp.float32, 0.9, 0.999)
    got = TR._uniform(tuple(int(w) for w in np.asarray(key)), (4097,), 0.9,
                      0.999)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("width", [128, 2560])  # reduced; recurrentgemma-2b
def test_init_rglru_block_against_the_reference(width):
    jc, tc = _cfgs(d_model=width, rglru_width=width)
    key = jax.random.PRNGKey(9)
    want = JR.init_rglru_block(key, jc)
    got = TR.init_rglru_block(prf.key_words(np.asarray(key)), tc, "cpu")
    assert sorted(got) == sorted(want)
    assert {k: tuple(v) for k, v in TR.rglru_shapes(tc).items()} == \
        {k: tuple(v.shape) for k, v in got.items()}
    for name in want:
        if name == "lambda":
            _close(want[name], got[name], LAMBDA)
        else:
            np.testing.assert_array_equal(np.asarray(want[name]),
                                          got[name].numpy(), err_msg=name)


def test_gates():
    jc, tc = _cfgs()
    jp, tp = _params(jc)
    u = np.random.RandomState(0).randn(2, 7, 128).astype(np.float32)
    ja, jb = JR._gates(jp, jnp.asarray(u))
    ta, tb = TR._gates(tp, _t(u))
    _close(ja, ta)
    _close(jb, tb)


# powers of two and not, one step, a long sequence
@pytest.mark.parametrize("S", [1, 2, 5, 64, 100, 333])
def test_scan_against_associative_scan(S):
    jc, tc = _cfgs()
    jp, tp = _params(jc)
    u = np.random.RandomState(S).randn(2, S, 128).astype(np.float32)
    _close(JR.rg_lru_scan(jp, jnp.asarray(u)), TR.rg_lru_scan(tp, _t(u)))


def test_linear_scan_is_the_recurrence():
    rs = np.random.RandomState(1)
    a = torch.from_numpy(rs.uniform(0.5, 1.0, (3, 50, 4)).astype(np.float64))
    b = torch.from_numpy(rs.randn(3, 50, 4))
    h, want = torch.zeros(3, 4, dtype=torch.float64), []
    for t in range(50):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(TR.linear_scan(a, b), torch.stack(want, 1),
                               rtol=1e-12, atol=1e-12)


def test_block_with_its_cache_then_decode():
    """The block over a prompt with its cache, then single-token decode
    steps from the reference's cache carried into the port, against the
    reference's steps and the full-sequence block."""
    jc, tc = _cfgs()
    jp, tp = _params(jc)
    S, n = 30, 5
    x = np.random.RandomState(2).randn(2, S + n, 128).astype(np.float32)
    full = JR.apply_rglru_block(jc, jp, jnp.asarray(x))
    _close(full, TR.apply_rglru_block(tc, tp, _t(x)))
    jy, jcache = JR.apply_rglru_block(jc, jp, jnp.asarray(x[:, :S]),
                                      return_cache=True)
    ty, tcache = TR.apply_rglru_block(tc, tp, _t(x[:, :S]),
                                      return_cache=True)
    _close(jy, ty)
    for k in ("h", "conv"):
        _close(jcache[k], tcache[k])
    tcache = convert.cache_from_numpy(jax.tree.map(np.asarray, jcache))
    held = tcache["h"]
    for t in range(S, S + n):
        jy, jcache = JR.decode_rglru_block(jc, jp, jnp.asarray(x[:, t:t + 1]),
                                           jcache)
        ty, tcache = TR.decode_rglru_block(tc, tp, _t(x[:, t:t + 1]), tcache)
        _close(jy, ty)
        _close(full[:, t:t + 1], ty, dict(rtol=0, atol=1e-4))
        for k in ("h", "conv"):
            _close(jcache[k], tcache[k])
    assert tcache["h"] is held  # updated in place


def test_init_rglru_cache():
    jc, tc = _cfgs()
    want = JR.init_rglru_cache(jc, 3)
    got = TR.init_rglru_cache(tc, 3, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(want[k]), got[k].numpy())
