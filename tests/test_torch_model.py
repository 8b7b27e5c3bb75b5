"""The port's dense-model parameter tree, and the slice as a whole.

``param_shapes``/``init_params`` give the JAX init's exact tree (paths and
shapes, via ``jax.eval_shape``) for qwen2-reduced and for qwen2-1.5b at its
published widths cut to 2 layers, and ``init_params(cfg, seed)`` the JAX
init's own weights, bit for bit.  Then the whole slice: the qwen2-reduced
parameter tree (JAX-initialised, converted) through the masked ``client``
engine over a multi-chunk plan with one slot dropping out, port against
reference — bit-equal parameters after the recovering flush.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen2_1_5b as jq
from repro.configs.base import FLConfig as JFL
from repro.core.fl.async_fl import AsyncServer as JServer
from repro.models.model import build_model
from repro_torch import convert
from repro_torch import tree as T
from repro_torch.configs import qwen2_1_5b as tq
from repro_torch.configs.base import FLConfig
from repro_torch.core.fl.async_fl import AsyncServer
from repro_torch.models.model import init_params, param_shapes
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()


def _jax_paths_shapes(cfg):
    shapes = jax.eval_shape(build_model(cfg).init, jax.random.PRNGKey(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    return [(tuple(k.key for k in path), tuple(s.shape)) for path, s in flat]


@pytest.mark.parametrize("name", ["reduced", "qwen2-1.5b-2layers"])
def test_param_shapes_match_jax_init(name):
    if name == "reduced":
        jcfg, tcfg = jq.reduced(), tq.reduced()
    else:
        jcfg = jq.CONFIG.with_overrides(num_layers=2)
        tcfg = tq.CONFIG.with_overrides(num_layers=2)
    want = _jax_paths_shapes(jcfg)
    paths, shapes = T.flatten(param_shapes(tcfg))
    assert [(p, tuple(s)) for p, s in zip(paths, shapes)] == want
    if name != "reduced":
        assert len(paths) == 14
        assert sum(int(np.prod(s)) for s in shapes) == 326_970_880
    else:
        p = init_params(tcfg, seed=0, device="cpu")
        assert [tuple(x.shape) for x in T.leaves(p)] == [s for _, s in want]
        assert float(p["final_norm"]["scale"].min()) == 1.0
        assert float(p["stack"]["scan"]["attn"]["bq"].abs().max()) == 0.0


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("layers", [2, 3])
def test_init_params_equal_the_reference_init(seed, layers):
    """``init_params(cfg, seed)`` is the reference's
    ``build_model(cfg).init(PRNGKey(seed))`` leaf for leaf, bit for bit
    (qwen2-reduced: narrow widths, 2 or 3 scanned layers)."""
    jcfg = jq.reduced().with_overrides(num_layers=layers)
    tcfg = tq.reduced().with_overrides(num_layers=layers)
    want = build_model(jcfg).init(jax.random.PRNGKey(seed))
    got = init_params(tcfg, seed=seed, device="cpu")
    paths, leaves = T.flatten(got)
    jflat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert paths == [tuple(k.key for k in p) for p, _ in jflat]
    for (_, a), b in zip(jflat, leaves):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_qwen2_reduced_through_client_engine_bit_equal():
    cfg = jq.reduced()
    params = jax.tree.map(np.asarray,
                          build_model(cfg).init(jax.random.PRNGKey(0)))
    rs = np.random.RandomState(0)
    deltas = [jax.tree.map(
        lambda x: (rs.randn(*x.shape) * 1e-3).astype(np.float32), params)
        for _ in range(3)]
    fl = dict(cohort_size=3, clip_norm=1.0, noise_multiplier=0.0,
              secure_agg_bits=32, param_chunk_elems=1 << 18)
    js = JServer(jax.tree.map(jnp.asarray, params), JFL(**fl), buffer_size=3,
                 staleness_mode="constant", mask_mode="client")
    ts = AsyncServer(convert.params_from_numpy(params), FLConfig(**fl),
                     buffer_size=3, staleness_mode="constant",
                     mask_mode="client", device="cpu")
    # the same chunk layout (sorted-key leaf order, offsets, padding)
    assert ts.plan.num_chunks > 1
    assert [tuple(c) for c in ts.plan.chunks] == [
        tuple(c) for c in js.plan.chunks]
    for slot, d in zip((0, 2), deltas):  # slot 1 drops out
        js.push(jax.tree.map(jnp.asarray, d), 0, slot=slot)
        ts.push(convert.params_from_numpy(d), 0, slot=slot)
    assert js.flush() and ts.flush()  # the recovering deadline flush
    assert js.version == ts.version == 1
    for a, b in zip(jax.tree.leaves(js.params), T.leaves(ts.params)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
