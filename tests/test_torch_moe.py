"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's, on the same inputs (weights from the JAX init, activations from
a numpy seed), both on the CPU.

Integer work is bit-equal: the routed expert indices (ties to the lower
index, as ``jax.lax.top_k``), each pair's position in its expert's buffer
and which pairs are dropped.  Float outputs are held at rtol = atol = 1e-5
(a layer, as ``tests/test_torch_serve.py``): the two frameworks sum the
expert products and the gate combine in other orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import moe as JM
from repro_torch import convert
from repro_torch import tree as T
from repro_torch.configs import registry as treg
from repro_torch.models import moe as TM

LAYER = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["deepseek-moe-16b", "llama4-scout-17b-a16e"]


def _cfgs(arch, **kw):
    return (jreg.get_config(arch, reduced=True).with_overrides(**kw),
            treg.get_config(arch, reduced=True).with_overrides(**kw))


def _params(jc, seed=0):
    jp = JM.init_moe(jax.random.PRNGKey(seed), jc)
    return jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp))


def _x(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_moe_bit_equal_to_the_reference(arch):
    """One ``split`` key per expert where the reference ``vmap``s, and the
    router's ``normal / sqrt(d)`` as a true division."""
    jc, tc = _cfgs(arch)
    key = jax.random.PRNGKey(5)
    want = JM.init_moe(key, jc)
    got = TM.init_moe(tuple(int(w) for w in np.asarray(key)), tc, "cpu")
    paths, leaves = T.flatten(got)
    assert paths == [tuple(k.key for k in p) for p, _ in
                     jax.tree_util.tree_flatten_with_path(want)[0]]
    assert T.tree_map(lambda s: tuple(s), TM.moe_shapes(tc)) == \
        T.tree_map(lambda x: tuple(x.shape), got)
    for a, b in zip(jax.tree.leaves(want), leaves):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_route_indices_bit_equal(arch):
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc)
    x = _x(np.random.RandomState(1), 256, jc.d_model)
    jg, ji, jaux = JM.route(jc, jp, jnp.asarray(x))
    tg, ti, taux = TM.route(tc, tp, torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_allclose(np.asarray(jg), tg.numpy(), **LAYER)
    np.testing.assert_allclose(float(jaux), float(taux), **LAYER)


def test_route_breaks_ties_toward_the_lower_expert():
    """Zero router columns (experts 1 and 4) give exactly equal logits
    whatever the summation order, and zero tokens tie every expert; both
    pick the lower expert index first."""
    jc, tc = _cfgs("deepseek-moe-16b", num_experts=6, experts_per_token=3)
    rs = np.random.RandomState(2)
    router = _x(rs, jc.d_model, 6) * 0.1
    router[:, [1, 4]] = 0.0
    x = _x(rs, 64, jc.d_model)
    x[:4] = 0.0
    _, ji, _ = JM.route(jc, {"router": jnp.asarray(router)}, jnp.asarray(x))
    _, ti, _ = TM.route(tc, {"router": torch.from_numpy(router)},
                        torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(ti.numpy()[:4], [[0, 1, 2]] * 4)
    both = [list(r) for r in ti.numpy() if 1 in r and 4 in r]
    assert both and all(r.index(1) < r.index(4) for r in both)


# (T, E, k, capacity factor): the decode batch at deepseek-moe-16b's ratios
# (C = 1, drops), a reduced prefill with drops, one with ample capacity
@pytest.mark.parametrize("T_,E,k,cf", [(8, 64, 6, 1.25), (96, 4, 2, 0.5),
                                       (96, 4, 2, 4.0), (40, 16, 1, 1.25)])
def test_positions_and_keep_bit_equal(T_, E, k, cf):
    rs = np.random.RandomState(T_ + E)
    idx = np.stack([rs.choice(E, k, replace=False) for _ in range(T_)])
    C = max(int(np.ceil(k * T_ / E * cf)), 1)
    jidx = jnp.asarray(idx, jnp.int32)
    for sorted_positions in (True, False):
        jpos, jkeep = JM._positions_and_keep(T_, E, k, C, jidx,
                                             sorted_positions=sorted_positions)
        tpos, tkeep, counts = TM.positions_and_keep(E, C,
                                                    torch.from_numpy(idx))
        np.testing.assert_array_equal(np.asarray(jpos), tpos.numpy())
        np.testing.assert_array_equal(np.asarray(jkeep), tkeep.numpy())
    np.testing.assert_array_equal(counts.numpy(),
                                  np.bincount(idx.reshape(-1), minlength=E))
    if cf < 1.0 or (T_, E) == (8, 64):
        assert not tkeep.all()  # pairs are dropped


@pytest.mark.parametrize("dispatch", ["onehot", "gather", "ragged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_each_dispatch_matches_its_jax_twin(arch, dispatch):
    """At capacity factor 0.5 the capacity dispatches drop pairs; ragged
    keeps all."""
    jc, tc = _cfgs(arch, moe_dispatch=dispatch, capacity_factor=0.5)
    jp, tp = _params(jc, 1)
    x = _x(np.random.RandomState(3), 4, 24, jc.d_model)
    jy, jaux = JM.apply_moe(jc, jp, jnp.asarray(x))
    ty, taux = TM.apply_moe(tc, tp, torch.from_numpy(x))
    np.testing.assert_allclose(np.asarray(jy), ty.numpy(), **LAYER)
    np.testing.assert_allclose(float(jaux), float(taux), **LAYER)


@pytest.mark.parametrize("arch", ARCHS)
def test_onehot_and_gather_are_one_function(arch):
    jc, tc = _cfgs(arch, capacity_factor=0.5)
    _, tp = _params(jc, 2)
    x = torch.from_numpy(_x(np.random.RandomState(4), 3, 16, jc.d_model))
    y1, _ = TM.apply_moe(tc, tp, x)
    y2, _ = TM.apply_moe(tc.with_overrides(moe_dispatch="gather"), tp, x)
    assert torch.equal(y1, y2)
    y3, _ = TM.apply_moe(tc, tp, x, use_ragged=True)
    assert not torch.equal(y1, y3)  # ragged keeps the dropped pairs


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_with_shared_experts(arch):
    """The published capacity 1.25 and the jitted reference."""
    jc, tc = _cfgs(arch)
    assert jc.num_shared_experts == 1
    jp, tp = _params(jc, 3)
    x = _x(np.random.RandomState(5), 2, 32, jc.d_model)
    jy, jaux = jax.jit(lambda p, v: JM.apply_moe(jc, p, v))(jp,
                                                           jnp.asarray(x))
    ty, taux = TM.apply_moe(tc, tp, torch.from_numpy(x))
    np.testing.assert_allclose(np.asarray(jy), ty.numpy(), **LAYER)
    np.testing.assert_allclose(float(jaux), float(taux), **LAYER)


def test_large_buffers_size_to_the_largest_expert_load(monkeypatch):
    """Past ``BUFFER_ELEMS`` the expert buffers hold the largest load, not
    the capacity: the same function."""
    jc, tc = _cfgs("deepseek-moe-16b", capacity_factor=4.0)
    _, tp = _params(jc, 4)
    x = torch.from_numpy(_x(np.random.RandomState(6), 2, 40, jc.d_model))
    want, _ = TM.apply_moe(tc, tp, x)
    monkeypatch.setattr(TM, "BUFFER_ELEMS", 0)
    got, _ = TM.apply_moe(tc, tp, x)
    torch.testing.assert_close(got, want, **LAYER)
