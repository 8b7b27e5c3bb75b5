"""The port's optimizers (``repro_torch.optim``) against the JAX package's
(``repro.optim``), three steps on the same seeded trees, both on the CPU.

sgd and momentum match bit for bit (one f32 op per step, each rounded as
the reference's eager op); adam and adamw within rtol 1e-6: their bias
corrections are f32 ``pow``s, which torch and XLA may round a last bit
apart.  The states keep the reference's trees (``step`` an int32 scalar).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jopt
from repro_torch import tree as T
from repro_torch.optim import optimizers as topt
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

EXACT = {"sgd", "sgd_momentum"}


def _tree(rs):
    return {"dense": {"w": rs.randn(5, 7).astype(np.float32),
                      "b": rs.randn(7).astype(np.float32)},
            "embed": rs.randn(11, 3).astype(np.float32)}


@pytest.mark.parametrize("name,kw", [
    ("sgd", {}), ("sgd_momentum", {"momentum": 0.8}), ("adam", {}),
    ("adamw", {"weight_decay": 0.05})])
def test_three_steps_match_the_reference(name, kw):
    rs = np.random.RandomState(len(name))
    p0 = _tree(rs)
    grads = [jax.tree.map(lambda x: rs.randn(*x.shape).astype(np.float32),
                          p0) for _ in range(3)]
    jo, to = jopt.build_optimizer(name, 0.05, **kw), topt.build_optimizer(
        name, 0.05, **kw)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = T.tree_map(torch.from_numpy, p0)
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        ju, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = to.update(T.tree_map(torch.from_numpy, g), ts, tp)
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
    assert sorted(ts) == sorted(js)
    if "step" in ts:
        assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 3
    tol = dict(rtol=0, atol=0) if name in EXACT else dict(rtol=1e-6,
                                                          atol=1e-7)

    def moments(state):
        return {k: v for k, v in state.items() if k != "step"}

    want = jax.tree.leaves((jp, moments(js)))
    got = T.leaves(tp) + T.leaves(moments(ts))
    assert len(want) == len(got)
    for a, b in zip(want, got):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), **tol)


@pytest.mark.parametrize("name,lr", [("sgd", 0.1), ("sgd_momentum", 0.05),
                                     ("adam", 0.2), ("adamw", 0.2)])
def test_optimizers_minimize_quadratic(name, lr):
    """Twin of ``tests/test_misc.py::test_optimizers_minimize_quadratic``:
    120 steps on sum(x^2) from (5, -3), the gradient from autograd."""
    opt = topt.build_optimizer(name, lr)
    params = {"x": torch.tensor([5.0, -3.0])}
    state = opt.init(params)
    for _ in range(120):
        x = params["x"].clone().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum(torch.square(x)), [x])
        upd, state = opt.update({"x": g}, state, params)
        params = topt.apply_updates(params, upd)
    assert float(params["x"].abs().max()) < 0.05
