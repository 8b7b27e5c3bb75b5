"""``cfg.remat`` in the port's stack: each block checkpointed
(``torch.utils.checkpoint``), as the reference ``jax.checkpoint``s its
scan body.

- the loss and every gradient with ``remat=True`` are ``torch.equal`` to
  those with ``remat=False``: the recomputed forward runs the same ops in
  the same order;
- both match ``jax.value_and_grad`` of the reference with ``remat=True``
  within the tolerance of ``tests/test_torch_grads.py``: each leaf's
  gradient within 1e-4 of its largest entry (plus 1e-7), the loss within
  rtol 1e-5 (the frameworks sum in other orders).

deepseek-7b's 2 reduced layers are a scanned tail (every block
checkpointed); deepseek-moe-16b at 3 layers keeps its dense first layer
ahead of a scanned MoE tail, which alone is checkpointed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models.model import build_model as jbuild
from repro_torch import convert
from repro_torch import tree as T
from repro_torch.configs import registry as treg
from repro_torch.models import transformer as TR
from repro_torch.models.model import build_model as tbuild
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
CASES = [("deepseek-7b", {}), ("deepseek-moe-16b", {"num_layers": 3})]


def _setup(arch, over, seed=0, B=2, S=16):
    over = dict(over, max_seq_len=64)
    jc = jreg.get_config(arch, reduced=True).with_overrides(remat=True,
                                                             **over)
    tc = treg.get_config(arch, reduced=True).with_overrides(**over)
    params = jax.tree.map(np.asarray, jbuild(jc).init(jax.random.PRNGKey(seed)))
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, jc.vocab_size, (B, S + 1))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32),
             "loss_mask": np.ones((B, S), np.float32)}
    return jc, tc, params, batch


def _torch_loss_and_grads(tc, params, batch):
    paths, leaves = T.flatten(convert.params_from_numpy(params))
    leaves = [x.requires_grad_(True) for x in leaves]
    loss, _ = tbuild(tc, device="cpu").loss_fn(
        T.unflatten(paths, leaves),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return paths, loss.detach(), grads


@pytest.mark.parametrize("arch,over", CASES)
def test_remat_changes_no_bit_of_loss_or_gradient(arch, over, monkeypatch):
    _, tc, params, batch = _setup(arch, over)
    calls = []
    real = TR.checkpoint
    monkeypatch.setattr(TR, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _, loss0, g0 = _torch_loss_and_grads(tc.with_overrides(remat=False),
                                         params, batch)
    assert not calls
    _, loss1, g1 = _torch_loss_and_grads(tc.with_overrides(remat=True),
                                         params, batch)
    # every block of the scanned tail, none of the dense head
    assert len(calls) == tc.num_layers - tc.first_k_dense
    assert torch.equal(loss0, loss1)
    for a, b in zip(g0, g1):
        assert (a is None) == (b is None)
        assert a is None or torch.equal(a, b)


@pytest.mark.parametrize("arch,over", CASES)
def test_remat_gradients_match_jax_grad_under_jax_checkpoint(arch, over):
    jc, tc, params, batch = _setup(arch, over)
    (jloss, _), jg = jax.value_and_grad(jbuild(jc).loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    paths, loss, grads = _torch_loss_and_grads(tc.with_overrides(remat=True),
                                               params, batch)
    np.testing.assert_allclose(float(jloss), float(loss), rtol=1e-5)
    for path, a, g in zip(paths, jax.tree.leaves(jg), grads):
        a = np.asarray(a)
        b = np.zeros_like(a) if g is None else g.numpy()
        tol = GRAD_RTOL * float(np.abs(a).max()) + GRAD_ATOL
        assert float(np.abs(a - b).max()) <= tol, (path, tol)
