"""Training the five non-dense families: the port's autograd through its
models against ``jax.value_and_grad`` of the JAX package's, on the same
reduced configs, weights and batches, both on the CPU.

- each family's loss (cross entropy + MoE aux) and every parameter's
  gradient: the frameworks sum in other orders, so each leaf's gradient is
  held within 1e-4 of its largest entry (plus 1e-7); the MoE router's aux
  loss reaches the router only through the probabilities (its expert
  fractions carry no gradient in either package);
- an expert that no token reaches gets an exactly zero delta from the
  client update in both packages: plain, under FedProx and SCAFFOLD;
- the RG-LRU's ``sqrt(max(1 - a^2, 1e-12))`` (``prf.sqrt_f32``) passes a
  finite gradient, zero where the clamp holds, and the log-depth scan's
  gradient is ``associative_scan``'s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import FLConfig as JFL
from repro.core.fl import round as jround
from repro.models import rglru as jrglru
from repro.models.model import build_model as jbuild
from repro_torch import convert
from repro_torch import tree as T
from repro_torch.configs import registry as treg
from repro_torch.configs.base import FLConfig as TFL
from repro_torch.core.fl import round as tround
from repro_torch.models import rglru as trglru
from repro_torch.models.model import build_model as tbuild
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

ARCHS = ["deepseek-moe-16b", "llama4-scout-17b-a16e", "mamba2-780m",
         "recurrentgemma-2b", "internvl2-76b", "whisper-tiny"]
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7


def _cfgs(arch, **kw):
    kw.setdefault("max_seq_len", 64)
    return (jreg.get_config(arch, reduced=True).with_overrides(**kw),
            treg.get_config(arch, reduced=True).with_overrides(**kw))


def _batch(cfg, rs, B, S):
    toks = rs.randint(0, cfg.vocab_size, (B, S + 1))
    b = {"tokens": toks[:, :-1].astype(np.int32),
         "labels": toks[:, 1:].astype(np.int32),
         "loss_mask": np.ones((B, S), np.float32)}
    n = {"vlm": cfg.num_image_tokens, "audio": cfg.encoder_seq}.get(
        cfg.family)
    if n is not None:
        name = "patch_embeds" if cfg.family == "vlm" else "audio_embeds"
        b[name] = (0.02 * rs.randn(B, n, cfg.d_model)).astype(np.float32)
    return b


def _setup(arch, seed=0, B=2, S=16, **kw):
    jc, tc = _cfgs(arch, **kw)
    jm, tm = jbuild(jc), tbuild(tc, device="cpu")
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    batch = _batch(jc, np.random.RandomState(seed), B, S)
    return jm, tm, params, batch


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jpaths(tree):
    return [tuple(k.key for k in p) for p, _ in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax_grad(arch):
    jm, tm, params, batch = _setup(arch)
    (jloss, jmet), jg = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    paths, leaves = T.flatten(convert.params_from_numpy(params))
    leaves = [x.requires_grad_(True) for x in leaves]
    loss, met = tm.loss_fn(T.unflatten(paths, leaves), _torch(batch))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    np.testing.assert_allclose(float(jloss), float(loss.detach()),
                               rtol=1e-5)
    np.testing.assert_allclose(float(jmet["aux"]), float(met["aux"]),
                               rtol=1e-5, atol=1e-7)
    assert _jpaths(jg) == list(paths)
    for path, a, g in zip(paths, jax.tree.leaves(jg), grads):
        a = np.asarray(a)
        b = np.zeros_like(a) if g is None else g.numpy()
        assert np.isfinite(b).all(), path
        tol = GRAD_RTOL * float(np.abs(a).max()) + GRAD_ATOL
        assert float(np.abs(a - b).max()) <= tol, (path, np.abs(a - b).max(),
                                                   tol)


def _expert_deltas(delta):
    """{path: (E, ...) delta} of the stacked routed-expert leaves."""
    return {p: x for p, x in zip(*T.flatten(delta))
            if "experts" in p}


@pytest.mark.parametrize("update", ["plain", "fedprox", "scaffold"])
def test_an_unreached_expert_gets_an_exactly_zero_delta(update):
    """16 experts, 2 of them per token, 4 tokens: at most 8 reached in each
    MoE layer.  The unreached experts' delta is exactly zero in the port and
    in the reference, over two local steps."""
    jm, tm, params, batch = _setup("deepseek-moe-16b", seed=5, B=1, S=4,
                                   num_experts=16)
    kw = dict(local_steps=2, local_lr=0.5,
              fedprox_mu=0.1 if update == "fedprox" else 0.0)
    jfl, tfl = JFL(**kw), TFL(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tp = convert.params_from_numpy(params)
    if update == "scaffold":
        zj = jax.tree.map(jnp.zeros_like, jp)
        zt = T.tree_map(torch.zeros_like, tp)
        (jd, _), _ = jround.build_scaffold_client_update(jm.loss_fn, jfl)(
            jp, zj, zj, jb, None)
        (td, _), _ = tround.build_scaffold_client_update(tm.loss_fn, tfl)(
            tp, zt, zt, _torch(batch), None)
    else:
        jd, _ = jround.build_client_update(jm.loss_fn, jfl)(jp, jb, None)
        td, _ = tround.build_client_update(tm.loss_fn, tfl)(
            tp, _torch(batch), None)
    jexp = {tuple(p): np.asarray(x) for p, x in zip(_jpaths(jd),
                                                    jax.tree.leaves(jd))}
    unreached = 0
    for path, x in _expert_deltas(td).items():
        zero = (x.reshape(x.shape[0], x.shape[1], -1) == 0).all(-1)  # (L, E)
        jzero = (jexp[path].reshape(zero.shape + (-1,)) == 0).all(-1)
        np.testing.assert_array_equal(zero.numpy(), jzero)
        unreached += int(zero.sum())
    assert unreached > 0


def test_rglru_gates_gradient_at_the_clamp_and_the_scan():
    """``sqrt(max(1 - a^2, 1e-12))`` with ``a`` = 1 (the clamp holds: a zero
    gradient, finite) and below it, and the log-depth scan, against
    ``jax.grad`` of the reference's gates and ``associative_scan``."""
    rs = np.random.RandomState(0)
    r = 8
    p = {"w_a": rs.randn(r, r).astype(np.float32) / 3,
         "b_a": np.zeros(r, np.float32),
         "w_x": rs.randn(r, r).astype(np.float32) / 3,
         "b_x": np.zeros(r, np.float32),
         "lambda": np.array([-60.0] * 4 + [0.5, 1.0, 2.0, -1.0], np.float32)}
    u = rs.randn(2, 9, r).astype(np.float32)

    def jloss(p, u):
        a, b = jrglru._gates(p, u)
        h = jax.lax.associative_scan(
            lambda x, y: (x[0] * y[0], y[0] * x[1] + y[1]), (a, b), axis=1)[1]
        return jnp.sum(h * jnp.cos(u))

    jg = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, p),
                                         jnp.asarray(u))
    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True)
          for k, v in p.items()}
    tu = torch.from_numpy(u.copy()).requires_grad_(True)
    a, b = trglru._gates(tp, tu)
    assert bool((a[..., :4] == 1.0).all())  # the clamp holds there
    h = trglru.linear_scan(a, b)
    gu, *gp = torch.autograd.grad(torch.sum(h * torch.cos(tu)),
                                  [tu] + list(tp.values()))
    for want, got in [(jg[1], gu)] + [(jg[0][k], g)
                                      for k, g in zip(tp, gp)]:
        want = np.asarray(want)
        assert np.isfinite(got.numpy()).all()
        tol = GRAD_RTOL * float(np.abs(want).max()) + GRAD_ATOL
        assert float(np.abs(want - got.numpy()).max()) <= tol
    # through the normalization alone: nothing passes where the clamp holds
    jb = jax.grad(lambda lam: jnp.sum(jrglru._gates(
        dict(p, **{"lambda": lam}), jnp.asarray(u))[1]))(
            jnp.asarray(p["lambda"]))
    (gb,) = torch.autograd.grad(trglru._gates(tp, tu)[1].sum(),
                                [tp["lambda"]])
    np.testing.assert_allclose(np.asarray(jb), gb.numpy(), rtol=1e-4,
                               atol=1e-7)
    assert np.isfinite(gb.numpy()).all()
    assert float(gb[:4].abs().max()) == float(np.abs(jb[:4]).max()) == 0.0


def test_ssd_gradient_stays_finite_where_the_reference_overflows():
    """One 64-long SSD chunk whose decay passes e^88: the reference's
    ``where(tri, exp(cum_q - cum_k), 0)`` overflows in the masked upper
    triangle and its gradient there is 0 * inf = NaN (a caveat of the
    reference: its mamba2 round at sequence 64 prints ``|u|=nan``).  The
    port masks before the exp: the same forward, and a finite gradient
    equal to ``jax.grad`` of the reference's SSD at chunk 16 (the same
    function, no overflow)."""
    from repro.models import ssm as jssm
    from repro_torch.models import ssm as tssm
    rs = np.random.RandomState(4)
    b, S, nh, hd, ds = 1, 64, 2, 4, 8
    x = rs.randn(b, S, nh, hd).astype(np.float32)
    dt = (0.1 + 0.02 * rs.rand(b, S, nh)).astype(np.float32)
    A = np.array([-16.0, -2.0], np.float32)  # 64 x 0.1 x 16 > 88
    Bm = rs.randn(b, S, 1, ds).astype(np.float32)
    Cm = rs.randn(b, S, 1, ds).astype(np.float32)
    w = rs.randn(b, S, nh, hd).astype(np.float32)

    def jf(chunk):
        return jax.grad(lambda *a: jnp.sum(
            jssm.ssd_chunked(*a[:2], jnp.asarray(A), *a[2:], chunk)[0] * w),
            argnums=(0, 1, 2, 3))(*map(jnp.asarray, (x, dt, Bm, Cm)))

    ins = [torch.from_numpy(v.copy()).requires_grad_(True)
           for v in (x, dt, Bm, Cm)]
    y, _ = tssm.ssd_chunked(ins[0], ins[1], torch.from_numpy(A), ins[2],
                            ins[3], 64)
    jy = jssm.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), 64)[0]
    np.testing.assert_allclose(np.asarray(jy), y.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    got = torch.autograd.grad(torch.sum(y * torch.from_numpy(w)), ins)
    assert any(np.isnan(np.asarray(g)).any() for g in jf(64))
    for want, g in zip(jf(16), got):
        want = np.asarray(want)
        assert np.isfinite(g.numpy()).all()
        tol = GRAD_RTOL * float(np.abs(want).max()) + GRAD_ATOL
        assert float(np.abs(want - g.numpy()).max()) <= tol
