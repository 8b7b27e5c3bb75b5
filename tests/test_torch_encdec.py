"""The port's encoder-decoder (``repro_torch.models.encdec``, whisper's
family) against the JAX package's, on the same inputs (weights from the JAX
init, frames and tokens from a numpy seed), both on the CPU.

Tolerances (as ``tests/test_torch_serve.py``): a layer at rtol = atol =
1e-5, whole-model logits and caches at atol = 1e-4.  The cross-attention
decode runs K10's plain version here (CPU tensors): every encoder frame
valid, no RoPE, the cache untouched.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import encdec as JE
from repro.models import layers as JL
from repro_torch import convert
from repro_torch import tree as T
from repro_torch.configs import registry as treg
from repro_torch.kernels import flash_decode as kfd
from repro_torch.models import encdec as TE
from repro_torch.models import layers as TL
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

LAYER = dict(rtol=1e-5, atol=1e-5)
MODEL = dict(rtol=0, atol=1e-4)


def _cfgs(**kw):
    return (jreg.get_config("whisper-tiny", reduced=True).with_overrides(**kw),
            treg.get_config("whisper-tiny", reduced=True).with_overrides(**kw))


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _close(a, b, tol=LAYER):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), **tol)


_PARAMS = {}


def _params(jc):
    if jc.name not in _PARAMS:
        jp = jax.jit(lambda k: JE.init_encdec(k, jc))(jax.random.PRNGKey(1))
        _PARAMS[jc.name] = jax.tree.map(np.asarray, jp)
    p = _PARAMS[jc.name]
    return jax.tree.map(jnp.asarray, p), convert.params_from_numpy(p)


def _frames(jc, rs, B=2):
    return (rs.randn(B, jc.encoder_seq, jc.d_model) * 0.02).astype(np.float32)


@pytest.mark.parametrize("S,d", [(64, 128), (1500, 384)])  # reduced; whisper
def test_sincos_positions(S, d):
    """``sin``/``cos`` of angles up to S - 1 rad through torch's and XLA's
    f32 ``pow`` and range reduction: within 1e-5 (an ulp of a 1499-rad
    angle alone is 1.2e-4; the two agree far closer)."""
    _close(JL.sincos_positions(S, d), TL.sincos_positions(S, d),
           dict(rtol=0, atol=1e-5))


def test_init_encdec_bit_equal_to_the_reference():
    jc, tc = _cfgs()
    key = jax.random.PRNGKey(4)
    want = JE.init_encdec(key, jc)
    got = TE.init_encdec(tuple(int(w) for w in np.asarray(key)), tc, "cpu")
    paths, leaves = T.flatten(got)
    assert paths == [tuple(k.key for k in p) for p, _ in
                     jax.tree_util.tree_flatten_with_path(want)[0]]
    assert T.tree_map(tuple, TE.encdec_shapes(tc)) == \
        T.tree_map(lambda x: tuple(x.shape), got)
    for a, b in zip(jax.tree.leaves(want), leaves):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_encode():
    jc, tc = _cfgs()
    jp, tp = _params(jc)
    a = _frames(jc, np.random.RandomState(0))
    _close(JE.encode(jc, jp, jnp.asarray(a)), TE.encode(tc, tp, _t(a)),
           MODEL)


def test_cross_attention_and_cross_kv():
    jc, tc = _cfgs()
    jp, tp = _params(jc)
    rs = np.random.RandomState(1)
    x = rs.randn(2, 9, jc.d_model).astype(np.float32)
    mem = rs.randn(2, jc.encoder_seq, jc.d_model).astype(np.float32)
    p_j, p_t = jp["dec_0"]["cross_attn"], tp["dec_0"]["cross_attn"]
    _close(JE.cross_attention(jc, p_j, jnp.asarray(x), jnp.asarray(mem)),
           TE.cross_attention(tc, p_t, _t(x), _t(mem)))
    for a, b in zip(JE.cross_kv(jc, p_j, jnp.asarray(mem)),
                    TE.cross_kv(tc, p_t, _t(mem))):
        _close(a, b)
        assert b.is_contiguous()


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_cross_attention_decode_through_k10(qkv_bias):
    """The reference's ``attention_decode(..., cross_kv=...)`` branch: K10
    over every frame; the cache passes through untouched."""
    jc, tc = _cfgs(qkv_bias=qkv_bias)
    rs = np.random.RandomState(2)
    d, h, kv, hd = jc.d_model, jc.num_heads, jc.num_kv_heads, jc.head_dim
    p = {"wq": rs.randn(d, h, hd), "wk": rs.randn(d, kv, hd),
         "wv": rs.randn(d, kv, hd), "wo": rs.randn(h, hd, d) * 0.1}
    if qkv_bias:
        p.update(bq=rs.randn(h, hd), bk=rs.randn(kv, hd),
                 bv=rs.randn(kv, hd))
    p = {k: (v * d ** -0.5).astype(np.float32) for k, v in p.items()}
    x = rs.randn(2, 1, d).astype(np.float32)
    k = rs.randn(2, jc.encoder_seq, kv, hd).astype(np.float32)
    v = rs.randn(2, jc.encoder_seq, kv, hd).astype(np.float32)
    jy, _ = JL.attention_decode(jc, jax.tree.map(jnp.asarray, p),
                                jnp.asarray(x), None, jnp.int32(17),
                                cross_kv=(jnp.asarray(k), jnp.asarray(v)))
    kfd.reset_counts()
    marker = object()
    ty, same = TL.attention_decode(tc, convert.params_from_numpy(p), _t(x),
                                   marker, 17, cross_kv=(_t(k), _t(v)))
    assert same is marker
    assert kfd.flash_decode.plain_calls == 1
    _close(jy, ty)


def test_apply_prefill_and_decode_with_the_cross_branch():
    jc, tc = _cfgs(max_seq_len=64)
    jp, tp = _params(jc)
    rs = np.random.RandomState(3)
    B, S, Sp = 2, 20, 14
    toks = rs.randint(0, jc.vocab_size, (B, S))
    a = _frames(jc, rs, B)
    jb = {"tokens": jnp.asarray(toks), "audio_embeds": jnp.asarray(a)}
    jfull = JE.apply_encdec(jc, jp, jb)
    tfull = TE.apply_encdec(tc, tp, {"tokens": _t(toks),
                                     "audio_embeds": _t(a)})
    _close(jfull, tfull, MODEL)
    jl, jcache = JE.prefill_encdec(jc, jp, {"tokens": jnp.asarray(toks[:, :Sp]),
                                            "audio_embeds": jnp.asarray(a)}, S)
    tl, tcache = TE.prefill_encdec(tc, tp, {"tokens": _t(toks[:, :Sp]),
                                            "audio_embeds": _t(a)}, S)
    _close(jl, tl, MODEL)
    paths, leaves = T.flatten(tcache)
    assert paths == [tuple(k.key for k in p) for p, _ in
                     jax.tree_util.tree_flatten_with_path(jcache)[0]]
    want = TE.init_encdec_cache(tc, B, S, device="cpu")
    assert T.tree_map(lambda x: (tuple(x.shape), x.dtype), want) == \
        T.tree_map(lambda x: (tuple(x.shape), x.dtype), tcache)
    for path, x, y in zip(paths, jax.tree.leaves(jcache), leaves):
        if path[-1] == "pos":
            np.testing.assert_array_equal(np.asarray(x), y.numpy())
        else:
            _close(x, y, MODEL)
    kfd.reset_counts()
    for t in range(Sp, S):
        jl, jcache = JE.decode_step_encdec(jc, jp, jcache,
                                           jnp.asarray(toks[:, t:t + 1]), t)
        tl, tcache = TE.decode_step_encdec(tc, tp, tcache,
                                           _t(toks[:, t:t + 1]), t)
        _close(jl, tl, MODEL)
        _close(jfull[:, t], tl[:, 0], MODEL)
    # a self and a cross attention per layer per step
    assert kfd.flash_decode.plain_calls == 2 * jc.num_layers * (S - Sp)
    for x, y in zip(jax.tree.leaves(jcache), T.leaves(tcache)):
        _close(x, y, MODEL)
