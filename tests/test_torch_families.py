"""The six model families beyond the dense one (MoE, Mamba-2, the RG-LRU
hybrid, VLM early fusion, the whisper encoder-decoder), whole models: the
port's ``build_model`` against the JAX package's at the reduced configs,
both on the CPU.

- the init from the same key is the reference's ``build_model(cfg).init``
  (run as the reference runs it, op by op) bit for bit, but for three
  transcendental leaves: RG-LRU ``lambda`` at rtol 1e-4 (torch's ``pow``
  an ulp off, then a cancellation; ``tests/test_torch_rglru.py``) and
  Mamba-2 ``dt_bias``/``A_log`` at 4 ulp;
- ``apply``, ``prefill`` (logits and every cache leaf) and every
  ``decode_step`` against the jitted reference at atol = 1e-4 (as
  ``tests/test_torch_serve.py``: the frameworks sum in other orders);
- the port's decode started from the reference's prefill cache
  (``convert.cache_from_numpy``) against the reference's decode;
- the port's own decode against its teacher-forced ``apply`` within 2e-4
  (``tests/test_models.py``'s bound), MoE at ``capacity_factor =
  num_experts`` (single-token decode drops pairs that a batch does not).
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
from repro_torch.kernels import flash_decode as kfd
from repro_torch.kernels import prf
from repro_torch.models.model import build_model as tbuild

MODEL = dict(rtol=0, atol=1e-4)
TF_ATOL = 2e-4
ARCHS = ["deepseek-moe-16b", "llama4-scout-17b-a16e", "mamba2-780m",
         "recurrentgemma-2b", "internvl2-76b", "whisper-tiny"]
ULPS = {"dt_bias": 4, "A_log": 4}
B, S, SP = 2, 24, 18


def _cfgs(arch, **kw):
    kw.setdefault("max_seq_len", 128)
    return (jreg.get_config(arch, reduced=True).with_overrides(**kw),
            treg.get_config(arch, reduced=True).with_overrides(**kw))


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _close(a, b, tol=MODEL):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), **tol)


def _jpaths(tree):
    return [tuple(k.key for k in p) for p, _ in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


_INIT = {}


def _reference_init(arch):
    """The reference's init at the reduced config, op by op (as
    ``repro.launch.serve`` runs it), once per arch."""
    if arch not in _INIT:
        jc, _ = _cfgs(arch)
        _INIT[arch] = jax.tree.map(np.asarray,
                                   jbuild(jc).init(jax.random.PRNGKey(2)))
    return _INIT[arch]


def _batch(cfg, rs, n_tok):
    b = {"tokens": rs.randint(0, cfg.vocab_size, (B, n_tok))}
    if cfg.family == "vlm":
        b["patch_embeds"] = (rs.randn(B, cfg.num_image_tokens, cfg.d_model)
                             * 0.02).astype(np.float32)
    if cfg.family == "audio":
        b["audio_embeds"] = (rs.randn(B, cfg.encoder_seq, cfg.d_model)
                             * 0.02).astype(np.float32)
    return b


def _check_cache(jcache, tcache, tol=MODEL):
    paths, leaves = T.flatten(tcache)
    assert paths == _jpaths(jcache)
    for path, a, b in zip(paths, jax.tree.leaves(jcache), leaves):
        assert tuple(a.shape) == tuple(b.shape), path
        if path[-1] == "pos":
            assert b.dtype == torch.int32
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        else:
            _close(a, b, tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_equals_the_reference_init(arch):
    _, tc = _cfgs(arch)
    want = _reference_init(arch)
    got = tbuild(tc, device="cpu").init(prf.PRNGKey(2))
    paths, leaves = T.flatten(got)
    assert paths == _jpaths(want)
    for path, a, b in zip(paths, jax.tree.leaves(want), leaves):
        assert tuple(a.shape) == tuple(b.shape), path
        b = b.numpy()
        if path[-1] == "lambda":
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=0)
        elif path[-1] in ULPS:
            ulp = np.abs(a.view(np.int32).astype(np.int64)
                         - b.view(np.int32)).max()
            assert ulp <= ULPS[path[-1]], (path, ulp)
        else:
            np.testing.assert_array_equal(a, b, err_msg=str(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_prefill_and_every_decode_step(arch):
    jc, tc = _cfgs(arch)
    params = _reference_init(arch)
    jm, tm = jbuild(jc), tbuild(tc, device="cpu")
    jp, tp = jax.tree.map(jnp.asarray, params), \
        convert.params_from_numpy(params)
    batch = _batch(jc, np.random.RandomState(5), S)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: _t(v) for k, v in batch.items()}
    jlog, jaux = jax.jit(jm.apply)(jp, jb)
    tlog, taux = tm.apply(tp, tb)
    _close(jlog, tlog)
    _close(jaux, taux)
    jloss, _ = jax.jit(jm.loss_fn)(jp, jb)
    tloss, _ = tm.loss_fn(tp, tb)
    _close(jloss, tloss)

    off = jc.num_image_tokens if jc.family == "vlm" else 0
    jpb, tpb = dict(jb), dict(tb)
    jpb["tokens"], tpb["tokens"] = jb["tokens"][:, :SP], tb["tokens"][:, :SP]
    jl, jcache = jax.jit(jm.prefill, static_argnums=2)(jp, jpb, S + off)
    tl, tcache = tm.prefill(tp, tpb, S + off)
    _close(jl, tl)
    _check_cache(jcache, tcache)
    carried = convert.cache_from_numpy(jax.tree.map(np.asarray, jcache))
    decode = jax.jit(jm.decode_step)
    kfd.reset_counts()
    for t in range(SP, S):
        jl, jcache = decode(jp, jcache, jb["tokens"][:, t:t + 1],
                            jnp.int32(t + off))
        tl, tcache = tm.decode_step(tp, tcache, tb["tokens"][:, t:t + 1],
                                    t + off)
        _close(jl, tl)
        # the reference's prefill cache carried on by the port
        tl2, carried = tm.decode_step(tp, carried, tb["tokens"][:, t:t + 1],
                                      t + off)
        _close(jl, tl2)
    _check_cache(jcache, tcache)
    _check_cache(jcache, carried)
    kinds = jc.layer_kinds
    attn = sum(k in ("attn", "local_attn", "moe") for k in kinds)
    per_step = 2 * jc.num_layers if jc.family == "audio" else attn
    assert kfd.counts()["flash_decode"] == {
        "launches": 0, "plain_calls": 2 * per_step * (S - SP)}


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing(arch):
    """The port alone, as ``tests/test_models.py`` holds the reference."""
    _, tc = _cfgs(arch)
    if tc.family == "moe":
        tc = tc.with_overrides(capacity_factor=float(tc.num_experts))
    tm = tbuild(tc, device="cpu")
    tp = convert.params_from_numpy(_reference_init(arch))
    tb = {k: _t(v) for k, v in
          _batch(tc, np.random.RandomState(6), S).items()}
    full, _ = tm.apply(tp, tb)
    off = tc.num_image_tokens if tc.family == "vlm" else 0
    pb = dict(tb, tokens=tb["tokens"][:, :SP])
    logits, cache = tm.prefill(tp, pb, S + off)
    torch.testing.assert_close(logits[:, -1], full[:, SP - 1], rtol=0,
                               atol=TF_ATOL)
    for t in range(SP, S):
        lg, cache = tm.decode_step(tp, cache, tb["tokens"][:, t:t + 1],
                                   t + off)
        torch.testing.assert_close(lg[:, 0], full[:, t], rtol=0,
                                   atol=TF_ATOL)


# stacked (scan) and per-layer caches of every state kind
@pytest.mark.parametrize("arch,layers", [
    ("mamba2-780m", 2), ("mamba2-780m", 1), ("recurrentgemma-2b", 3),
    ("whisper-tiny", 2), ("deepseek-moe-16b", 3), ("internvl2-76b", 2)])
def test_cache_from_numpy_round_trips_the_reference_cache(arch, layers):
    jc, tc = _cfgs(arch, num_layers=layers)
    if jc.block_pattern is not None:
        jc = jc.with_overrides(block_pattern=jc.block_pattern[:layers])
        tc = tc.with_overrides(block_pattern=tc.block_pattern[:layers])
    jcache = jax.eval_shape(lambda: jbuild(jc).init_cache(B, 16))
    rs = np.random.RandomState(7)
    filled = jax.tree.map(
        lambda s: rs.randint(-5, 9, s.shape).astype(s.dtype)
        if s.dtype == jnp.int32 else rs.randn(*s.shape).astype(s.dtype),
        jcache)
    got = convert.cache_from_numpy(filled)
    paths, leaves = T.flatten(got)
    assert paths == _jpaths(filled)
    want = tbuild(tc, device="cpu").init_cache(B, 16)
    assert T.tree_map(lambda x: (tuple(x.shape), x.dtype), want) == \
        T.tree_map(lambda x: (tuple(x.shape), x.dtype), got)
    for a, b in zip(jax.tree.leaves(filled), leaves):
        assert b.is_contiguous()
        np.testing.assert_array_equal(a, b.numpy())
    assert any(p[0] == "scan" for p in paths) == (
        layers > 1 and jc.block_pattern is None and jc.family != "audio")


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shapes_at_full_width(arch):
    """``init_cache`` at the published widths equals the reference's
    (``jax.eval_shape``: nothing allocated on the JAX side), on the meta
    device on the port's."""
    jc, tc = jreg.get_config(arch), treg.get_config(arch)
    want = jax.eval_shape(lambda: jbuild(jc).init_cache(2, 64))
    got = tbuild(tc, device="meta").init_cache(2, 64)
    assert T.flatten(got)[0] == _jpaths(want)
    for a, b in zip(jax.tree.leaves(want), T.leaves(got)):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")


def test_use_ragged_moe_serves_drop_free():
    """``build_model(cfg, use_ragged_moe=True)`` is the reference's
    drop-free model."""
    arch = "deepseek-moe-16b"
    jc, tc = _cfgs(arch, capacity_factor=0.25)
    params = _reference_init(arch)
    batch = _batch(jc, np.random.RandomState(8), S)
    jl, _ = jax.jit(jbuild(jc, use_ragged_moe=True).apply)(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    tm = tbuild(tc, use_ragged_moe=True, device="cpu")
    assert tm.cfg.moe_ragged
    tl, _ = tm.apply(convert.params_from_numpy(params),
                     {k: _t(v) for k, v in batch.items()})
    _close(jl, tl)
