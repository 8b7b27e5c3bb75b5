"""The serving path: the port's dense model and serve CLI against the JAX
package, on the same inputs (weights from the JAX init, tokens and
activations from a numpy seed), JAX on the CPU beside the port on the CPU.

Tolerances (f32 throughout; the two frameworks sum matrix products and
softmaxes in other orders, ~1e-6 relative per op):
- a single layer: rtol = atol = 1e-5;
- whole-model logits and caches at the reduced configs: atol = 1e-4, half
  the 2e-4 that ``tests/test_models.py`` holds decode against teacher
  forcing to within one framework;
- int8 quantization: bit-equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs import shapes as jshapes
from repro.launch import serve as jserve
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.model import build_model as jbuild
from repro_torch import convert
from repro_torch import tree as T
from repro_torch.configs import registry as treg
from repro_torch.configs import shapes as tshapes
from repro_torch.kernels import flash_decode as kfd
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.model import build_model as tbuild

LAYER = dict(rtol=1e-5, atol=1e-5)
MODEL = dict(rtol=0, atol=1e-4)


def _cfgs(arch="qwen2-1.5b", **kw):
    return (jreg.get_config(arch, reduced=True).with_overrides(**kw),
            treg.get_config(arch, reduced=True).with_overrides(**kw))


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), **tol)


def _randn(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
def test_registry_resolves_every_arch_as_the_reference():
    assert treg.ARCH_IDS == jreg.ARCH_IDS
    assert treg.LONG_CONTEXT_WINDOW == jreg.LONG_CONTEXT_WINDOW
    for arch in jreg.ARCH_IDS:
        for reduced in (True, False):
            assert dataclasses.asdict(treg.get_config(arch, reduced)) == \
                dataclasses.asdict(jreg.get_config(arch, reduced)), arch
    assert {k: dataclasses.asdict(v) for k, v in tshapes.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()}


FAMILIES = ["deepseek-moe-16b", "llama4-scout-17b-a16e", "mamba2-780m",
            "recurrentgemma-2b", "internvl2-76b", "whisper-tiny"]


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch", FAMILIES)
def test_every_family_builds_and_matches_the_reference_shapes(arch, reduced):
    """``build_model`` takes every family; ``param_shapes`` is the JAX
    init's tree, leaf for leaf, at the reduced config and at the published
    widths (``jax.eval_shape``: nothing allocated)."""
    from repro_torch.models.model import param_shapes
    jc, tc = jreg.get_config(arch, reduced), treg.get_config(arch, reduced)
    model = tbuild(tc, device="cpu")
    assert model.cfg == tc
    want = jax.eval_shape(jbuild(jc).init, jax.random.PRNGKey(0))
    paths, shapes = T.flatten(param_shapes(tc))
    assert paths == [tuple(k.key for k in path) for path, _ in
                     jax.tree_util.tree_flatten_with_path(want)[0]]
    assert [tuple(s) for s in shapes] == \
        [tuple(x.shape) for x in jax.tree.leaves(want)]


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_apply_norm(norm):
    jc, tc = _cfgs(norm=norm)
    rs = np.random.RandomState(1)
    x = _randn(rs, 2, 5, 128, scale=3.0)
    p = {"scale": _randn(rs, 128) + 1.0, "bias": _randn(rs, 128)}
    if norm == "rmsnorm":
        del p["bias"]
    want = JL.apply_norm(jc, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    _close(want, TL.apply_norm(tc, convert.params_from_numpy(p), _t(x)),
           LAYER)
    for a, b in zip(jax.tree.leaves(JL.init_norm(jc, 128)),
                    T.leaves(TL.init_norm(tc, 128))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("num_layers", [3, 1])  # stack.scan, layer_0
def test_block_and_stack_init_trees_match_the_reference(num_layers):
    """The same tree (paths and shapes) and, from the same key, the same
    weights bit for bit: the reference's split/fold_in key tree and its
    ``jax.random.normal`` draws."""
    jc, tc = _cfgs(num_layers=num_layers)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 1)
    kw = tuple(int(w) for w in np.asarray(key))

    def tree(t):
        flat = jax.tree_util.tree_flatten_with_path(t)[0]
        return [(tuple(k.key for k in path), tuple(x.shape))
                for path, x in flat]

    for want, got in ((JT.init_block(key, jc, "attn"),
                       TT.init_block(kw, tc, "attn", "cpu")),
                      (JT.init_stack(key, jc), TT.init_stack(kw, tc, "cpu"))):
        paths, leaves = T.flatten(got)
        assert [(p, tuple(x.shape)) for p, x in zip(paths, leaves)] == \
            tree(want)
        for a, b in zip(jax.tree.leaves(want), leaves):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("d", [None, 96])
def test_init_attention_and_mlp_take_an_input_width(d):
    """The reference's optional ``d`` (input width other than d_model)."""
    jc, tc = _cfgs()
    key = jax.random.PRNGKey(4)
    kw = tuple(int(w) for w in np.asarray(key))
    for want, got in ((JL.init_attention(key, jc, d),
                       TL.init_attention(kw, tc, "cpu", d=d)),
                      (JL.init_mlp(key, jc, 64, d),
                       TL.init_mlp(kw, tc, 64, "cpu", d=d))):
        assert sorted(want) == sorted(got)
        for name in want:
            np.testing.assert_array_equal(np.asarray(want[name]),
                                          got[name].numpy())
    assert got["w_in"].shape[0] == (d or tc.d_model)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope(theta):
    rs = np.random.RandomState(2)
    x = _randn(rs, 2, 7, 4, 32)
    pos = np.arange(7, dtype=np.int32) + 1000
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    _close(want, TL.apply_rope(_t(x), _t(pos), theta), LAYER)


@pytest.mark.parametrize("act", ["swiglu", "relu2", "gelu"])
def test_apply_mlp(act):
    jc, tc = _cfgs(mlp_act=act)
    rs = np.random.RandomState(3)
    d, f = jc.d_model, jc.d_ff
    p = {"w_in": _randn(rs, d, f, scale=d ** -0.5),
         "w_out": _randn(rs, f, d, scale=f ** -0.5)}
    if act == "swiglu":
        p["w_gate"] = _randn(rs, d, f, scale=d ** -0.5)
    x = _randn(rs, 2, 5, d)
    want = JL.apply_mlp(jc, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    _close(want, TL.apply_mlp(tc, convert.params_from_numpy(p), _t(x)), LAYER)


def _attn_params(cfg, rs):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {"wq": _randn(rs, d, h, hd, scale=d ** -0.5),
            "wk": _randn(rs, d, kv, hd, scale=d ** -0.5),
            "wv": _randn(rs, d, kv, hd, scale=d ** -0.5),
            "wo": _randn(rs, h, hd, d, scale=(h * hd) ** -0.5),
            "bq": _randn(rs, h, hd, scale=0.1),
            "bk": _randn(rs, kv, hd, scale=0.1),
            "bv": _randn(rs, kv, hd, scale=0.1)}


# one chunk (S % 512 != 0 falls back to S), three chunks, a window
@pytest.mark.parametrize("q_chunk,window", [(0, None), (8, None), (8, 5)])
def test_prefill_attention(q_chunk, window):
    jc, tc = _cfgs(attn_q_chunk=q_chunk)
    rs = np.random.RandomState(4)
    p = _attn_params(jc, rs)
    x = _randn(rs, 2, 24, jc.d_model)
    pos = np.arange(24, dtype=np.int32)
    jy, (jk, jv) = JL.attention(jc, jax.tree.map(jnp.asarray, p),
                                jnp.asarray(x), jnp.asarray(pos),
                                window=window, return_kv=True)
    ty, (tk, tv) = TL.attention(tc, convert.params_from_numpy(p), _t(x),
                                torch.arange(24), window=window,
                                return_kv=True)
    for a, b in ((jy, ty), (jk, tk), (jv, tv)):
        _close(a, b, LAYER)


@pytest.mark.parametrize("W", [32, 8])  # full cache, ring buffer
def test_fill_kv_cache(W):
    jc, tc = _cfgs(attention_window=W if W < 24 else None)
    rs = np.random.RandomState(5)
    k = _randn(rs, 2, 24, jc.num_kv_heads, jc.head_dim)
    v = _randn(rs, 2, 24, jc.num_kv_heads, jc.head_dim)
    pos = np.arange(24, dtype=np.int32)
    want = JL.fill_kv_cache(jc, JL.init_kv_cache(jc, 2, 32), jnp.asarray(k),
                            jnp.asarray(v), jnp.asarray(pos))
    got = TL.fill_kv_cache(tc, TL.init_kv_cache(tc, 2, 32, device="cpu"),
                           _t(k), _t(v), torch.arange(24))
    assert got["k"].shape[1] == W
    for name in ("k", "v", "pos"):
        np.testing.assert_array_equal(np.asarray(want[name]),
                                      got[name].numpy())


@pytest.mark.parametrize("window", [None, 8])
def test_attention_decode(window):
    jc, tc = _cfgs(attention_window=window)
    rs = np.random.RandomState(6)
    p = _attn_params(jc, rs)
    B, W, pos = 2, 32 if window is None else window, 19
    kv, hd = jc.num_kv_heads, jc.head_dim
    filled = np.arange(pos) if window is None else np.arange(pos - W + 1, pos)
    slot_pos = np.full(W, -1, np.int32)
    slot_pos[filled % W] = filled
    cache = {"k": _randn(rs, B, W, kv, hd), "v": _randn(rs, B, W, kv, hd),
             "pos": slot_pos}
    x = _randn(rs, B, 1, jc.d_model)
    jy, jcache = JL.attention_decode(jc, jax.tree.map(jnp.asarray, p),
                                     jnp.asarray(x),
                                     jax.tree.map(jnp.asarray, cache),
                                     jnp.int32(pos), window=window)
    kfd.reset_counts()
    ty, tcache = TL.attention_decode(tc, convert.params_from_numpy(p), _t(x),
                                     convert.cache_from_numpy(cache), pos,
                                     window=window)
    assert kfd.flash_decode.plain_calls == 1
    _close(jy, ty, LAYER)
    for name in ("k", "v"):
        _close(jcache[name], tcache[name], LAYER)
    np.testing.assert_array_equal(np.asarray(jcache["pos"]),
                                  tcache["pos"].numpy())


@pytest.mark.parametrize("extra", [0, 3])
def test_attention_decode_at_a_full_cache_clamps_the_write(extra):
    """Past the cache's end the reference's ``dynamic_update_slice`` clamps
    the new k/v/pos onto the last slot; the port writes the same slot."""
    jc, tc = _cfgs()
    rs = np.random.RandomState(9)
    p = _attn_params(jc, rs)
    B, W = 2, 16
    pos = W + extra
    kv, hd = jc.num_kv_heads, jc.head_dim
    cache = {"k": _randn(rs, B, W, kv, hd), "v": _randn(rs, B, W, kv, hd),
             "pos": np.arange(W, dtype=np.int32)}
    x = _randn(rs, B, 1, jc.d_model)
    jy, jcache = JL.attention_decode(jc, jax.tree.map(jnp.asarray, p),
                                     jnp.asarray(x),
                                     jax.tree.map(jnp.asarray, cache),
                                     jnp.int32(pos))
    ty, tcache = TL.attention_decode(tc, convert.params_from_numpy(p), _t(x),
                                     convert.cache_from_numpy(cache), pos)
    _close(jy, ty, LAYER)
    for name in ("k", "v"):
        _close(jcache[name], tcache[name], LAYER)
        np.testing.assert_array_equal(tcache[name][:, :W - 1].numpy(),
                                      cache[name][:, :W - 1])
    np.testing.assert_array_equal(np.asarray(jcache["pos"]),
                                  tcache["pos"].numpy())
    assert int(tcache["pos"][W - 1]) == pos


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def _models(jc, tc, seed=0):
    """The reference model (its functions jitted) and the port's, with the
    reference's init in both."""
    jm = jbuild(jc)
    params = jax.tree.map(np.asarray,
                          jax.jit(jm.init)(jax.random.PRNGKey(seed)))
    jm = jm._replace(apply=jax.jit(jm.apply), loss_fn=jax.jit(jm.loss_fn),
                     prefill=jax.jit(jm.prefill, static_argnums=2),
                     decode_step=jax.jit(jm.decode_step))
    return (jm, jax.tree.map(jnp.asarray, params), tbuild(tc, device="cpu"),
            convert.params_from_numpy(params))


def _check_cache(jcache, tcache):
    jpaths = [tuple(k.key for k in path) for path, _ in
              jax.tree_util.tree_flatten_with_path(jcache)[0]]
    tpaths, tleaves = T.flatten(tcache)
    assert tpaths == jpaths
    for a, b in zip(jax.tree.leaves(jcache), tleaves):
        if b.dtype == torch.int32:
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        else:
            _close(a, b, MODEL)


def _decode_both(jm, jp, tm, tp, jcache, tcache, toks, start, stop):
    for t in range(start, stop):
        jl, jcache = jm.decode_step(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                                    jnp.int32(t))
        tl, tcache = tm.decode_step(tp, tcache, _t(toks[:, t:t + 1]), t)
        _close(jl, tl, MODEL)
    return jcache, tcache


@pytest.mark.parametrize("num_layers", [2, 1])  # stack.scan, layer_0
def test_model_apply_prefill_and_decode(num_layers):
    jc, tc = _cfgs(num_layers=num_layers, max_seq_len=128)
    jm, jp, tm, tp = _models(jc, tc)
    B, S, Sp = 2, 24, 16
    toks = np.random.RandomState(7).randint(0, jc.vocab_size, (B, S))
    jlog, _ = jm.apply(jp, {"tokens": jnp.asarray(toks)})
    tlog, aux = tm.apply(tp, {"tokens": _t(toks)})
    _close(jlog, tlog, MODEL)
    assert float(aux) == 0.0
    jloss, _ = jm.loss_fn(jp, {"tokens": jnp.asarray(toks)})
    tloss, _ = tm.loss_fn(tp, {"tokens": _t(toks)})
    _close(jloss, tloss, MODEL)

    jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :Sp])}, S)
    tl, tcache = tm.prefill(tp, {"tokens": _t(toks[:, :Sp])}, S)
    _close(jl, tl, MODEL)
    assert ("scan" in tcache) == (num_layers > 1)
    _check_cache(jcache, tcache)
    # the JAX cache carried across decodes on the port like its own
    carried = convert.cache_from_numpy(jax.tree.map(np.asarray, jcache))
    kfd.reset_counts()
    jcache, tcache = _decode_both(jm, jp, tm, tp, jcache, tcache, toks, Sp, S)
    assert kfd.counts()["flash_decode"] == {
        "launches": 0, "plain_calls": num_layers * (S - Sp)}
    _check_cache(jcache, tcache)
    for t in range(Sp, S):  # teacher forced, from the carried cache
        tl, carried = tm.decode_step(tp, carried, _t(toks[:, t:t + 1]), t)
        _close(jlog[:, t], tl[:, 0], MODEL)
    _check_cache(jcache, carried)


def test_sliding_window_decode_variant():
    """Mirrors tests/test_models.py: the ring-buffer cache gives windowed
    attention, here against the reference's decode and teacher forcing."""
    W = 8
    jc, tc = _cfgs(max_seq_len=256)
    jc, tc = jc.decode_variant(W), tc.decode_variant(W)
    jm, jp, tm, tp = _models(jc, tc)
    B, S = 1, 40
    toks = np.random.RandomState(8).randint(0, jc.vocab_size, (B, S))
    jfull, _ = jm.apply(jp, {"tokens": jnp.asarray(toks)})
    tfull, _ = tm.apply(tp, {"tokens": _t(toks)})
    _close(jfull, tfull, MODEL)
    jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S - 8])}, S)
    tl, tcache = tm.prefill(tp, {"tokens": _t(toks[:, :S - 8])}, S)
    assert tcache["scan"]["k"].shape[2] == W  # (L, B, W, KV, hd)
    _check_cache(jcache, tcache)
    jcache, tcache = _decode_both(jm, jp, tm, tp, jcache, tcache, toks,
                                  S - 8, S)
    _check_cache(jcache, tcache)


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------
def test_int8_round_trip_bit_equal_to_reference():
    jc, _ = _cfgs()
    params = jax.jit(jbuild(jc).init)(jax.random.PRNGKey(0))
    jq = jserve.quantize_int8(params)
    tq = tserve.quantize_int8(
        convert.params_from_numpy(jax.tree.map(np.asarray, params)))
    jleaves = jax.tree.leaves(jq, is_leaf=lambda x: isinstance(x, tuple))
    tleaves = T.leaves(tq)
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        assert isinstance(a, tuple) == isinstance(b, tuple)
        if isinstance(a, tuple):
            assert b[0].dtype == torch.int8
            np.testing.assert_array_equal(np.asarray(a[0]), b[0].numpy())
            np.testing.assert_array_equal(np.asarray(a[1]), b[1].numpy())
        else:
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in zip(jax.tree.leaves(jserve.dequantize_int8(jq)),
                    T.leaves(tserve.dequantize_int8(tq))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_serve_main_on_cpu_prints_the_reference_lines(capsys):
    argv = ["--batch", "2", "--prompt-len", "16", "--decode-tokens", "4",
            "--int8"]
    assert jserve.main(argv) == 0
    want = capsys.readouterr().out.splitlines()
    session = {}
    kfd.reset_counts()
    assert tserve.main(argv + ["--device", "cpu"], session=session) == 0
    got = capsys.readouterr().out.splitlines()
    assert kfd.counts()["flash_decode"]["plain_calls"] == 2 * 4
    assert len(got) == len(want) == 4
    assert got[0] == want[0]  # the int8 MiB line: shapes only
    for g, w, head in zip(got[1:3], want[1:3], ("prefill: 2x16 in ",
                                                "decode: 4 steps in ")):
        assert g.startswith(head) and w.startswith(head)
    # the reference's weights and prompt, so the reference's tokens
    assert got[3] == want[3]
    gen = session["generation"]
    assert tuple(gen.tokens.shape) == (2, 5)
    assert got[3] == f"sample: {gen.tokens[0].tolist()}"
    # each step's logits against teacher forcing over prompt + generated
    full = torch.cat([session["tokens"], gen.tokens[:, :4]], dim=1)
    logits, _ = session["model"].apply(session["params"], {"tokens": full})
    for i, step in enumerate(gen.logits):
        torch.testing.assert_close(step, logits[:, 15 + i], rtol=0,
                                   atol=2e-4)
        assert torch.equal(gen.tokens[:, i], step.argmax(-1))


def test_serve_main_window_serves_the_ring_buffer_variant(capsys):
    session = {}
    assert tserve.main(["--device", "cpu", "--batch", "1", "--prompt-len",
                        "12", "--decode-tokens", "4", "--window", "8"],
                       session=session) == 0
    assert capsys.readouterr().out.count("\n") == 3
    model, gen = session["model"], session["generation"]
    assert model.cfg.attention_window == 8
    assert model.init_cache(1, 16)["scan"]["k"].shape[2] == 8
    full = torch.cat([session["tokens"], gen.tokens[:, :4]], dim=1)
    logits, _ = model.apply(session["params"], {"tokens": full})
    for i, step in enumerate(gen.logits):
        torch.testing.assert_close(step, logits[:, 11 + i], rtol=0,
                                   atol=2e-4)


def test_serve_main_refuses_a_checkpoint():
    with pytest.raises(NotImplementedError, match="Queue 1, item 1,"):
        tserve.main(["--device", "cpu", "--checkpoint", "ckpt"])


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_main_samples_every_family_as_the_reference(arch, capsys):
    """``serve.main --arch <family> --device cpu`` at the reduced config:
    the reference's weights, prompt and stub frontend draws (the VLM's
    patch and the audio model's frame embeddings from the prompt's key), so
    the reference's ``sample:`` line; each decode step against teacher
    forcing over prompt + generated tokens (MoE: the prefill's)."""
    argv = ["--arch", arch, "--batch", "2", "--prompt-len", "12",
            "--decode-tokens", "4"]
    assert jserve.main(argv) == 0
    want = capsys.readouterr().out.splitlines()
    session = {}
    assert tserve.main(argv + ["--device", "cpu"], session=session) == 0
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 3
    assert got[-1] == want[-1]
    model, gen = session["model"], session["generation"]
    if model.cfg.family == "moe":
        # at the published capacity a single-token step drops pairs that
        # a batch does not: the prefill against apply on the prompt (same
        # T, same capacity), the steps finite
        full = session["tokens"]
        assert all(bool(torch.isfinite(s).all()) for s in gen.logits)
    else:
        full = torch.cat([session["tokens"], gen.tokens[:, :4]], dim=1)
    logits, _ = model.apply(session["params"],
                            {"tokens": full, **session["inputs"]})
    for i in range(logits.shape[1] - 11):
        torch.testing.assert_close(gen.logits[i], logits[:, 11 + i], rtol=0,
                                   atol=2e-4)


def test_stub_inputs_are_the_reference_draws():
    key = jax.random.PRNGKey(3)
    kw = tuple(int(w) for w in np.asarray(key))
    for arch, name in (("internvl2-76b", "patch_embeds"),
                       ("whisper-tiny", "audio_embeds")):
        cfg = treg.get_config(arch, reduced=True)
        n = cfg.num_image_tokens if name == "patch_embeds" \
            else cfg.encoder_seq
        want = 0.02 * jax.random.normal(key, (2, n, cfg.d_model))
        got = tserve.stub_inputs(cfg, kw, 2, "cpu")
        assert list(got) == [name]
        np.testing.assert_array_equal(np.asarray(want), got[name].numpy())
    assert tserve.stub_inputs(treg.get_config("qwen2-1.5b", True), kw, 2,
                              "cpu") == {}


def test_layers_cuts_the_depth_and_the_pattern():
    cfg = tserve.cut_depth(treg.get_config("recurrentgemma-2b"), 5)
    assert cfg.num_layers == 5
    assert cfg.block_pattern == ("rglru", "rglru", "local_attn", "rglru",
                                 "rglru")
    moe = tserve.cut_depth(treg.get_config("deepseek-moe-16b"), 4)
    assert moe.layer_kinds == ("attn", "moe", "moe", "moe")
