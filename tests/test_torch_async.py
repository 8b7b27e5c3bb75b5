"""The port's ``AsyncServer`` against the JAX package's, on the same deltas.

Bit-equal (no clipping, ``noise_multiplier=0``, constant staleness
weighting, FedAvg at ``server_lr=1.0``): the stored buffers, the
``ClientPush`` wire words and the flushed parameters, in all four mask modes
(and the unstreamed ``off`` engine) over a multi-chunk plan at
``secure_agg_bits`` 32 and 16 (the packed 18-bit wire of a 3-slot
session), through a full session and a partial (dropout) flush; the
single-chunk plan once.

Held to ``atol=1e-6``, each for a stated cause: polynomial staleness (f32
``pow`` differs from XLA's in the last bit), active clipping (the
whole-model norm is summed in another order) and FedAdam (``pow``/``sqrt``
rounding).  One fixed-point level is 1/scale ~ 5.6e-9 at bits 32 and a
buffer of 3, so the bound allows ~180 levels per element against updates
of ~5e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JFL
from repro.core.fl.async_fl import AsyncServer as JServer
from repro_torch import convert
from repro_torch import tree as T
from repro_torch.configs.base import FLConfig
from repro_torch.core.fl import aggregation as agg
from repro_torch.core.fl.async_fl import AsyncServer, staleness_weight

B = 3  # session size: 3 pairwise masks, one dropout recovers 2


def _model(rs, scale=1.0):
    return {"a": rs.randn(3, 5).astype(np.float32) * scale,
            "b": {"c": rs.randn(7).astype(np.float32) * scale,
                  "d": rs.randn(4, 4).astype(np.float32) * scale},
            "e": rs.randn(40).astype(np.float32) * scale}


def _setup(n_deltas, seed=0, scale=0.05):
    rs = np.random.RandomState(seed)
    return _model(rs), [_model(rs, scale) for _ in range(n_deltas)]


def _servers(params, mode, fl_kw, **kw):
    fl = dict(cohort_size=B, clip_norm=1.0, noise_multiplier=0.0, **fl_kw)
    kw.setdefault("staleness_mode", "constant")
    js = JServer(jax.tree.map(jnp.asarray, params), JFL(**fl),
                 buffer_size=B, mask_mode=mode, **kw)
    ts = AsyncServer(convert.params_from_numpy(params), FLConfig(**fl),
                     buffer_size=B, mask_mode=mode, device="cpu", **kw)
    return js, ts


def _jx(d):
    return jax.tree.map(jnp.asarray, d)


def _assert_trees_equal(jtree, ttree):
    for a, b in zip(jax.tree.leaves(jtree), T.leaves(ttree)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _assert_bufs_equal(js, ts):
    assert len(js._bufs) == len(ts._bufs)
    for a, b in zip(js._bufs, ts._bufs):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# chunk 40 splits the 78-element model into 2 chunks ({a, b.c, b.d}, {e});
# the unstreamed off engine also runs the single-chunk plan (chunk 0)
CASES = [(mode, kw, bits, 40) for mode, kw in
         [("off", {}), ("client", {}), ("tee_stream", {}), ("tee", {})]
         for bits in (32, 16)] + [("off", {"stream_encode": False}, 32, 0),
                                  ("off", {"stream_encode": False}, 16, 40)]


@pytest.mark.parametrize("mode,kw,bits,chunk", CASES)
def test_async_server_bit_equal_to_reference(mode, kw, bits, chunk):
    params, deltas = _setup(5)
    js, ts = _servers(params, mode,
                      dict(secure_agg_bits=bits, param_chunk_elems=chunk),
                      **kw)
    assert ts.plan.num_chunks == (2 if chunk else 1)
    # session 0: a full buffer; the first two arrive as one stacked push
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *deltas[:2])
    assert js.push(_jx(stacked), 0) == 2
    assert ts.push(convert.params_from_numpy(stacked), 0) == 2
    # the buffers before the apply
    _assert_bufs_equal(js, ts)
    js.push(_jx(deltas[2]), 0)
    ts.push(convert.params_from_numpy(deltas[2]), 0)
    assert js.version == ts.version == 1
    _assert_trees_equal(js.params, ts.params)
    # session 1: slot 1 drops out, the deadline flush recovers it
    for slot, d in zip((0, 2), deltas[3:5]):
        js.push(_jx(d), 1, slot=slot)
        ts.push(convert.params_from_numpy(d), 1, slot=slot)
    frng = jax.random.PRNGKey(77)
    assert js.flush(rng=frng) and ts.flush(rng=convert.key_from_numpy(frng))
    assert js.version == ts.version == 2
    _assert_trees_equal(js.params, ts.params)
    for k in ("weight_total", "clip_fraction", "update_norm"):
        assert float(ts.last_metrics[k]) == pytest.approx(
            float(js.last_metrics[k]), rel=1e-6)



@pytest.mark.parametrize("mode", ["client", "tee_stream", "tee"])
def test_random_k_regular_session_bit_equal_to_reference(mode):
    """A 6-slot session on a random 2-regular mask graph (the reference's
    default for ``secure_agg_degree > 0``): the port draws the same
    ``session_perm`` from each chunk's session key, so the buffers and the
    params after a full session and a recovering flush are bit-equal."""
    n = 6
    rs = np.random.RandomState(5)
    params = _model(rs)
    deltas = [_model(rs, 0.05) for _ in range(n + 4)]
    fl = dict(cohort_size=n, clip_norm=1.0, noise_multiplier=0.0,
              secure_agg_bits=32, param_chunk_elems=40, secure_agg_degree=2)
    kw = dict(buffer_size=n, mask_mode=mode, staleness_mode="constant")
    js = JServer(_jx(params), JFL(**fl), **kw)
    ts = AsyncServer(convert.params_from_numpy(params), FLConfig(**fl),
                     device="cpu", **kw)
    assert ts._spec.random_graph and ts._spec.mask_degree == 2
    for d in deltas[:n]:
        js.push(_jx(d), 0)
        ts.push(convert.params_from_numpy(d), 0)
    assert js.version == ts.version == 1
    _assert_trees_equal(js.params, ts.params)
    # session 1: slots 1 and 4 drop out; the flush recovers their shares
    for slot, d in zip((0, 2, 3, 5), deltas[n:]):
        js.push(_jx(d), 1, slot=slot)
        ts.push(convert.params_from_numpy(d), 1, slot=slot)
    if mode != "tee":
        _assert_bufs_equal(js, ts)
    frng = jax.random.PRNGKey(78)
    assert js.flush(rng=frng) and ts.flush(rng=convert.key_from_numpy(frng))
    _assert_trees_equal(js.params, ts.params)

def test_client_push_words_and_interop():
    """ClientPush words (the packed 18-bit wire of a 2-chunk plan) are
    bit-equal; a converted reference ClientPush is ingested by the port
    and decodes identically."""
    params, deltas = _setup(2, seed=1)
    fl_kw = dict(secure_agg_bits=16, param_chunk_elems=40)
    js, ts = _servers(params, "client", fl_kw)
    _, interop = _servers(params, "client", fl_kw)
    for slot, d in zip((2, 0), deltas):
        jcp = js.encode_push(_jx(d), 0, slot=slot)
        tcp = ts.encode_push(convert.params_from_numpy(d), 0, slot=slot)
        jrows = jcp.row if isinstance(jcp.row, tuple) else (jcp.row,)
        trows = tcp.row if isinstance(tcp.row, tuple) else (tcp.row,)
        for a, b in zip(jrows, trows):
            np.testing.assert_array_equal(np.asarray(a),
                                          convert.words_to_numpy(b))
        assert (tcp.slot, tcp.version, tcp.modulus, tcp.token) == (
            jcp.slot, jcp.version, jcp.modulus, jcp.token)
        assert float(tcp.weight) == float(jcp.weight)
        assert float(tcp.norm) == pytest.approx(float(jcp.norm), rel=1e-6)
        assert js.push_encoded(jcp) and ts.push_encoded(tcp)
        assert interop.push_encoded(convert.client_push_from_numpy(jcp))
    _assert_bufs_equal(js, ts)
    _assert_bufs_equal(js, interop)
    js.flush(), ts.flush(), interop.flush()
    _assert_trees_equal(js.params, ts.params)
    _assert_trees_equal(js.params, interop.params)


def test_client_protocol_errors_tokens_and_quorum():
    params, deltas = _setup(3, seed=2)
    fl = FLConfig(cohort_size=B, clip_norm=1.0, secure_agg_bits=16,
                  flush_quorum=0.75)
    srv = AsyncServer(convert.params_from_numpy(params), fl, buffer_size=B,
                      mask_mode="client", device="cpu")
    cp = srv.encode_push(convert.params_from_numpy(deltas[0]), 0)
    assert srv.push_encoded(cp)
    assert not srv.push_encoded(cp)  # a retried token is a counted no-op
    assert srv.fault_metrics["duplicate_pushes"] == 1
    other = srv.encode_push(convert.params_from_numpy(deltas[1]), 0, slot=1)
    with pytest.raises(ValueError, match="field modulus"):
        srv.push_encoded(other._replace(modulus=1 << 32, token=0))
    with pytest.raises(ValueError, match="stale"):
        srv.push_encoded(other._replace(version=5))
    srv.strict = False
    assert not srv.push_encoded(other._replace(version=5))
    assert srv.fault_metrics["rejected_pushes"] == 1
    assert not srv.flush()  # 1 of 3 slots is below the 0.75 quorum
    assert srv.fault_metrics["subquorum_deferrals"] == 1
    assert srv.flush(force=True) and srv.version == 1
    with pytest.raises(ValueError):
        AsyncServer(convert.params_from_numpy(params), fl, buffer_size=B,
                    mask_mode="tee", device="cpu").encode_push(
                        convert.params_from_numpy(deltas[0]), 0)


@pytest.mark.parametrize("what", ["polynomial", "clipping", "fedadam"])
def test_tolerance_cases(what):
    """Staleness pow, clipped rows and FedAdam: within ``atol`` of the
    reference (the cause of each difference is named in the module doc)."""
    params, deltas = _setup(B, seed=3, scale=0.05)
    fl_kw = dict(secure_agg_bits=32)
    kw = {}
    if what == "polynomial":
        kw["staleness_mode"] = "polynomial"
    elif what == "clipping":
        fl_kw["clip_norm"] = 0.1  # every delta's norm (~0.44) is clipped
    else:
        fl_kw.update(server_opt="fedadam", server_lr=0.1)
    fl = dict(cohort_size=B, clip_norm=1.0, noise_multiplier=0.0)
    fl.update(fl_kw)
    js = JServer(jax.tree.map(jnp.asarray, params), JFL(**fl),
                 buffer_size=B, mask_mode="tee_stream", **kw)
    ts = AsyncServer(convert.params_from_numpy(params), FLConfig(**fl),
                     buffer_size=B, mask_mode="tee_stream", device="cpu", **kw)
    for i, d in enumerate(deltas):
        # stale pulls: staleness 0, 3, 6 under the polynomial weight
        js.push(_jx(d), js.version - 3 * i)
        ts.push(convert.params_from_numpy(d), ts.version - 3 * i)
    assert js.version == ts.version == 1
    for a, b in zip(jax.tree.leaves(js.params), T.leaves(ts.params)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0,
                                   atol=1e-6)
    assert float(ts.last_metrics["clip_fraction"]) == float(
        js.last_metrics["clip_fraction"])


def test_decode_matches_the_jitted_reference_at_every_scale():
    """XLA compiles the reference's division by the constant fixed-point
    scale as a multiply by its f32 reciprocal; the port's decode does the
    same, bit-equal at bits 16 and 32 for buffer sizes whose scales a true
    division would get wrong."""
    from repro.core.fl import aggregation as jagg
    from repro_torch.core.fl import aggregation as agg
    rs = np.random.RandomState(6)
    acc = rs.randint(-2 ** 31, 2 ** 31, size=4000, dtype=np.int64).astype(
        np.int32)
    params = {"w": np.zeros(4000, np.float32)}
    for bits in (16, 32):
        for n in (3, 5, 6, 7, 10, 100):
            fl = dict(secure_agg_bits=bits)
            jspec, spec = jagg.make_spec(JFL(**fl), n), agg.make_spec(
                FLConfig(**fl), n)
            jplan = jagg.make_param_plan(_jx(params))
            plan = agg.make_param_plan(convert.params_from_numpy(params))
            # the total weight is a runtime value in the engines
            want = jax.jit(lambda a, w: jagg.finalize_plan_aggregate(
                (a,), w, jspec, jplan, None))(acc, np.float32(3.0))
            got = agg.finalize_plan_aggregate(
                (torch.from_numpy(acc),), torch.tensor(3.0), spec, plan, None)
            np.testing.assert_array_equal(np.asarray(want["w"]),
                                          got["w"].numpy())


def test_staleness_weight_close_to_reference():
    from repro.core.fl.async_fl import staleness_weight as jweight
    s = np.arange(0, 4096, dtype=np.float32)
    want = np.asarray(jweight(jnp.asarray(s)))
    got = staleness_weight(torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(got, want, rtol=2 ** -22, atol=0)
    np.testing.assert_array_equal(staleness_weight(torch.tensor([-3.0, 2.0]),
                                                   "constant").numpy(), 1.0)


@pytest.mark.parametrize("kind", ["fedavg", "fedavgm", "fedadam",
                                  "fedadagrad"])
def test_server_opt_and_dp_match_reference(kind):
    """Server optimizers over two steps: FedAvg bit-equal at lr 1.0; the
    others to 1e-6 (``pow``/``sqrt``/division rounding).  DP clipping to
    1e-6 (norm summation order)."""
    from repro.core.fl import dp as jdp
    from repro.core.fl.server_opt import build_server_opt as jbuild
    from repro_torch.core.fl import dp
    from repro_torch.core.fl.server_opt import build_server_opt
    params, deltas = _setup(2, seed=5, scale=0.5)
    lr = 1.0 if kind == "fedavg" else 0.3
    fl = dict(server_opt=kind, server_lr=lr)
    jopt, topt = jbuild(JFL(**fl)), build_server_opt(FLConfig(**fl))
    jp, tp = _jx(params), convert.params_from_numpy(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for d in deltas:
        jp, js = jopt.apply(jp, js, _jx(d))
        tp, ts = topt.apply(tp, ts, convert.params_from_numpy(d))
    for a, b in zip(jax.tree.leaves(jp), T.leaves(tp)):
        if kind == "fedavg":
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        else:
            np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-6,
                                       atol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 2
    jc, jn, jw = jdp.clip_update(_jx(deltas[0]), 0.5)
    tc, tn, tw = dp.clip_update(convert.params_from_numpy(deltas[0]), 0.5)
    assert bool(jw) and bool(tw)
    assert float(tn) == pytest.approx(float(jn), rel=1e-6)
    for a, b in zip(jax.tree.leaves(jc), T.leaves(tc)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-6)
    for pl in ("tee", "device"):
        cfg = dict(noise_multiplier=1.3, clip_norm=0.7)
        assert dp.noise_stddev(FLConfig(**cfg), 8, pl) == jdp.noise_stddev(
            JFL(**cfg), 8, pl)


@pytest.mark.parametrize("placement", ["device", "tee"])
def test_dp_noise_draws_are_seeded_and_scaled(placement):
    """DP noise is the reference's draw: a replay is bit-identical, the
    noised update departs from the noiseless one by about the configured
    std, and the engine agrees with the JAX engine on the same deltas and
    keys.  Device noise is checked in the streamed ``tee_stream`` and the
    batched ``tee`` engine (``normal(chunk_noise_key(rng, c), ...)``), TEE
    noise in ``tee_stream``.

    Tolerance: the draws are ``jax.random.normal``'s bit for bit, but the
    jitted reference adds them as one FMA (XLA contracts ``x + noise * s``)
    where the port rounds the product first, so a noised value may differ
    in its last bit: at most an ulp of a 4-sigma draw, 2^-20 * sigma;
    where that moves a stochastic rounding across a level the encode
    flips by one fixed-point level (1/scale ~ 5.6e-9 at bits 32 and a
    buffer of 3), and the mean of B rows by up to B levels."""
    params, deltas = _setup(B, seed=4)
    sigma = 2.0
    modes = ["tee_stream", "tee"] if placement == "device" else ["tee_stream"]

    def run(sigma, mode, server=AsyncServer, conv=convert.params_from_numpy,
            **kw):
        cfg = dict(cohort_size=B, clip_norm=1.0, noise_multiplier=sigma,
                   noise_placement=placement, secure_agg_bits=32)
        fl = (FLConfig if server is AsyncServer else JFL)(**cfg)
        srv = server(conv(params), fl, buffer_size=B, mask_mode=mode,
                     staleness_mode="constant", **kw)
        for d in deltas:
            srv.push(conv(d), 0)
        if server is AsyncServer:
            return torch.cat([x.reshape(-1) for x in T.leaves(srv.params)])
        return np.concatenate([np.asarray(x).reshape(-1)
                               for x in jax.tree.leaves(srv.params)])

    for mode in modes:
        base, noised = run(0.0, mode, device="cpu"), run(sigma, mode,
                                                         device="cpu")
        assert torch.equal(noised, run(sigma, mode, device="cpu"))
        # mean-delta noise std: sigma*clip/B (tee) or sigma*clip/sqrt(B)
        # (device)
        std = sigma / B if placement == "tee" else sigma / B ** 0.5
        got = float((noised - base).std())
        assert 0.5 * std < got < 1.5 * std
        ref = run(sigma, mode, server=JServer, conv=_jx)
        levels = B / agg.fixed_point_scale(FLConfig(secure_agg_bits=32), B)
        np.testing.assert_allclose(noised.numpy(), ref, rtol=0,
                                   atol=2 ** -20 * sigma + levels)


def test_entry_point_needs_a_gpu_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from repro_torch.core.fl.async_fl import (build_async_buffer_step,
                                              build_masked_async_buffer_step)
    from repro_torch.models.model import init_params
    from repro_torch.configs import qwen2_1_5b
    params = convert.params_from_numpy(_setup(0)[0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AsyncServer(params, FLConfig(), buffer_size=B)
    for build in (build_async_buffer_step, build_masked_async_buffer_step):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build(params, FLConfig(), buffer_size=B)
        assert callable(build(params, FLConfig(), buffer_size=B,
                              device="cpu"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(qwen2_1_5b.reduced(), seed=0)
