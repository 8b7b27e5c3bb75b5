"""The port's compressed uploads against the JAX package, on the same inputs.

Bit-equal: the PRF-derived operators (kept coordinates and sign diagonal,
ties included), the Walsh–Hadamard rotations and ``expand`` against the
JITTED reference functions, the folded constants of the sketch encode and of
the decode, and ``AsyncServer`` with the sketch and the subsample in the
streamed engines (``off``, ``client``, ``tee_stream``) at
``secure_agg_bits`` 32 and 16: the ``ClientPush`` words, and the
parameters after a full session and after a flush that recovers a dropped
slot.  Bit-exact runs use ``noise_multiplier=0``, constant staleness and
deltas inside ``clip_norm``, as in ``test_torch_async.py``.

The ``enclave_wire_bits`` lane is bit-equal too: its stochastic quantize
draws the reference's ``jax.random.split`` + ``jax.random.uniform``
(rebuilt in ``kernels.prf``); it also stays within the reference's own
bound of ``0 < err < 0.05`` of the raw f32 uplink.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JFL
from repro.core.fl import aggregation as jagg
from repro.core.fl import compression as jcomp
from repro.core.fl.async_fl import AsyncServer as JServer
from repro.core.telemetry import Telemetry as JTelemetry
from repro.kernels import prf as jprf
from repro_torch import convert
from repro_torch import tree as T
from repro_torch.configs.base import FLConfig
from repro_torch.core import telemetry as tele
from repro_torch.core.fl import aggregation as agg
from repro_torch.core.fl import compression as comp
from repro_torch.core.fl.async_fl import AsyncServer
from repro_torch.kernels import prf
from repro_torch.kernels import secure_agg as ksa
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

# the reference's compression test model: 2245 parameters, three chunks of
# 645 / 700 / 900 at param_chunk_elems 1000 (sorted-key leaf order)
SHAPES = {"emb": (40, 16), "w1": (700,), "w2": (300, 3), "b": (5,)}
D = 2245
CHUNK = 1000
B = 4
RATES = (0.2, 0.25, 0.37, 0.5)
KEY = (0x5A5E, 0xCB01)


def _params(seed=0):
    rs = np.random.RandomState(seed)
    return {k: rs.randn(*s).astype(np.float32) for k, s in SHAPES.items()}


def _deltas(n, seed=1, scale=0.01):
    """Deltas of L2 norm ~0.47, inside clip_norm 1.0."""
    rs = np.random.RandomState(seed)
    return [{k: (rs.randn(*s) * scale).astype(np.float32)
             for k, s in SHAPES.items()} for _ in range(n)]


def _jx(tree):
    return jax.tree.map(jnp.asarray, tree)


def _tt(tree):
    return convert.params_from_numpy(tree)


def _fl(**kw):
    base = dict(cohort_size=B, clip_norm=1.0, noise_multiplier=0.0,
                secure_agg_bits=32, param_chunk_elems=CHUNK)
    base.update(kw)
    return base


def _servers(mode, fl_kw, **kw):
    params = _params()
    kw.setdefault("staleness_mode", "constant")
    js = JServer(_jx(params), JFL(**fl_kw), buffer_size=B, mask_mode=mode,
                 telemetry=JTelemetry(), **kw)
    ts = AsyncServer(_tt(params), FLConfig(**fl_kw), buffer_size=B,
                     mask_mode=mode, device="cpu",
                     telemetry=tele.Telemetry(), **kw)
    return js, ts


def _assert_trees_equal(jtree, ttree):
    for a, b in zip(jax.tree.leaves(jtree), T.leaves(ttree)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _rows(cp):
    return cp.row if isinstance(cp.row, tuple) else (cp.row,)


def _lane_bytes(tel, lane):
    return sum(v for (n, lk), v in tel.counters().items()
               if n == "upload_bytes" and ("lane", lane) in lk)


# --- operators ---------------------------------------------------------------
@pytest.mark.parametrize("mode", ["subsample", "sketch"])
@pytest.mark.parametrize("rate", RATES)
def test_chunk_operators_equal_reference(mode, rate):
    jops = jcomp.chunk_operators(jnp.asarray(KEY, jnp.uint32), mode, D, rate)
    ops = comp.chunk_operators(KEY, mode, D, rate)
    assert (ops.full, ops.m) == (jops.full, jops.m)
    np.testing.assert_array_equal(np.asarray(jops.idx), ops.idx.numpy())
    if mode == "sketch":
        np.testing.assert_array_equal(np.asarray(jops.signs),
                                      ops.signs.numpy())
        assert ops.key_words == KEY
    else:
        assert ops.signs is None


def test_selection_ties_break_by_position(monkeypatch):
    """Only 16 distinct rank words over 2245 positions: almost every kept
    coordinate wins on a tie, and both sides keep the lower positions."""
    jstream, tstream = jprf.stream_block, prf.stream_block
    monkeypatch.setattr(jprf, "stream_block",
                        lambda *a, **k: jstream(*a, **k) >> 28)
    monkeypatch.setattr(prf, "stream_block",
                        lambda *a, **k: tstream(*a, **k) >> 28)
    for mode in ("subsample", "sketch"):
        jops = jcomp.chunk_operators(jnp.asarray(KEY, jnp.uint32), mode, D,
                                     0.37)
        ops = comp.chunk_operators(KEY, mode, D, 0.37)
        np.testing.assert_array_equal(np.asarray(jops.idx), ops.idx.numpy())


def test_rotations_equal_the_jitted_reference():
    rs = np.random.RandomState(3)
    x = rs.randn(4 * 512).astype(np.float32)
    s = np.where(rs.rand(4 * 512) < 0.5, -1.0, 1.0).astype(np.float32)
    tx, ts_ = torch.from_numpy(x), torch.from_numpy(s)
    for h in (2, 64, 512):
        np.testing.assert_array_equal(
            np.asarray(jax.jit(jcomp.fwht)(x.reshape(-1, h))),
            comp.fwht(tx.reshape(-1, h)).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.jit(jcomp.block_rotate)(x, s)),
        comp.block_rotate(tx, ts_).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.jit(jcomp.block_rotate_t)(x, s)),
        comp.block_rotate_t(tx, ts_).numpy())
    with pytest.raises(ValueError, match="power of two"):
        comp.fwht(tx[:24])


@pytest.mark.parametrize("scale", [3333.25, 131067.5, 16777215.6875,
                                   536870910.75 / 4.0, 0.37])
def test_sketch_encode_uses_the_folded_constant(scale):
    """Inside ``jit`` the reference's ``block_rotate(x, s) * scale`` is the
    raw butterflies times ONE f32 constant, f32(f32(1/sqrt(512)) * scale);
    the port's sketch encode multiplies by exactly that constant."""
    rs = np.random.RandomState(int(scale) % 1000)
    x = rs.randn(3 * 512).astype(np.float32) * 0.01
    s = np.where(rs.rand(3 * 512) < 0.5, -1.0, 1.0).astype(np.float32)
    want = jax.jit(lambda x, s: jcomp.block_rotate(x, s) * scale)(x, s)
    raw = comp.butterflies(torch.from_numpy(x * s).reshape(-1, 512))
    got = raw.reshape(-1) * torch.tensor(comp.sketch_multiplier(scale))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("mode", ["subsample", "sketch"])
@pytest.mark.parametrize("rate", RATES)
def test_expand_and_decode_equal_the_jitted_reference(mode, rate):
    """Standalone ``expand``, and the decode of an operator-domain
    accumulator (where XLA folds the fixed-point reciprocal and ``full/m``
    into one constant), bit-equal at rates where an unfolded decode is
    not."""
    jops = jcomp.chunk_operators(jnp.asarray(KEY, jnp.uint32), mode, D, rate)
    ops = comp.chunk_operators(KEY, mode, D, rate)
    rs = np.random.RandomState(int(rate * 100))
    z = rs.randn(ops.m).astype(np.float32)
    want = jax.jit(lambda z, idx, s: jcomp.expand(
        z, jops._replace(idx=idx, signs=s), D))(z, jops.idx, jops.signs)
    np.testing.assert_array_equal(
        np.asarray(want), comp.expand(torch.from_numpy(z), ops, D).numpy())
    # the flush decode: recenter, descale, expand, divide by the weight
    for bits, n in ((16, 8), (32, 3), (16, 5)):
        fl = dict(secure_agg_bits=bits, compress_mode=mode,
                  compress_rate=rate)
        jspec, spec = jagg.make_spec(JFL(**fl), n), agg.make_spec(
            FLConfig(**fl), n)
        params = {"w": np.zeros(D, np.float32)}
        jplan = jagg.make_param_plan(_jx(params))
        plan = agg.make_param_plan(_tt(params))
        acc = rs.randint(-2 ** 31, 2 ** 31, size=ops.m,
                         dtype=np.int64).astype(np.int32)
        want = jax.jit(lambda a, w, idx, s: jagg.finalize_plan_aggregate(
            (a,), w, jspec, jplan, None,
            ops=(jops._replace(idx=idx, signs=s),)))(
                acc, np.float32(3.0), jops.idx, jops.signs)
        got = agg.finalize_plan_aggregate(
            (torch.from_numpy(acc),), torch.tensor(3.0), spec, plan, None,
            ops=(ops,))
        np.testing.assert_array_equal(np.asarray(want["w"]), got["w"].numpy())


def test_compress_expand_round_trip_is_unbiased_in_the_mean():
    """The port's own operators: expand(compress(x)) over 200 operator
    seeds averages to x (the reference's unbiasedness property)."""
    x = torch.from_numpy(np.random.RandomState(5).randn(700).astype(
        np.float32))
    for mode in ("subsample", "sketch"):
        acc = torch.zeros(700, dtype=torch.float64)
        for seed in range(200):
            ops = comp.chunk_operators((seed, 9), mode, 700, 0.5)
            acc += comp.expand(comp.compress(x, ops), ops, 700).double()
        err = float((acc / 200 - x.double()).abs().mean())
        assert err < 0.2 * float(x.abs().mean()), (mode, err)


# --- the engine --------------------------------------------------------------
# sketch and subsample x the three streamed engines x the 32-bit and the
# packed 20-bit wire (bits 16, buffer 4); rates 0.2 and 0.5 alternate
ENGINE_CASES = [(mode, cmode, bits, 0.2 if (bits == 32) == (cmode == "sketch")
                 else 0.5)
                for mode in ("off", "client", "tee_stream")
                for cmode in ("sketch", "subsample") for bits in (32, 16)]


@pytest.mark.parametrize("mode,cmode,bits,rate", ENGINE_CASES)
def test_compressed_async_server_bit_equal_to_reference(mode, cmode, bits,
                                                        rate):
    js, ts = _servers(mode, _fl(secure_agg_bits=bits, compress_mode=cmode,
                                compress_rate=rate))
    assert ts.plan.num_chunks == 3
    wire = agg.plan_wire_chunks(ts._spec, ts.plan)
    assert wire == jagg.plan_wire_chunks(js._spec, js.plan)
    assert all(b.shape[1] == wc.padded for b, wc in zip(ts._bufs, wire))
    deltas = _deltas(B + 3)
    # session 0: a full buffer (client mode through encode_push/push_encoded
    # with the ClientPush words compared)
    for i in range(B):
        if mode == "client":
            jcp = js.encode_push(_jx(deltas[i]), 0)
            tcp = ts.encode_push(_tt(deltas[i]), 0)
            assert tcp.compression == ts._spec.compression
            assert tcp.compression.describe() == jcp.compression.describe()
            for a, b in zip(_rows(jcp), _rows(tcp)):
                np.testing.assert_array_equal(np.asarray(a),
                                              convert.words_to_numpy(b))
            assert js.push_encoded(jcp) and ts.push_encoded(tcp)
        else:
            js.push(_jx(deltas[i]), 0)
            ts.push(_tt(deltas[i]), 0)
        if i == B - 2:
            for a, b in zip(js._bufs, ts._bufs):
                np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert js.version == ts.version == 1
    _assert_trees_equal(js.params, ts.params)
    # session 1: slot 1 drops out, the flush recovers its mask shares
    for slot, d in zip((0, 2, 3), deltas[B:]):
        js.push(_jx(d), 1, slot=slot)
        ts.push(_tt(d), 1, slot=slot)
    assert js.flush() and ts.flush()
    assert js.version == ts.version == 2
    _assert_trees_equal(js.params, ts.params)


def test_compressed_client_push_converts_and_decodes_identically():
    """A reference ClientPush on the compressed wire, converted, is ingested
    by the port and decodes bit-equal to the reference."""
    fl = _fl(secure_agg_bits=16, compress_mode="sketch", compress_rate=0.25)
    js, ts = _servers("client", fl)
    for slot, d in zip((2, 0, 3), _deltas(3, seed=7)):
        jcp = js.encode_push(_jx(d), 0, slot=slot)
        assert js.push_encoded(jcp)
        tcp = convert.client_push_from_numpy(jcp)
        assert tcp.compression == comp.CompressionSpec("sketch", 0.25)
        assert ts.push_encoded(tcp)
    assert js.flush() and ts.flush()
    _assert_trees_equal(js.params, ts.params)


@pytest.mark.parametrize("mode", ["off", "client", "tee_stream"])
def test_rate_one_is_the_identity_path(mode):
    """compress_rate 1.0 canonicalizes to the identity spec: no operators,
    the plan's own widths, and parameters bit-equal to the uncompressed
    engine (no compressed-lane bytes)."""
    deltas = _deltas(B, seed=4)
    out = []
    for fl in (_fl(secure_agg_bits=16),
               _fl(secure_agg_bits=16, compress_mode="sketch",
                   compress_rate=1.0)):
        srv = AsyncServer(_tt(_params()), FLConfig(**fl), buffer_size=B,
                          mask_mode=mode, staleness_mode="constant",
                          device="cpu", telemetry=tele.Telemetry())
        assert srv._spec.compression.identity and srv._operators() is None
        assert tuple(b.shape[1] for b in srv._bufs) == tuple(
            ck.padded for ck in srv.plan.chunks)
        for d in deltas:
            srv.push(_tt(d), 0)
        assert _lane_bytes(srv.telemetry, "compressed") == 0
        out.append(torch.cat([x.reshape(-1) for x in T.leaves(srv.params)]))
    assert torch.equal(out[0], out[1])


@pytest.mark.parametrize("engine", ["async", "tier-flat", "tier-tree"])
def test_compression_mismatch_names_both_specs(engine):
    fl = _fl(secure_agg_bits=16, compress_mode="sketch", compress_rate=0.25)
    if engine == "async":
        _, ts = _servers("client", fl)
    else:
        ts, _ = _tiers("client", fl, engine == "tier-tree")
    peer = "server" if engine == "async" else "tier"
    cp = ts.encode_push(_tt(_deltas(1)[0]), 0)
    bad = cp._replace(compression=comp.CompressionSpec("subsample", 0.5),
                      token=0)
    with pytest.raises(ValueError, match=rf"subsample@rate=0\.5 but the "
                       rf"{peer}'s session expects sketch@rate=0\.25: .* "
                       rf"client and {peer} must agree"):
        ts.push_encoded(bad)
    with pytest.raises(ValueError, match=r"identity.*sketch@rate=0\.25"):
        ts.push_encoded(cp._replace(compression=comp.CompressionSpec(),
                                    token=0))
    assert ts.push_encoded(cp)


@pytest.mark.parametrize("mode,kw", [("tee", {}),
                                     ("off", {"stream_encode": False})])
def test_batched_engine_refuses_an_active_spec(mode, kw):
    fl = FLConfig(**_fl(compress_mode="subsample", compress_rate=0.5))
    with pytest.raises(ValueError, match="STREAMING engines only"):
        AsyncServer(_tt(_params()), fl, buffer_size=B, mask_mode=mode,
                    device="cpu", **kw)
    with pytest.raises(ValueError, match="subsample@rate=0.5"):
        JServer(_jx(_params()), JFL(**_fl(compress_mode="subsample",
                                          compress_rate=0.5)),
                buffer_size=B, mask_mode=mode, **kw)


def test_upload_bytes_lanes_metered_at_both_seams():
    """encode_push and push_encoded each meter the wire under the lane the
    session's spec names, and the counts equal the reference's."""
    d = _deltas(1)[0]
    for fl_kw, lane, other in (
            (_fl(compress_mode="sketch", compress_rate=0.25), "compressed",
             "packed"),
            (_fl(), "packed", "compressed")):
        js, ts = _servers("client", fl_kw)
        js.push_encoded(js.encode_push(_jx(d), 0, slot=0))
        ts.push_encoded(ts.encode_push(_tt(d), 0, slot=0))
        wire = agg.plan_wire_chunks(ts._spec, ts.plan)
        assert _lane_bytes(ts.telemetry, lane) == 2 * 4 * sum(
            wc.padded for wc in wire)
        assert _lane_bytes(ts.telemetry, lane) == _lane_bytes(js.telemetry,
                                                              lane)
        assert _lane_bytes(ts.telemetry, other) == 0
    # the compressed wire really is ~rate of the packed wire (single-chunk
    # plan: no 512-block padding at these toy widths)
    cspec = agg.make_spec(FLConfig(**_fl(compress_mode="sketch",
                                         compress_rate=0.25)), B)
    plan = agg.make_param_plan(_tt(_params()))
    cw = agg.plan_wire_chunks(cspec, plan)
    assert sum(wc.padded for wc in cw) <= 0.3 * plan.total


@pytest.mark.parametrize("mode", ["tee_stream", "tee"])
def test_enclave_wire_quantizes_the_tee_uplink(mode):
    """enclave_wire_bits=8 rides a packed 8-bit field: the decode moves but
    stays within the reference's bound (0 < err < 0.05) of the raw f32
    uplink, and the port's params are bit-equal to the reference's (the
    same split keys and uniforms); the metered enclave bytes are below 0.3
    of the raw wire and equal the reference's."""
    params, deltas = _params(), _deltas(B, seed=9, scale=0.1)
    fl = _fl(secure_agg_bits=32, param_chunk_elems=0)
    fle = dict(fl, enclave_wire_bits=8)
    kw = dict(buffer_size=B, mask_mode=mode, staleness_mode="constant")
    raw = AsyncServer(_tt(params), FLConfig(**fl), device="cpu",
                      telemetry=tele.Telemetry(), **kw)
    srv8 = AsyncServer(_tt(params), FLConfig(**fle), device="cpu",
                       telemetry=tele.Telemetry(), **kw)
    jraw = JServer(_jx(params), JFL(**fl), telemetry=JTelemetry(), **kw)
    j8 = JServer(_jx(params), JFL(**fle), telemetry=JTelemetry(), **kw)
    for d in deltas:
        for s in (raw, srv8):
            s.push(_tt(d), s.version)
        for s in (jraw, j8):
            s.push(_jx(d), s.version)
    assert raw.version == srv8.version == j8.version == 1

    def diff(a, b):
        return max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
                   for x, y in zip(a, b))

    tl8, tlraw = [x.numpy() for x in T.leaves(srv8.params)], [
        x.numpy() for x in T.leaves(raw.params)]
    jl8, jlraw = jax.tree.leaves(j8.params), jax.tree.leaves(jraw.params)
    assert diff(tlraw, jlraw) == 0.0
    assert diff(tl8, jl8) == 0.0
    for err in (diff(tl8, tlraw), diff(tl8, jlraw), diff(jl8, jlraw)):
        assert 0.0 < err < 0.05
    ebytes = _lane_bytes(srv8.telemetry, "enclave")
    assert 0 < ebytes < 0.3 * (B * 4 * D)
    assert ebytes == _lane_bytes(j8.telemetry, "enclave")
    assert _lane_bytes(raw.telemetry, "enclave") == 0


def test_enclave_quantize_dequantize_law():
    """The stochastic quantize is unbiased and seeded: a replay is
    bit-identical, each level is floor or ceil of x*scale, the mean
    over draws converges to x, and the draw is the reference's."""
    from repro_torch.core.fl import secure_agg as sa
    x = torch.linspace(-5.0, 5.0, 1001)
    q = sa.quantize(x, 8, 4.0, (1, 2))
    assert torch.equal(q, sa.quantize(x, 8, 4.0, (1, 2)))
    xf = torch.clamp(x, -4.0, 4.0) * (127.0 / 4.0)
    assert bool(((q == torch.floor(xf)) | (q == torch.ceil(xf))).all())
    mean = torch.stack([sa.dequantize(sa.quantize(x, 8, 4.0, (s, 3)), 8,
                                      4.0) for s in range(400)]).mean(0)
    assert float((mean - torch.clamp(x, -4.0, 4.0)).abs().max()) < 0.01
    from repro.core.fl import secure_agg as jsa
    qi = np.arange(-127, 128, dtype=np.int32)
    np.testing.assert_array_equal(
        np.asarray(jsa.dequantize(jnp.asarray(qi), 8, 4.0)),
        sa.dequantize(torch.from_numpy(qi), 8, 4.0).numpy())
    np.testing.assert_array_equal(
        np.asarray(jsa.quantize(jnp.asarray(x.numpy()), 8, 4.0)),
        sa.quantize(x, 8, 4.0).numpy())
    jkey = jax.random.PRNGKey(11)
    np.testing.assert_array_equal(
        np.asarray(jax.jit(lambda a, k: jsa.quantize(a, 8, 4.0, k))(
            jnp.asarray(x.numpy()), jkey)),
        sa.quantize(x, 8, 4.0, convert.key_from_numpy(jkey)).numpy())


def test_operators_are_derived_once_per_session(monkeypatch):
    """Push and flush share one derivation per session; the sketch pushes
    go through the rotate_quantize_prf wrapper (its plain version here)."""
    fl = _fl(secure_agg_bits=16, compress_mode="sketch", compress_rate=0.2)
    ts = AsyncServer(_tt(_params()), FLConfig(**fl), buffer_size=B,
                     mask_mode="tee_stream", staleness_mode="constant",
                     device="cpu")
    calls = []
    orig = agg.plan_operators
    monkeypatch.setattr(agg, "plan_operators",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    ksa.reset_counts()
    deltas = _deltas(B + 2)
    for d in deltas[:B]:
        ts.push(_tt(d), ts.version)
    assert len(calls) == 1 and ts.version == 1
    for d in deltas[B:]:
        ts.push(_tt(d), ts.version)
    assert ts.flush() and len(calls) == 2
    # one launch per chunk per push; the 20-bit wire is never packed here
    assert ksa.rotate_quantize_prf.plain_calls == 3 * (B + 2)
    assert ksa.quantize_mask_prf.plain_calls == 0
    assert math.isfinite(float(ts.last_metrics["update_norm"]))


def test_compressed_config_requires_the_field():
    with pytest.raises(ValueError, match="secure_agg_bits"):
        FLConfig(compress_mode="sketch", compress_rate=0.5,
                 secure_agg_bits=0)


# --- the compressed tier (ShardedAsyncServer) --------------------------------
def _tiers(mode, fl_kw, two_level, ref=False):
    """The port's 2-leaf x 2-slot tier (and with ``ref`` the reference's
    session tree of that shape, which one JAX device runs)."""
    from repro.core.fl.hierarchy import ShardedAsyncServer as JTier
    from repro_torch.core.fl.hierarchy import ShardedAsyncServer
    params = _params()
    ts = ShardedAsyncServer(_tt(params), FLConfig(**fl_kw), num_leaves=2,
                            leaf_buffer=2, mask_mode=mode,
                            two_level=two_level, staleness_mode="constant",
                            device="cpu")
    js = (JTier(_jx(params), JFL(**fl_kw), num_leaves=2, leaf_buffer=2,
                mask_mode=mode, two_level=True, staleness_mode="constant")
          if ref else None)
    return ts, js


def _land(srv, d, slot, j=False):
    d = _jx(d) if j else _tt(d)
    if srv.mask_mode == "client":
        srv.push_encoded(srv.encode_push(d, srv.version, slot=slot))
    else:
        srv.push(d, srv.version, slots=[slot])


@pytest.mark.parametrize("mode", ["off", "tee", "tee_stream", "client"])
@pytest.mark.parametrize("two_level", [False, True],
                         ids=["flat-session", "session-tree"])
def test_rate_one_bit_identical_tier(mode, two_level):
    """Rate 1.0 is the identity on the tier too, through nested client +
    whole-leaf dropout (only slot 0 lands: leaf 1 dies entirely); the
    session tree equals the reference's."""
    ds = _deltas(1)
    outs = []
    for rate_kw in ({}, {"compress_mode": "sketch", "compress_rate": 1.0}):
        ts, js = _tiers(mode, _fl(**rate_kw), two_level, ref=two_level)
        _land(ts, ds[0], 0)
        ts.flush(rng=convert.key_from_numpy(jax.random.PRNGKey(11)))
        assert ts.version == 1
        outs.append(ts.params)
        if js is not None:
            _land(js, ds[0], 0, j=True)
            js.flush(rng=jax.random.PRNGKey(11))
            _assert_trees_equal(js.params, ts.params)
    for a, b in zip(T.leaves(outs[0]), T.leaves(outs[1])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ("client", "tee_stream"))
@pytest.mark.parametrize("two_level", [False, True],
                         ids=["flat-session", "session-tree"])
def test_compressed_tier_matches_flat(mode, two_level):
    """Sketch-domain sums commute with the leaves: the compressed tier
    decodes bit-equal to the port's compressed flat server and to the
    reference's (operators keyed by the ENGINE session key), through a
    recovering flush."""
    fl_kw = _fl(compress_mode="sketch", compress_rate=0.25)
    ts, _ = _tiers(mode, fl_kw, two_level)
    js, flat = _servers(mode, fl_kw)
    ds = _deltas(4)
    frng = jax.random.PRNGKey(11)
    for s in (0, 2, 3):
        _land(ts, ds[s], s)
        if mode == "client":
            flat.push_encoded(flat.encode_push(_tt(ds[s]), 0, slot=s))
            js.push_encoded(js.encode_push(_jx(ds[s]), 0, slot=s))
        else:
            flat.push(_tt(ds[s]), 0, slot=s)
            js.push(_jx(ds[s]), 0, slot=s)
    for srv, k in ((ts, convert.key_from_numpy(frng)),
                   (flat, convert.key_from_numpy(frng)), (js, frng)):
        srv.flush(rng=k)
    assert ts.version == flat.version == js.version == 1
    for a, b in zip(T.leaves(ts.params), T.leaves(flat.params)):
        assert torch.equal(a, b)
    _assert_trees_equal(js.params, ts.params)
    assert tuple(b.shape[-1] for b in ts._bufs) == tuple(
        wc.padded for wc in agg.plan_wire_chunks(ts._spec, ts.plan))


def test_retry_after_session_roll_rederives_operators():
    """A delayed compressed push landing after its session rolled is
    re-encoded under the NEW session (new masks and new sketch operators);
    the run replays bit for bit from the survivor record, and its fault
    trace is the reference's."""
    from repro.core.fl import faults as jfaults
    from repro_torch.core.fl.faults import FaultInjector, FaultPlan, FaultSpec
    fl_kw = _fl(compress_mode="sketch", compress_rate=0.25)
    params = _params()

    def mk(ref=False):
        if ref:
            return JServer(_jx(params), JFL(**fl_kw), buffer_size=2,
                           mask_mode="client", strict=False,
                           staleness_mode="constant")
        return AsyncServer(_tt(params), FLConfig(**fl_kw), buffer_size=2,
                           mask_mode="client", strict=False,
                           staleness_mode="constant", device="cpu")

    ds = _deltas(4)
    runs = []
    for ref in (False, True):
        cv = _jx if ref else _tt
        srv = mk(ref)
        plan = (jfaults.FaultPlan(jfaults.FaultSpec(
            p_delay=1.0, delay_pushes=1, seed=0)) if ref
            else FaultPlan(FaultSpec(p_delay=1.0, delay_pushes=1, seed=0)))
        inj = (jfaults.FaultInjector if ref else FaultInjector)(srv, plan)
        inj.push(cv(ds[0]), srv.version)  # held, encoded under session 0
        srv.push_encoded(srv.encode_push(cv(ds[2]), srv.version, slot=0))
        srv.push_encoded(srv.encode_push(cv(ds[3]), srv.version, slot=1))
        assert srv.version == 1  # the session rolled
        inj.push(cv(ds[1]), srv.version)  # the held push lands stale
        inj.flush(force=True)
        assert any(site == "retry" for site, _ in inj.plan.trace)
        assert len(inj.delivered) == 2 and srv.version == 2
        runs.append((srv, inj))
    (ts, tinj), (js, jinj) = runs
    assert tinj.plan.trace == jinj.plan.trace
    assert tinj.survivors == jinj.survivors
    _assert_trees_equal(js.params, ts.params)
    ref = mk()
    ref.push_encoded(ref.encode_push(_tt(ds[2]), 0, slot=0))
    ref.push_encoded(ref.encode_push(_tt(ds[3]), 0, slot=1))
    for ver in sorted(tinj.survivors):
        assert ref.version == ver
        for slot, (seq, cv) in sorted(tinj.survivors[ver].items()):
            ref.push_encoded(ref.encode_push(_tt(ds[seq]), cv, slot=slot))
        if ref.version == ver:
            ref.flush(force=True)
    for a, b in zip(T.leaves(ts.params), T.leaves(ref.params)):
        assert torch.equal(a, b)
