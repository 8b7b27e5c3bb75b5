"""The port's aggregation tier against the JAX package (twin of
``tests/test_hierarchy.py``).

The tier's contract: leaf partial modular sums + the root's wraparound
combine + the root decode are BIT-identical to the single-host engine at
``buffer_size = num_leaves * leaf_buffer``, in every mask mode, with and
without client and whole-leaf dropout, for batched and sequential ingest,
in both topologies.  Held here:

- against the reference ``ShardedAsyncServer`` at 1 leaf (both
  topologies) and 2 leaves (the tree), which is what one JAX device runs;
- at 4, 8 and 16 leaves against the reference single-host
  ``AsyncServer`` and the port's own ``AsyncServer`` (params bit-equal;
  ``update_norm`` within 2 f32 ulp: the reference's own 4-leaf tree is one
  ulp off its single host there, from the order of that sum), never
  against the reference's two-level tier;
- the JAX file's ``multidev`` cases as leaves multiplexed onto the one
  device (the port's leaf mesh maps every logical leaf to it);
- ``build_sharded_round_step``: masked == unmasked bit for bit, and equal
  to the port's single-host round given the same deltas.

Deltas are the reference file's ``jax.random.normal`` draws (by the port's
bit-equal ``prf.normal``) scaled by 0.02 instead of 0.1, so that no row is
clipped (norm ~0.53 < clip 1.0): under an active clip the whole-model norm
is summed in another order and the clip scale may differ from the
reference's in its last bit (the port-wide tolerance; the clipped case is
held apart below).  Staleness is constant, the noise is off and
``server_lr`` is 1, so every compared quantity is exact unless stated.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JFL
from repro.core.fl.async_fl import AsyncServer as JServer
from repro.core.fl.hierarchy import ShardedAsyncServer as JTier
from repro.launch.mesh import make_leaf_mesh as jmake_leaf_mesh
from repro.launch.sharding import leaf_device_map as jleaf_device_map
from repro_torch.configs.base import FLConfig
from repro_torch.core.fl import hierarchy as hier
from repro_torch.core.fl.async_fl import AsyncServer
from repro_torch.core.fl.hierarchy import ShardedAsyncServer
from repro_torch.kernels import prf
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsharding
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

D = 700
FL_KW = dict(clip_norm=1.0, server_lr=1.0, secure_agg_bits=32)
FL = FLConfig(**FL_KW)
JFL_ = JFL(**FL_KW)
MODES = ("off", "tee", "tee_stream", "client")


def _params():
    return {"w": torch.zeros(D)}


def _jparams():
    return {"w": jnp.zeros((D,), jnp.float32)}


def _deltas(n, seed=0, scale=0.02):
    key = prf.PRNGKey(seed)
    return [scale * prf.normal(prf.fold_in(key, i), (D,)) for i in range(n)]


def _stack(ds):
    return {"w": torch.stack(ds)}


def _diff(a, b):
    return float(np.abs(np.asarray(a["w"]) - np.asarray(b["w"])).max())


def _tier(mode, L, Bl, fl=FL, **kw):
    kw.setdefault("staleness_mode", "constant")
    return ShardedAsyncServer(_params(), fl, num_leaves=L, leaf_buffer=Bl,
                              mask_mode=mode, device="cpu", **kw)


def _flat_server(mode, B, fl=FL):
    return AsyncServer(_params(), fl, buffer_size=B, mask_mode=mode,
                       staleness_mode="constant", device="cpu")


def _jserver(mode, B, **fl_kw):
    return JServer(_jparams(), dataclasses.replace(JFL_, **fl_kw),
                   buffer_size=B, mask_mode=mode, staleness_mode="constant")


def _ulps(a: float, b: float) -> int:
    ia, ib = (np.asarray([a, b], np.float32).view(np.int32))
    return abs(int(ia) - int(ib))


def _metrics_match(ref, got, *, ulps=0):
    for k in ("update_norm", "clip_fraction", "weight_total"):
        a, b = float(ref.last_metrics[k]), float(got.last_metrics[k])
        if k == "update_norm":
            assert _ulps(a, b) <= ulps, (k, a, b)
        else:
            assert a == b, (k, a, b)


# --- single-leaf tier: against the reference tier ---------------------------
@pytest.mark.parametrize("mode", MODES)
def test_single_leaf_tier_bit_identical(mode):
    """num_leaves=1: the port's tier == the reference's tier == the port's
    single host, to the bit."""
    srv1 = _flat_server(mode, 4)
    srv2 = _tier(mode, 1, 4)
    jsrv = JTier(_jparams(), JFL_, num_leaves=1, leaf_buffer=4,
                 mask_mode=mode, staleness_mode="constant")
    for d in _deltas(4):
        srv1.push({"w": d}, srv1.version)
        srv2.push({"w": d}, srv2.version)
        jsrv.push({"w": jnp.asarray(d.numpy())}, jsrv.version)
    assert srv1.version == srv2.version == jsrv.version == 1
    assert _diff(srv1.params, srv2.params) == 0.0
    assert _diff(jsrv.params, srv2.params) == 0.0
    _metrics_match(srv1, srv2)
    _metrics_match(jsrv, srv2)


@pytest.mark.parametrize("mode,degree", [("client", 0), ("client", 4),
                                         ("tee_stream", 0), ("off", 0)])
def test_single_leaf_partial_flush_recovery(mode, degree):
    """Dropout recovery through the tier's flush == the reference tier's
    (incl. the random k-regular graph at degree 4)."""
    fl = dataclasses.replace(FL, secure_agg_degree=degree)
    srv = _tier(mode, 1, 4, fl)
    jsrv = JTier(_jparams(), dataclasses.replace(JFL_,
                                                 secure_agg_degree=degree),
                 num_leaves=1, leaf_buffer=4, mask_mode=mode,
                 staleness_mode="constant")
    for d in _deltas(2):
        srv.push({"w": d}, srv.version)
        jsrv.push({"w": jnp.asarray(d.numpy())}, jsrv.version)
    srv.flush(rng=prf.PRNGKey(9))
    jsrv.flush(rng=jax.random.PRNGKey(9))
    assert _diff(jsrv.params, srv.params) == 0.0
    assert float(srv.last_metrics["weight_total"]) == pytest.approx(2.0)


@pytest.mark.parametrize("mode", ["tee_stream", "off", "tee"])
def test_batched_ingestion_matches_sequential_push(mode):
    """A stacked push lands the buffer state of sequential pushes, which
    is the reference tier's buffer."""
    ds = _deltas(3)
    srv_a, srv_b = _tier(mode, 1, 4), _tier(mode, 1, 4)
    jsrv = JTier(_jparams(), JFL_, num_leaves=1, leaf_buffer=4,
                 mask_mode=mode, staleness_mode="constant")
    for d in ds:
        srv_a.push({"w": d}, 0)
    srv_b.push(_stack(ds), 0)
    jsrv.push({"w": jnp.asarray(_stack(ds)["w"].numpy())}, 0)
    assert torch.equal(srv_a._buf, srv_b._buf)
    np.testing.assert_array_equal(srv_a._buf.numpy(), np.asarray(jsrv._buf))
    assert srv_a._fill == srv_b._fill == 3
    srv_a.push({"w": ds[0]}, 0)
    srv_b.push(_stack(ds[:1]), 0)
    assert srv_a.version == srv_b.version == 1
    assert _diff(srv_a.params, srv_b.params) == 0.0


def test_client_mode_batched_encode_and_routing():
    """A batched encode == AsyncServer's per-push encode (bit-exact wire
    words); landing validates sessions and slots before the scatter."""
    srv1, srv2 = _flat_server("client", 4), _tier("client", 1, 4)
    ds = _deltas(4)
    cps1 = [srv1.encode_push({"w": d}, 0, slot=i) for i, d in enumerate(ds)]
    cps2 = srv2.encode_push(_stack(ds), 0)
    for a, b in zip(cps1, cps2):
        assert a.slot == b.slot
        assert torch.equal(a.row, b.row)
    stale = srv2.encode_push({"w": ds[0]}, 0, slot=0)
    dup = cps2[0]
    assert srv2.push_encoded(cps2) == 4
    assert srv2.version == 1
    assert not srv2.push_encoded(dup)  # idempotent: token delivered
    assert srv2.fault_metrics["duplicate_pushes"] == 1
    with pytest.raises(ValueError):  # session moved on
        srv2.push_encoded(stale)
    with pytest.raises(ValueError):  # duplicate slots within one batch
        srv2.push_encoded([srv2.encode_push({"w": ds[0]}, 1, slot=0),
                           srv2.encode_push({"w": ds[1]}, 1, slot=0)])


def test_single_leaf_tee_with_device_noise_bit_identical():
    """'device' noise rides the batched tier step: the global (B, D) draw
    taken per leaf, so the tier equals the port's single host bit for bit;
    against the reference within one f32 rounding of each noised element
    (XLA adds the noise as one FMA, the port rounds the product first)."""
    kw = dict(noise_placement="device", noise_multiplier=0.05)
    fl = dataclasses.replace(FL, **kw)
    srv1, srv2 = _flat_server("tee", 4, fl), _tier("tee", 2, 2, fl)
    jsrv = _jserver("tee", 4, **kw)
    for d in _deltas(4):
        srv1.push({"w": d}, srv1.version)
        srv2.push({"w": d}, srv2.version)
        jsrv.push({"w": jnp.asarray(d.numpy())}, jsrv.version)
    assert srv1.version == srv2.version == 1
    assert _diff(srv1.params, srv2.params) == 0.0
    assert _diff(jsrv.params, srv2.params) <= 1e-6


def test_tier_requires_field_and_bounds_batches():
    with pytest.raises(ValueError):
        _tier("off", 1, 4, dataclasses.replace(FL, secure_agg_bits=0))
    srv = _tier("off", 1, 2)
    with pytest.raises(ValueError):  # batch larger than the open session
        srv.push(_stack(_deltas(3)), 0)
    with pytest.raises(ValueError):  # explicit duplicate slots
        srv.push(_stack(_deltas(2)), 0, slots=[0, 0])
    srv.push(_stack(_deltas(1)), 0, slots=[1])
    with pytest.raises(ValueError):  # explicit slot already delivered
        srv.push(_stack(_deltas(1)), 0, slots=[1])
    assert srv._fill == 1  # rejected batches mutated nothing
    with pytest.raises(ValueError):
        _tier("tee", 1, 2, dataclasses.replace(FL, compress_mode="sketch",
                                               compress_rate=0.5))


# --- the session tree (two_level=True) --------------------------------------
@pytest.mark.parametrize("num_leaves", [2, 4, 8, 16])
@pytest.mark.parametrize("mode", MODES)
def test_two_level_bit_identical_no_dropout(mode, num_leaves):
    """The session tree == the single host, bit for bit: against the port's
    ``AsyncServer`` and the reference's at every leaf count (update_norm
    within 2 ulp of the reference's, the gap its own 4-leaf tree shows),
    and against the reference's tree at 2 leaves."""
    srv1 = _flat_server(mode, num_leaves * 2)
    srv2 = _tier(mode, num_leaves, 2, two_level=True)
    jsrv = _jserver(mode, num_leaves * 2)
    assert srv2.two_level
    ds = _deltas(num_leaves * 2)
    for d in ds:
        srv1.push({"w": d}, srv1.version)
        jsrv.push({"w": jnp.asarray(d.numpy())}, jsrv.version)
    srv2.push(_stack(ds), srv2.version)
    assert srv1.version == srv2.version == jsrv.version == 1
    assert _diff(srv1.params, srv2.params) == 0.0
    assert _diff(jsrv.params, srv2.params) == 0.0
    _metrics_match(srv1, srv2, ulps=2)
    _metrics_match(jsrv, srv2, ulps=2)
    if num_leaves == 2:
        jt = JTier(_jparams(), JFL_, num_leaves=2, leaf_buffer=2,
                   mask_mode=mode, staleness_mode="constant", two_level=True)
        jt.push({"w": jnp.asarray(_stack(ds)["w"].numpy())}, 0)
        assert _diff(jt.params, srv2.params) == 0.0


@pytest.mark.parametrize("degree", [0, 4])
@pytest.mark.parametrize("mode", ["client", "tee_stream", "off"])
def test_two_level_nested_dropout_equals_flat_survivors(mode, degree):
    """One WHOLE leaf dies (slots 4, 5) and clients inside surviving leaves
    drop (1, 7): the tree's leaf-local + root recovery equals the flat
    survivor aggregate (the port's 1x8 flat tier and the reference's)."""
    fl = dataclasses.replace(FL, secure_agg_degree=degree)
    flat, tree = _tier(mode, 1, 8, fl), _tier(mode, 4, 2, fl, two_level=True)
    jflat = JTier(_jparams(), dataclasses.replace(JFL_,
                                                  secure_agg_degree=degree),
                  num_leaves=1, leaf_buffer=8, mask_mode=mode,
                  staleness_mode="constant")
    ds = _deltas(8)
    keep = [0, 2, 3, 6]
    batch = _stack([ds[s] for s in keep])
    flat.push(batch, 0, slots=keep)
    tree.push(batch, 0, slots=keep)
    jflat.push({"w": jnp.asarray(batch["w"].numpy())}, 0, slots=keep)
    flat.flush(rng=prf.PRNGKey(17))
    tree.flush(rng=prf.PRNGKey(17))
    jflat.flush(rng=jax.random.PRNGKey(17))
    assert tree.version == 1
    assert _diff(flat.params, tree.params) == 0.0
    assert _diff(jflat.params, tree.params) == 0.0
    assert float(tree.last_metrics["weight_total"]) == pytest.approx(
        len(keep))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_two_level_nested_dropout_property(seed):
    """Seeded survivor sets with a fully-dead leaf decode to the flat
    survivor aggregate (client mode, random 4-regular flat graph vs
    per-leaf complete graphs)."""
    rs = np.random.RandomState(seed)
    L, Bl = 4, 2
    fl = dataclasses.replace(FL, secure_agg_degree=4)
    dead_leaf = int(rs.randint(L))
    keep = [s for s in range(L * Bl)
            if s // Bl != dead_leaf and rs.uniform() > 0.35]
    if not keep:
        keep = [(dead_leaf * Bl + Bl) % (L * Bl)]
    flat, tree = (_tier("client", 1, L * Bl, fl),
                  _tier("client", L, Bl, fl, two_level=True))
    ds = _deltas(L * Bl, seed=seed)
    for s in keep:
        flat.push_encoded(flat.encode_push({"w": ds[s]}, 0, slot=s))
        tree.push_encoded(tree.encode_push({"w": ds[s]}, 0, slot=s))
    flat.flush(rng=prf.PRNGKey(100 + seed))
    tree.flush(rng=prf.PRNGKey(100 + seed))
    assert _diff(flat.params, tree.params) == 0.0, (seed, keep)


@pytest.mark.parametrize("two_level", [False, True])
def test_tier_ingest_is_destination_sharded_and_bit_equal(two_level):
    """A batch is routed by destination leaf and encoded leaf by leaf: the
    same buffer state as sequential pushes, in both topologies."""
    ds = _deltas(6)

    def mk():
        return _tier("tee_stream", 2, 4, two_level=two_level)

    srv_a, srv_b = mk(), mk()
    for d in ds:
        srv_a.push({"w": d}, 0)
    srv_b.push(_stack(ds), 0)
    assert torch.equal(srv_a._buf, srv_b._buf)
    assert torch.equal(srv_a._wts, srv_b._wts)
    assert srv_a._fill == srv_b._fill == 6
    per = srv_b._route_by_leaf([5, 0, 6, 1],
                               np.asarray([0, 1, 2, 3], np.float32))
    # per leaf, (batch position, local slot, staleness) in batch order
    assert per == [[(1, 0, 1.0), (3, 1, 3.0)], [(0, 1, 0.0), (2, 2, 2.0)]]


def test_two_level_client_rows_and_root_isolation():
    """Tree rows are masked under LEAF sessions (different words from the
    flat session's), yet the applied round is the single host's."""
    srv1, srv2 = _flat_server("client", 4), _tier("client", 2, 2,
                                                  two_level=True)
    ds = _deltas(4)
    cps1 = [srv1.encode_push({"w": d}, 0, slot=i) for i, d in enumerate(ds)]
    cps2 = srv2.encode_push(_stack(ds), 0)
    assert not torch.equal(cps1[0].row, cps2[0].row)
    jt = JTier(_jparams(), JFL_, num_leaves=2, leaf_buffer=2,
               mask_mode="client", staleness_mode="constant", two_level=True)
    jcps = jt.encode_push({"w": jnp.asarray(_stack(ds)["w"].numpy())}, 0)
    for a, b in zip(cps2, jcps):  # the reference tree's wire words
        np.testing.assert_array_equal(a.row.numpy().view(np.uint32),
                                      np.asarray(b.row))
    for cp in cps1:
        srv1.push_encoded(cp)
    srv2.push_encoded(cps2)
    assert srv1.version == srv2.version == 1
    assert _diff(srv1.params, srv2.params) == 0.0


@pytest.mark.parametrize("two_level", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_sub32_field_packed_wire_parity_under_dropout(mode, two_level):
    """bits=16: a 2^19 field and a 19-bit packed wire; under dropout the
    tier (1x8 flat or the 4x2 tree) decodes bit-equal to the reference's
    single host, and client words are narrower than an int32 row."""
    fl = dataclasses.replace(FL, secure_agg_bits=16)
    srv = (_tier(mode, 4, 2, fl, two_level=True) if two_level
           else _tier(mode, 1, 8, fl))
    jsrv = _jserver(mode, 8, secure_agg_bits=16)
    assert srv._spec.field_modulus == 1 << 19
    ds = _deltas(8)
    for s in range(5):  # dropout: slots 5..7 never deliver
        jd = {"w": jnp.asarray(ds[s].numpy())}
        if mode == "client":
            cp = srv.encode_push({"w": ds[s]}, 0, slot=s)
            assert cp.modulus == 1 << 19
            assert cp.row.numel() * 4 < D * 4
            srv.push_encoded(cp)
            jsrv.push_encoded(jsrv.encode_push(jd, 0, slot=s))
        else:
            srv.push({"w": ds[s]}, 0)
            jsrv.push(jd, 0)
    srv.flush(rng=prf.PRNGKey(29))
    jsrv.flush(rng=jax.random.PRNGKey(29))
    assert _diff(jsrv.params, srv.params) == 0.0
    assert float(srv.last_metrics["weight_total"]) == pytest.approx(5.0)


def test_client_mode_mixed_staleness_batch():
    """A (K,) client_version reaches each ClientPush and its weight
    (polynomial discount: f32 ``pow``, held to 1e-6 of the reference)."""
    srv = ShardedAsyncServer(_params(), FL, num_leaves=1, leaf_buffer=4,
                             mask_mode="client", device="cpu")
    jsrv = JTier(_jparams(), JFL_, num_leaves=1, leaf_buffer=4,
                 mask_mode="client")
    srv.version = jsrv.version = 3
    ds = _stack(_deltas(3))
    cps = srv.encode_push(ds, torch.tensor([3, 2, 1]))
    jcps = jsrv.encode_push({"w": jnp.asarray(ds["w"].numpy())},
                            jnp.asarray([3, 2, 1]))
    assert [cp.staleness for cp in cps] == [0.0, 1.0, 2.0]
    ws = [float(cp.weight) for cp in cps]
    assert ws[0] == pytest.approx(1.0) and ws[1] > ws[2]
    np.testing.assert_allclose(ws, [float(cp.weight) for cp in jcps],
                               rtol=0, atol=1e-6)
    srv.push_encoded(cps)
    assert srv._fill == 3
    srv.push(_stack(_deltas(1)), [2], slots=[3])
    assert srv.version == 4


def test_config_defaults_drive_the_tier_shape():
    fl = dataclasses.replace(FL, num_leaves=2, leaf_buffer=3, two_level=True)
    srv = ShardedAsyncServer(_params(), fl, device="cpu")
    assert (srv.num_leaves, srv.leaf_buffer, srv.two_level) == (2, 3, True)
    assert srv.buffer_size == 6
    with pytest.raises(ValueError):
        ShardedAsyncServer(_params(), FL, device="cpu")  # shape unset


def test_leaf_multiplexing_maps_leaves_onto_devices():
    """make_leaf_mesh folds logical leaves onto the devices (all onto the
    one device here) and leaf_device_map equals the reference's map; a
    leaf count that divides badly warns."""
    mesh = tmesh.make_leaf_mesh(6, device="cpu")
    assert mesh.shape == {"leaf": 1}
    assert tmesh.leaves_per_device(6, mesh) == 6
    m = tsharding.leaf_device_map(6, mesh)
    np.testing.assert_array_equal(m, jleaf_device_map(6, jmake_leaf_mesh(6)))
    four = tmesh.make_leaf_mesh(8, devices=["cpu"] * 4)
    np.testing.assert_array_equal(tsharding.leaf_device_map(8, four),
                                  [0, 0, 1, 1, 2, 2, 3, 3])
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert tmesh.make_leaf_mesh(5, devices=["cpu"] * 4).shape == {
            "leaf": 1}
    assert any("divide" in str(x.message) for x in w)
    with pytest.raises(ValueError):
        tmesh.make_agg_mesh(2, device="cpu")  # one device, two leaves
    with pytest.raises(ValueError):
        tmesh.leaves_per_device(6, four)


# --- the JAX file's multidev cases, leaves multiplexed onto one device ------
@pytest.mark.parametrize("num_leaves", [2, 4])
@pytest.mark.parametrize("mode", MODES)
def test_multidev_sharded_flush_bit_identical(num_leaves, mode):
    """The flat (one global session) tier at 2 and 4 leaves ingesting one
    batch == the reference single host's sequential pushes."""
    srv2 = _tier(mode, num_leaves, 2)
    jsrv = _jserver(mode, num_leaves * 2)
    ds = _deltas(num_leaves * 2)
    for d in ds:
        jsrv.push({"w": jnp.asarray(d.numpy())}, jsrv.version)
    srv2.push(_stack(ds), srv2.version)
    assert jsrv.version == srv2.version == 1
    assert _diff(jsrv.params, srv2.params) == 0.0
    _metrics_match(jsrv, srv2, ulps=2)


@pytest.mark.parametrize("degree", [0, 4])
@pytest.mark.parametrize("num_leaves", [2, 4])
def test_multidev_cross_shard_dropout_recovery(num_leaves, degree):
    """Survivors on different leaves; the absent slots' shares (edges that
    cross leaves) recovered by the per-leaf edge shards == the reference
    single host's recovery, and the client words are the reference's."""
    fl = dataclasses.replace(FL, secure_agg_degree=degree)
    srv2 = _tier("client", num_leaves, 2, fl)
    jsrv = _jserver("client", num_leaves * 2, secure_agg_degree=degree)
    ds = _deltas(num_leaves * 2)
    keep = [0, 2, num_leaves * 2 - 1]
    for s in keep:
        cp2 = srv2.encode_push({"w": ds[s]}, 0, slot=s)
        jcp = jsrv.encode_push({"w": jnp.asarray(ds[s].numpy())}, 0, slot=s)
        np.testing.assert_array_equal(cp2.row.numpy().view(np.uint32),
                                      np.asarray(jcp.row))
        srv2.push_encoded(cp2)
        jsrv.push_encoded(jcp)
    srv2.flush(rng=prf.PRNGKey(99))
    jsrv.flush(rng=jax.random.PRNGKey(99))
    assert _diff(jsrv.params, srv2.params) == 0.0
    assert float(srv2.last_metrics["weight_total"]) == pytest.approx(
        len(keep))


def test_multidev_sharded_sync_round_masked_bit_identical():
    """The cohort-sharded sync round: masked == unmasked across leaves
    (degree 0 and 4), equal to the port's single-host round given the same
    deltas, and within the round's 1e-5 of the reference's round."""
    from repro.configs import mlp as jmlp
    from repro.core.fl.round import build_round_step as jbuild
    from repro.core.fl.round import init_fl_state as jinit
    from repro.models.model import build_mlp_classifier as jbuild_mlp
    from repro_torch import convert
    from repro_torch import tree as T
    from repro_torch.configs import mlp as mlp_cfg
    from repro_torch.core.fl.round import (build_round_step,
                                           build_sharded_round_step,
                                           init_fl_state)
    from repro_torch.models.model import build_mlp_classifier

    cfg = mlp_cfg.CONFIG
    model = build_mlp_classifier(cfg, device="cpu")
    key = prf.PRNGKey(0)
    params = model.init(key)
    x = prf.normal(prf.fold_in(key, 1), (8, 2, cfg.num_features))
    batch = {"features": x, "label": (x.sum(-1) > 0).to(torch.float32)}
    fl_kw = dict(cohort_size=8, local_steps=1, local_lr=0.2, clip_norm=1.0,
                 secure_agg_bits=32)
    fl = FLConfig(**fl_kw)
    rng = prf.PRNGKey(3)

    def md(a, b):
        return max(float((p - q).abs().max())
                   for p, q in zip(T.leaves(a), T.leaves(b)))

    s0, m0 = build_round_step(model.loss_fn, fl, cohort_size=8,
                              device="cpu")(init_fl_state(params, fl),
                                            dict(batch), rng)
    step1 = build_sharded_round_step(model.loss_fn, fl, cohort_size=8,
                                     num_leaves=4, device="cpu")
    s1, m1 = step1(init_fl_state(params, fl), dict(batch), rng)
    assert md(s0.params, s1.params) == 0.0
    assert float(m0["loss"]) == pytest.approx(float(m1["loss"]), abs=1e-6)
    for degree in (0, 4):
        flm = dataclasses.replace(fl, secure_agg_masked=True,
                                  secure_agg_degree=degree)
        stepm = build_sharded_round_step(model.loss_fn, flm, cohort_size=8,
                                         num_leaves=4, device="cpu")
        sm, _ = stepm(init_fl_state(params, flm), dict(batch), rng)
        assert md(s1.params, sm.params) == 0.0, degree
    jmodel = jbuild_mlp(jmlp.CONFIG)
    jfl = JFL(**fl_kw)
    js, jm = jax.jit(jbuild(jmodel.loss_fn, jfl, cohort_size=8))(
        jinit(jmodel.init(jax.random.PRNGKey(0)), jfl),
        {k: jnp.asarray(v.numpy()) for k, v in batch.items()},
        jax.random.PRNGKey(3))
    assert md(convert.params_from_numpy(js.params), s1.params) <= 1e-5
    assert float(jm["loss"]) == pytest.approx(float(m1["loss"]), abs=1e-5)
    with pytest.raises(ValueError):
        build_sharded_round_step(model.loss_fn, dataclasses.replace(
            fl, secure_agg_bits=0), cohort_size=8, num_leaves=4,
            device="cpu")


def test_multidev_buffer_is_physically_sharded():
    """Each leaf's rows are its own slice of the leaf-major buffer; the
    layout descriptors of an 8-leaf mesh on the one device place every
    logical leaf there."""
    srv = _tier("tee_stream", 8, 2)
    assert tuple(srv._buf.shape) == (8, 2, D)
    mesh = tmesh.make_leaf_mesh(8, device="cpu")
    sh = tsharding.hierarchy_shardings(mesh)
    assert sh["buffer"].spec == ("leaf",) and sh["replicated"].spec == ()
    assert sh["buffer"].device_set == {srv._buf.device}
    assert tsharding.leaf_device_map(8, mesh).tolist() == [0] * 8
    srv.push(_stack(_deltas(3)), 0, slots=[1, 4, 15])
    nz = [(leaf, s) for leaf in range(8) for s in range(2)
          if bool(srv._buf[leaf, s].any())]
    assert nz == [(0, 1), (2, 0), (7, 1)]


@pytest.mark.parametrize("degree", [0, 4])
def test_multidev_two_level_nested_dropout_multiplexed(degree):
    """16 logical tree leaves vs the 8x4 flat tier under nested dropout:
    two whole leaves die and clients drop inside surviving leaves."""
    fl = dataclasses.replace(FL, secure_agg_degree=degree)
    flat = _tier("client", 8, 4, fl)
    tree = _tier("client", 16, 2, fl, two_level=True)
    ds = _deltas(32)
    dead = {3, 11}
    keep = [s for s in range(32) if s // 2 not in dead and (s % 5 != 4)]
    for s in keep:
        flat.push_encoded(flat.encode_push({"w": ds[s]}, 0, slot=s))
        tree.push_encoded(tree.encode_push({"w": ds[s]}, 0, slot=s))
    flat.flush(rng=prf.PRNGKey(23))
    tree.flush(rng=prf.PRNGKey(23))
    assert _diff(flat.params, tree.params) == 0.0
    assert float(tree.last_metrics["weight_total"]) == pytest.approx(
        len(keep))


@pytest.mark.parametrize("two_level", [False, True])
@pytest.mark.parametrize("mode", ["client", "tee_stream", "off", "tee"])
def test_leaf_death_recovers_like_dropout(mode, two_level):
    """mark_leaf_dead: the dead leaf's buffered rows are lost, its slots
    leave allocation, and the flush decodes the survivors exactly as the
    port's flat server over the survivors does."""
    L, Bl = 4, 2
    srv = _tier(mode, L, Bl, two_level=two_level)
    ds = _deltas(L * Bl)
    srv.push(_stack([ds[s] for s in (0, 2, 3)]), 0, slots=[0, 2, 3])
    assert srv.mark_leaf_dead(1) == [2, 3]
    assert srv.mark_leaf_dead(1) == []
    assert srv.live_capacity == 6 and 2 not in srv.open_slots()
    with pytest.raises(ValueError):
        srv.push({"w": ds[2]}, 0, slots=2)  # dead leaf: closed slot
    keep = [0, 4, 7]
    srv.push(_stack([ds[4], ds[7]]), 0, slots=[4, 7])
    srv.flush(rng=prf.PRNGKey(5))
    ref = _flat_server(mode, L * Bl)
    for s in keep:
        ref.push({"w": ds[s]}, 0, slot=s)
    ref.flush(rng=prf.PRNGKey(5))
    assert _diff(ref.params, srv.params) == 0.0
    assert srv.fault_metrics["lost_contributions"] == 2
    assert srv.fault_metrics["dead_leaves"] == 1


def test_enclave_wire_on_the_tier():
    """enclave_wire_bits=8 on the tee tier: one key per batch split per
    row, as the reference tier draws them; the upload is the packed 8-bit
    words and the decode equals the reference tier's within the noise-free
    enclave quantization (bit-equal here)."""
    kw = dict(enclave_wire_bits=8)
    srv = _tier("tee_stream", 1, 4, dataclasses.replace(FL, **kw))
    jsrv = JTier(_jparams(), dataclasses.replace(JFL_, **kw), num_leaves=1,
                 leaf_buffer=4, mask_mode="tee_stream",
                 staleness_mode="constant")
    ds = _stack(_deltas(4))
    srv.push(ds, 0)
    jsrv.push({"w": jnp.asarray(ds["w"].numpy())}, 0)
    assert srv.version == jsrv.version == 1
    assert _diff(jsrv.params, srv.params) == 0.0
    lanes = {dict(k).get("lane"): v for (n, k), v in
             srv.telemetry.counters().items()
             if n == "upload_bytes" and ("eid", srv._eid) in k}
    assert lanes["enclave"] == 4 * 4 * (D * 8 // 32)
    assert hier.ROOT_SESSION_TAG == 0x4007 and hier.LEAF_SESSION_TAG == 0x1EAF


@pytest.mark.parametrize("two_level", [False, True])
def test_clipped_rows_bit_equal_to_flat_and_close_to_reference(two_level):
    """The reference file's own scale (0.1: every row clipped): the tier is
    still bit-equal to the port's single host (same norms, same order);
    against the reference the clip scale may differ in its last bit.  One
    client's quantization step is 2^-31 x range (1.86e-9 at range 4); the
    measured gap is 3 steps here (5.59e-9; 2-4 steps at seeds 0-2), so
    the params are held to 8 steps."""
    srv1 = _flat_server("client", 8)
    srv2 = _tier("client", 4, 2, two_level=two_level)
    jsrv = _jserver("client", 8)
    ds = _deltas(8, scale=0.1)
    for d in ds:
        srv1.push({"w": d}, srv1.version)
        jsrv.push({"w": jnp.asarray(d.numpy())}, jsrv.version)
    srv2.push(_stack(ds), 0)
    assert float(srv2.last_metrics["clip_fraction"]) == 1.0
    assert _diff(srv1.params, srv2.params) == 0.0
    _metrics_match(srv1, srv2)
    step = 2.0 ** -31 * FL.secure_agg_range
    assert _diff(jsrv.params, srv2.params) <= 8 * step


def test_tier_entry_points_need_a_gpu_unless_told_cpu():
    """The tier's entry points default to the card and raise without one
    (never a silent CPU run); the same calls run with device='cpu'."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from repro_torch.core.fl.async_fl import simulate_training
    calls = [
        lambda **k: ShardedAsyncServer(_params(), FL, num_leaves=2,
                                       leaf_buffer=2, **k),
        lambda **k: hier.build_two_level_masked_step(
            _params(), FL, num_leaves=2, leaf_buffer=2, **k),
        lambda **k: hier.build_two_level_buffer_step(
            _params(), FL, num_leaves=2, leaf_buffer=2, **k),
        lambda **k: tmesh.make_leaf_mesh(2, **k),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
        call(device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulate_training("async", loss_fn=None, params=_params(),
                          fl_cfg=FL, make_client_batch=None,
                          target_updates=1, cohort=1)
