"""The aggregation tier across processes: ``torch.distributed`` gloo worlds
of 2 and 4 ranks on the CPU, against the JAX reference.

One module-scoped fixture spawns each world once (``launch.dist.run``) and
runs every case in it through ``repro_torch.testing.tier_world``, so a rank
imports the port only; this process runs the JAX reference and the port's
one-process tier on the same inputs and compares:

- the flat (one global session) and two-level tiers in every mask mode
  (``off``, ``client``, ``tee``, ``tee_stream``) over 4 leaves x 2 slots:
  a full session, then a session with two client dropouts and a leaf that
  dies holding two rows, recovered by ``flush``: params bit-equal to the
  JAX single-host ``AsyncServer`` at ``buffer_size = 8`` (``update_norm``
  within 2 f32 ulp, as ``tests/test_torch_hierarchy.py`` holds it) and
  ``torch.equal`` to the one-process tier; every rank holds the same
  params and only its own leaves' rows;
- the bits-16 packed wire and sketch@0.2 (``client``), the same way;
- ``build_sharded_round_step`` across ranks: masked == unmasked and equal
  to the one-process round;
- ``combine`` of int32 partials whose sum overflows int32 (sizes that W
  divides or not, shorter than W, a list of them), the two collectives a
  partial it counts and the bytes a rank sends, and
  ``_partition_edges`` for any number of shards;
- a twin of ``tests/test_hierarchy.py``'s multidev cases (the reference
  forces 8 host devices; here gloo ranks), which the reference runs in
  ``test_multidev_parity_under_forced_host_devices``.

Deltas are ``prf.normal`` draws scaled by 0.02 (no row is clipped), the
staleness is constant, the noise off and ``server_lr`` 1, so every
compared quantity is exact unless stated.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JFL
from repro.core.fl.async_fl import AsyncServer as JServer
from repro_torch import tree as T
from repro_torch.configs.base import FLConfig
from repro_torch.core.fl import aggregation as agg
from repro_torch.core.fl import hierarchy as hier
from repro_torch.core.fl import secure_agg as sa
from repro_torch.core.fl.round import (build_round_step,
                                       build_sharded_round_step,
                                       init_fl_state)
from repro_torch.kernels import prf
from repro_torch.launch import dist
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsharding
from repro_torch.testing import (CombineCase, MeshCase, NumpySource,
                                 RoundCase, TierCase,
                                 classifier_round_inputs, combine_partial,
                                 pin_cpu_threads, run_tier_case, tier_world)

pin_cpu_threads()

D = 700
FL_KW = dict(clip_norm=1.0, server_lr=1.0, secure_agg_bits=32)
MODES = ("off", "client", "tee", "tee_stream")
WORLDS = (2, 4)
L, BL = 4, 2


def _deltas(n, seed=0, scale=0.02):
    key = prf.PRNGKey(seed)
    return [{"w": (scale * prf.normal(prf.fold_in(key, i), (D,))).numpy()}
            for i in range(n)]


SOURCE = NumpySource({"w": np.zeros(D, np.float32)}, _deltas(32))

# session 0: all 8 slots in one batch (applies on arrival); session 1:
# slots 1, 2, 6 never arrive, leaf 2 dies holding slots 4 and 5, flush
STEPS = (("push", tuple(range(8)), 0, tuple(range(8))),
         ("push", (8, 9, 10), 1, (0, 4, 5)),
         ("dead", 2),
         ("push", (11, 12), 1, (3, 7)),
         ("flush", 17))
# what the single host sees: (delta index, version, slot) per push
FLAT_PUSHES = (tuple((i, 0, i) for i in range(8))
               + ((8, 1, 0), (11, 1, 3), (12, 1, 7)))
SKETCH = dict(compress_mode="sketch", compress_rate=0.2)


def _tier_cases():
    cases = {}
    for mode in MODES:
        for two_level in (False, True):
            cases[f"{mode}-{'tree' if two_level else 'flat'}"] = TierCase(
                f"{mode}-{'tree' if two_level else 'flat'}", mode, two_level,
                L, BL, FL_KW, STEPS)
    cases["bits16-tree"] = TierCase("bits16-tree", "client", True, L, BL,
                                    dict(FL_KW, secure_agg_bits=16), STEPS)
    for two_level in (False, True):
        name = f"sketch-{'tree' if two_level else 'flat'}"
        cases[name] = TierCase(name, "client", two_level, L, BL,
                               dict(FL_KW, **SKETCH), STEPS)
    # the multidev twins: cross-shard dropout (degree 0 and 4), 16 logical
    # leaves multiplexed on the ranks in every mode, nested dropout on the
    # multiplexed tree against the flat 8 x 4 tier
    for degree in (0, 4):
        keep = (0, 2, 7)
        cases[f"md-cross-{degree}"] = TierCase(
            f"md-cross-{degree}", "client", False, L, BL,
            dict(FL_KW, secure_agg_degree=degree),
            (("push", keep, 0, keep), ("flush", 99)))
        keep32 = tuple(s for s in range(32)
                       if s // 2 not in (3, 11) and s % 5 != 4)
        for two_level, nl, bl in ((False, 8, 4), (True, 16, 2)):
            name = f"md-nested-{degree}-{'tree' if two_level else 'flat'}"
            cases[name] = TierCase(
                name, "client", two_level, nl, bl,
                dict(FL_KW, secure_agg_degree=degree),
                (("push", keep32, 0, keep32), ("flush", 23)))
    for mode in MODES:
        cases[f"md-mux-{mode}"] = TierCase(
            f"md-mux-{mode}", mode, True, 16, 2, FL_KW,
            (("push", tuple(range(32)), 0, tuple(range(32))),))
    return cases


ROUND_FL = dict(cohort_size=8, local_steps=1, local_lr=0.2, clip_norm=1.0,
                secure_agg_bits=32)
ROUNDS = {"round-plain": RoundCase("round-plain", ROUND_FL, 8, 4)}
for _deg in (0, 4):
    ROUNDS[f"round-masked-{_deg}"] = RoundCase(
        f"round-masked-{_deg}", dict(ROUND_FL, secure_agg_masked=True,
                                     secure_agg_degree=_deg), 8, 4)
COMBINES = {f"combine-{s}": CombineCase(f"combine-{s}", s) for s in (1, 2)}
# partials that W does not divide, one shorter than W (the seed makes its
# sum overflow in both worlds), and a list of unequal ones with an empty one
for _case in (CombineCase("combine-ragged", 3, (4099,)),
              CombineCase("combine-tiny", 7, (1,)),
              CombineCase("combine-chunks", 4,
                          (5000, 0, 4099, 3, 1, 2, 1031))):
    COMBINES[_case.name] = _case
# a ("data", "model") mesh of 2 x 2: a DeviceMesh in the world of 4 only
MESHES = [MeshCase("mesh-2x2", (2, 2), ("data", "model"))]
TIER_CASES = _tier_cases()


@pytest.fixture(scope="module")
def worlds():
    """{world size: per-rank results} — each world spawned once."""
    cases = (list(TIER_CASES.values()) + list(ROUNDS.values())
             + list(COMBINES.values()) + MESHES)
    return {w: dist.run(tier_world, w, [SOURCE], cases, device="cpu",
                        threads=1)
            for w in WORLDS}


@pytest.fixture(scope="module")
def one_process():
    """The port's one-process tier on every tier case."""
    src = SOURCE.build("cpu")
    out = {}
    for name, case in TIER_CASES.items():
        srv = run_tier_case(case, src, device="cpu")
        out[name] = srv
    return out


def _jserver(case: TierCase):
    fl = JFL(**{k: v for k, v in case.fl.items()})
    return JServer({"w": jnp.zeros((D,), jnp.float32)}, fl,
                   buffer_size=case.num_leaves * case.leaf_buffer,
                   mask_mode=case.mode, staleness_mode="constant")


@functools.cache
def _jax_flat(name: str, pushes, flush_seed):
    """The JAX single host over the survivors of ``TIER_CASES[name]``
    (``pushes``: (delta index, version, slot) each): its params and last
    metrics, computed once for both worlds."""
    case = TIER_CASES[name]
    jsrv = _jserver(case)
    for i, version, slot in pushes:
        d = {"w": jnp.asarray(SOURCE.deltas[i]["w"])}
        if case.mode == "client":
            jsrv.push_encoded(jsrv.encode_push(d, version, slot=slot))
        else:
            jsrv.push(d, version, slot=slot)
    if flush_seed is not None:
        jsrv.flush(rng=jax.random.PRNGKey(flush_seed))
    return (np.asarray(jsrv.params["w"]),
            {k: float(v) for k, v in jsrv.last_metrics.items()})


def _ulps(a: float, b: float) -> int:
    ia, ib = np.asarray([a, b], np.float32).view(np.int32)
    return abs(int(ia) - int(ib))


def _ranks_agree(results, name):
    """Every rank holds the same params and metrics; returns rank 0's."""
    r0 = results[0][name]
    for r in results[1:]:
        assert torch.equal(r[name]["params"]["w"], r0["params"]["w"])
        assert r[name]["metrics"] == r0["metrics"]
    return r0


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", [f"{m}-{t}" for m in MODES
                                  for t in ("flat", "tree")]
                         + ["bits16-tree", "sketch-flat", "sketch-tree"])
def test_tier_across_ranks_equals_single_host_and_one_process(
        worlds, one_process, world, name):
    got = _ranks_agree(worlds[world], name)
    assert got["version"] == 2
    assert got["fault"]["dead_leaves"] == 1
    assert got["fault"]["lost_contributions"] == 2
    one = one_process[name]
    assert torch.equal(got["params"]["w"], one.params["w"])
    for k in ("update_norm", "weight_total", "clip_fraction"):
        assert got["metrics"][k] == float(one.last_metrics[k]), k
    jw, jm = _jax_flat(name, FLAT_PUSHES, 17)
    np.testing.assert_array_equal(got["params"]["w"].numpy(), jw)
    assert got["metrics"]["weight_total"] == jm["weight_total"] == 3.0
    assert _ulps(got["metrics"]["update_norm"], jm["update_norm"]) <= 2


@pytest.mark.parametrize("world", WORLDS)
def test_each_rank_holds_only_its_leaves(worlds, world):
    """The buffer is physically split: each rank's chunks hold its
    ``num_leaves / W`` leaves (the twin of the reference's
    ``test_multidev_buffer_is_physically_sharded``), and a rank's K1
    launches are its own rows only (client mode: 14 pushes over 4
    leaves)."""
    for r, res in enumerate(worlds[world]):
        assert res["client-flat"]["local_rows"] == [L // world]
        assert res["md-mux-off"]["local_rows"] == [16 // world]
    k1 = sum(res["client-tree"]["counts"]["quantize_mask_prf"]["plain_calls"]
             for res in worlds[world])
    assert k1 == 8 + 5  # every landed row encoded once, on its rank
    # two flushes, each D int32 words: (W - 1) / W of them out, and back
    assert all(res["client-tree"]["combine_bytes"]
               == 2 * 2 * 4 * (world - 1) * D // world
               for res in worlds[world])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("degree", [0, 4])
def test_multidev_cross_shard_dropout_recovery(worlds, world, degree):
    """Survivors on different ranks; the absent slots' shares (edges that
    cross ranks) recovered by each rank's edge shard == the JAX single
    host's recovery."""
    name = f"md-cross-{degree}"
    got = _ranks_agree(worlds[world], name)
    jw, _ = _jax_flat(name, tuple((s, 0, s) for s in (0, 2, 7)), 99)
    np.testing.assert_array_equal(got["params"]["w"].numpy(), jw)
    assert got["metrics"]["weight_total"] == 3.0


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("mode", MODES)
def test_multidev_two_level_multiplexed_bit_identical(worlds, one_process,
                                                      world, mode):
    """16 logical leaves on W ranks (16 / W each), a full session of 32:
    bit-equal to the port's single host at buffer 32 and to the
    one-process tier (the 4-leaf cases above hold the port's single host
    against the JAX one)."""
    from repro_torch.core.fl.async_fl import AsyncServer
    got = _ranks_agree(worlds[world], f"md-mux-{mode}")
    assert got["version"] == 1
    params, delta = SOURCE.build("cpu")
    flat = AsyncServer(params, FLConfig(**FL_KW), buffer_size=32,
                       mask_mode=mode, staleness_mode="constant",
                       device="cpu")
    for i in range(32):
        flat.push(delta(i), 0, slot=i)
    assert flat.version == 1
    assert torch.equal(got["params"]["w"], flat.params["w"])
    one = one_process[f"md-mux-{mode}"]
    assert torch.equal(got["params"]["w"], one.params["w"])
    assert got["metrics"]["update_norm"] == float(
        one.last_metrics["update_norm"])
    assert _ulps(got["metrics"]["update_norm"],
                 float(flat.last_metrics["update_norm"])) <= 2


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("degree", [0, 4])
def test_multidev_two_level_nested_dropout_multiplexed(worlds, world,
                                                       degree):
    """Two whole tree leaves (3 and 11) never deliver and clients drop in
    the others: the 16-leaf tree's leaf-local + root recovery equals the
    flat 8 x 4 tier's cross-rank sweep, and the one-process tiers."""
    tree = _ranks_agree(worlds[world], f"md-nested-{degree}-tree")
    flat = _ranks_agree(worlds[world], f"md-nested-{degree}-flat")
    assert torch.equal(tree["params"]["w"], flat["params"]["w"])
    for kind in ("tree", "flat"):
        one = run_tier_case(TIER_CASES[f"md-nested-{degree}-{kind}"],
                            SOURCE.build("cpu"), device="cpu")
        assert torch.equal(one.params["w"], tree["params"]["w"])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_round_across_ranks(worlds, world):
    """Masked (degree 0 and 4) == unmasked == the one-process sharded round
    == the single-host round, params bit for bit; the metrics of the
    one-process sharded round exactly."""
    model, params, batch, rng = classifier_round_inputs(8, 0, "cpu")
    fl = FLConfig(**ROUND_FL)
    s0, _ = build_round_step(model.loss_fn, fl, cohort_size=8,
                             device="cpu")(init_fl_state(params, fl),
                                           dict(batch), rng)
    s1, m1 = build_sharded_round_step(
        model.loss_fn, fl, cohort_size=8, num_leaves=4,
        device="cpu")(init_fl_state(params, fl), dict(batch), rng)
    for name in ROUNDS:
        got = worlds[world][0][name]
        leaves = T.leaves(got["params"])
        for r in worlds[world][1:]:
            assert all(map(torch.equal, T.leaves(r[name]["params"]), leaves))
        assert all(map(torch.equal, T.leaves(s1.params), leaves)), name
        assert all(map(torch.equal, T.leaves(s0.params), leaves)), name
        for k in ("loss", "update_norm", "clip_fraction", "participation"):
            assert got["metrics"][k] == float(m1[k]), (name, k)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(COMBINES))
def test_combine_wraps_mod_2_32_across_ranks(worlds, world, name):
    """Partials from the ends of the int32 range: their sum overflows int32
    many times over; every rank gets numpy's sum mod 2^32, partial by
    partial, whether or not W divides a partial's size."""
    case = COMBINES[name]
    want = sum(combine_partial(case.seed, r, sum(case.sizes)).astype(np.int64)
               for r in range(world))
    assert np.abs(want).max() > 2 ** 31  # the int32 sum overflows
    want = (((want & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).astype(np.int32)
    want = np.split(want, np.cumsum(case.sizes)[:-1])
    for r in worlds[world]:
        got = r[name]["combined"]
        assert [g.numel() for g in got] == list(case.sizes)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(COMBINES))
def test_combine_makes_two_collectives_a_partial(worlds, world, name):
    """An exchange and a gather a non-empty partial, none for an empty one;
    a rank sends ``2 (W - 1) / W`` of a partial padded to ``W`` equal
    shards, 4 bytes a word: in ``combine_calls``, ``combine_bytes`` and
    the ``combine`` span's labels."""
    case = COMBINES[name]
    padded = [world * -(-n // world) for n in case.sizes]
    calls = 2 * sum(1 for n in case.sizes if n)
    nbytes = sum(2 * (world - 1) * 4 * n // world for n in padded)
    for r in worlds[world]:
        assert r[name]["counters"] == {"combine_calls": calls,
                                       "combine_bytes": nbytes}
        assert r[name]["span_labels"] == [{"ranks": world, "bytes": nbytes,
                                           "calls": calls}]


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("num_slots,degree", [(8, 0), (10, 4), (7, 0),
                                              (16, 4)])
def test_partition_edges_covers_every_edge_once(shards, num_slots, degree):
    spec_fl = FLConfig(**dict(FL_KW, secure_agg_degree=degree))
    sess = agg.make_mask_session(agg.make_spec(spec_fl, num_slots),
                                 prf.PRNGKey(5))
    lo, hi = sess.edges()
    plo, phi, w = hier._partition_edges(sess, shards)
    per = len(plo) // shards
    assert len(plo) == len(phi) == len(w) == per * shards
    assert per == max(1, -(-len(lo) // shards))
    got = sorted((a, b) for a, b, x in zip(plo, phi, w) if x)
    assert got == sorted(zip(lo, hi))
    assert sum(w) == len(lo) and set(w) <= {0, 1}
    # the shards' sweeps add up to the whole sweep
    pres = [1 if s % 3 else 0 for s in range(num_slots)]
    whole = sa.recovery_sweep((33,), pres, lo, hi, sess.key)
    acc = torch.zeros(33, dtype=torch.int32)
    for i in range(shards):
        t = slice(i * per, (i + 1) * per)
        agg.add_mod32_(acc, sa.recovery_sweep(
            (33,), pres, plo[t], phi[t], sess.key, w[t]))
    assert torch.equal(acc, whole)


@pytest.mark.parametrize("world", WORLDS)
def test_model_parallel_mesh_in_a_world(worlds, world):
    """``make_mesh_compat`` builds a ``DeviceMesh`` over the group only when
    the world has as many ranks as the mesh; its axis sizes either way."""
    for r in worlds[world]:
        got = r["mesh-2x2"]
        assert got["shape"] == {"data": 2, "model": 2}
        assert got["device_mesh"] == (("data", "model") if world == 4
                                      else None)


def test_meshes_over_a_world_and_without_one():
    """Without a group a mesh is the one process's device list (the
    one-device tier); the rank block helpers match the reference's map."""
    m = tmesh.make_leaf_mesh(8, device="cpu")
    assert m.group is None and tmesh.leaf_range(8, m) == range(8)
    assert tmesh.leaf_range(8, None) == range(8)
    fake = tmesh.LeafMesh((torch.device("cpu"),) * 4, group=object(),
                          rank=2)
    assert tmesh.leaf_range(8, fake) == range(4, 6)
    blocks = tsharding.hierarchy_shardings(fake)["buffer"].blocks(8)
    assert [b for _, b in blocks] == [range(0, 2), range(2, 4), range(4, 6),
                                      range(6, 8)]
    assert tsharding.hierarchy_shardings(fake)["replicated"].blocks(8)[3][
        1] == range(8)
    np.testing.assert_array_equal(tsharding.leaf_device_map(8, fake),
                                  [0, 0, 1, 1, 2, 2, 3, 3])
    assert dist.pick_backend(4, "cpu") == "gloo"


def test_a_failing_rank_fails_the_run():
    """An exception in any rank reaches the caller."""
    with pytest.raises(Exception, match="leaves do not divide"):
        dist.run(tier_world, 2, [SOURCE],
                 [TierCase("bad", "off", False, 3, 2, FL_KW, ())],
                 device="cpu", threads=1, timeout_s=60)


def test_the_launcher_defaults_to_the_gpu(monkeypatch):
    """``run`` and ``current_device`` outside a rank follow the port's
    device rule: the GPU unless the caller asks for the CPU, raising
    without one instead of falling back to gloo ranks on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dist.run(tier_world, 2, [SOURCE], [])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dist.current_device()


@pytest.mark.parametrize("name", ["client-flat", "tee-flat", "md-cross-4"])
def test_a_groupless_mesh_is_the_one_process_tier(one_process, name):
    """A leaf mesh without a process group (``make_leaf_mesh(L)``, the
    reference's own call) runs the one-process tier: the flat topology
    flushes through the flat engine, as with ``mesh=None``."""
    case = TIER_CASES[name]
    mesh = tmesh.make_leaf_mesh(case.num_leaves, device="cpu")
    srv = run_tier_case(case, SOURCE.build("cpu"), mesh=mesh)
    assert srv.mesh is None
    want = one_process[name]
    for a, b in zip(T.leaves(srv.params), T.leaves(want.params)):
        assert torch.equal(a, b)
