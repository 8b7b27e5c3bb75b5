"""The port's model-parallel specs and the registry's per-shape helpers
against the JAX package (twin of ``tests/test_sharding.py``).

The port's ``launch.sharding`` specs are tuples with one entry per tensor
dimension (None, an axis name, or a tuple of names): each must equal the
reference's ``PartitionSpec`` leaf by leaf, for every architecture, on the
reference's production meshes (16 x 16 ``("data", "model")`` and 2 x 16 x
16 ``("pod", "data", "model")``), with and without FSDP.  The meshes are
shape-only on both sides (the reference tests' ``FakeMesh``; the port's
``ShapeMesh`` when no process group exists).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import registry as jreg
from repro.launch import sharding as jsharding
from repro.models.model import build_model
from repro_torch import tree as T
from repro_torch.configs import registry as treg
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsharding
from repro_torch.models.model import param_shapes
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


MESHES = {"pod": (16, 16), "multipod": (2, 16, 16)}


def _meshes(kind):
    tm = tmesh.make_production_mesh(multi_pod=kind == "multipod")
    return FakeMesh(dict(tm.shape)), tm


_JPARAMS = {}


def _jparams(arch):
    if arch not in _JPARAMS:
        cfg = jreg.get_config(arch, reduced=True)
        _JPARAMS[arch] = jax.eval_shape(build_model(cfg).init,
                                        jax.random.PRNGKey(0))
    return _JPARAMS[arch]


def _by_path(jtree):
    flat = jax.tree_util.tree_leaves_with_path(
        jtree, is_leaf=lambda x: isinstance(x, P))
    return {tuple(getattr(k, "key", getattr(k, "name", str(k)))
                  for k in path): tuple(v) for path, v in flat}


def _port_specs(arch, mesh, fsdp):
    shapes = param_shapes(treg.get_config(arch, reduced=True))
    specs = tsharding.param_specs(shapes, mesh, fsdp_axis=fsdp)
    paths, leaves = T.flatten(specs)
    return shapes, dict(zip(paths, leaves))


@pytest.mark.parametrize("arch", list(jreg.ARCH_IDS))
def test_specs_divisible_and_unique(arch):
    """Every sharded dim divides its axis, no axis twice per tensor, and
    each spec equals the reference's, on both production meshes with and
    without FSDP."""
    jp = _jparams(arch)
    for kind in MESHES:
        jm, tm = _meshes(kind)
        for fsdp in ("data", None):
            want = _by_path(jsharding.param_specs(jp, jm, fsdp_axis=fsdp))
            shapes, got = _port_specs(arch, tm, fsdp)
            assert got == want, (arch, kind, fsdp)
            for path, shape in zip(*T.flatten(shapes)):
                spec = got[path]
                assert len(spec) <= len(shape)
                seen = []
                for dim, ax in zip(shape, spec):
                    if ax is None:
                        continue
                    axes = ax if isinstance(ax, tuple) else (ax,)
                    n = int(np.prod([tm.shape[a] for a in axes]))
                    assert dim % n == 0, (arch, path, shape, spec)
                    seen.extend(axes)
                assert len(seen) == len(set(seen)), (arch, path, spec)


def test_big_matrices_are_sharded():
    """The big 2-D weights get a model-axis shard; the vocab is sharded."""
    _, tm = _meshes("pod")
    _, got = _port_specs("deepseek-7b", tm, None)
    assert any("model" in str(v) for v in got.values())
    emb = [v for k, v in got.items() if "embed" in k[-1]][0]
    assert "model" in str(emb)
    want = _by_path(jsharding.param_specs(_jparams("deepseek-7b"),
                                          _meshes("pod")[0]))
    assert got == want


def test_kv_heads_not_divisible_stay_replicated():
    """qwen2's 2 kv heads on a 16-way model axis: wk/wv's head dim is not
    sharded."""
    _, tm = _meshes("pod")
    _, got = _port_specs("qwen2-1.5b", tm, None)
    kv = [v for k, v in got.items() if k[-1] in ("wk", "wv")]
    assert kv and all(ax is None for v in kv for ax in v[1:])


def test_shardings_are_dtensor_placements():
    """``to_shardings``: per mesh axis ``Shard(dim)`` or ``Replicate()``;
    a shape-only mesh has no ``DeviceMesh``."""
    from torch.distributed.tensor import Replicate, Shard
    _, tm = _meshes("multipod")
    assert tm.device_mesh is None and tm.size == 512
    assert tmesh.batch_axes(tm) == ("pod", "data")
    assert tmesh.batch_axes(tmesh.make_host_mesh()) == ("data",)
    sh = tsharding.to_shardings({"a": (("pod", "data"), None, "model"),
                                 "b": (None,)}, tm)
    assert sh["a"].placements == (Shard(0), Shard(0), Shard(2))
    assert sh["b"].placements == (Replicate(),) * 3
    shapes = param_shapes(treg.get_config("qwen2-1.5b", reduced=True))
    full = tsharding.param_shardings(shapes, tm, fsdp_axis="data")
    for s in T.leaves(full):
        assert len(s.placements) == 3


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k",
                                        "decode_32k", "long_500k"])
def test_config_for_pair_and_input_specs_match_reference(shape_name):
    """For every architecture: the same skip, the same adjusted config and
    the same input shapes and dtypes; batch specs as the reference's."""
    assert treg.SKIPS == jreg.SKIPS
    jm, tm = _meshes("pod")
    for arch in jreg.ARCH_IDS:
        jc = jreg.config_for_pair(arch, shape_name, reduced=True)
        tc = treg.config_for_pair(arch, shape_name, reduced=True)
        assert (jc is None) == (tc is None), arch
        if jc is None:
            assert (arch, shape_name) in treg.SKIPS
            continue
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc), arch
        shape = treg.get_shape(shape_name)
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            jreg.get_shape(shape_name))
        want = jreg.input_specs(jc, jreg.get_shape(shape_name))
        got = treg.input_specs(tc, shape)
        assert set(got) == set(want), arch
        for k, sds in want.items():
            assert got[k].shape == tuple(sds.shape), (arch, k)
            assert str(got[k].dtype).split(".")[-1] == str(sds.dtype)
        shapes = {k: torch.Size(v.shape) for k, v in got.items()}
        jsds = {k: jax.ShapeDtypeStruct(v.shape, jnp.float32)
                for k, v in want.items()}
        for ca, sa_ in ((None, None), ("data", None), ("data", "model")):
            assert tsharding.train_batch_specs(
                shapes, tm, client_axis=ca, seq_axis=sa_) == {
                k: tuple(v) for k, v in jsharding.train_batch_specs(
                    jsds, jm, client_axis=ca, seq_axis=sa_).items()}
        assert tsharding.infer_batch_specs(shapes, tm) == {
            k: tuple(v) for k, v in jsharding.infer_batch_specs(
                jsds, jm).items()}


@pytest.mark.parametrize("shard_seq", [False, True])
def test_cache_specs_match_reference(shard_seq):
    """KV, SSM, conv, RG-LRU and memory caches, scanned and unscanned."""
    tree = {"scan": {"k": (4, 128, 2048, 16, 128), "v": (4, 128, 2048, 16,
                                                         128),
                     "ssm": (4, 128, 32, 64, 128), "conv": (4, 128, 3, 256),
                     "h": (4, 128, 2560)},
            "layer_0": {"k": (128, 4096, 2, 64), "pos": (4096,),
                        "cross_k": (128, 1500, 6, 64),
                        "memory": (128, 1500, 384)}}
    for kind in MESHES:
        jm, tm = _meshes(kind)
        jtree = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s, jnp.float32),
                             tree, is_leaf=lambda x: isinstance(x, tuple))
        want = _by_path(jsharding.cache_specs(jtree, jm, shard_seq=shard_seq))
        ttree = T.tree_map(torch.Size, tree)
        paths, got = T.flatten(tsharding.cache_specs(ttree, tm,
                                                     shard_seq=shard_seq))
        assert dict(zip(paths, got)) == want, kind
