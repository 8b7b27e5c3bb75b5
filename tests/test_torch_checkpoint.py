"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's (``repro.checkpoint.checkpoint``) and its in-repo MessagePack
codec against ``msgpack`` itself, on the CPU.

- the codec writes the bytes of ``msgpack.packb(obj, use_bin_type=True)``
  (every header width of map, array, str, bin and int) and reads what
  ``msgpack`` writes as ``msgpack.unpackb(raw=False)`` does;
- a port save is byte for byte the reference's payload of the same tree
  (NamedTuples written as ``__seq__``, Python scalars as 0-d f8/i8 leaves);
- checkpoints cross between the packages in both directions, leaf for leaf
  bit-equal, with the reference's restore dtypes (64-bit types narrowed,
  as ``jnp.asarray`` without x64 narrows them);
- a flipped payload byte raises ``IOError``; ``latest_step_dir``; the port
  needs no ``msgpack``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import NamedTuple

import jax
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jck
from repro_torch.checkpoint import checkpoint as tck
from repro_torch.checkpoint import msgpack_codec as mp
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

SRC = Path(__file__).resolve().parents[1] / "src"


class Pair(NamedTuple):
    first: object
    second: object


def _boundaries(n):
    return [n - 1, n, n + 1]


SCALARS = ([None, True, False, 1.5, -0.0, float("inf")]
           + [v for b in (7, 8, 16, 32) for v in _boundaries(1 << b)]
           + [-v for b in (5, 7, 15, 31) for v in _boundaries(1 << b)]
           + [2 ** 64 - 1, -2 ** 63, 0])
SIZED = [s for n in (31, 32, 255, 256, 65535, 65536) for s in (
    "x" * n, b"y" * n, list(range(min(n, 70000))))] + [
    {str(i): i for i in range(n)} for n in (15, 16, 65535, 65536)] + [
    (1, "é", b"", []), {"a": {"b": [{}, ()]}}]


@pytest.mark.parametrize("obj", SCALARS + SIZED,
                         ids=lambda o: repr(o)[:24])
def test_codec_bytes_equal_msgpack(obj):
    want = msgpack.packb(obj, use_bin_type=True)
    assert mp.packb(obj) == want
    assert mp.unpackb(want) == msgpack.unpackb(want, raw=False)


def test_codec_refuses_what_it_does_not_write():
    with pytest.raises(TypeError):
        mp.packb({1.0j})
    with pytest.raises(ValueError):
        mp.unpackb(msgpack.packb(msgpack.ExtType(1, b"x")))
    with pytest.raises(ValueError):
        mp.unpackb(msgpack.packb([1, 2]) + b"\x00")
    with pytest.raises(ValueError):
        mp.unpackb(msgpack.packb("abc")[:-1])
    view = mp.unpackb(msgpack.packb(b"abc"), bin_view=True)
    assert isinstance(view, memoryview) and bytes(view) == b"abc"


# every numpy dtype a registry tree or an optimizer state holds, and the
# 64-bit ones restore narrows
DTYPES = [np.float32, np.float16, np.float64, np.int8, np.uint8, np.int16,
          np.int32, np.int64, np.uint32, np.bool_, np.complex64]


def _tree(rs):
    leaves = {np.dtype(d).name: (rs.randn(3, 5) * 50).astype(d)
              for d in DTYPES}
    return {
        "params": {"w": rs.randn(4, 3).astype(np.float32),
                   "empty": np.zeros((0, 7), np.float32),
                   "scalar": np.array(3.5, np.float32),
                   "big": rs.randn(70000).astype(np.float32),
                   "dtypes": leaves},
        "opt": Pair(np.int32(7), [np.ones(2, np.float32), 1.25, 3]),
        "steps": (np.arange(4, dtype=np.int64), True),
        "str_key_" + "k" * 40: {"nested": [np.array([1, 2], np.uint8)]},
    }


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_torch_tree(v) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_torch_tree(v) for v in tree)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    return tree


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_port_payload_is_the_reference_payload(tmp_path):
    tree = _tree(np.random.RandomState(0))
    jck.save(str(tmp_path / "j"), tree, step=3)
    tck.save(str(tmp_path / "t"), _torch_tree(tree), step=3)
    a = (tmp_path / "j" / "payload.msgpack").read_bytes()
    b = (tmp_path / "t" / "payload.msgpack").read_bytes()
    assert a == b
    assert a == mp.packb(msgpack.unpackb(a, raw=False))
    ma = json.loads((tmp_path / "j" / "manifest.json").read_text())
    mb = json.loads((tmp_path / "t" / "manifest.json").read_text())
    assert ma == mb
    assert not (tmp_path / "t" / ".payload.tmp").exists()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_cross_between_the_packages(tmp_path, writer):
    """A save by either package restores in both, leaf for leaf bit-equal,
    with the same structure (a NamedTuple comes back as a list, a tuple as
    a tuple) and the reference's restore dtypes."""
    tree = _tree(np.random.RandomState(1))
    path = str(tmp_path / "ck")
    if writer == "reference":
        jck.save(path, tree, step=11, metadata={"arch": "x"})
    else:
        tck.save(path, _torch_tree(tree), step=11, metadata={"arch": "x"})
    jt, jm = jck.restore(path)
    tt, tm = tck.restore(path, device="cpu")
    assert jm == tm and tm["step"] == 11 and tm["metadata"] == {"arch": "x"}
    assert isinstance(tt["opt"], list) and isinstance(jt["opt"], list)
    assert isinstance(tt["steps"], tuple) and isinstance(jt["steps"], tuple)
    assert (jax.tree_util.tree_structure(jt)
            == jax.tree_util.tree_structure(tt))
    want, got = jax.tree.leaves(jt), _leaves(tt)
    assert len(want) == len(got) == len(_leaves(tree))
    for a, b in zip(want, got):
        a = np.asarray(a)
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
        assert a.shape == tuple(b.shape)
        np.testing.assert_array_equal(a, b.numpy())
    narrowed = tt["params"]["dtypes"]
    assert narrowed["float64"].dtype == torch.float32
    assert narrowed["int64"].dtype == torch.int32
    assert tt["opt"][1][1].dtype == torch.float32  # a Python float leaf
    assert tt["opt"][1][2].dtype == torch.int32  # a Python int leaf


def test_flipped_payload_byte_raises(tmp_path):
    path = tmp_path / "ck"
    tck.save(str(path), {"w": torch.arange(10.0)}, step=1)
    raw = bytearray((path / "payload.msgpack").read_bytes())
    raw[len(raw) // 2] ^= 0x01
    (path / "payload.msgpack").write_bytes(bytes(raw))
    with pytest.raises(IOError, match="sha mismatch"):
        tck.restore(str(path), device="cpu")
    with pytest.raises(IOError):
        jck.restore(str(path))


def test_bfloat16_and_string_leaves_are_refused(tmp_path):
    with pytest.raises(TypeError, match="bfloat16"):
        tck.save(str(tmp_path / "a"),
                 {"w": torch.zeros(2, dtype=torch.bfloat16)})
    with pytest.raises(TypeError):
        tck.save(str(tmp_path / "b"), {"name": "qwen"})
    with pytest.raises(TypeError):
        tck.save(str(tmp_path / "c"), {"none": None})


def test_latest_step_dir(tmp_path):
    assert tck.latest_step_dir(str(tmp_path / "missing")) is None
    assert tck.latest_step_dir(str(tmp_path)) is None
    for s in (2, 10, 9):
        os.makedirs(tmp_path / f"step_{s}")
    os.makedirs(tmp_path / "other")
    want = jck.latest_step_dir(str(tmp_path))
    assert tck.latest_step_dir(str(tmp_path)) == want == str(
        tmp_path / "step_10")


PROBE = """
import sys
sys.modules["msgpack"] = None
import torch
from repro_torch.checkpoint import checkpoint as ck
ck.save(sys.argv[1], {"w": torch.arange(6.0).reshape(2, 3), "n": (1, 2.5)},
        step=4)
tree, man = ck.restore(sys.argv[1], device="cpu")
assert man["step"] == 4 and torch.equal(tree["w"], torch.arange(6.0).reshape(2, 3))
assert isinstance(tree["n"], tuple) and float(tree["n"][1]) == 2.5
print("ok")
"""


def test_port_checkpoints_without_msgpack(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", PROBE, str(tmp_path / "ck")],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip() == "ok"
