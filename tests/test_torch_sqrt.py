"""``prf.sqrt_f32``: the port's correctly rounded f32 square root, the value
XLA's ``jnp.sqrt`` gives, against numpy's (IEEE, correctly rounded) and
``jnp.sqrt`` itself.

torch's own f32 ``sqrt`` on the CPU is not correctly rounded on some hosts
(it gives ``4.7328010`` for ``sqrt(22.399402618408203)``, where the
correctly rounded value is ``4.7328005``), so every port site whose
reference is a ``jnp.sqrt`` goes through the helper; the last test holds
the package to that.
"""
import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import prf
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"

F32_MAX = np.finfo(np.float32).max
EDGES = np.array(
    [0.0, 1.0, 2.0, 4.0, 22.399402618408203, 217959.89, 466.861755 ** 2,
     np.float32(2.0 ** -149),            # the least subnormal
     np.float32(2.0 ** -126) - np.float32(2.0 ** -149),  # the greatest
     np.float32(2.0 ** -126),            # the least normal
     np.nextafter(np.float32(2.0 ** -126), np.float32(0)),
     F32_MAX, np.nextafter(F32_MAX, np.float32(0)), np.inf],
    dtype=np.float32)


def _bits(a: np.ndarray) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.uint32)


def _sample(seed: int, n: int) -> np.ndarray:
    """Half uniform in [0, 1e4) (the norms and variances the port takes
    roots of), half random bit patterns of finite non-negative f32 (every
    binade, subnormals included)."""
    rng = np.random.default_rng(seed)
    uni = rng.uniform(0.0, 1e4, n // 2).astype(np.float32)
    pat = rng.integers(0, 0x7F800000, n - n // 2, dtype=np.uint32)
    return np.concatenate([uni, pat.view(np.float32), EDGES])


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_sqrt_f32_is_correctly_rounded_on_many_values(seed):
    x = _sample(seed, 1 << 22)
    got = prf.sqrt_f32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(np.sqrt(x)))


def test_sqrt_f32_equals_jnp_sqrt_and_the_first_values_that_differed():
    x = _sample(3, 1 << 16)
    x = x[x >= np.float32(2.0 ** -126)]  # XLA's CPU code flushes subnormals
    got = prf.sqrt_f32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(jnp.sqrt(x)))
    # the enclave test's first whole-model norm (torch's f32 CPU sqrt gave
    # 4.7328010 on a host where it misrounds)
    one = prf.sqrt_f32(torch.tensor([22.399402618408203])).numpy()
    np.testing.assert_array_equal(_bits(one),
                                  _bits(np.array([4.7328005], np.float32)))


def test_sqrt_f32_on_every_f32_in_two_binades():
    # [1, 4) holds every mantissa at both exponent parities: the root of any
    # other normal f32 is one of these roots times a power of two
    x = (np.arange(1 << 24, dtype=np.uint32) + np.uint32(0x3F800000)
         ).view(np.float32)
    got = prf.sqrt_f32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(np.sqrt(x)))


def test_sqrt_f32_tiles_keep_shape_and_bits(monkeypatch):
    monkeypatch.setattr(prf, "TILE", 1000)
    x = _sample(4, 5000)[:4998].reshape(3, 1666, 1)[:, ::2]  # strided view
    got = prf.sqrt_f32(torch.from_numpy(np.ascontiguousarray(x)))
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(np.sqrt(x)))
    scalar = prf.sqrt_f32(torch.tensor(22.399402618408203))
    assert scalar.shape == () and float(scalar) == float(np.float32(4.7328005))
    assert torch.isnan(prf.sqrt_f32(torch.tensor([-1.0, float("nan")]))).all()
    with pytest.raises(TypeError):
        prf.sqrt_f32(torch.ones(3, dtype=torch.float64))


def _sqrt_calls(tree: ast.AST):
    """(line, enclosing function) of every ``<x>.sqrt(...)`` call other than
    ``math.sqrt`` and ``np.sqrt`` (Python floats and numpy arrays, computed
    as the reference computes them)."""
    found = []

    def walk(node, fn):
        for child in ast.iter_child_nodes(node):
            name = fn
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                name = child.name
            if (isinstance(child, ast.Call)
                    and isinstance(child.func, ast.Attribute)
                    and child.func.attr == "sqrt"
                    and not (isinstance(child.func.value, ast.Name)
                             and child.func.value.id in ("math", "np"))):
                found.append((child.lineno, fn))
            walk(child, name)

    walk(tree, None)
    return found


def test_no_bare_torch_sqrt_outside_the_helper():
    bare = []
    for path in sorted(SRC.rglob("*.py")):
        for line, fn in _sqrt_calls(ast.parse(path.read_text())):
            if (path.name, fn) != ("prf.py", "sqrt_f32"):
                bare.append(f"{path.relative_to(SRC)}:{line} in {fn}")
    assert not bare, ("use prf.sqrt_f32 where the reference has jnp.sqrt: "
                      + ", ".join(bare))
    # the helper itself is found, so the scan sees attribute calls
    prf_calls = _sqrt_calls(ast.parse((SRC / "kernels" / "prf.py")
                                      .read_text()))
    assert {fn for _, fn in prf_calls} == {"sqrt_f32"}
