"""The plain versions of the two ported kernels against the Pallas kernels
(interpret mode) and the ``repro.kernels.ref`` oracles — bit-equal — plus the
wrappers' device dispatch and launch counters.

The CUDA kernels themselves run only on the card: see
``tests/test_torch_cuda.py`` (marked ``cuda``) and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.fl import secure_agg as jsa
from repro.kernels import ref
from repro.kernels import secure_agg as jksa
from repro_torch.core.fl import secure_agg as sa
from repro_torch.kernels import prf
from repro_torch.kernels import secure_agg as ksa

KW = (0x1234, 0x5A5E)
UW = (77, 0xDEADBEEF)
SCALE = 1.0e4 / 3.0


def _jsession(n, degree, perm=None, offset=0):
    nbrs = None
    if perm is not None:
        nbrs = jsa.neighbor_table(n, degree, jnp.asarray(perm))
    return jksa.SessionMeta(key_words=jnp.asarray(KW, jnp.uint32),
                            num_slots=n, degree=degree, slot_offset=offset,
                            neighbors=nbrs)


def _tsession(n, degree, perm=None, offset=0):
    nbrs = None if perm is None else sa.neighbor_table(n, degree, perm)
    return ksa.SessionMeta(key_words=KW, num_slots=n, degree=degree,
                           slot_offset=offset, neighbors=nbrs)


GRAPHS = [(8, 0, None), (10, 4, None), (10, 4, [3, 0, 9, 1, 4, 8, 2, 7, 6, 5])]


# a 5-slot complete graph and a random 4-regular table; the circulant ring
# runs through the same enumeration in the K2 shard lane
@pytest.mark.parametrize("n,degree,perm", [(5, 0, None), GRAPHS[2]])
def test_quantize_mask_prf_plain_matches_pallas_and_ref(n, degree, perm):
    D, slot, u_off = 1000, 3, 4097  # ragged D, nonzero uniform offset
    x = np.random.RandomState(n).randn(D).astype(np.float32) * 0.01
    ksa.reset_counts()
    got = ksa.quantize_mask_prf(torch.from_numpy(x), SCALE, slot, UW,
                                _tsession(n, degree, perm), u_offset=u_off)
    assert ksa.quantize_mask_prf.plain_calls == 1
    assert ksa.quantize_mask_prf.launches == 0
    js = _jsession(n, degree, perm)
    pallas = jksa.quantize_mask_prf(jnp.asarray(x), SCALE, slot,
                                    jnp.asarray(UW, jnp.uint32), js,
                                    u_offset=u_off, interpret=True)
    oracle = ref.quantize_mask_prf(jnp.asarray(x), SCALE, slot,
                                   jnp.asarray(UW, jnp.uint32), js, perm=perm,
                                   u_offset=u_off)
    np.testing.assert_array_equal(np.asarray(pallas), got.numpy())
    np.testing.assert_array_equal(np.asarray(oracle), got.numpy())


def _wqa_inputs(C, D, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(C, D).astype(np.float32) * 0.01
    w = rs.uniform(0.2, 1.0, size=C).astype(np.float32)
    u = prf.uniform_block(5, 6, C * D).reshape(C, D).numpy()
    return x, w, u


@pytest.mark.parametrize("lane", ["plain", "masks", "prf", "prf-shard"])
def test_weighted_quantize_accum_plain_matches_pallas_and_ref(lane):
    C, D = 6, 777  # ragged D and C (the Pallas wrapper pads both)
    x, w, u = _wqa_inputs(C, D)
    jx, jw, ju = jnp.asarray(x), jnp.asarray(w), jnp.asarray(u)
    tx, tw, tu = (torch.from_numpy(a) for a in (x, w, u))
    kw, jkw = {}, {}
    if lane == "plain":
        oracle = ref.weighted_quantize_accum(jx, jw, ju, SCALE)
    elif lane == "masks":
        m = np.random.RandomState(1).randint(-2 ** 31, 2 ** 31, size=(C, D),
                                             dtype=np.int64).astype(np.int32)
        kw["masks"], jkw["masks"] = torch.from_numpy(m), jnp.asarray(m)
        oracle = ref.weighted_quantize_accum(jx, jw, ju, SCALE,
                                             masks=jnp.asarray(m))
    else:
        n, degree, perm = GRAPHS[0] if lane == "prf" else GRAPHS[1]
        # the shard places rows 0..5 at slots 6..11 of a 10-slot ring
        # session: rows at slot >= 10 are padding and carry no mask
        offset = 6 if lane == "prf-shard" else 0
        kw["session"] = _tsession(n, degree, perm, offset)
        jkw["session"] = _jsession(n, degree, perm, offset)
        oracle = ref.weighted_quantize_accum_prf(jx, jw, ju, SCALE,
                                                 jkw["session"], perm=perm)
    ksa.reset_counts()
    got = ksa.weighted_quantize_accum(tx, tw, tu, SCALE, **kw)
    assert ksa.weighted_quantize_accum.plain_calls == 1
    pallas = jksa.weighted_quantize_accum(jx, jw, ju, SCALE, interpret=True,
                                          **jkw)
    np.testing.assert_array_equal(np.asarray(pallas), got.numpy())
    np.testing.assert_array_equal(np.asarray(oracle), got.numpy())


def test_full_session_masks_cancel_in_the_accumulation():
    x, w, u = _wqa_inputs(8, 300, seed=3)
    args = [torch.from_numpy(a) for a in (x, w, u)]
    plain = ksa.weighted_quantize_accum(*args, SCALE)
    masked = ksa.weighted_quantize_accum(*args, SCALE,
                                         session=_tsession(8, 0))
    assert torch.equal(plain, masked)
    with pytest.raises(ValueError):
        ksa.weighted_quantize_accum(*args, SCALE, session=_tsession(8, 0),
                                    masks=torch.zeros(8, 300,
                                                      dtype=torch.int32))


def test_non_cpu_tensors_never_fall_back_to_the_plain_version():
    """Only a CPU tensor takes the plain version; any other device goes to
    the kernel path, which checks its inputs and raises instead."""
    ksa.reset_counts()
    x = torch.empty(16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ksa.quantize_mask_prf(x, SCALE, 0, UW, _tsession(8, 0))
    with pytest.raises(ValueError, match="CUDA"):
        ksa.weighted_quantize_accum(x.reshape(2, 8), x[:2], x.reshape(2, 8),
                                    SCALE)
    assert ksa.counts() == {
        "quantize_mask_prf": {"launches": 0, "plain_calls": 0},
        "weighted_quantize_accum": {"launches": 0, "plain_calls": 0}}
