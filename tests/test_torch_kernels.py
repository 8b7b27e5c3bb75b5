"""The plain versions of the ported kernels against the Pallas kernels
(interpret mode) and the ``repro.kernels.ref`` oracles — bit-equal — plus the
wrappers' device dispatch and launch counters.

The CUDA kernels themselves run only on the card: see
``tests/test_torch_cuda.py`` (marked ``cuda``) and ``chip_smoke.py``.
"""
import jax
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
    # the PRF lane is counted apart from the other two
    prf_lane = "session" in kw
    assert ksa.weighted_quantize_accum.plain_calls == int(not prf_lane)
    assert ksa.weighted_quantize_accum.prf_plain_calls == int(prf_lane)
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


def _engine_sketch_lane(x, scale, signs, uk, u_off):
    """The jitted reference engine's unfused sketch encode
    (``aggregation.encode_plan_flat``'s ``ops`` branch)."""
    from repro.core.fl import compression as jcomp
    from repro.kernels import prf as jprf
    full = signs.shape[0]

    def lane(x, s):
        y = jcomp.block_rotate(jnp.pad(x, (0, full - x.shape[0])), s) * scale
        floor = jnp.floor(y)
        u = jprf.uniform_block(*jnp.asarray(uk, jnp.uint32), full,
                               offset=u_off)
        return (floor + (u < (y - floor)).astype(jnp.float32)).astype(
            jnp.int32)

    return jax.jit(lane)(jnp.asarray(x), jnp.asarray(signs))


# ragged and whole Hadamard blocks; scales of the bits-16/32 fields at
# buffers 3 and 8 and an arbitrary one.  The last case puts the rotated
# values near 1e5, where an ulp is 2^-6 of a level: there the reference's
# folded constant f32(f32(1/sqrt(512)) * scale) and a stepwise
# ``(y / sqrt(512)) * scale`` round 16 of the 4608 elements differently.
@pytest.mark.parametrize("D,scale,u_off,amp", [
    (1, SCALE, 0, 0.01), (511, 16777215.6875, 4097, 0.01),
    (512, 131067.5, 3, 0.01), (2245, 536870910.75 / 4.0, 1 << 20, 0.01),
    (4097, SCALE, 12345, 0.01), (4097, 131067.5, 5, 1.0)])
def test_rotate_quantize_prf_plain_matches_pallas_and_ref(D, scale, u_off,
                                                          amp):
    """Bit-equal to the Pallas kernel (interpret mode), the ``ref.py``
    oracle and the engine's unfused lane, each under ``jit`` — the
    reference as its engine runs it.  (The eager oracle rounds the two
    constant multiplies one at a time and differs in the last case.)"""
    x = np.random.RandomState(D).randn(D).astype(np.float32) * amp
    ok, uk = (0x1234, 0xCB01), UW
    ksa.reset_counts()
    got = ksa.rotate_quantize_prf(torch.from_numpy(x), scale, ok, uk,
                                  u_offset=u_off)
    assert ksa.rotate_quantize_prf.plain_calls == 1
    assert got.shape == (-(-D // 512) * 512,) and got.dtype == torch.int32
    jok, juk = jnp.asarray(ok, jnp.uint32), jnp.asarray(UW, jnp.uint32)
    pallas = jksa.rotate_quantize_prf(jnp.asarray(x), scale, jok, juk,
                                      u_offset=u_off, interpret=True)
    oracle = jax.jit(lambda v: ref.rotate_quantize_prf(
        v, scale, jok, juk, u_offset=u_off))(jnp.asarray(x))
    bits = prf.stream_block(*ok, got.shape[0], tag=prf.TAG_SIGN)
    signs = (1.0 - 2.0 * (bits & 1).to(torch.float32)).numpy()
    lane = _engine_sketch_lane(x, scale, signs, uk, u_off)
    for want in (pallas, oracle, lane):
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("bits", range(1, 33))
def test_pack_residues_plain_matches_pallas_ref_and_host_codec(bits):
    """Four ways bit-equal at a ragged width (not a multiple of 32): the
    plain version, the Pallas pair, the bit-by-bit ``ref.py`` oracles and
    the reference's host codec; and the round trip."""
    D = 1001
    rs = np.random.RandomState(bits)
    q = rs.randint(0, 2 ** bits, size=D, dtype=np.int64).astype(
        np.uint32).view(np.int32)
    ksa.reset_counts()
    words = ksa.pack_residues(torch.from_numpy(q), bits)
    back = ksa.unpack_residues(words, D, bits)
    assert (ksa.pack_residues.plain_calls, ksa.unpack_residues.plain_calls,
            ksa.pack_residues.launches) == (1, 1, 0)
    got = words.numpy().view(np.uint32)
    assert got.shape == (-(-D * bits // 32),)
    jq = jnp.asarray(q)
    np.testing.assert_array_equal(
        np.asarray(jksa.pack_residues(jq, bits, interpret=True)), got)
    np.testing.assert_array_equal(np.asarray(ref.pack_residues(jq, bits)),
                                  got)
    np.testing.assert_array_equal(
        np.asarray(jsa.pack_residues(jq, 1 << bits if bits < 32 else 1 << 32)),
        got)
    jw = jnp.asarray(got)
    for want in (jksa.unpack_residues(jw, D, bits, interpret=True),
                 ref.unpack_residues(jw, D, bits)):
        np.testing.assert_array_equal(np.asarray(want), back.numpy())
    np.testing.assert_array_equal(back.numpy(), q)


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
    with pytest.raises(ValueError, match="CUDA"):
        ksa.rotate_quantize_prf(x, SCALE, (1, 2), UW)
    q = torch.empty(64, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ksa.pack_residues(q, 19)
    with pytest.raises(ValueError, match="CUDA"):
        ksa.unpack_residues(q[:38], 64, 19)
    with pytest.raises(ValueError, match="expected 38"):
        ksa.unpack_residues(q[:37], 64, 19)
    with pytest.raises(ValueError, match="CUDA"):
        ksa.quantize_mask(x, None, x, SCALE, 4.0)
    with pytest.raises(ValueError, match="CUDA"):
        ksa.dequantize(q, 1e-4)
    with pytest.raises(ValueError, match="CUDA"):
        ksa.weighted_quantize_accum(x.reshape(2, 8), x[:2], x.reshape(2, 8),
                                    SCALE, session=_tsession(8, 0))
    assert ksa.counts() == {name: {"launches": 0, "plain_calls": 0} for name in
                            ("quantize_mask_prf", "weighted_quantize_accum",
                             "rotate_quantize_prf", "pack_residues",
                             "unpack_residues", "quantize_mask",
                             "dequantize", ksa.PRF_LANE)}
    from repro_torch.kernels import dp_clip as kdp
    kdp.reset_counts()
    with pytest.raises(ValueError, match="CUDA"):
        kdp.sq_norms(x.reshape(2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        kdp.scale_accum(x.reshape(2, 8), x[:2])
    assert kdp.counts() == {name: {"launches": 0, "plain_calls": 0}
                            for name in ("sq_norms", "scale_accum")}
