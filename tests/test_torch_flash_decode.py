"""K10's plain version against the Pallas ``flash_decode`` (interpret mode)
and the ``repro.kernels.ref`` oracle, plus the wrapper's device dispatch and
the kernel's launch geometry.

Tolerances: f32 scores and softmax summed in another order than the
reference's — rtol = atol = 2e-5, as ``tests/test_kernels.py`` holds the
Pallas kernel to its oracle; bf16 K/V atol 0.03, as there.  The CUDA kernel
itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_decode as jfd
from repro.kernels import ref
from repro_torch.kernels import flash_decode as kfd


def _inputs(seed, B, H, KV, hd, W):
    rs = np.random.RandomState(seed)
    q = (rs.randn(B, H, hd) * hd ** -0.5).astype(np.float32)
    k = rs.randn(B, W, KV, hd).astype(np.float32)
    v = rs.randn(B, W, KV, hd).astype(np.float32)
    return q, k, v


def _ref(q, k, v, slot, pos, window):
    return np.stack([np.asarray(ref.flash_decode(
        jnp.asarray(q[b]), jnp.asarray(k[b]), jnp.asarray(v[b]),
        jnp.asarray(slot), jnp.int32(pos), window if window else None))
        for b in range(q.shape[0])])


def _plain(q, k, v, slot, pos, window):
    return kfd.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), torch.from_numpy(slot), pos,
                            window=window).numpy()


# the grid of tests/test_kernels.py::test_flash_decode_sweep
@pytest.mark.parametrize("B,H,KV,hd,W", [(2, 8, 2, 64, 512),
                                         (1, 4, 4, 128, 256),
                                         (2, 16, 8, 64, 1024),
                                         (1, 10, 1, 256, 512)])
@pytest.mark.parametrize("window", [0, 128])
@pytest.mark.parametrize("fill", [0.4, 1.0])
def test_flash_decode_plain_matches_pallas_and_ref(B, H, KV, hd, W, window,
                                                   fill):
    q, k, v = _inputs(B * H + W + window, B, H, KV, hd, W)
    n_valid = int(W * fill)
    slot = np.where(np.arange(W) < n_valid, np.arange(W), -1).astype(np.int32)
    pos = n_valid - 1
    kfd.reset_counts()
    got = _plain(q, k, v, slot, pos, window)
    assert kfd.counts() == {"flash_decode": {"launches": 0, "plain_calls": 1}}
    pallas = np.asarray(jfd.flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(slot),
        jnp.int32(pos), window=window, interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, _ref(q, k, v, slot, pos, window),
                               rtol=2e-5, atol=2e-5)


def test_flash_decode_plain_bf16_matches_pallas():
    B, H, KV, hd, W = 2, 4, 2, 128, 512
    q, k, v = _inputs(9, B, H, KV, hd, W)
    qb, kb, vb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    slot = np.arange(W, dtype=np.int32)
    pallas = np.asarray(jfd.flash_decode(qb, kb, vb, jnp.asarray(slot),
                                         jnp.int32(W - 1), interpret=True))
    # the same bf16 values on the port's side (f32 -> bf16 rounds to nearest
    # even in both); the kernel takes q in f32, so q is widened back
    tq = torch.from_numpy(q).to(torch.bfloat16).float()
    tk = torch.from_numpy(k).to(torch.bfloat16)
    tv = torch.from_numpy(v).to(torch.bfloat16)
    np.testing.assert_array_equal(
        tk.float().numpy(), np.asarray(kb.astype(jnp.float32)))
    got = kfd.flash_decode(tq, tk, tv, torch.from_numpy(slot), W - 1).numpy()
    np.testing.assert_allclose(got, pallas, atol=0.03)
    want = _ref(tq.numpy(), tk.float().numpy(), tv.float().numpy(), slot,
                W - 1, 0)
    np.testing.assert_allclose(got, want, atol=0.03)


def _ring_slots(W, pos, filled):
    """slot_pos of a ring buffer after writing positions 0..pos at
    ``p % W``; only the last ``filled`` positions kept (-1 elsewhere)."""
    s = np.arange(W)
    last = pos - ((pos - s) % W)  # newest position written to each slot
    return np.where((last >= 0) & (last > pos - filled), last,
                    -1).astype(np.int32)


# cases the Pallas wrapper cannot take (W % 256 != 0): against the oracle
@pytest.mark.parametrize("W,pos,filled,window", [
    (300, 299, 300, 0),      # ragged W, full cache
    (2080, 2047, 2048, 0),   # the serve path's W, prompt filled, tail empty
    (100, 130, 100, 100),    # wrapped ring buffer (pos % W = 30)
    (100, 130, 100, 64),     # wrapped ring, a window inside the ring
    (96, 250, 50, 96),       # wrapped ring, partly filled
])
def test_flash_decode_plain_ragged_and_ring_match_ref(W, pos, filled, window):
    B, H, KV, hd = 2, 12, 2, 128
    q, k, v = _inputs(W + pos, B, H, KV, hd, W)
    slot = _ring_slots(W, pos, filled)
    assert (slot >= 0).any()
    got = _plain(q, k, v, slot, pos, window)
    np.testing.assert_allclose(got, _ref(q, k, v, slot, pos, window),
                               rtol=2e-5, atol=2e-5)


def test_flash_decode_no_valid_slot_follows_the_pallas_mask():
    """-1e30 masking (not -inf): a row with no valid slot averages v over
    the cache, as the Pallas kernel does, where the oracle gives NaN."""
    B, H, KV, hd, W = 1, 4, 2, 64, 256
    q, k, v = _inputs(3, B, H, KV, hd, W)
    slot = np.full(W, -1, np.int32)
    got = _plain(q, k, v, slot, 5, 0)
    pallas = np.asarray(jfd.flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(slot),
        jnp.int32(5), interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=2e-5, atol=2e-5)
    mean_v = v.mean(axis=1)  # (B, KV, hd)
    np.testing.assert_allclose(got.reshape(B, KV, 2, hd),
                               np.repeat(mean_v[:, :, None], 2, axis=2),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("B,KV,rep,W", [
    (8, 2, 6, 2080), (128, 2, 6, 32768), (1, 1, 10, 7), (2, 8, 2, 1),
    (4, 32, 1, 5000), (1, 2, 12, 100000)])
def test_flash_decode_splits_cover_the_cache(B, KV, rep, W):
    nsplit = kfd.splits(B, KV, rep, W)
    assert 1 <= nsplit <= min(W, kfd.MAX_SPLITS)
    # near-equal ranges, as the kernel cuts them: no empty split, no gap
    ranges = [kfd.split_range(W, nsplit, i) for i in range(nsplit)]
    assert ranges[0][0] == 0 and ranges[-1][1] == W
    assert all(a < b for a, b in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(nsplit - 1))
    assert max(b - a for a, b in ranges) - min(b - a for a, b in ranges) <= 1
    ctas = kfd.row_groups(B, KV, rep) * nsplit
    wave = kfd.SMS * kfd.CTAS_PER_SM
    if (B, W) == (8, 2080):
        # the serve path: 33 splits of 63-64 slots, 528 CTAs = one wave
        assert nsplit == 33 and ctas == wave
    if (B, W) == (128, 32768):
        # decode_32k: 33 splits of 992-993 slots, 8448 CTAs = 16 waves
        assert nsplit == 33 and ctas == 16 * wave
    if ctas % wave:
        # no whole number of waves fits: at most one wave, or one split per
        # tile of the cache
        assert ctas <= wave or nsplit == min(-(-W // kfd.TILE),
                                             kfd.MAX_SPLITS)


@pytest.mark.parametrize("sms,per_sm", [(132, 4), (132, 2), (114, 4)])
def test_flash_decode_splits_follow_the_card(sms, per_sm):
    """The split count is taken from the card's SMs and the kernel's
    occupancy: the grid stays a whole number of waves on each."""
    for B, KV, rep, W in ((8, 2, 6, 2080), (128, 2, 6, 32768)):
        nsplit = kfd.splits(B, KV, rep, W, sms=sms, per_sm=per_sm)
        assert kfd.row_groups(B, KV, rep) * nsplit % (sms * per_sm) == 0
        assert nsplit <= min(-(-W // kfd.TILE), kfd.MAX_SPLITS)


@pytest.mark.parametrize("B,KV,rep,rows", [
    (8, 2, 6, 16), (128, 2, 6, 256), (1, 1, 10, 2), (3, 8, 2, 24),
    (4, 32, 1, 128), (1, 2, 12, 4), (2, 1, 16, 4)])
def test_flash_decode_row_groups_size_the_ticket_buffer(B, KV, rep, rows):
    """One CTA row (and one split-merge ticket) per batch row, kv head and
    group of up to 8 query rows."""
    assert kfd.row_groups(B, KV, rep) == rows
