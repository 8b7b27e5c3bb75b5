"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: skips without a GPU (the kernels have no CPU mode).  This
file imports neither JAX nor the JAX package, so it also runs on a GPU
machine without them:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.core.fl import secure_agg as sa
from repro_torch.kernels import prf
from repro_torch.kernels import secure_agg as ksa

SCALE = 1.0e4 / 3.0
UW = (77, 0xDEADBEEF)


def _session(n, degree, perm=None, offset=0):
    nbrs = None if perm is None else sa.neighbor_table(n, degree, perm,
                                                       device="cuda")
    return ksa.SessionMeta(key_words=(0x1234, 0x5A5E), num_slots=n,
                           degree=degree, slot_offset=offset, neighbors=nbrs)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(100_003, generator=g, device=cuda) * 0.01
    ksa.reset_counts()
    for n, degree, perm in ((8, 0, None), (10, 4, None),
                            (10, 4, [3, 0, 9, 1, 4, 8, 2, 7, 6, 5])):
        s = _session(n, degree, perm)
        got = ksa.quantize_mask_prf(x, SCALE, 2, UW, s, u_offset=9)
        want = ksa.quantize_mask_prf_plain(x, SCALE, 2, UW, s, u_offset=9)
        assert torch.equal(got, want)
    xs = torch.randn(8, 5001, generator=g, device=cuda) * 0.01
    ws = torch.rand(8, generator=g, device=cuda)
    us = prf.uniform_block(1, 2, 8 * 5001, device=cuda).reshape(8, 5001)
    for kw in ({}, {"session": _session(8, 0)},
               {"session": _session(10, 4, offset=3)}):
        got = ksa.weighted_quantize_accum(xs, ws, us, SCALE, **kw)
        want = ksa.weighted_quantize_accum_plain(xs, ws, us, SCALE, **kw)
        assert torch.equal(got, want)
    # K4 at ragged and whole Hadamard blocks, nonzero uniform offsets
    for D, scale, u_off in ((1, SCALE, 0), (511, 131067.5, 4097),
                            (100_003, 16777215.6875, 1 << 20)):
        x = torch.randn(D, generator=g, device=cuda) * 0.01
        got = ksa.rotate_quantize_prf(x, scale, (0x1234, 0xCB01), UW,
                                      u_offset=u_off)
        want = ksa.rotate_quantize_prf_plain(x, scale, (0x1234, 0xCB01), UW,
                                             u_offset=u_off)
        assert torch.equal(got, want)
    # K5 at three widths, a ragged size, both directions
    for bits in (1, 19, 31):
        q = torch.randint(0, 2 ** bits, (10_007,), generator=g, device=cuda,
                          dtype=torch.int64).to(torch.int32)
        words = ksa.pack_residues(q, bits)
        assert torch.equal(words, ksa.pack_residues_plain(q, bits))
        back = ksa.unpack_residues(words, 10_007, bits)
        assert torch.equal(back, ksa.unpack_residues_plain(words, 10_007,
                                                           bits))
        assert torch.equal(back, q)
    assert ksa.counts() == {
        "quantize_mask_prf": {"launches": 3, "plain_calls": 0},
        "weighted_quantize_accum": {"launches": 3, "plain_calls": 0},
        "rotate_quantize_prf": {"launches": 3, "plain_calls": 0},
        "pack_residues": {"launches": 3, "plain_calls": 0},
        "unpack_residues": {"launches": 3, "plain_calls": 0}}
